"""IRN's loss fused with K7 (``kernels/irn_affinity.py``,
``csrc/irn_affinity.cu``) and K7's tiled backward on the CPU.

The fused loss's plain route (K7's plain affinity, then K8's plain masked
sums) against the JAX package's ``path_max_affinity_slices``, pair labels and
``irn_loss``'s masked sums, and their ``jax.vjp`` with respect to the edge
map and the displacement field: sums within 1e-5 relative, counts exact,
d edge and d dp within 1e-5 of their scales (JAX sums in float32), also
on displacements with pairs exactly at their targets, where the port takes
``abs``' slope as JAX does (1 at 0; torch's ``abs`` would take 0). The same for
``tris_tpu_torch/tools/irn_affinity_schedule.py``'s emulation of the
kernels' arithmetic. The emulation of the tiles, with the constants of
``csrc/launchers.h``: each pair of the forward summed by one block; each
backward tile's pairs covering every pair and step that reaches its pixels;
the tiled gather equal bit for bit to the per-pixel gather in (direction,
step) order, whose d edge in float64 rounded once is the plain float64
gradient rounded once (within an ulp where ties split terms); the plan
pinned at the IRN step's, the walk's and ragged shapes. ``chip_smoke.py``'s
IRN launches per step from the step's calls.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tris_tpu.pseudo import train_irn as JT
from tris_tpu.pseudo.indexing import PathIndex as JPathIndex
from tris_tpu.pseudo.indexing import path_max_affinity_slices as j_path_max
from tris_tpu.pseudo.irnet import to_pair_displacement as j_pairs
from tris_tpu_torch import kernels
from tris_tpu_torch.kernels import path_max as K7
from tris_tpu_torch.pseudo.indexing import PathIndex
from tris_tpu_torch.tools import irn_affinity_schedule as T

K8 = importlib.import_module("tris_tpu_torch.kernels.irn_loss")

torch.set_num_threads(2)

W5 = np.array([0.3, -1.2, 0.7, 2.0, -0.4], np.float32)   # the five sums' cotangent


def _inputs(B, H, W, seed, edge="random", zeros=True):
    rng = np.random.default_rng(seed)
    blocks = rng.choice(np.array([0, 1, 255], np.uint8), (B, H // 4 + 1, W // 4 + 1))
    labels = blocks.repeat(4, 1).repeat(4, 2)[:, :H, :W].copy()
    if edge == "tied":     # four levels, zero among them (aff = 1), noise in the top third
        e = (rng.integers(0, 4, (B, H, W)) / 4).astype(np.float32)
        e[:, :H // 3] = rng.random((B, H // 3, W), dtype=np.float32)
    else:
        e = rng.random((B, H, W), dtype=np.float32)
    dp = (3 * rng.standard_normal((B, 2, H, W))).astype(np.float32)
    if zeros:   # exact zeros of |pair - target|, where JAX's abs has slope 1 (torch's: 0)
        dp[:, :, :H // 4] = np.round(dp[:, :, :H // 4])
    return labels, e, dp


def _jax_sums(edge, dp, labels, jpi):
    """JAX's masked sums (train_irn.irn_loss's numerators) and pair counts."""
    B = edge.shape[0]
    aff = jnp.concatenate([g.reshape(B, -1) for g in j_path_max(edge, jpi)], axis=1)
    pos, neg = -jnp.log(aff + 1e-5), -jnp.log(1.0 + 1e-5 - aff)
    pair = j_pairs(dp.transpose(0, 2, 3, 1), jpi)
    target = jnp.asarray(jpi.search_dst.T, jnp.float32)[None, :, :, None]
    bg, fg, neg_m = (m.reshape(pos.shape) for m in JT.affinity_labels_on_device(labels, jpi))
    fg4, bg4 = fg.reshape(B, 1, *pair.shape[2:]), bg.reshape(B, 1, *pair.shape[2:])
    sums = jnp.stack([(bg * pos).sum(), (fg * pos).sum(), (neg_m * neg).sum(),
                      (jnp.abs(pair - target) * fg4).sum(), (jnp.abs(pair) * bg4).sum()])
    return sums, jnp.stack([bg.sum(), fg.sum(), neg_m.sum()])


@functools.lru_cache(maxsize=4)
def _jax_fn(radius, H, W):
    """JAX's sums and their vjp of the five sums' cotangent W5, jitted once a grid."""
    jpi = JPathIndex(radius, (H, W))

    def run(e, d, lab):
        (sums, counts), vjp = jax.vjp(lambda e, d: _jax_sums(e, d, lab, jpi), e, d)
        return (sums, counts, *vjp((jnp.asarray(W5), jnp.zeros(3, jnp.float32))))

    return jax.jit(run)


@functools.lru_cache(maxsize=8)
def _case(B, H, W, radius, edge, zeros=False):
    """A case's inputs (with ``zeros``, pair displacements planted exactly at
    their targets) and JAX's (sums, counts, d edge, d dp)."""
    labels, e, dp = _inputs(B, H, W, radius + H, edge, zeros=zeros)
    want = tuple(np.asarray(x) for x in _jax_fn(radius, H, W)(e, dp, labels))
    return (labels, e, dp), want


def _scaled_err(a, b):
    b = np.asarray(b, np.float64)
    return float(np.abs(np.asarray(a, np.float64) - b).max() / max(np.abs(b).max(), 1e-30))


CASES = [(2, 19, 23, 5, "random"), (2, 19, 23, 5, "tied"), (1, 24, 29, 10, "random"),
         (1, 24, 29, 10, "tied")]


@pytest.mark.parametrize("B,H,W,radius,edge", CASES)
def test_plain_route_matches_jax(B, H, W, radius, edge):
    (labels, e, dp), (want_s, want_c, want_de, want_ddp) = _case(B, H, W, radius, edge)
    pi = PathIndex(radius, (H, W))
    et, dpt = torch.from_numpy(e).requires_grad_(), torch.from_numpy(dp).requires_grad_()
    sums, counts = kernels.irn_affinity_loss(torch.from_numpy(labels), et, dpt, pi)
    np.testing.assert_array_equal(counts.numpy(), want_c.astype(np.int64))
    assert want_c.min() > 0
    assert np.abs(sums.detach().numpy() / want_s - 1).max() <= 1e-5
    (sums * torch.from_numpy(W5)).sum().backward()
    assert _scaled_err(et.grad.numpy(), want_de) <= 1e-5
    assert _scaled_err(dpt.grad.numpy(), want_ddp) <= 1e-5


@pytest.mark.parametrize("B,H,W,radius,edge", CASES)
def test_kernel_arithmetic_matches_jax(B, H, W, radius, edge):
    # the schedule tool's emulation of the kernels' arithmetic (float terms
    # summed in double; d aff in float, q in double, d edge rounded once; d dp
    # in float in K8's order)
    (labels, e, dp), (want_s, want_c, want_de, want_ddp) = _case(B, H, W, radius, edge)
    pi = PathIndex(radius, (H, W))
    steps, rf = K7.path_steps(pi.paths_by_length), pi.radius_floor
    sums, counts = T.fused_forward(labels, e, dp, steps, rf, K8.EPS, K8.ONE_EPS, K8.MAX_VALID)
    np.testing.assert_array_equal(counts, want_c.astype(np.int64))
    assert np.abs(sums / want_s - 1).max() <= 1e-5
    d_edge, d_dp = T.fused_backward(labels, e, dp, W5, steps, rf, K8.EPS, K8.ONE_EPS,
                                    K8.MAX_VALID)
    assert _scaled_err(d_edge, want_de) <= 1e-5
    assert _scaled_err(d_dp, want_ddp) <= 1e-5


@pytest.mark.parametrize("route", ["plain", "kernel_arithmetic"])
@pytest.mark.parametrize("B,H,W,radius,edge", CASES[:2])
def test_abs_slope_at_zero_follows_jax(B, H, W, radius, edge, route):
    # pair displacements exactly at their targets (and bg pairs exactly 0): JAX's abs has
    # slope 1 there (jax.grad(jnp.abs)(0.0) == 1), so d dp follows JAX, not torch's sign()
    (labels, e, dp), (_, _, _, want_ddp) = _case(B, H, W, radius, edge, zeros=True)
    pi = PathIndex(radius, (H, W))
    steps, rf = K7.path_steps(pi.paths_by_length), pi.radius_floor
    pairs = T._windows(dp[:, 0], [(0, 0), (1, 0)], rf)
    assert (pairs[0] == pairs[1]).sum() > 0      # some differences are exact zeros
    if route == "plain":
        dpt = torch.from_numpy(dp).requires_grad_()
        sums, _ = kernels.irn_affinity_loss(torch.from_numpy(labels), torch.from_numpy(e), dpt, pi)
        (sums * torch.from_numpy(W5)).sum().backward()
        got = dpt.grad.numpy()
    else:
        got = T.fused_backward(labels, e, dp, W5, steps, rf, K8.EPS, K8.ONE_EPS,
                               K8.MAX_VALID)[1]
    assert _scaled_err(got, want_ddp) <= 1e-5


@pytest.mark.parametrize("B,H,W,radius,edge", CASES + [(1, 45, 77, 10, "tied")])
def test_kernel_arithmetic_against_float64(B, H, W, radius, edge):
    # the emulated kernels against the plain route run in float64 (the
    # loss's float32 constants kept): d edge within 1e-6 and d dp within 1e-5
    # of their scales, the bars chip_smoke.py holds the card to
    labels, e, dp = _inputs(B, H, W, radius + W, edge)
    pi = PathIndex(radius, (H, W))
    steps, rf = K7.path_steps(pi.paths_by_length), pi.radius_floor
    et = torch.from_numpy(e.astype(np.float64)).requires_grad_()
    dpt = torch.from_numpy(dp.astype(np.float64)).requires_grad_()
    sums, _ = kernels.irn_affinity_loss_plain(torch.from_numpy(labels), et, dpt, pi)
    (sums * torch.from_numpy(W5).double()).sum().backward()
    d_edge, d_dp = T.fused_backward(labels, e, dp, W5, steps, rf, K8.EPS, K8.ONE_EPS,
                                    K8.MAX_VALID)
    assert _scaled_err(d_edge, et.grad.numpy()) <= 1e-6
    assert _scaled_err(d_dp, dpt.grad.numpy()) <= 1e-5


@pytest.mark.parametrize("B,H,W,radius,edge", [(2, 19, 23, 5, "random"), (2, 19, 23, 5, "tied"),
                                               (1, 45, 77, 10, "random"), (1, 45, 77, 10, "tied"),
                                               (3, 9, 14, 3, "tied")])
def test_gather_rounds_the_float64_gradient_once(B, H, W, radius, edge):
    # K7's backward: the per-pixel gather in (direction, step) order, in
    # float64 rounded once, is the plain version's float64 gradient (summed
    # by autograd in another order) rounded once: bit for bit where no path
    # ties (each term a float32, every double sum exact), within one float32
    # ulp where ties split a term by its count (g / 3 rounds in double, so the
    # two orders' sums may straddle a float32 rounding boundary)
    _, e, _ = _inputs(B, H, W, 3, edge)
    pi = PathIndex(radius, (H, W))
    steps, rf = K7.path_steps(pi.paths_by_length), pi.radius_floor
    g = np.random.default_rng(4).standard_normal((B, len(steps), H - rf, W - 2 * rf))
    g = g.astype(np.float32)
    et = torch.from_numpy(e.astype(np.float64)).requires_grad_()
    aff = kernels.path_max_affinity_plain(et, pi.paths_by_length, rf)
    (aff * torch.from_numpy(g).double()).sum().backward()
    got = T.gather(e, [g[:, d] for d in range(len(steps))], steps, rf)
    want = et.grad.numpy().astype(np.float32)
    if edge == "random":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("B,H,W,radius,edge", [(2, 19, 23, 5, "tied"), (1, 45, 77, 10, "tied"),
                                               (1, 40, 37, 10, "random"), (3, 9, 14, 3, "tied"),
                                               (1, 128, 128, 10, "tied")])
def test_tiled_backward_equals_the_gather(B, H, W, radius, edge):
    # the kernels' tiles (staged halo, each direction's pairs, their max,
    # count and q from the staged values) give the per-pixel gather bit for
    # bit: K7's backward with a cotangent read, the fused loss's formed
    labels, e, dp = _inputs(B, H, W, 5, edge)
    pi = PathIndex(radius, (H, W))
    steps, rf = K7.path_steps(pi.paths_by_length), pi.radius_floor
    g = np.random.default_rng(6).standard_normal((B, len(steps), H - rf, W - 2 * rf))
    g = g.astype(np.float32)
    tiled = T.tiled_backward(e, steps, rf, cot_of=lambda b, d: g[b, d])
    np.testing.assert_array_equal(tiled, T.gather(e, [g[:, d] for d in range(len(steps))],
                                                  steps, rf))
    tiled = T.tiled_backward(e, steps, rf, labels=labels, dp=dp, gsum=W5, eps=K8.EPS,
                             one_eps=K8.ONE_EPS, max_valid=K8.MAX_VALID)
    want, _ = T.fused_backward(labels, e, dp, W5, steps, rf, K8.EPS, K8.ONE_EPS, K8.MAX_VALID)
    np.testing.assert_array_equal(tiled, want)


@pytest.mark.parametrize("B,H,W,radius", [(24, 128, 128, 10), (1, 133, 170, 5), (1, 45, 77, 10),
                                          (2, 19, 23, 5), (1, 5, 6, 3)])
def test_forward_sums_each_pair_once(B, H, W, radius):
    pi = PathIndex(radius, (H, W))
    visits = T.forward_visits(B, H, W, pi.radius_floor, len(pi.search_dst))
    assert visits.min() == 1 and visits.max() == 1


@pytest.mark.parametrize("kind,H,W,radius", [
    (T.LOSS_BACKWARD, 128, 128, 10), (T.MAX_BACKWARD, 133, 170, 5), (T.LOSS_BACKWARD, 45, 77, 10),
    (T.MAX_BACKWARD, 45, 77, 10), (T.LOSS_BACKWARD, 19, 23, 5), (T.MAX_BACKWARD, 5, 6, 3)])
def test_backward_tiles_cover_every_pair_and_step(kind, H, W, radius):
    pi = PathIndex(radius, (H, W))
    cov = T.backward_coverage(kind, 1, H, W, pi.radius_floor,
                              K7.path_steps(pi.paths_by_length))
    assert cov["failures"] == []
    assert cov["computed"] >= cov["needed"] > 0


# worked from launchers.h::path_tile_plan by hand: (kind, B, H, W, rf) -> rpt, tiles_y, tiles_x,
# pitch, staged_rows, region_rows, smem_bytes (8192 of them the table's offsets)
PLANS = [
    ((0, 24, 128, 128, 9), (4, 4, 4, 50, 41, 0, 34848)),     # the IRN step's forward: 384 blocks
    ((1, 24, 128, 128, 9), (4, 4, 4, 50, 50, 41, 65296)),    # its backward
    ((2, 24, 128, 128, 9), (4, 4, 4, 50, 50, 41, 42800)),    # K7's backward there
    ((2, 1, 133, 170, 4), (1, 17, 6, 40, 16, 12, 16512)),     # the walk's grid: 102 blocks
    ((0, 1, 133, 170, 4), (1, 17, 6, 40, 12, 0, 14432)),     # 129 x 162 pairs
    ((0, 1, 45, 77, 9), (1, 5, 2, 50, 17, 0, 19248)),        # ragged: 36 x 59 pairs
    ((1, 1, 45, 77, 9), (1, 6, 3, 50, 26, 17, 35296)),
    ((0, 12, 128, 128, 9), (2, 8, 4, 50, 25, 0, 24448)),     # 12 x 4 x 4 < 264: rpt 2
]


@pytest.mark.parametrize("args,want", PLANS, ids=[str(a) for a, _ in PLANS])
def test_plan_pinned(args, want):
    p = T.plan(*args)
    got = (p["rpt"], p["tiles_y"], p["tiles_x"], p["pitch"], p["staged_rows"], p["region_rows"],
           p["smem_bytes"])
    assert got == want
    assert p["tile_rows"] == 8 * p["rpt"] and p["blocks"] == args[1] * p["tiles_y"] * p["tiles_x"]


def test_constants_read_from_launchers():
    c = T.constants()
    assert (c["kPathTileCols"], c["kPathThreads"], c["kPathRowsPerThread"],
            c["kPathWaveBlocks"]) == (32, 256, 4, 264)
    assert (K7.TABLE_STEPS, K7.TABLE_DIRS) == (c["kPathTableSteps"], c["kPathTableDirs"])
    assert (K7.LOSS_FORWARD, K7.LOSS_BACKWARD, K7.MAX_BACKWARD) == \
        (c["kPathLossForward"], c["kPathLossBackward"], c["kPathMaxBackward"]) == \
        (T.LOSS_FORWARD, T.LOSS_BACKWARD, T.MAX_BACKWARD)
    # radius 12 is the largest whose table the tiled kernels take
    for radius, fits in ((12, True), (13, False)):
        pi = PathIndex(radius, (2 * radius + 2, 2 * radius + 2))
        steps = K7.path_steps(pi.paths_by_length)
        assert (sum(map(len, steps)) <= K7.TABLE_STEPS and len(steps) <= K7.TABLE_DIRS) == fits


def test_table_refuses_steps_outside_the_window():
    small, large = PathIndex(5, (16, 16)), PathIndex(10, (32, 32))
    steps = K7.path_steps(large.paths_by_length)
    flat, offsets = K7.tile_table(steps, large.radius_floor)
    assert flat.dtype == torch.int32 and flat.device.type == "cpu"
    assert offsets.tolist()[-1] == flat.shape[0] == 2134
    with pytest.raises(ValueError, match="outside the window of radius floor 4"):
        K7.tile_table(steps, small.radius_floor)
    big = PathIndex(13, (30, 30))
    with pytest.raises(ValueError, match="at most"):
        K7.tile_table(K7.path_steps(big.paths_by_length), big.radius_floor)


def test_irn_launches_per_step_are_chip_smokes(monkeypatch):
    # an IRN train step on the device-label feed calls the fused loss once
    # (two launches forward, one backward on the card), K7 alone never, and
    # K6's bilinear resize six times (each with one launch and one backward):
    # chip_smoke.py's IRN_LAUNCHES_PER_STEP
    import chip_smoke
    from tris_tpu_torch.pseudo.irnet import IRNet
    from tris_tpu_torch.pseudo.train_irn import IRNTrainConfig, make_irn_optimizer, train_step

    calls = {"irn_affinity_loss": 0, "path_max_affinity": 0, "bilinear_resize": 0}
    for name in calls:
        fn = getattr(kernels, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(kernels, name, counted)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = IRNet().train()
    opt, sched = make_irn_optimizer(model, IRNTrainConfig(crop_size=64, radius=5), 10)
    pi = PathIndex(5, (16, 16))
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.standard_normal((2, 3, 64, 64)).astype(np.float32)),
             "reduced_label": torch.from_numpy(rng.choice(np.array([0, 1, 255], np.uint8),
                                                          (2, 16, 16)))}
    train_step(model, opt, sched, pi, batch)
    per_call = {"irn_affinity_loss": (2, 1), "path_max_affinity": (1, 1),
                "bilinear_resize": (1, 1)}
    want = {}
    for name, n in calls.items():
        want[name], want[name + "_bwd"] = n * per_call[name][0], n * per_call[name][1]
    assert want == {k: chip_smoke.IRN_LAUNCHES_PER_STEP.get(k, 0) for k in want}
    assert set(chip_smoke.IRN_LAUNCHES_PER_STEP) <= set(kernels.KERNELS)
    src = importlib.import_module("tris_tpu_torch.kernels.irn_affinity")
    import inspect
    text = inspect.getsource(src._IrnAffinityLoss)
    assert 'build.count("irn_affinity_loss", n=2)' in text
    assert 'build.count("irn_affinity_loss_bwd")' in text
