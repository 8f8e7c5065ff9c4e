"""K13, BatchNorm with the activation that follows it, on the CPU: the port's
``kernels.batch_norm_act`` (its plain version here) against the JAX package's
``TorchBatchNorm`` followed by ``jax.nn.relu``, the residual add or ``PReLU``,
forward, running statistics and ``jax.vjp``; the fused ``Bottleneck`` and
``ConvBNRelu`` against their JAX modules; the route reference the card's
checks use; and, emulated by ``tris_tpu_torch/tools/batch_norm_schedule.py``
from the constants of ``csrc/launchers.h``, the plan that chooses between
the fused and the two-pass design, the two-pass design's partition of a
channel among warps, the fused design's among a cluster's blocks and their
lane groups, the statistics in each design's order of sums, and the launches
each main path makes, at every shape of the RN50 trunk and stage 2's decoder
at B=48, 320 px.

Inputs are made with numpy from a seed. Bars: outputs within 1e-5 of their
scale, running statistics within 1e-6 relative, gradients within 1e-5 of
each gradient's max (the fused blocks, through convolutions, 2e-5 and 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import randomize_norms
from tris_tpu.models import clip as jc, layers as jl, stage2 as js2
from tris_tpu_torch import kernels as K
from tris_tpu_torch.ckpt.from_jax import state_dict_from_flax
from tris_tpu_torch.models import clip as tc, stage2 as ts2
from tris_tpu_torch.models.clip import CLIP_CONFIGS, ModifiedResNet
from tris_tpu_torch.tools import batch_norm_schedule as S

torch.set_num_threads(2)

MODES = {"train": (True, True), "eval": (False, False), "teacher": (True, False)}
ACTS = ["none", "relu", "relu_residual", "none_residual", "prelu"]


def _np(t):
    return t.detach().numpy()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return _np(t).transpose(0, 2, 3, 1)


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} of {scale}"


def _inputs(shape, seed):
    """x NHWC, the BN variables, PReLU's slope and a residual, from a seed."""
    rng = np.random.default_rng(seed)
    N, H, W, C = shape
    x = (1.5 * rng.standard_normal(shape) + rng.standard_normal(C)).astype(np.float32)
    v = {"params": {"scale": (1 + 0.3 * rng.standard_normal(C)).astype(np.float32),
                    "bias": (0.5 * rng.standard_normal(C)).astype(np.float32)},
         "batch_stats": {"mean": rng.standard_normal(C).astype(np.float32),
                         "var": (0.5 + rng.random(C)).astype(np.float32)}}
    alpha = np.array([0.3], np.float32)
    res = rng.standard_normal(shape).astype(np.float32)
    return x, v, alpha, res


def _jax_bn_act(v, x, train, act, alpha, res):
    y, upd = jl.TorchBatchNorm().apply(v, x, use_running_average=not train,
                                       mutable=["batch_stats"])
    if res is not None:
        y = y + res
    if act.startswith("relu"):
        y = jax.nn.relu(y)
    elif act == "prelu":
        y = jl.PReLU().apply({"params": {"alpha": alpha}}, y)
    return y, upd


def _port_args(v, alpha, act, res):
    p, s = v["params"], v["batch_stats"]
    weight, bias = (torch.from_numpy(p[k].copy()).requires_grad_() for k in ("scale", "bias"))
    rm, rv = (torch.from_numpy(s[k].copy()) for k in ("mean", "var"))
    slope = torch.from_numpy(alpha.copy()).requires_grad_() if act == "prelu" else None
    residual = _nchw(res).requires_grad_() if res is not None else None
    return weight, bias, rm, rv, slope, residual


@pytest.mark.parametrize("shape", [(3, 5, 7, 6), (1, 1, 1, 4)])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("mode", list(MODES))
def test_batch_norm_act_against_jax(mode, act, shape):
    # forward within 1e-5 of its scale; the running statistics within 1e-6
    # relative (train), untouched (eval and the teacher's update_stats=False);
    # dx, dscale, dbias, the slope and the residual's gradient within 1e-5 of
    # each gradient's max against jax.vjp. (1, 1, 1, 4): one element a
    # channel, the unbiased variance's max(n - 1, 1) guard.
    _check_against_jax(K.batch_norm_act, mode, act, shape)


@pytest.mark.parametrize("shape", [(3, 5, 7, 6), (1, 1, 1, 4)])
@pytest.mark.parametrize("act", ["relu_residual", "prelu"])
@pytest.mark.parametrize("mode", list(MODES))
def test_route_reference_against_jax(mode, act, shape):
    # the card's route reference (the kernels' statistics, parameters
    # through float64) at the same bars against the JAX package
    _check_against_jax(K.batch_norm_act_reference, mode, act, shape)


def _check_against_jax(fn, mode, act, shape):
    training, update = MODES[mode]
    x, v, alpha, res = _inputs(shape, 11)
    res = res if act.endswith("residual") else None
    kind = act.split("_")[0]
    want, upd = _jax_bn_act(v, x, training, kind, alpha, res)
    weight, bias, rm, rv, slope, residual = _port_args(v, alpha, kind, res)
    rm0, rv0 = rm.clone(), rv.clone()
    xt = _nchw(x).requires_grad_()
    got = fn(xt, weight, bias, rm, rv, training=training, update_stats=update, momentum=0.1,
             eps=1e-5, act=kind, slope=slope, residual=residual)
    _close(_nhwc(got), want, 1e-5, "y")
    if mode == "train":
        for buf, leaf in ((rm, "mean"), (rv, "var")):
            np.testing.assert_allclose(_np(buf), upd["batch_stats"][leaf], rtol=1e-6,
                                       atol=1e-6 * float(np.abs(upd["batch_stats"][leaf]).max()))
    else:
        assert torch.equal(rm, rm0) and torch.equal(rv, rv0)

    cot = np.random.default_rng(12).standard_normal(want.shape).astype(np.float32)

    def f(x, scale, bias, alpha, res):
        vv = {"params": {"scale": scale, "bias": bias}, "batch_stats": v["batch_stats"]}
        return _jax_bn_act(vv, x, training, kind, alpha, res)[0]

    _, vjp = jax.vjp(f, x, v["params"]["scale"], v["params"]["bias"], alpha, res)
    gx, gs, gb, ga, gr = vjp(jnp.asarray(cot))
    got.backward(_nchw(cot))
    _close(_nhwc(xt.grad), gx, 1e-5, "dx")
    _close(_np(weight.grad), gs, 1e-5, "dscale")
    _close(_np(bias.grad), gb, 1e-5, "dbias")
    if slope is not None:
        _close(_np(slope.grad), ga, 1e-5, "dslope")
    if residual is not None:
        _close(_nhwc(residual.grad), gr, 1e-5, "dresidual")


def test_batch_norm_act_on_the_cpu_is_the_plain_version(monkeypatch):
    # CPU tensors take the plain version: the same bits, and no kernel built
    # or counted
    def no_build():
        raise AssertionError("the CPU route built the kernels")

    monkeypatch.setattr(K.build, "ops", no_build)
    x, v, alpha, res = _inputs((2, 4, 6, 5), 3)
    K.reset_launches()
    for training, update in MODES.values():
        for act, r in (("relu", res), ("prelu", None), ("none", None)):
            outs = []
            for fn in (K.batch_norm_act, K.batch_norm_act_plain):
                weight, bias, rm, rv, slope, residual = _port_args(v, alpha, act, r)
                outs.append((fn(_nchw(x), weight, bias, rm, rv, training=training,
                                update_stats=update, momentum=0.1, eps=1e-5, act=act,
                                slope=slope, residual=residual), rm, rv))
            assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert not any(K.launches.values())


def test_batch_norm_act_refuses_unfused_forms():
    x, v, alpha, res = _inputs((2, 3, 3, 4), 5)
    weight, bias, rm, rv, slope, _ = _port_args(v, alpha, "prelu", None)
    kw = dict(training=True, update_stats=False, momentum=0.1, eps=1e-5)
    with pytest.raises(ValueError, match="one of"):
        K.batch_norm_act(_nchw(x), weight, bias, rm, rv, act="gelu", **kw)
    with pytest.raises(ValueError, match="slope goes with"):
        K.batch_norm_act(_nchw(x), weight, bias, rm, rv, act="relu", slope=slope, **kw)
    with pytest.raises(ValueError, match="slope goes with"):
        K.batch_norm_act(_nchw(x), weight, bias, rm, rv, act="prelu", **kw)
    with pytest.raises(ValueError, match="no residual before a PReLU"):
        K.batch_norm_act(_nchw(x), weight, bias, rm, rv, act="prelu", slope=slope,
                         residual=_nchw(res), **kw)


# ---- the fused modules against their JAX counterparts ------------------------------------


def _jax_module_pair(jmod, tmod, x, seed, rename=None):
    v = jax.jit(lambda k: jmod.init(k, x, train=False))(jax.random.PRNGKey(seed))
    v = randomize_norms(jax.tree_util.tree_map(np.asarray, v), seed)
    sd = state_dict_from_flax(v if rename is None else rename(v))
    tmod.load_state_dict(sd, strict=True)
    return v


def _bn_buffers(tmod):
    return {k: _np(b) for k, b in tmod.named_buffers() if k.endswith(("running_mean",
                                                                       "running_var"))}


def _check_module(jmod, tmod, v, x, train, buf_key):
    # forward within 2e-5 of its scale, the running statistics within 1e-6
    # relative (1e-5 after two convolutions), dx within 1e-4 of its max
    fwd = jax.jit(lambda v, x: jmod.apply(v, x, train=train, mutable=["batch_stats"]))
    want, upd = fwd(v, x)
    tmod.train(train)
    xt = _nchw(x).requires_grad_()
    got = tmod(xt)
    _close(_nhwc(got), want, 2e-5, "y")
    if train:
        flat = jax.tree_util.tree_leaves_with_path(upd["batch_stats"])
        bufs = _bn_buffers(tmod)
        assert len(flat) == len(bufs)
        for path, leaf in flat:
            key = buf_key(tuple(p.key for p in path))
            np.testing.assert_allclose(bufs[key], np.asarray(leaf), rtol=1e-5,
                                       atol=1e-6 * float(np.abs(leaf).max()))
    cot = np.random.default_rng(2).standard_normal(np.shape(want)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: fwd(v, x)[0], x)
    got.backward(_nchw(cot))
    _close(_nhwc(xt.grad), vjp(jnp.asarray(cot))[0], 1e-4, "dx")


_BOTTLENECK_KEYS = {"ds_bn": "downsample.1"}


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("inplanes,planes,stride", [(16, 4, 1), (8, 4, 2), (8, 4, 1)])
def test_bottleneck_fused_against_jax(inplanes, planes, stride, train):
    # bn1 + ReLU, bn2 + ReLU and bn3 + identity + ReLU, each one call
    x = np.random.default_rng(7).standard_normal((2, 8, 8, inplanes)).astype(np.float32)
    jmod = jc.Bottleneck(planes=planes, stride=stride)
    tmod = tc.Bottleneck(inplanes, planes, stride)
    v = _jax_module_pair(jmod, tmod, x, 3)
    _check_module(jmod, tmod, v, x, train,
                  lambda p: f"{_BOTTLENECK_KEYS.get(p[0], p[0])}.running_{p[1]}")


@pytest.mark.parametrize("train", [True, False])
def test_conv_bn_relu_fused_against_jax(train):
    # BatchNorm and the channel-shared PReLU in one call, the slope read
    # from ``relu.weight``
    x = np.random.default_rng(8).standard_normal((3, 6, 5, 8)).astype(np.float32)
    jmod = js2.ConvBNRelu(features=6)
    tmod = ts2.ConvBNRelu(8, 6)

    def rename(v):
        return {c: {("relu" if k == "act" else k): t for k, t in tree.items()}
                for c, tree in v.items()}

    v = _jax_module_pair(jmod, tmod, x, 4, rename)
    _check_module(jmod, tmod, v, x, train, lambda p: f"{p[0]}.running_{p[1]}")


# ---- the kernels' partition, emulated ----------------------------------------------------


PATH_SHAPES = sorted(set(S.trunk_shapes()) | set(S.decoder_shapes()))


@pytest.mark.parametrize("shape", PATH_SHAPES)
def test_chunks_tile_every_channel(shape):
    # the warps' slices (the statistics' and the backward's) tile a plane:
    # each a full kBatchNormSlice but the last, which is not empty; with HW %
    # 4 == 0 no float4 crosses a slice; the warp index stays an int64 and a
    # channel's elements below the kernels' 2^24
    N, C, H, W = shape
    HW = H * W
    size = S.constants()["kBatchNormSlice"]
    assert size % 4 == 0 and HW % 4 == 0
    assert (S.slices(HW) - 1) * size < HW <= S.slices(HW) * size
    bounds = [(s * size, min((s + 1) * size, HW)) for s in range(S.slices(HW))]
    assert bounds[0][0] == 0 and bounds[-1][1] == HW
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert N * HW < 2 ** 24 and N <= S.constants()["kBatchNormMaxBatch"]


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (3, 2, 4, 4), (1, 1, 1, 1), (2, 1, 64, 64),
                                   (3, 1, 61, 61), (2, 2, 1, 3), (2, 1, 96, 96)])
def test_every_element_is_visited_once(shape):
    # the warps of the statistics and the backward's sums, float4 and
    # scalar, at shapes with one and several slices a plane, a short last
    # slice and HW % 4 != 0
    N, C, H, W = shape
    assert (S.visits(N, C, H * W) == 1).all()


@pytest.mark.parametrize("shape", PATH_SHAPES)
def test_statistics_combine_against_numpys_float64(shape):
    # two channels of each path shape, offset from zero so that the shift
    # matters: the mean within 1e-6 of its scale (|mean| + std), the biased
    # variance and rstd within 1e-6 relative of numpy's float64 (each
    # sample's sums are exact to float32, the batch is added in float32)
    N, C, H, W = shape
    rng = np.random.default_rng(C + H)
    for c in range(2):
        planes = (4.0 + 2.0 * rng.standard_normal((N, H * W))).astype(np.float32)
        mean, var, rstd = S.channel_stats(planes)
        v64 = planes.astype(np.float64)
        assert abs(mean - v64.mean()) <= 1e-6 * (abs(v64.mean()) + v64.std())
        assert abs(var - v64.var()) <= 1e-6 * v64.var()
        assert abs(rstd - 1 / np.sqrt(v64.var() + 1e-5)) <= 1e-6 * rstd


@pytest.mark.parametrize("shape", [(3, 5, 7, 6), (2, 4, 96, 96), (48, 8, 10, 10)])
def test_kernel_statistics_are_jaxs_to_float32(shape):
    # the kernels' statistics (the route reference's) against the JAX
    # package's float32 two-pass (the plain version's):
    # the mean within 1e-6 of its scale, var and rstd within 1e-6 relative
    from tris_tpu_torch.kernels.batch_norm import batch_stats_plain, jax_batch_stats

    N, C, H, W = shape
    x = torch.from_numpy((1.0 + 2.0 * np.random.default_rng(H).standard_normal(shape))
                         .astype(np.float32))
    got, want = batch_stats_plain(x, 1e-5), jax_batch_stats(x, 1e-5)
    _close(got[0], want[0], 1e-6, "mean")
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(3, 5, 7, 6), (2, 4, 96, 96), (1, 3, 1, 1)])
def test_plain_statistics_are_the_kernels_sums(shape):
    # the route reference's statistics are the emulated kernels' bit for bit:
    # each sample's float64 sums (slices of a plane added in order) rounded
    # once, the batch added in float32 in order
    from tris_tpu_torch.kernels.batch_norm import batch_stats_plain

    N, C, H, W = shape
    x = (3.0 + np.random.default_rng(C).standard_normal((N, C, H, W))).astype(np.float32)
    got = [t.numpy() for t in batch_stats_plain(torch.from_numpy(x), 1e-5)]
    for c in range(C):
        want = S.channel_stats(x[:, c].reshape(N, H * W))
        assert [g[c] for g in got] == list(want)


def test_trunk_shapes_and_calls_are_the_models(monkeypatch):
    # the 55 calls of a full-width RN50 trunk at B=48, 320 px, traced on the
    # meta device, in order and with their activations
    calls = []

    def record(x, *args, act="none", residual=None, **kw):
        calls.append((tuple(x.shape), act, residual is not None))
        return torch.empty_like(x)

    monkeypatch.setattr(K, "batch_norm_act", record)
    cfg = CLIP_CONFIGS["RN50"]
    with torch.device("meta"):
        trunk = ModifiedResNet(cfg.vision_layers, cfg.embed_dim, cfg.vision_width // 2,
                               cfg.image_resolution, cfg.vision_width)
        trunk(torch.empty(48, 3, 320, 320), pool=False)
    assert [c[0] for c in calls] == S.trunk_shapes() and len(calls) == 55
    assert sum(a == "relu" and not r for _, a, r in calls) == 3 + 2 * 16
    assert sum(a == "relu" and r for _, a, r in calls) == 16
    assert sum(a == "none" for _, a, r in calls) == 4


@pytest.mark.parametrize("side", [True, False])
def test_decoder_shapes_and_calls_are_the_models(monkeypatch, side):
    # stage 2's decoder at B=48, 320 px on the meta device: 12 ConvBNRelu
    # calls with the side heads (train), 9 without (eval), each with PReLU
    calls = []

    def record(x, *args, act="none", slope=None, **kw):
        calls.append((tuple(x.shape), act, slope is not None))
        return torch.empty_like(x)

    monkeypatch.setattr(K, "batch_norm_act", record)
    monkeypatch.setattr(K, "pixel_attn", lambda q, lk, lv, S: q)
    monkeypatch.setattr(K, "bilinear_resize",
                        lambda x, hw, align_corners=False: x.new_empty(*x.shape[:-2], *hw))
    with torch.device("meta"):
        model = ts2.TRISStage2(ts2.Stage2Config(backbone="RN50", txt_length=20))
        cs = [torch.empty(48, c, 320 // s, 320 // s)
              for c, s in ((256, 4), (512, 8), (1024, 16), (2048, 32))]
        model._decode(*cs, torch.empty(48, 20, 512), 1, (320, 320), side=side)
    assert [c[0] for c in calls] == S.decoder_shapes(side=side)
    assert len(calls) == (S.DECODER_TRAIN_CALLS if side else S.DECODER_EVAL_CALLS)
    assert all(a == "prelu" and s for _, a, s in calls)


def test_parameters_from_double_sum_their_gradients_in_float64():
    # the route reference broadcasts weight, bias and the slope through
    # float64: the same values, and gradients that are float64 sums
    # of the float32 products (a float32 sum of 2^20 cancelling terms is off
    # by far more)
    from tris_tpu_torch.kernels.batch_norm import _from_double

    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.standard_normal((4, 2, 256, 256)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((4, 2, 256, 256)).astype(np.float32))
    w = torch.tensor([0.5, -1.5]).requires_grad_()
    full = _from_double(w[:, None, None], y)
    assert full.dtype == torch.float32 and torch.equal(full, w[:, None, None].expand(y.shape))
    (got,) = torch.autograd.grad(full, w, g)
    want = g.double().sum(dim=(0, 2, 3))
    assert float((got.double() - want).abs().max()) <= 1e-7 * float(want.abs().max())


# ---- the plan and the fused design, emulated ------------------------------------------------


def test_plan_follows_the_rules_constants():
    # launchers.h's rule: the first R within the target at 256 threads, else
    # the first within the most a block may have at 512, else (backward) 16;
    # R <= N; smem, group and blocks as the helpers give them
    k = S.constants()
    assert (k["kBatchNormSmemSmall"], k["kBatchNormSmemTarget"], k["kBatchNormSmemMax"]) == (
        56 * 1024, 113 * 1024, 227 * 1024)
    assert k["kBatchNormMaxRanks"] == 8 and k["kBatchNormWideRanks"] == 16
    for N, HW in [(48, 100), (48, 400), (48, 1600), (48, 6400), (48, 25600), (5, 3), (1, 1),
                  (16, 9000), (2, 30000), (1, 60000), (4096, 1)]:
        for backward in (False, True):
            p = S.plan(N, 7, HW, True, backward)
            if p["design"] == 0:
                assert p["launches"] == 3
                for r in range(1, min(N, 8) + 1):
                    assert S.fused_smem(N, HW, backward, -(-N // r), 512) > k["kBatchNormSmemMax"]
                continue
            R, threads = p["ranks"], p["threads"]
            assert R <= N and p["samples"] == -(-N // R) and p["blocks"] == 7 * R
            assert p["smem_bytes"] == S.fused_smem(N, HW, backward, p["samples"], threads)
            assert p["group"] == S.group(threads, p["samples"], S.items(HW))
            most = k["kBatchNormSmemTarget"] if threads == 256 else k["kBatchNormSmemMax"]
            assert p["smem_bytes"] <= most
            # R: the first that fits the small target at 256 threads, else the target,
            # else the most at 512
            portable = range(1, min(N, 8) + 1)
            fits = [[r for r in portable if S.fused_smem(N, HW, backward, -(-N // r), t) <= b]
                    for t, b in ((256, k["kBatchNormSmemSmall"]), (256, k["kBatchNormSmemTarget"]),
                                 (512, k["kBatchNormSmemMax"]))]
            assert R == (fits[0] or fits[1] or fits[2] or [16])[0]
            assert threads == (256 if fits[0] or fits[1] else 512)
    assert S.plan(48, 64, 6400, True, True, max_ranks=8)["design"] == 0
    assert S.plan(8, 3, 100, training=False)["design"] == 2
    assert S.plan(8, 3, 100, training=False)["launches"] == 1


def test_plan_takes_the_group_and_smem_of_launchers_h():
    # the emulated helpers are the header's: its constexpr bodies, read as
    # text, give the same numbers through a tiny C-to-Python reading
    text = S.LAUNCHERS.read_text()
    assert "constexpr long long batch_norm_fused_smem" in text
    assert ("(backward ? 2 : 1) * samples * batch_norm_pitch(HW) * 4 + (backward ? 24LL : 8LL)"
            " * N +") in text
    assert "24LL * (threads / 32) + 8LL * samples + 16;" in text
    assert "while (2LL * g * samples <= threads && g < items) g *= 2;" in text
    assert S.group(256, 48, 25) == 4 and S.group(512, 3, 1600) == 128 and S.group(256, 1, 1) == 1
    assert S.pitch(3) == 4 and S.pitch(100) == 100 and S.items(100) == 25 and S.items(3) == 3


TRUNK_DESIGNS = {  # (HW, backward) -> (design, R) at B=48
    (25600, False): (0, 0), (25600, True): (0, 0), (6400, False): (1, 6), (6400, True): (1, 16),
    (1600, False): (1, 6), (1600, True): (1, 6), (400, False): (1, 2), (400, True): (1, 3),
    (100, False): (1, 1), (100, True): (1, 1)}


@pytest.mark.parametrize("part", ["trunk", "decoder"])
def test_designs_at_the_paths_shapes(part):
    # which design each norm of the RN50 trunk and stage 2's decoder takes at
    # B=48, pinned: the stem's three two-pass, every other fused (HW = 6400
    # backward on a cluster of 16)
    shapes = S.trunk_shapes() if part == "trunk" else S.decoder_shapes()
    act = "relu" if part == "trunk" else "prelu"
    for backward in (False, True):
        got = [(S.plan(N, C, H * W, True, backward, act)["design"],
                S.plan(N, C, H * W, True, backward, act)["ranks"]) for N, C, H, W in shapes]
        assert got == [TRUNK_DESIGNS[(H * W, backward)] for N, C, H, W in shapes]
    fused = [S.plan(N, C, H * W)["design"] == 1 for N, C, H, W in S.trunk_shapes()]
    assert sum(fused) == 52 and not any(fused[:3])
    small = [s for s in S.trunk_shapes() if s[2] * s[3] <= 1600]
    assert len(small) == 40


@pytest.mark.parametrize("shape", PATH_SHAPES)
def test_fused_plans_fit_a_block(shape):
    # every fused plan within 227 KB of shared memory a block, R <= 8 but the
    # backward at HW = 6400 (16); its threads hold a group a sample
    N, C, H, W = shape
    for backward in (False, True):
        p = S.plan(N, C, H * W, True, backward)
        if p["design"] != 1:
            assert H * W == 25600
            continue
        assert p["smem_bytes"] <= 227 * 1024
        assert p["ranks"] <= 8 or (backward and H * W == 6400 and p["ranks"] == 16)
        assert p["group"] * p["samples"] <= p["threads"] or p["group"] == 1


@pytest.mark.parametrize("HW", [1, 3, 100, 400])
@pytest.mark.parametrize("N", [1, 5, 48])
def test_fused_blocks_stage_and_write_every_element_once(N, HW):
    # the fused kernels' blocks at clusters of 1, 2, 4 and 8 (ranks beyond N
    # stage nothing), forward and backward: each element staged, summed and
    # written once
    for R in (1, 2, 4, 8):
        for backward in (False, True):
            v = S.fused_visits(N, 2, HW, backward, ranks=R)
            for what, counts in v.items():
                assert (counts == 1).all(), (R, backward, what)


@pytest.mark.parametrize("shape", [(3, 7, 6), (48, 10, 10), (48, 20, 20), (5, 1, 3), (1, 1, 1),
                                   (6, 40, 40), (16, 9, 9)])
def test_fused_statistics_are_the_two_pass_designs(shape):
    # a channel's statistics in the fused kernel's order of sums (at its
    # plan's group, and at clusters of 2 and 8 where N allows) equal the
    # two-pass design's and the route reference's bit for bit on seeded
    # planes, and numpy's float64 within float32 (1e-6 relative; the mean of
    # its scale)
    from tris_tpu_torch.kernels.batch_norm import batch_stats_plain

    N, H, W = shape
    rng = np.random.default_rng(N * H + W)
    x = (2.5 + 1.5 * rng.standard_normal((N, 3, H, W))).astype(np.float32)
    ref = [t.numpy() for t in batch_stats_plain(torch.from_numpy(x), 1e-5)]
    for c in range(3):
        planes = x[:, c].reshape(N, H * W)
        want = S.channel_stats(planes)
        for ranks in [None] + [r for r in (2, 8) if r <= N]:
            got = S.fused_channel_stats(planes, ranks=ranks)
            assert list(got) == list(want) == [r[c] for r in ref], (c, ranks)
        v64 = planes.astype(np.float64)
        assert abs(want[0] - v64.mean()) <= 1e-6 * (abs(v64.mean()) + v64.std())
        assert abs(want[1] - v64.var()) <= 1e-6 * v64.var()


def test_launches_per_step_are_chip_smokes():
    # chip_smoke.py's K13 counts, from the plans: a stage-1 train step's
    # trunk 52 fused + 3 two-pass norms each way; stage 2 two train-mode
    # forwards of the trunk and the decoder, one backward (PReLU's second
    # launch at the decoder's 12); eval one apply a norm. Without the wide
    # cluster, HW = 6400's backward goes two-pass
    import chip_smoke

    got = chip_smoke.bn_launches(max_ranks=16)
    assert got == {"stage1_eval": {"batch_norm": 55, "batch_norm_bwd": 0},
                   "stage1_train": {"batch_norm": 61, "batch_norm_bwd": 61},
                   "stage2_train": {"batch_norm": 2 * (61 + 12), "batch_norm_bwd": 61 + 24},
                   "stage2_eval": {"batch_norm": 55 + 9, "batch_norm_bwd": 0}}
    narrow = chip_smoke.bn_launches(max_ranks=8)
    assert narrow["stage1_train"] == {"batch_norm": 61, "batch_norm_bwd": 40 + 15 * 3}
    assert narrow["stage2_train"]["batch_norm_bwd"] == 40 + 15 * 3 + 8 * 2 + 4 * 3
    trunk = S.trunk_shapes()
    assert S.launches_per_forward(trunk, "eval") == len(trunk)
    assert S.launches_per_forward(trunk, "teacher") == S.launches_per_forward(trunk, "train")
