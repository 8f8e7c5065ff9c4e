"""K3's training head on the CPU: ``tris_tpu_torch/tools/stage1_head_schedule.py``
runs the kernels' partition (a cluster of R ranks an image; forward, each rank
the scores of its share of the pixels in tiles of 56 x 48, the block's warps
splitting the channels and their sums added in warp order, then cls_out on its
share of the texts and both maps on its band of output rows; backward, d seg on
its band streamed in row groups onto the h rows and reduced onto its [h, w]
partial, the partials added in rank order, and both input gradients on its
channel groups) in the kernels' arithmetic. Each score is formed once, each
output row written once and read once by the backward, each channel group
written once, for every R the plans take, ragged shares, B = 1 and identity
taps included; the emulation agrees with K3's plain version in float64 within
the card tests' bars (2e-5 of each output's and gradient's scale), and, put in
the stage-1 model's place, with JAX's ``forward(train=True)`` and with the
gradients of its ``stage1_loss`` at the bars of ``tests/test_torch_train.py``.
The plans are pinned at the train path's shape and the card tests' to
``csrc/launchers.h::stage1_head_plan``'s answers, worked from the rule by hand
(the card's tests hold the extension's own answer to the tool's).
"""

import copy
import re

import numpy as np
import pytest
import torch

from tests.test_torch_train import jax_loss, make_batch, pair  # noqa: F401
from tris_tpu_torch import kernels
from tris_tpu_torch.eval.validate import image_to_nchw
from tris_tpu_torch.kernels.response_head import taps_on, upsample_taps_plain
from tris_tpu_torch.ckpt.from_jax import grads_from_flax
from tris_tpu_torch.tools import stage1_head_schedule as S1
from tris_tpu_torch.train.stage1 import Stage1LossWeights, batch_to_device, stage1_loss

torch.set_num_threads(2)

FOCAL = (3.0, 0.01)
SCALE = np.float32(1 / 0.07)


def _inputs(B, hw, D, seed, T=None):
    rng = np.random.default_rng(seed)
    vis = rng.standard_normal((B, hw, D)).astype(np.float32)
    lan = rng.standard_normal((B, B if T is None else T, D)).astype(np.float32)
    vis /= np.linalg.norm(vis, axis=-1, keepdims=True)
    lan /= np.linalg.norm(lan, axis=-1, keepdims=True)
    return vis, lan


def _plain64(vis, lan, hw_shape, out_hw, offset=0):
    v = torch.from_numpy(vis).double().requires_grad_()
    l_ = torch.from_numpy(lan).double().requires_grad_()
    return v, l_, kernels.stage1_head_plain(v, l_, torch.tensor(float(SCALE), dtype=torch.float64),
                                            hw_shape, out_hw, *FOCAL, offset)


# (B, (h, w), (H, W), d relu_map too, D): B = 1 (a softmax over bg and one text), identity
# taps (out == hw), the train path's B = 48 and maps (R = 2 forward, 4 backward) cut in D,
# W % 4 != 0 (a column a thread), a ragged pixel share (hw not a multiple of R)
CASES = [(1, (3, 3), (24, 24), False, 32), (4, (10, 10), (10, 10), True, 64),
         (6, (10, 10), (320, 288), False, 64), (5, (4, 7), (33, 50), True, 48),
         (48, (10, 10), (320, 320), False, 32), (3, (5, 5), (96, 96), True, 16)]


@pytest.mark.parametrize("B,hw,out,relu,D", CASES)
def test_emulation_covers_each_score_row_and_group_once(B, hw, out, relu, D):
    (h, w), (H, W) = hw, out
    vis, lan = _inputs(B, h * w, D, B + D)
    scores, rows = np.zeros((B, h * w, B), np.int64), np.zeros((B, H), np.int64)
    score, cls_out, cls_fg, relu_map, sig_map = S1.emulate_forward(
        vis, lan, SCALE, hw, out, *FOCAL, scores, rows)
    assert (scores == 1).all() and (rows == 1).all()
    for o in (score, cls_out, cls_fg, relu_map, sig_map):
        assert np.isfinite(o).all()
    rng = np.random.default_rng(B)
    g_sig = rng.standard_normal((B, H, W)).astype(np.float32)
    g_relu = rng.standard_normal((B, H, W)).astype(np.float32) if relu else None
    read, groups = np.zeros((B, H), np.int64), np.zeros((B, D // 4), np.int64)
    d_vis, d_lan = S1.emulate_backward(rng.standard_normal((B, B)).astype(np.float32), g_relu,
                                       g_sig, vis, lan, SCALE, score, hw, out, *FOCAL, read,
                                       groups)
    assert (read == 1).all() and (groups == 1).all()
    assert np.isfinite(d_vis).all() and np.isfinite(d_lan).all()


@pytest.mark.parametrize("B,hw,out,relu,D", CASES)
def test_emulation_matches_the_plain_version(B, hw, out, relu, D):
    # forward outputs and the gradients of vis_p and lan_p against the plain version in
    # float64: 2e-5 of each output's / gradient's scale, the card test's bars; with relu
    # the map gradient also comes through relu_map
    (h, w), (H, W) = hw, out
    vis, lan = _inputs(B, h * w, D, B + D + 1)
    score, *got = S1.emulate_forward(vis, lan, SCALE, hw, out, *FOCAL)
    v, l_, want = _plain64(vis, lan, hw, out)
    for a, b in zip(got, want):
        b = b.detach().numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 2e-5 * max(1.0, np.abs(b).max())
    rng = np.random.default_rng(B + 7)
    cot = [rng.standard_normal((B, B)).astype(np.float32), None,
           rng.standard_normal((B, H, W)).astype(np.float32) if relu else None,
           rng.standard_normal((B, H, W)).astype(np.float32)]
    got_g = S1.emulate_backward(cot[0], cot[2], cot[3], vis, lan, SCALE, score, hw, out, *FOCAL)
    outs = [o for o, c in zip(want, cot) if c is not None]
    want_g = torch.autograd.grad(outs, [v, l_], [torch.from_numpy(c).double() for c in cot
                                                 if c is not None])
    for a, b in zip(got_g, want_g):
        b = b.numpy()
        assert np.abs(a - b).max() <= 2e-5 * max(1.0, np.abs(b).max())


@pytest.mark.parametrize("B,hw,out,relu,D", CASES[:4])
def test_emulated_maps_are_the_plain_upsample_of_the_emulated_scores(B, hw, out, relu, D):
    # the maps' arithmetic bit for bit: the plain version's taps in its order on the
    # emulated score plane's diagonal (the card holds its plane and relu map to the emulation)
    (h, w), (H, W) = hw, out
    vis, lan = _inputs(B, h * w, D, B)
    score, _, _, relu_map, _ = S1.emulate_forward(vis, lan, SCALE, hw, out, *FOCAL)
    own = torch.from_numpy(score).diagonal(dim1=0, dim2=2).T.reshape(B, h, w)
    want = torch.relu(upsample_taps_plain(own, taps_on(h, H, False, own.device),
                                          taps_on(w, W, False, own.device)))
    assert torch.equal(torch.from_numpy(relu_map), want)


def test_the_first_argmax_takes_the_gmp_gradient():
    # pixels 2 and 5 tie for text 1's max (image 0, text 1 not its own): the first takes
    # d cls_out whole (JAX would split it); their masks are equal, so their dscore rows
    # differ by exactly d cls_out[0, 1]
    B, h, w = 3, 3, 3
    vis, lan = _inputs(B, h * w, 8, 11)
    score, *_ = S1.emulate_forward(vis, lan, SCALE, (h, w), (12, 12), *FOCAL)
    score[0, 5] = score[0, 2]
    score[0, 2, 1] = score[0, 5, 1] = score[0, :, 1].max() + 1
    g = np.zeros((B, B), np.float32)
    g[0, 1] = 0.75
    ds = S1.dscore(g, score, np.zeros((B, h * w), np.float32), *FOCAL)
    assert ds[0, 2, 1] - ds[0, 5, 1] == np.float32(0.75)
    assert np.array_equal(np.delete(ds[0, 2], 1), np.delete(ds[0, 5], 1))


@pytest.mark.parametrize("R", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n", [1, 7, 25, 100, 256, 320])
def test_shares_partition(R, n):
    # the ranks' shares of n pixels, texts, rows or channel groups are consecutive, disjoint
    # and whole
    shares = [S1.share(n, R, r) for r in range(R)]
    assert [i for s in shares for i in s] == list(range(n))
    assert max(len(s) for s in shares) <= -(-n // R)


@pytest.mark.parametrize("n,T", [(25, 48), (13, 48), (0, 5), (1, 1), (9, 7), (100, 160),
                                 (29, 49)])
def test_score_tiles_cover_the_share_once(n, T):
    seen = np.zeros((n, T), np.int64)
    for pixels, texts in S1.score_tiles(n, T):
        seen[np.ix_(pixels, texts)] += 1
    assert (seen == 1).all()


# (B, h, w, D, H, W, backward) at the train path's shape and the card tests' -> (ranks,
# pixels, band_rows, vec, passes, stages, groups, blocks, smem_bytes), from launchers.h's rule
# by hand
PLANS = {
    (48, 10, 10, 1024, 320, 320, False): (2, 50, 160, 4, 1, 3, 0, 96, 183936),  # the train step
    (48, 10, 10, 1024, 320, 320, True): (4, 25, 80, 4, 0, 0, 64, 192, 69920),
    (1, 3, 3, 256, 24, 24, False): (2, 5, 12, 4, 1, 3, 0, 2, 164784),           # B = 1
    (1, 3, 3, 256, 24, 24, True): (2, 5, 12, 4, 0, 0, 32, 2, 13120),
    (5, 4, 7, 256, 33, 50, False): (4, 7, 9, 1, 1, 3, 0, 20, 165296),           # W % 4 != 0
    (6, 10, 10, 256, 320, 288, True): (8, 13, 40, 4, 0, 0, 8, 48, 41976),       # R = 8
    (200, 10, 10, 64, 64, 64, False): (1, 100, 64, 4, 10, 2, 0, 200, 189824),   # 2 stages fit
    (72, 20, 20, 64, 64, 64, False): (1, 400, 64, 4, 16, 2, 0, 72, 225024),
    (72, 20, 20, 64, 64, 64, True): (2, 200, 32, 4, 0, 0, 8, 144, 246496),      # refused
}


@pytest.mark.parametrize("key", list(PLANS), ids=[str(k) for k in PLANS])
def test_plan_pinned(key):
    p = S1.plan(*key)
    got = tuple(p[k] for k in ("ranks", "pixels", "band_rows", "vec", "passes", "stages",
                               "groups", "blocks", "smem_bytes"))
    assert got == PLANS[key]
    assert p["threads"] == 256 and p["ranks"] <= S1.constants()["kStage1HeadMaxRanks"]


def test_constants_read_from_launchers():
    assert S1.constants() == {
        "kStage1HeadThreads": 256, "kStage1HeadMaxRanks": 8, "kStage1HeadWaveBlocks": 132,
        "kStage1HeadBwdWaveBlocks": 264, "kStage1HeadMinRows": 8, "kStage1HeadKSplit": 8,
        "kStage1HeadTilePixels": 56, "kStage1HeadTileTexts": 48, "kStage1HeadChunk": 128,
        "kStage1HeadStages": 3, "kStage1HeadMaxSmem": 232448, "kStage1HeadPad": 4,
        "kStage1HeadMapGroups": 3, "kStage1HeadMapLoads": 4, "kStage1HeadGradRows": 8,
        "kStage1HeadGradGroups": 2,
        "kStage1HeadGradChunk": 8, "kStage1HeadGradStages": 3}


def test_chip_smoke_counts_one_launch_each_way():
    import chip_smoke

    per_step = chip_smoke.TRAIN_LAUNCHES_PER_STEP
    assert per_step["stage1_head"] == 1 and per_step["stage1_head_bwd"] == 1


def test_emulation_in_the_model_matches_jax_forward_train(pair, monkeypatch):  # noqa: F811
    # as test_torch_train.py::test_forward_train_matches_jax: the five outputs within 1e-4
    # of their scale, with the emulated kernels in the plain version's place
    import jax
    import jax.numpy as jnp

    jm, v, tm, *_ = pair
    tm = copy.deepcopy(tm).train()
    batch = make_batch(1, u8=False, negatives=False)
    want, _ = jax.jit(lambda v, i, w: jm.apply(v, i, w, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(batch["image"]), jnp.asarray(batch["word_ids"]))
    monkeypatch.setattr(kernels, "stage1_head", S1.emulated_head)
    with torch.no_grad():
        got = tm(image_to_nchw(torch.from_numpy(batch["image"])),
                 torch.from_numpy(batch["word_ids"]), train=True)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.ndim == 4:
            w = w.transpose(0, 3, 1, 2)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(w).max()))


def test_emulation_in_the_model_matches_jax_loss_gradients(pair, monkeypatch):  # noqa: F811
    # as test_torch_train.py::test_stage1_loss_and_grads_match_jax (u8, negatives): the loss
    # terms within 1e-5 relative and every parameter's gradient within 1e-4 of its leaf's
    # max-abs gradient, with the emulated kernels, forward and backward, in the plain
    # version's place. logit_scale is frozen in stage 1 and gets no gradient from the
    # kernels (JAX's is computed and never applied)
    jm, v, tm, jc, cv, tc = pair
    tm = copy.deepcopy(tm).train()
    batch = make_batch(2, u8=True, negatives=True)
    j_loss, j_metrics, _, j_grads = jax_loss(jm, v, jc, cv, batch)
    monkeypatch.setattr(kernels, "stage1_head", S1.emulated_head)
    loss, metrics = stage1_loss(tm, tc, batch_to_device(batch, "cpu"), Stage1LossWeights())
    loss.backward()
    for k in ("loss", "l1", "l4", "l5", "cls_fg"):
        np.testing.assert_allclose(float(metrics[k]), j_metrics[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    want = grads_from_flax(j_grads)
    params = dict(tm.named_parameters())
    top = max(float(w.abs().max()) for w in want.values())
    assert tm.logit_scale.grad is None and float(want["logit_scale"].abs().max()) > 0
    for k, w in want.items():
        if k == "logit_scale":
            continue
        g = params[k].grad
        g = torch.zeros_like(w) if g is None else g
        if re.fullmatch(r"attn_fusion\.(v_proj[123]|v_output)\.0\.bias", k):
            # zero in exact arithmetic (the InstanceNorm right after removes them)
            assert float(g.abs().max()) <= 1e-4 * top and float(w.abs().max()) <= 1e-4 * top, k
            continue
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * float(w.abs().max()) + 1e-12, err_msg=k)


# the rectangular head of a process group: B images of a rank against the T texts of the
# global batch, the rank's own at offset = rank * B. (B, T, offset, (h, w), (H, W), d relu_map
# too, D): the first and last rank of two, a middle rank of three with a ragged share, and the
# card check's 2 x 24 against 48 at the train maps (cut in D)
RECT = [(2, 4, 0, (3, 3), (24, 24), True, 32), (2, 4, 2, (3, 3), (24, 24), False, 32),
        (3, 9, 3, (4, 7), (33, 50), True, 16), (24, 48, 24, (10, 10), (320, 320), False, 8)]


@pytest.mark.parametrize("B,T,off,hw,out,relu,D", RECT)
def test_rectangular_emulation_covers_each_score_row_and_group_once(B, T, off, hw, out, relu, D):
    (h, w), (H, W) = hw, out
    vis, lan = _inputs(B, h * w, D, B + T, T)
    scores, rows = np.zeros((B, h * w, T), np.int64), np.zeros((B, H), np.int64)
    score, cls_out, cls_fg, relu_map, sig_map = S1.emulate_forward(
        vis, lan, SCALE, hw, out, *FOCAL, scores, rows, offset=off)
    assert (scores == 1).all() and (rows == 1).all() and cls_out.shape == (B, T)
    rng = np.random.default_rng(T)
    read, groups = np.zeros((B, H), np.int64), np.zeros((B, D // 4), np.int64)
    d_vis, d_lan = S1.emulate_backward(
        rng.standard_normal((B, T)).astype(np.float32),
        rng.standard_normal((B, H, W)).astype(np.float32) if relu else None,
        rng.standard_normal((B, H, W)).astype(np.float32), vis, lan, SCALE, score, hw, out,
        *FOCAL, read, groups, offset=off)
    assert (read == 1).all() and (groups == 1).all() and d_lan.shape == (B, T, D)
    assert np.isfinite(d_vis).all() and np.isfinite(d_lan).all()


@pytest.mark.parametrize("B,T,off,hw,out,relu,D", RECT)
def test_rectangular_emulation_matches_the_plain_version(B, T, off, hw, out, relu, D):
    # as test_emulation_matches_the_plain_version, at its bars, for B images against T texts
    (h, w), (H, W) = hw, out
    vis, lan = _inputs(B, h * w, D, B + T + 1, T)
    score, *got = S1.emulate_forward(vis, lan, SCALE, hw, out, *FOCAL, offset=off)
    v, l_, want = _plain64(vis, lan, hw, out, off)
    for a, b in zip(got, want):
        b = b.detach().numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 2e-5 * max(1.0, np.abs(b).max())
    rng = np.random.default_rng(B + T)
    cot = [rng.standard_normal((B, T)).astype(np.float32), None,
           rng.standard_normal((B, H, W)).astype(np.float32) if relu else None,
           rng.standard_normal((B, H, W)).astype(np.float32)]
    got_g = S1.emulate_backward(cot[0], cot[2], cot[3], vis, lan, SCALE, score, hw, out, *FOCAL,
                                offset=off)
    outs = [o for o, c in zip(want, cot) if c is not None]
    want_g = torch.autograd.grad(outs, [v, l_], [torch.from_numpy(c).double() for c in cot
                                                 if c is not None])
    for a, b in zip(got_g, want_g):
        b = b.numpy()
        assert np.abs(a - b).max() <= 2e-5 * max(1.0, np.abs(b).max())


def test_rectangular_head_is_the_square_heads_rows():
    # a rank's rows of the square head over the global batch: cls_out, cls_fg and both maps
    # of images [off, off + B) equal the B x T head's with its own texts at off (the plain
    # version, float64)
    Bg, hw, out, D = 6, (4, 5), (16, 20), 16
    vis, lan = _inputs(Bg, 20, D, 3)
    lan_g = lan[0]  # every image the same T = Bg texts, as stage 1 expands them
    full = _plain64(vis, np.broadcast_to(lan_g, (Bg, Bg, D)).copy(), hw, out)[2]
    for off in (0, 2, 4):
        part = _plain64(vis[off:off + 2], np.broadcast_to(lan_g, (2, Bg, D)).copy(), hw, out,
                        off)[2]
        for a, b in zip(part, full):
            assert torch.equal(a, b[off:off + 2])


def test_rectangular_plain_refuses_an_offset_past_the_texts():
    v = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="own texts"):
        kernels.stage1_head(v, torch.zeros(2, 3, 8), torch.tensor(1.0), (2, 2), (4, 4), 3.0,
                            0.01, offset=2)


# (B, T, h, w, D, H, W, backward) -> as PLANS; the card check's 2 x 24 images against 48 texts:
# the forward's plane [100, 48] and stages as the train step's (R = 4 now: 24 images x 2 x 4 >
# 132 stops the doubling at 4), the backward's R = 8 (24 x 2 x 8 = 384 > 264 stops it there)
RECT_PLANS = {
    (24, 48, 10, 10, 1024, 320, 320, False): (4, 25, 80, 4, 1, 3, 0, 96, 183936),
    (24, 48, 10, 10, 1024, 320, 320, True): (8, 13, 40, 4, 0, 0, 32, 192, 62296),
}


@pytest.mark.parametrize("key", list(RECT_PLANS), ids=[str(k) for k in RECT_PLANS])
def test_rectangular_plan_pinned(key):
    B, T, *rest = key
    p = S1.plan(B, *rest[:-1], backward=rest[-1], T=T)
    got = tuple(p[k] for k in ("ranks", "pixels", "band_rows", "vec", "passes", "stages",
                               "groups", "blocks", "smem_bytes"))
    assert got == RECT_PLANS[key]
