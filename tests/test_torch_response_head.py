"""K3's eval head on the CPU: ``tris_tpu_torch/tools/response_head_schedule.py``
runs the kernel's partition (a cluster of R ranks a pair, each forming the
scores of its share of the pixels, a warp a pixel, then writing its band of
output rows from t-rows formed once) in the kernel's arithmetic (each lane's
fmaf chain, the butterfly of shuffles, each product and sum of the upsample
rounded alone). Each pixel's score is formed once and each output row written
once, for every R the plan takes, ragged shares and S = 1 included; the
emulation agrees with K3's plain version within 1e-5 of the map's scale and,
put in the stage-1 model's place, with JAX's ``response_maps`` and eval
forward within the 1e-4 bar of ``tests/test_torch_models.py``. The plan is
pinned at the paths' shapes and the card tests' to
``csrc/launchers.h::response_head_plan``'s answers, worked from the rule by
hand (the card's tests hold the extension's own answer to the tool's).
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_models import _nchw, make_inputs, stage1  # noqa: F401 - a fixture
from tris_tpu_torch import kernels
from tris_tpu_torch.tools import response_head_schedule as RH

torch.set_num_threads(2)


def _head_inputs(N, S, h, w, D, fused, seed):
    rng = np.random.default_rng(seed)
    vb = rng.standard_normal((N, h * w, D)).astype(np.float32)
    vb /= np.linalg.norm(vb, axis=-1, keepdims=True)
    vn = rng.standard_normal((N * S, h * w, D)).astype(np.float32) if fused else None
    ln = rng.standard_normal((N * S, D)).astype(np.float32)
    ln /= np.linalg.norm(ln, axis=-1, keepdims=True)
    return vn, vb, ln


# (N images, S sentences, h, w, D, H, W, fused): the eval batch's shape cut in D, S = 1 (the
# eval branch of the train forward), pair counts that are not a multiple of R, ragged pixel
# shares and row bands, W % 4 != 0
CASES = [
    (8, 4, 10, 10, 64, 320, 320, True),
    (3, 1, 10, 10, 96, 320, 288, True),
    (11, 3, 5, 7, 32, 37, 41, False),
    (13, 1, 4, 6, 48, 64, 64, True),
    (1, 1, 1, 1, 40, 9, 10, False),
    (40, 4, 3, 3, 16, 24, 24, True),
]


@pytest.mark.parametrize("N,S,h,w,D,H,W,fused", CASES)
def test_emulation_covers_each_pixel_and_row_once(N, S, h, w, D, H, W, fused):
    vn, vb, ln = _head_inputs(N, S, h, w, D, fused, N + D)
    scores, rows = np.zeros((N * S, h * w), np.int64), np.zeros((N * S, H), np.int64)
    out = RH.emulate(vn, vb, ln, S, 1 / 0.07, 0.1, (h, w), (H, W), scores, rows)
    assert (scores == 1).all() and (rows == 1).all()
    assert np.isfinite(out).all() and (out >= 0).all()


@pytest.mark.parametrize("N,S,h,w,D,H,W,fused", CASES)
def test_emulation_matches_the_plain_version(N, S, h, w, D, H, W, fused):
    # 1e-5 of the map's scale: the plain version's einsum sums the D channels in another
    # order; the upsample is the same operations in the same order
    vn, vb, ln = _head_inputs(N, S, h, w, D, fused, N + D + 1)
    got = RH.emulate(vn, vb, ln, S, 1 / 0.07, 0.1, (h, w), (H, W))
    want = kernels.response_head_plain(None if vn is None else torch.from_numpy(vn),
                                       torch.from_numpy(vb), torch.from_numpy(ln), S,
                                       torch.tensor(1 / 0.07), 0.1, (h, w), (H, W)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("R", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n", [1, 7, 37, 100, 320])
def test_shares_partition_pixels_and_rows(R, n):
    # the ranks' shares of n pixels (or rows) are consecutive, disjoint and whole
    shares = [RH.pixel_share(n, R, r) for r in range(R)]
    assert [i for s in shares for i in s] == list(range(n))
    assert [list(RH.row_band(n, R, r)) for r in range(R)] == [list(s) for s in shares]
    assert max(len(s) for s in shares) <= -(-n // R)


def _emulated_head(vis_new, vis_base, lan, S, scale, alpha, hw_shape, out_hw):
    return torch.from_numpy(RH.emulate(
        None if vis_new is None else vis_new.numpy(), vis_base.numpy(), lan.numpy(), S,
        float(scale), alpha, hw_shape, out_hw))


def test_emulation_in_the_model_matches_jax_response_maps(stage1, monkeypatch):  # noqa: F811
    # as test_torch_models.py::test_response_maps: 1e-4 of the map's scale, the whole
    # stage-1 eval forward, with the emulated kernel in the plain version's place
    jm, v, tm = stage1
    img, ids = make_inputs(2, 3)
    maps = jax.jit(lambda v, i, w: jm.apply(v, i, w, method="response_maps"))
    want = np.asarray(maps(v, img, ids))
    monkeypatch.setattr(kernels, "response_head", _emulated_head)
    with torch.no_grad():
        got = tm.response_maps(_nchw(img), torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 3, 64, 64) and (want > 0).mean() > 0.2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_emulation_in_the_model_matches_jax_eval_forward(stage1, monkeypatch):  # noqa: F811
    # as test_torch_models.py::test_forward_eval: the eval branch takes S = 1 pairs
    jm, v, tm = stage1
    img, ids = make_inputs(3, 1, seed=4)
    want = np.asarray(jax.jit(lambda v, i, w: jm.apply(v, i, w, train=False))(v, img, ids[:, 0]))
    monkeypatch.setattr(kernels, "response_head", _emulated_head)
    with torch.no_grad():
        got = tm(_nchw(img), torch.from_numpy(ids[:, 0])).numpy()
    assert got.shape == (3, 1, 64, 64)
    np.testing.assert_allclose(got[:, 0], want[..., 0], rtol=1e-4, atol=1e-4 * np.abs(want).max())


# (P, S, h, w, D, H, W) at the paths' shapes and the card tests' -> (ranks, pixels, band_rows,
# vec, blocks, smem_bytes), from launchers.h's rule by hand
PLANS = {
    (32, 4, 10, 10, 1024, 320, 320): (4, 25, 80, 4, 128, 3600),   # stage-1 eval and PRMS
    (8, 1, 10, 10, 1024, 320, 320): (8, 13, 40, 4, 64, 2000),     # the eval forward, S = 1
    (33, 3, 5, 7, 32, 37, 41): (4, 9, 10, 1, 132, 424),           # 33 pairs: a wave at R = 4
    (13, 1, 4, 6, 48, 64, 64): (8, 3, 8, 4, 104, 288),            # 13 pairs, R = 8
    (1, 1, 1, 1, 40, 9, 10): (1, 1, 9, 1, 1, 52),                 # 9 rows: R = 1
    (160, 4, 3, 3, 16, 24, 24): (1, 9, 24, 4, 160, 336),          # a wave of pairs: R = 1
    (6, 3, 10, 10, 1024, 320, 288): (8, 13, 40, 4, 48, 2000),     # the card test's
}


@pytest.mark.parametrize("key", list(PLANS), ids=[str(k) for k in PLANS])
def test_plan_pinned(key):
    p = RH.plan(*key)
    got = tuple(p[k] for k in ("ranks", "pixels", "band_rows", "vec", "blocks", "smem_bytes"))
    assert got == PLANS[key]
    assert p["threads"] == 512 and p["ranks"] <= RH.constants()["kResponseHeadMaxRanks"]


def test_constants_read_from_launchers():
    assert RH.constants() == {"kResponseHeadThreads": 512, "kResponseHeadMaxRanks": 8,
                              "kResponseHeadWaveBlocks": 132, "kResponseHeadMinRows": 8}
