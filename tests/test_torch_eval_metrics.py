"""K4's cluster partition on the CPU: ``tris_tpu_torch/tools/eval_metrics_schedule.py``
emulates the kernel's ranks (bands of valid rows, the max exchange, per-rank
integer counts and first peaks, rank 0's rank-order combine, the shares of
the zero rows of the normalised plane) and must equal K4's plain version
exactly for every cluster size the plan takes, and JAX's device metrics on
the same inputs. The plan is pinned at the main paths' shapes to
``csrc/launchers.h::eval_metrics_plan``'s answers, worked from the rule by
hand (the card's tests hold the extension's own answer to the tool's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tris_tpu.eval.validate import _device_metrics, _padded_resize_matrix
from tris_tpu_torch import kernels
from tris_tpu_torch.tools import eval_metrics_schedule as ES

torch.set_num_threads(2)


def _case(sizes, max_hw, maps=2, h=16, seed=0):
    """Relu maps [B, maps, h, h], the tables, zero-padded gt masks and boxes."""
    rng = np.random.default_rng(seed)
    B = len(sizes)
    cams = np.maximum(rng.standard_normal((B, maps, h, h)), 0).astype(np.float32)
    tgt = np.zeros((B, *max_hw), np.uint8)
    for b, (oh, ow) in enumerate(sizes):
        tgt[b, :oh, :ow] = rng.random((oh, ow)) > 0.5
    boxes = np.array([[ow // 5, oh // 4, ow // 2, oh // 2] for oh, ow in sizes], np.float32)
    tables = kernels.eval_tables(h, h, sizes, max_hw, "cpu")
    return torch.from_numpy(cams), tables, torch.from_numpy(tgt), torch.from_numpy(boxes)


def _check(cams, tables, tgt, boxes, R):
    got = torch.stack(ES.clustered_metrics(cams, tables, tgt, boxes, R))
    want = torch.stack(kernels.eval_metrics_plain(cams, tables, tgt, boxes))
    assert torch.equal(got, want)
    assert torch.equal(ES.clustered_metrics(cams, tables, R=R, want_norm=True),
                       kernels.eval_metrics_plain(cams, tables, want_norm=True))
    return got


@pytest.mark.parametrize("R", [1, 2, 8, 16])
@pytest.mark.parametrize("case", ["mixed", "empty_ranks", "uneven", "small_originals"])
def test_clustered_metrics_equal_the_plain_version(case, R):
    # oh < R leaves ranks empty (-inf, INT_MAX, 0 counts); oh not a multiple of R;
    # originals of 17x9 inside a 48x64 pad
    sizes, max_hw = {
        "mixed": ([(30, 44), (48, 64), (17, 9)], (48, 64)),
        "empty_ranks": ([(5, 7), (3, 2), (1, 1)], (48, 64)),
        "uneven": ([(37, 29), (47, 61)], (48, 64)),
        "small_originals": ([(17, 9), (17, 9)], (48, 64)),
    }[case]
    cams, tables, tgt, boxes = _case(sizes, max_hw, seed=R)
    got = _check(cams, tables, tgt, boxes, R)
    assert float(got[1].sum()) > 0          # U: not vacuous


@pytest.mark.parametrize("R", [1, 8])
@pytest.mark.parametrize("kind", ["negative", "signed", "tiny"])
def test_clustered_metrics_sign_and_scale(kind, R):
    # every sample below -1e-5 (d <= 0: each sample divided), signed maps and maps near
    # the subnormal range (the cuts found by search next to zero)
    cams, tables, tgt, boxes = _case([(30, 44), (48, 64)], (48, 64), seed=7)
    raw = torch.from_numpy(np.random.default_rng(8).standard_normal(cams.shape).astype(np.float32))
    cams = {"negative": -cams - 1.0, "signed": raw, "tiny": raw.abs() * 1e-36}[kind]
    _check(cams, tables, tgt, boxes, R)


@pytest.mark.parametrize("R", [8, 16])
def test_clustered_metrics_at_the_eval_shape(R):
    # stage-1 eval's maps of 320^2 to COCO originals within 640^2 (images cut to 3)
    cams, tables, tgt, boxes = _case([(640, 480), (427, 640), (640, 640)], (640, 640), maps=2,
                                     h=320, seed=R)
    _check(cams, tables, tgt, boxes, R)


@pytest.mark.parametrize("R", [1, 2, 8, 16])
def test_clustered_metrics_peak_tie_across_ranks(R):
    # align_corners 16 -> 31 puts even output rows and columns exactly on input pixels:
    # the peak planted at input rows 2 and 12 lands on output rows 4 and 24, in two
    # ranks' bands from R = 2; the lower flat index wins (the box holds only it). The
    # all-zero map ties everywhere and takes index 0.
    rng = np.random.default_rng(3)
    cams = rng.random((2, 3, 16, 16)).astype(np.float32)
    cams[:, :, 2, 3] = cams[:, :, 12, 3] = 5.0
    cams[1, 2] = 0.0
    cams = torch.from_numpy(cams)
    tables = kernels.eval_tables(16, 16, [(31, 31), (31, 31)], (64, 64), "cpu")
    tgt = torch.zeros(2, 64, 64, dtype=torch.uint8)
    tgt[:, 4, 6] = 1
    boxes = torch.tensor([[5, 3, 7, 5]] * 2, dtype=torch.float32)
    if R > 1:
        rows = [ES.rank_rows(r, R, 31) for r in range(R)]
        assert [r for r in range(R) if 4 in rows[r]] != [r for r in range(R) if 24 in rows[r]]
    got = _check(cams, tables, tgt, boxes, R)
    assert got[2, 0].tolist() == [1.0, 1.0, 1.0] and got[3, 0].tolist() == [1.0, 1.0, 1.0]
    assert got[2, 1, 2] == 0.0


def test_clustered_metrics_equal_jax_device_metrics():
    # the JAX package's _device_metrics on the same maps, masks and boxes: exact (the
    # seeded peaks are tie-free; pred = norm > 1e-9 counts alike)
    sizes, max_hw = [(30, 44), (48, 64), (17, 9)], (48, 64)
    cams, tables, tgt, boxes = _case(sizes, max_hw, seed=11)
    Ah = np.stack([_padded_resize_matrix(16, s[0], max_hw[0]) for s in sizes])
    Aw = np.stack([_padded_resize_matrix(16, s[1], max_hw[1]) for s in sizes])
    want = _device_metrics(jnp.asarray(cams.numpy()), jnp.asarray(Ah), jnp.asarray(Aw),
                           jnp.asarray(tgt.numpy()), jnp.asarray(boxes.numpy()))
    got = ES.clustered_metrics(cams, tables, tgt, boxes, 8)
    for name, g, w in zip(("I", "U", "hit", "hitm"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


# (B, S, maxH, maxW, h, w, max_ranks) -> (ranks, band_rows, staged, smem_bytes, blocks),
# from launchers.h's rule by hand: R doubles while B S R < 256 and 2 R 8 <= maxH, then while
# 4 ceil(maxH / R) (w + 4) > 114688
PLANS = {
    (8, 4, 640, 640, 320, 320, 16): (8, 80, 1, 103680, 256),     # stage-1 eval
    (8, 1, 640, 640, 320, 320, 16): (16, 40, 1, 51840, 128),     # PRMS, wide clusters
    (8, 1, 640, 640, 320, 320, 8): (8, 80, 1, 103680, 64),       # PRMS, portable only
    (2, 4, 640, 640, 320, 320, 16): (16, 40, 1, 51840, 128),     # the last batch of a split
    (8, 4, 48, 64, 16, 16, 16): (4, 12, 1, 960, 128),            # small originals
    (1, 1, 2400, 2400, 320, 320, 16): (16, 150, 0, 0, 16),       # past shared memory
}


@pytest.mark.parametrize("key", list(PLANS), ids=[str(k) for k in PLANS])
def test_plan_pinned(key):
    *shape, max_ranks = key
    p = ES.plan(*shape, max_ranks=max_ranks)
    assert (p["ranks"], p["band_rows"], p["staged"], p["smem_bytes"], p["blocks"]) == PLANS[key]
    assert p["threads"] == 640 and p["max_ranks"] == max_ranks
    assert p["smem_bytes"] <= ES.constants()["kEvalSmemTarget"]


def test_constants_read_from_launchers():
    k = ES.constants()
    assert set(k) == {"kEvalThreads", "kEvalMaxRanks", "kEvalWideRanks", "kEvalMinRows",
                      "kEvalWaveBlocks", "kEvalSmemTarget"}
    assert k["kEvalThreads"] == 640 and k["kEvalThreads"] % 32 == 0
