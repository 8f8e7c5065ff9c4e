"""K10's products on the CPU: the occupancy maps and the schedule of the
card's kernels (``tris_tpu_torch/kernels/csrc/walk_matmul.cu``), which
cannot run here.

``walk_tile_occupancy_plain`` is held to a direct numpy count of each tile.
``tris_tpu_torch/tools/walk_schedule.py`` emulates in float64 what each
kernel sums, with the tile sizes of ``csrc/launchers.h``: per tile of the
square kernel's output, only the k-tiles that the band and the two
occupancy maps leave, in ascending k; per block of the thin kernel, its
warps' chunks of 16 rows, each warp's in ascending k, the warps added in
order. On the walk's T at the 32x32 bucket (a seeded smooth edge map, as
``tests/test_torch_irnet.py``), its powers and the thin step, each
emulation is within one float32 rounding of ``walk_matmul_plain`` (the
float64 product rounded once) and, in float64, bit for bit the same
emulation without the skip and without the band: the schedule drops no
nonzero product, and the groups it skips add exact zeros. The emulated
chain equals JAX's walk within its bar.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from tris_tpu.pseudo import indexing as J
from tris_tpu_torch import kernels as K
from tris_tpu_torch.kernels import walk as W
from tris_tpu_torch.pseudo import indexing as P
from tris_tpu_torch.tools import walk_schedule as S

torch.set_num_threads(2)


def _tiles_numpy(x, rt, ct):
    """Whether each rt x ct tile of x holds a nonzero, tile by tile."""
    R, C = x.shape
    out = np.zeros((-(-R // rt), -(-C // ct)), bool)
    for i in range(out.shape[0]):
        for k in range(out.shape[1]):
            out[i, k] = bool((x[i * rt:(i + 1) * rt, k * ct:(k + 1) * ct] != 0).any())
    return out


def _occupancy_cases():
    rng = np.random.default_rng(0)
    zero = np.zeros((256, 64), np.float32)
    corners = []
    for r, c in ((0, 0), (127, 15), (128, 0), (255, 63), (0, 63), (200, 31)):
        x = np.zeros((300, 200), np.float32)  # partial tiles at 300 rows and 200 columns
        x[r, c] = 0.5
        corners.append(x)
    off = np.arange(260)[None] - np.arange(300)[:, None]
    banded = (rng.random((300, 260)) * (np.abs(off) <= 37)).astype(np.float32)
    sparse = (rng.random((130, 132)) * (rng.random((130, 132)) > 0.999)).astype(np.float32)
    return [zero] + corners + [banded, sparse]


@pytest.mark.parametrize("case", range(9))
def test_walk_tile_occupancy_plain_matches_numpy(case):
    # all-zero, one nonzero at tile corners and on partial tiles, a band's
    # edge, scattered entries
    x = _occupancy_cases()[case]
    rows, cols = K.walk_tile_occupancy_plain(torch.from_numpy(x))
    tile, step = S.tiles()["kWalkTile"], S.tiles()["kWalkStep"]
    assert rows.dtype == torch.bool and cols.dtype == torch.bool
    np.testing.assert_array_equal(rows.numpy(), _tiles_numpy(x, tile, step))
    np.testing.assert_array_equal(cols.numpy(), _tiles_numpy(x, step, tile))


def _bucket_walk(seed=3, n_maps=5):
    """x [16, 32, 32] and the edge map padded to the 32x32 bucket from a
    smooth seeded edge map; T and its band."""
    rng = np.random.default_rng(seed)
    edge = ndimage.gaussian_filter(rng.random((30, 28)).astype(np.float32), 4)
    edge = (edge - edge.min()) / (edge.max() - edge.min() + 1e-9)
    x = (rng.random((n_maps, 30, 28)) * (rng.random((n_maps, 1, 1)) > 0.3)).astype(np.float32)
    x_p, edge_p = P.bucket_pad(x, edge, device="cpu")
    return x, edge, x_p, edge_p, P.transition_matrix(edge_p), P.transition_band(5, 32)


def _schedule_sums(a, b, band_a, band_b, thin=False, skip=True):
    if thin:  # the thin kernel skips by the band alone
        return S.thin_sums(a, b, band_a, band_b)
    maps = ((K.walk_tile_occupancy_plain(a)[0], K.walk_tile_occupancy_plain(b)[1]) if skip
            else (None, None))
    return S.square_sums(a, b, *maps, band_a, band_b)


def _check_schedule(a, b, band_a, band_b, thin=False):
    got = _schedule_sums(a, b, band_a, band_b, thin)
    want = K.walk_matmul_plain(a, b)
    assert float((got.float().double() - want.double()).abs().max()) <= \
        float(want.abs().max()) * 2.0 ** -23
    assert torch.equal(got, _schedule_sums(a, b, band_a, band_b, thin, skip=False))
    assert torch.equal(got, _schedule_sums(a, b, None, None, thin, skip=False))
    return got


def test_tile_sizes_match_the_kernels():
    # the wrapper's occupancy maps lie on the square kernel's grid, and the
    # kernels take their sizes from launchers.h, as the emulations do
    t = S.tiles()
    assert (W.TILE, W.STEP) == (t["kWalkTile"], t["kWalkStep"])
    assert set(t) == {"kWalkTile", "kWalkStep", "kWalkThinRows", "kWalkThinCols",
                      "kWalkThinChunk", "kWalkThinWarps"}
    src = (S.LAUNCHERS.parent / "walk_matmul.cu").read_text()
    for name in t:
        assert f"tris::{name}" in src


@pytest.mark.parametrize("squarings", [0, 1, 4])
def test_schedule_keeps_every_product_on_the_walk(squarings):
    # T, its square and a later power squared through the square kernel's
    # schedule (band, occupancy maps) against the float64 product
    *_, trans, band = _bucket_walk()
    t, b = P.square(trans, squarings, band)
    _check_schedule(t, t, b, b)


def test_schedule_keeps_every_product_on_the_thin_step():
    # the thin step's schedule (32-column strips, 16-row k-chunks from the band)
    _, _, x_p, edge_p, trans, band = _bucket_walk()
    t, b = P.square(trans, 8, band)
    x = (x_p * (1.0 - edge_p)[None]).reshape(16, -1)
    _check_schedule(x, t, None, b, thin=True)
    _check_schedule(x, trans, None, band, thin=True)


@pytest.mark.parametrize("M,Kd,N,band", [(1, 200, 100, 40), (17, 520, 260, 130),
                                         (33, 1000, 1000, 300)])
def test_thin_schedule_partial_blocks(M, Kd, N, band):
    # partial blocks of rows and columns, bands that start off the warps'
    # 128-row grid: no nonzero product dropped, banded = dense bit for bit
    rng = np.random.default_rng(M)
    a = torch.from_numpy(rng.random((M, Kd)).astype(np.float32))
    off = np.abs(np.arange(N)[None] - np.arange(Kd)[:, None])
    b = torch.from_numpy((rng.random((Kd, N)) * (off <= band)).astype(np.float32))
    _check_schedule(a, b, None, band, thin=True)


def test_schedule_skips_empty_tiles_exactly():
    # T-like powers whose band underflows to zero in the middle: whole
    # k-tiles are empty, the schedule skips them, and the sums do not move
    n = 1024
    rng = np.random.default_rng(5)
    off = np.abs(np.arange(n)[None] - np.arange(n)[:, None])
    t = torch.from_numpy((rng.random((n, n)) * ((off <= 40) | ((off > 300) & (off <= 420))))
                         .astype(np.float32))
    rows, cols = K.walk_tile_occupancy_plain(t)
    skipped, in_band = S.skipped_share(rows, cols, n, n, n, 420, 420)
    assert 0 < skipped < in_band
    _check_schedule(t, t, 420, 420)


def test_schedule_band_range_is_a_superset():
    # every k-tile holding a product of two band entries lies in the range
    M = N = K_ = 1000
    tile, step = S.tiles()["kWalkTile"], S.tiles()["kWalkStep"]
    for band in (0, 5, 130, 999):
        run = S.square_schedule(None, None, M, N, K_, band, band).numpy()
        for i in range(run.shape[0]):
            for j in range(run.shape[1]):
                rows = np.arange(i * tile, min((i + 1) * tile, M))
                cols = np.arange(j * tile, min((j + 1) * tile, N))
                ks = np.arange(K_)
                need = ((np.abs(ks[:, None] - rows[None]) <= band).any(1)
                        & (np.abs(cols[None] - ks[:, None]) <= band).any(1))
                assert run[i, j][np.unique(ks[need] // step)].all()


def test_scheduled_chain_matches_jax_walk():
    # the slice as a whole: eight squarings and the thin step, each through
    # its kernel's schedule, against JAX's bucketed walk (1e-4 of its max,
    # labels >= 99.9 %, as tests/test_torch_irnet.py holds the walk)
    x, edge, x_p, edge_p, t, b = _bucket_walk()
    n = t.shape[0]
    for _ in range(8):
        rows, cols = K.walk_tile_occupancy_plain(t)
        t = S.square_sums(t, t, rows, cols, b, b).float()
        b = min(2 * b, n)
    x_m = (x_p * (1.0 - edge_p)[None]).reshape(16, n)
    rw = S.thin_sums(x_m, t, None, b).float()
    got = rw.reshape(16, 32, 32)[:x.shape[0], :30, :28].numpy()
    want = np.asarray(J.propagate_to_edge_bucketed(x, edge))
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    labels = [np.argmax(np.concatenate([np.full((1, 30, 28), 0.25, np.float32),
                                        r / max(r.max(), 1e-12)], 0), 0) for r in (got, want)]
    assert (labels[0] == labels[1]).mean() >= 0.999
