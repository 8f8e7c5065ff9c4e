"""K6's banded forward and backward on the CPU:
``tris_tpu_torch/tools/resize_schedule.py`` runs the forward's partition (the
planes' output rows flattened into bands, column tiles, chunks of rows whose
interpolated input rows are formed once, ``vec`` columns a thread), which
must equal K6's plain version bit for bit, write every output once, and
agree with JAX's ``bilinear_resize`` to rounding on the same inputs; and the
backward's (bands of the flattened input rows, each staging the run of g rows
its adjoint ranges cover, the column adjoint formed once a staged row, then
the row adjoint), which must equal the first design's per-element gather bit
for bit (the same fmaf chains, emulated rounded once), write every input
element once, read no g row outside its band's span, and agree with the plain
version's autograd and with ``jax.vjp`` of JAX's ``bilinear_resize`` within
1e-5 of the gradient's scale. The plans are pinned at the paths' shapes to
``csrc/launchers.h``'s answers, worked from the rules by hand (the card's
tests hold the extension's own answers to the tool's), and the backward's
span bound is held to every band of three planes, both align settings.
"""

import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tris_tpu.ops.resize import bilinear_resize as j_bilinear_resize
from tris_tpu_torch import kernels
from tris_tpu_torch.ops.resize import interp_taps
from tris_tpu_torch.tools import resize_schedule as RS

torch.set_num_threads(2)

# (name, input shape with planes cut to a few, output size, align_corners)
CASES = [
    ("head_x4", (3, 1, 80, 80), (320, 320), False),        # stage 2's heads
    ("head_x16", (2, 1, 20, 20), (320, 320), False),
    ("dec_x2_c2", (2, 5, 40, 40), (80, 80), False),        # the decoder's x2 taps
    ("dec_x2_c4", (3, 7, 10, 10), (20, 20), False),        # planes * oh not a multiple of a band
    ("irn_dp6", (2, 3, 60, 80), (120, 160), False),        # IRNet's heads
    ("cam_to_grid", (480, 640), (120, 160), True),         # downsampling, align_corners
    ("walk_x4", (2, 120, 160), (480, 640), False),
    ("odd_width", (5, 7, 9), (13, 5), True),               # ow % 4 != 0: a column a thread
    ("one_pixel", (1, 1, 1), (3, 5), False),
    ("down_ac", (2, 37, 53), (11, 17), True),
    ("wide_tiles", (2, 7, 2000), (5, 1001), True),         # column tiles, odd
    ("wide_vec", (2, 8, 1500), (3, 1500), False),          # column tiles, 4 columns a thread
    ("unstaged", (2, 3000), (2, 7), False),                # t-rows past shared memory
]


def _x(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("name,shape,size,ac", CASES, ids=[c[0] for c in CASES])
def test_banded_resize_equals_the_plain_version(name, shape, size, ac):
    x = _x(shape, len(name))
    planes = math.prod(shape[:-2])
    visits = np.zeros((planes * size[0], size[1]), np.int64)
    got = RS.banded_resize(x, size, ac, visits)
    assert torch.equal(got, kernels.bilinear_resize_plain(x, size, ac))
    assert (visits == 1).all()


@pytest.mark.parametrize("name,shape,size,ac", CASES[:8], ids=[c[0] for c in CASES[:8]])
def test_banded_resize_matches_jax(name, shape, size, ac):
    # JAX's two HIGHEST-precision matrix products sum the same two terms a row and a
    # column, in another association: within 2e-6 of the input's scale
    x = _x(shape, len(name) + 1)
    got = RS.banded_resize(x, size, ac).numpy()
    want = np.asarray(j_bilinear_resize(jnp.asarray(x.numpy()), size, ac))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * float(np.abs(x.numpy()).max()))


# (planes, h, w, oh, ow) at the paths' shapes -> (vec, tile_groups, tiles, rows, rpt, threads,
# chunks, bands, staged, in_floats, smem_bytes), from launchers.h's rule by hand
PLANS = {
    (48, 80, 80, 320, 320): (4, 80, 1, 3, 4, 240, 2, 640, 1, 800, 10880),         # head x4
    (48, 40, 40, 320, 320): (4, 80, 1, 3, 4, 240, 2, 640, 1, 280, 4960),         # head x8
    (48, 20, 20, 320, 320): (4, 80, 1, 3, 4, 240, 2, 640, 1, 120, 2400),         # head x16
    (48 * 64, 40, 40, 80, 80): (4, 20, 1, 12, 4, 240, 4, 1280, 1, 4080, 31680),  # decoder c2
    (48 * 128, 20, 20, 40, 40): (4, 10, 1, 25, 4, 250, 4, 615, 1, 4260, 33040),  # decoder c3
    (48 * 256, 10, 10, 20, 20): (4, 5, 1, 51, 4, 255, 2, 603, 1, 2280, 25440),   # decoder c4
    (2 * 256, 60, 80, 120, 160): (4, 40, 1, 6, 4, 240, 4, 640, 1, 4160, 32000),  # IRNet dp6 tap
    (2 * 32, 30, 40, 120, 160): (4, 40, 1, 6, 4, 240, 1, 320, 1, 400, 9280),     # IRNet edge x4
    (1, 480, 640, 120, 160): (1, 160, 1, 1, 1, 160, 1, 120, 0, 0, 0),            # CAM to grid
    (4, 120, 160, 480, 640): (4, 160, 1, 1, 4, 160, 1, 480, 1, 800, 8320),       # walk x4
}


@pytest.mark.parametrize("key", list(PLANS), ids=[str(k) for k in PLANS])
def test_plan_pinned(key):
    p = RS.plan(*key)
    got = tuple(p[k] for k in ("vec", "tile_groups", "tiles", "rows", "rpt", "threads", "chunks",
                               "bands", "staged", "in_floats", "smem_bytes"))
    assert got == PLANS[key]
    assert p["blocks"] == p["bands"] * p["tiles"]
    assert p["band_rows"] == p["rows"] * p["rpt"] * p["chunks"]
    assert p["bands"] * p["band_rows"] >= key[0] * key[3]
    assert p["smem_bytes"] <= RS.constants()["kResizeSmem"]


@pytest.mark.parametrize("ac", [False, True])
def test_band_input_within_the_span_bound(ac):
    # any d + 1 consecutive output rows of 3 planes, up- and downsampling, span no more
    # flattened input rows than launchers.h's bound (the staged copy's size)
    for h, oh in [(1, 5), (5, 1), (7, 3), (10, 20), (20, 40), (40, 80), (80, 320), (60, 120),
                  (480, 120), (481, 160), (33, 7), (9, 31)]:
        lo, hi, _, _ = interp_taps(h, oh, ac)
        total = 3 * oh
        for d in (0, 1, 2, 5, 11, 50, 203):
            for r0 in range(0, total - d):
                r1 = r0 + d
                f0 = (r0 // oh) * h + int(lo[r0 % oh])
                f1 = (r1 // oh) * h + int(hi[r1 % oh]) + 1
                assert f1 - f0 <= RS.span_rows(d, h, oh), (h, oh, d, r0)


def test_constants_read_from_launchers():
    assert RS.constants() == {"kResizeThreads": 256, "kResizeTileGroups": 256,
                              "kResizeRowsPerThread": 4, "kResizeWaveBlocks": 528,
                              "kResizeMinBands": 132, "kResizeMaxChunks": 4,
                              "kResizeSmem": 49152, "kResizeBwdThreads": 256,
                              "kResizeBwdColThreads": 128, "kResizeBwdMaxBand": 64,
                              "kResizeBwdWaveBlocks": 528, "kResizeBwdSmem": 32768,
                              "kResizeBwdRowsWaveBlocks": 264, "kResizeBwdRowsSmem": 86016,
                              "kResizeBwdSmemMax": 232448, "kResizeBwdTaps": 4}


# ---- the backward ---------------------------------------------------------------------------


def _round_f32(q: Fraction) -> np.float32:
    """The float32 nearest the rational ``q`` (ties to even)."""
    r = np.float32(float(q))
    cands = [np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - q),
                                     int(np.array(c).view(np.int32)) & 1))


def test_fmaf_rounds_once():
    # the emulated fmaf is a * b + c rounded once to float32, also where rounding the
    # float64 sum first would land on a float32 tie (c a tiny nudge past it)
    rng = np.random.default_rng(5)
    a = rng.standard_normal(3000).astype(np.float32)
    b = rng.standard_normal(3000).astype(np.float32)
    c = rng.standard_normal(3000).astype(np.float32) * np.float32(2.0) ** rng.integers(-30, 3, 3000)
    one = np.float32(1)
    half_ulp = np.float32(2.0 ** -24)
    a = np.concatenate([a, [one + np.float32(2.0 ** -23)] * 2, [np.float32(2.0 ** 12 + 1)]])
    b = np.concatenate([b, [one, one], [np.float32(2.0 ** 12 + 1)]])
    c = np.concatenate([c, [half_ulp * np.float32(1 + 2.0 ** -20), -half_ulp],
                        [np.float32(2.0 ** -40)]])
    got = RS.fmaf(a, b, c)
    want = [_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
            for x, y, z in zip(a, b, c)]
    assert np.array_equal(got.view(np.int32), np.asarray(want, np.float32).view(np.int32))


# (name, g's input shape with planes cut to a few, output size, align_corners, the planes
# whose plan to emulate: the path's, or None for this shape's own)
BWD_CASES = [
    ("dp6", (2, 3, 64, 64), (128, 128), False, 24 * 256),      # IRN step, 3 launches
    ("dp45", (2, 3, 32, 32), (64, 64), False, 24 * 256),
    ("edge_x2", (1, 3, 64, 64), (128, 128), False, 24 * 32),
    ("edge_x4", (2, 3, 32, 32), (128, 128), False, 24 * 32),
    ("dec_c4", (2, 5, 10, 10), (20, 20), False, 48 * 256),      # stage-2 step
    ("dec_c3", (2, 5, 20, 20), (40, 40), False, 48 * 128),
    ("dec_c2", (2, 3, 40, 40), (80, 80), False, 48 * 64),
    ("head_x4", (3, 1, 80, 80), (320, 320), False, 48),
    ("head_x8", (2, 1, 40, 40), (320, 320), False, 48),
    ("head_x16", (2, 1, 20, 20), (320, 320), False, 48),
    ("odd", (5, 7, 9), (13, 4), True, None),                    # the card tests' edges
    ("one_pixel", (1, 1, 1), (3, 5), False, None),
    ("rows_equal", (4, 6), (4, 11), False, None),
    ("shrink", (2, 9, 13), (5, 6), False, None),                # taps skip inputs
    ("ragged", (7, 13, 12), (26, 24), True, 651),               # a last band of 15 rows
]


def _bwd_case(name, shape, size, ac, planes):
    g = _x((*shape[:-2], *size), len(name) + 7)
    plan = None if planes is None else RS.bwd_plan(planes, *shape[-2:], *size)
    return g, plan


@pytest.mark.parametrize("name,shape,size,ac,planes", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_banded_backward_equals_the_direct_gather(name, shape, size, ac, planes):
    g, plan = _bwd_case(name, shape, size, ac, planes)
    visits = np.zeros((math.prod(shape[:-2]) * shape[-2], shape[-1]), np.int64)
    got = RS.banded_resize_bwd(g, shape[-2:], ac, plan, visits)
    assert torch.equal(got, RS.direct_resize_bwd(g, shape[-2:], ac))
    assert (visits == 1).all()


@pytest.mark.parametrize("name,shape,size,ac,planes", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_banded_backward_matches_plain_and_jax(name, shape, size, ac, planes):
    # 1e-5 of the gradient's scale, chip_smoke's bar: the plain version's index backward
    # and JAX's two HIGHEST-precision products sum the same terms in other orders
    g, plan = _bwd_case(name, shape, size, ac, planes)
    got = RS.banded_resize_bwd(g, shape[-2:], ac, plan).numpy()
    x = _x(shape, 0).requires_grad_()
    kernels.bilinear_resize_plain(x, size, ac).backward(g)
    _, vjp = jax.vjp(lambda t: j_bilinear_resize(t, size, ac), jnp.asarray(x.detach().numpy()))
    (want_jax,) = vjp(jnp.asarray(g.numpy()))
    scale = float(np.abs(x.grad.numpy()).max())
    assert np.abs(got - x.grad.numpy()).max() <= 1e-5 * scale
    assert np.abs(got - np.asarray(want_jax)).max() <= 1e-5 * scale


# (planes, h, w, oh, ow) at the paths' shapes and the card tests' edges -> (staged, band,
# span_rows, g_pitch, r_pitch, vec, col_lanes, threads, blocks, smem_bytes), from launchers.h's
# rule by hand
BWD_PLANS = {
    (24 * 256, 64, 64, 128, 128): (1, 16, 38, 128, 68, 4, 1, 128, 24576, 32160),   # IRN dp6
    (24 * 256, 32, 32, 64, 64): (1, 32, 71, 64, 36, 4, 1, 128, 6144, 30000),       # dp4, dp5
    (24 * 32, 64, 64, 128, 128): (1, 16, 38, 128, 68, 4, 1, 128, 3072, 32160),     # edge e3
    (24 * 32, 32, 32, 128, 128): (1, 16, 73, 129, 36, 4, 0, 256, 1536, 50336),     # e4, e5
    (48 * 256, 10, 10, 20, 20): (1, 64, 147, 20, 12, 1, 1, 128, 1920, 20320),      # decoder c4
    (48 * 128, 20, 20, 40, 40): (1, 32, 72, 40, 20, 4, 1, 128, 3840, 18496),       # decoder c3
    (48 * 64, 40, 40, 80, 80): (1, 16, 38, 80, 44, 4, 1, 128, 7680, 20448),        # decoder c2
    (48, 80, 80, 320, 320): (1, 8, 40, 321, 84, 4, 0, 256, 480, 68960),            # head x4
    (48, 40, 40, 320, 320): (1, 4, 46, 321, 44, 4, 0, 256, 480, 70752),            # head x8
    (48, 20, 20, 320, 320): (1, 2, 58, 321, 20, 4, 0, 256, 480, 82480),            # head x16
    (5, 7, 9, 13, 4): (1, 1, 7, 4, 12, 1, 1, 128, 35, 688),                        # card edges
    (1, 1, 1, 3, 5): (1, 1, 3, 5, 4, 1, 0, 256, 1, 224),
    (1, 4, 6, 4, 11): (1, 1, 4, 11, 12, 1, 1, 128, 4, 592),
    (2, 9, 13, 5, 6): (1, 1, 4, 6, 20, 1, 1, 128, 18, 720),
    (651, 13, 12, 26, 24): (1, 16, 40, 24, 12, 4, 1, 128, 529, 6464),              # ragged
    (1, 2, 3000, 2, 70000): (0, 0, 0, 70001, 3004, 4, 0, 256, 24, 0),              # direct
}


@pytest.mark.parametrize("key", list(BWD_PLANS), ids=[str(k) for k in BWD_PLANS])
def test_backward_plan_pinned(key):
    p = RS.bwd_plan(*key)
    got = tuple(p[k] for k in ("staged", "band", "span_rows", "g_pitch", "r_pitch", "vec",
                               "col_lanes", "threads", "blocks", "smem_bytes"))
    assert got == BWD_PLANS[key]
    assert p["g_pitch"] == (key[4] if p["col_lanes"] else key[4] | 1) and p["r_pitch"] % 8 == 4
    if p["staged"]:
        assert p["blocks"] * p["band"] >= key[0] * key[1]
        assert p["smem_bytes"] <= RS.constants()["kResizeBwdSmemMax"]


@pytest.mark.parametrize("key", list(BWD_PLANS)[:10], ids=[str(k) for k in list(BWD_PLANS)[:10]])
def test_backward_bands_at_the_paths_shapes(key):
    # every band of the full-size call stages within the plan's span, the bands take every
    # input row once, and their spans cover every g row
    planes, h, w, oh, ow = key
    p = RS.bwd_plan(*key)
    spans = RS.band_spans(planes, h, oh, p["band"], False)
    assert len(spans) == p["blocks"]
    assert max(S for *_, S in spans) <= p["span_rows"]
    assert [f0 for f0, *_ in spans] == list(range(0, planes * h, p["band"]))
    assert spans[-1][1] == planes * h
    covered = np.zeros(planes * oh, bool)
    for _, _, g0, S in spans:
        covered[g0:g0 + S] = True
    assert covered.all()


@pytest.mark.parametrize("ac", [False, True])
def test_backward_band_span_within_the_bound(ac):
    # any d + 1 consecutive input rows of 3 planes, up- and downsampling, have adjoint
    # ranges spanning no more flattened g rows than launchers.h's bound (a block's stage)
    for h in (1, 2, 3, 5, 7, 9, 10, 13, 20, 32, 40, 64, 80):
        for oh in (1, 2, 3, 4, 5, 7, 11, 13, 20, 26, 40, 64, 80, 128, 320):
            _, lo_end, hi_begin, _ = RS.adjoint_ranges(h, oh, ac)
            for d in (0, 1, 2, 3, 7, 15, 31):
                bound = RS.bwd_span_rows(d, h, oh)
                for f0 in range(0, 3 * h - d):
                    f1 = f0 + d
                    S = ((f1 // h) * oh + int(lo_end[f1 % h])
                         - (f0 // h) * oh - int(hi_begin[f0 % h]))
                    assert 0 <= S <= bound, (h, oh, d, f0)
