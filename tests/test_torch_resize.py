"""K6's banded forward on the CPU: ``tris_tpu_torch/tools/resize_schedule.py``
runs the kernel's partition (the planes' output rows flattened into bands,
column tiles, chunks of rows whose interpolated input rows are formed once,
``vec`` columns a thread) and must equal K6's plain version bit for bit,
write every output once, and agree with JAX's ``bilinear_resize`` to
rounding on the same inputs. The plan is pinned at the paths' shapes to
``csrc/launchers.h::bilinear_resize_plan``'s answers, worked from the rule by
hand (the card's tests hold the extension's own answer to the tool's).
"""

import math

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
                              "kResizeSmem": 49152}
