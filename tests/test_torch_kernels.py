"""The hand-written kernels against their plain PyTorch versions on the card.

Marked ``cuda``: they need an NVIDIA GPU (sm_90a) and ``nvcc``, and skip
elsewhere. Run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest sets up JAX, which the card's
machine need not have.)

Shapes are small but cover the edges the main path does not: K1 across its
length and head-dim buckets' edges (L up to 128, hd 32 to 128), with 4-byte
loads where C % 4 != 0, its grids against the schedule tool's and its
backward bit for bit from run to run, several text tokens in K2, K3 without the fusion and
bit for bit with the schedule tool's emulation of its clusters (pair counts not a multiple
of R, S = 1, ragged shares), K3's training head
bit for bit (its score plane and relu map) with its schedule tool's
emulation across its plans (B = 1, several ranks, ragged pixel shares,
W % 4 != 0, ten passes of score tiles), with GMP's maxima planted tied and
nearly tied, its backward bit for bit run to run and the shapes it refuses,
ties in K4's peak, K5 at equal sizes (identity taps), K6 on odd shapes, and the
inputs every wrapper refuses. K2 also at its tiles' edges (HW and T
across 32-row tiles and 32-key slots up to the 256 keys a tile holds, S > 1,
channel slices cut short), beyond its limits, and bit for bit from run to
run in the backward. K1 at the critic's L = 50 and K4 on PRMS's
selected maps are here too. The IRNet path's kernels: K6's bilinear resize
at the pass's shapes and odd ones, K7 at radius 5 and 10 and on the
narrowest grids, K9 with centroids clamped on the edge, K10's transition
on the walk's buckets and its banded products (squarings, the thin step,
partial tiles, M across the thin kernel's bound, subnormals, one nonzero per
tile, an all-zero operand, skip against no skip) and occupancy maps. IRN
training's backward kernels: K6's bilinear backward (bit for bit with the schedule tool's
emulation of its bands, ragged and across planes, and of its direct path),
K7's tiled backward with ties planted (the gradient split evenly among them)
and the IRN loss fused with K7 from the edge map (pair labels and masked
sums, forward and backward), at radius 5 and 10, odd sizes, ragged last
tiles, B=1, an edge map tied everywhere and all-ignore labels, both bit for
bit against the schedule tool's emulation of their arithmetic, with their
plans against the tool's. Stage 2's: K11 forward and backward at odd
pixel counts, across its token buckets' edges (1 to 32 tokens), with 4-byte
loads where C % 4 != 0, past 2048 channels (sub-slices), S > 1 pairs sharing
an image's pixels, its grids against the schedule tool's and the inputs it
refuses; K12 over leaves of odd length, a
0-d leaf and an integer buffer, bit for bit. The fused IRN loss at another
pair-label threshold. K13 (BatchNorm with its activation) in train, eval and the
teacher's mode with each fused activation, at C = 1, one element a channel
(the unbiased variance's max(n - 1, 1) guard), HW % 4 != 0 and unaligned
data (its scalar loads), N = 1, HW = 1, the largest plane each cluster size
of its fused design takes, shapes of its two-pass design, both designs
against each other on the same inputs, its launch counts and grids against
the schedule tool's plans, the backward bit for bit run to run, and the
layouts it refuses; its forward against the route reference bit for bit
(but for channels whose statistics round apart). ``--bf16``'s four kernels
(K1's, K2's and K3's eval head's bfloat16 forwards, K13's bfloat16 eval fold)
at odd shapes and both leaf regimes' operand dtypes, against their plain
versions from float64 (K13's bit for bit), and the combinations they refuse;
stage 2's bfloat16 forwards (K11 at T = 1 and 48, C not a multiple of 8 or
of 4, S > 1 and sub-slices, bfloat16 or float32 q; K6 bit for bit at odd
sizes, both align_corners, staged and direct; K13's eval fold with PReLU at
planes of 100 and a bfloat16 or a float32 slope, bit for bit) and the mixes
they refuse before any launch.
One test is static and runs
anywhere: each differentiable wrapper's CUDA branch goes through its
``torch.autograd.Function``.
"""

import importlib
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tris_tpu_torch import kernels as K
from tris_tpu_torch.kernels.response_head import taps_on
from tris_tpu_torch.models.layers import causal_mask
from tris_tpu_torch.tools import irn_affinity_schedule as T
from tris_tpu_torch.tools import walk_schedule as S

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels are built with nvcc for sm_90a")
    K.build_all()
    return torch.device("cuda")


@pytest.fixture
def randn(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    return lambda *shape: torch.randn(*shape, generator=g, device=dev)


def _err(a, b):
    return float((a.double() - b.double()).abs().max())


# K1 across its buckets' edges: lengths 16 | 32 | 64 | 128, head dims 32 | 64 | 128
K1_LENGTHS = [(1, False), (8, True), (16, False), (17, True), (20, True), (50, False), (56, True),
              (57, False), (64, True), (65, False), (101, False), (128, True)]
K1_HEAD_DIMS = [32, 48, 64, 80, 128]


@pytest.mark.parametrize("hd", K1_HEAD_DIMS)
@pytest.mark.parametrize("L,causal", K1_LENGTHS)
def test_mha_short(randn, L, causal, hd):
    # 2e-5 against float64 on N(0, 1) inputs: f32 sums of up to 128 products
    n, H = 3, 4
    C = H * hd
    qkv = randn(n, L, 3 * C)
    q, k, v = qkv.chunk(3, dim=-1)          # read in place, row stride 3C
    mask = causal_mask(L, device=q.device) if causal else None
    got = K.mha_short(q, k, v, H, mask)
    torch.cuda.synchronize()
    want = K.mha_short_plain(q.double(), k.double(), v.double(), H,
                             None if mask is None else mask.double())
    assert torch.isfinite(got).all()
    assert _err(got, want) <= 2e-5
    assert K.mha_short_launch_shape("mha_short")["load_bytes"] == 16


def test_mha_short_refuses(randn):
    # the shapes csrc/launchers.h::mha_short_takes refuses raise ValueError in
    # Python, before a launch; the extension's rule is the schedule tool's
    from tris_tpu_torch.kernels import build
    from tris_tpu_torch.tools import mha_schedule

    q = randn(2, 129, 64)
    with pytest.raises(ValueError, match="mha_short_takes"):
        K.mha_short(q, q, q, 1)
    q = randn(2, 20, 129)
    with pytest.raises(ValueError, match="do not take Lq=20, Lk=20, hd=129"):
        K.mha_short(q, q, q, 1)
    with pytest.raises(TypeError, match="float32"):
        K.mha_short(q.bfloat16(), q.bfloat16(), q.bfloat16(), 1)
    for Lq, Lk, hd in [(1, 1, 1), (128, 128, 128), (129, 1, 1), (1, 1, 129), (0, 5, 5),
                       (50, 50, 64), (20, 101, 33), (128, 64, 96)]:
        for backward in (False, True):
            assert build.ops().mha_short_takes(Lq, Lk, hd, backward) == \
                bool(mha_schedule.takes(Lq, Lk, hd, backward))


@pytest.mark.parametrize("L,causal", [(20, True), (50, False), (101, False), (7, False)])
def test_mha_short_unaligned_loads(randn, L, causal):
    # C % 4 != 0 (hd = 37): the same kernels with 4-byte loads and stores,
    # forward and backward, against float64
    n, H, hd = 2, 3, 37
    C = H * hd
    mask = causal_mask(L, device=randn(1).device) if causal else None
    mask64 = None if mask is None else mask.double()
    (qkv,) = _leaves(randn(n, L, 3 * C))
    got = K.mha_short(*qkv.chunk(3, dim=-1), H, mask)
    assert K.mha_short_launch_shape("mha_short")["load_bytes"] == 4
    (qkv64,) = _leaves(qkv, double=True)
    want = K.mha_short_plain(*qkv64.chunk(3, dim=-1), H, mask64)
    assert _err(got, want) <= 2e-5
    g = randn(n, L, C)
    (dgot,) = torch.autograd.grad(got, qkv, g)
    assert K.mha_short_launch_shape("mha_short_bwd")["load_bytes"] == 4
    (dwant,) = torch.autograd.grad(want, qkv64, g.double())
    assert _err(dgot, dwant) <= 2e-5 * max(1.0, float(dwant.abs().max()))


@pytest.mark.parametrize("N,H,L,C,causal", [(32, 8, 20, 512, True), (48, 8, 20, 512, True),
                                            (32, 12, 50, 768, False), (48, 12, 50, 768, False),
                                            (8, 32, 101, 2048, False), (3, 4, 65, 320, True)])
def test_mha_short_launches_the_schedules_grid(randn, N, H, L, C, causal):
    # the grids the launchers made are those tools/mha_schedule.py emulates
    # (the CPU tests' tile map): the paths' shapes and one off every bucket
    from tris_tpu_torch.tools.mha_schedule import block_counts

    want = block_counts(N, H, L, L, C // H)
    mask = causal_mask(L, device=randn(1).device) if causal else None
    (qkv,) = _leaves(randn(N, L, 3 * C))
    out = K.mha_short(*qkv.chunk(3, dim=-1), H, mask)
    torch.autograd.grad(out, qkv, torch.ones_like(out))
    for name in ("mha_short", "mha_short_bwd"):
        got = K.mha_short_launch_shape(name)
        assert got["load_bytes"] == 16
        assert {k: got[k] for k in want[name]} == want[name], name


@pytest.mark.parametrize("N,S,hw,T,m", [
    (2, 4, 100, 1, 256), (2, 2, 100, 3, 256), (2, 1, 100, 8, 256),
    (2, 1, 37, 5, 256), (2, 1, 100, 48, 1024), (1, 2, 129, 33, 256), (2, 4, 100, 70, 256),
    (2, 4, 129, 1, 1024), (1, 2, 37, 70, 1000), (1, 1, 256, 33, 96), (2, 2, 100, 48, 1024),
    (1, 1, 300, 5, 256), (1, 2, 37, 260, 1024), (1, 1, 513, 3, 96), (1, 4, 600, 1, 256)])
def test_cross_attn(randn, N, S, hw, T, m):
    # 1e-5 against float64 on relu'd inputs (logits of O(10)), one launch, at
    # the tiles' edges: HW and T across the 32-row tiles and 32-key slots,
    # and past a 256-key block (300, 260, 513: a last block of one key), S >
    # 1 pairs sharing their image's keys, m = 256 (one slice), 1024 (a
    # cluster of 4), 1000 and 96 (a slice cut short)
    qv, kv, vv = (torch.relu(randn(N, hw, m)) for _ in range(3))
    qt, kt, vt = (torch.relu(randn(N * S, T, m)) for _ in range(3))
    args = (qv, kv, vv, qt, kt, vt, S, math.sqrt(m))
    K.reset_launches()
    got = K.cross_attn(*args)
    torch.cuda.synchronize()
    assert K.launches["cross_attn"] == 1
    want = K.cross_attn_plain(*(a.double() for a in args[:6]), S, math.sqrt(m))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _err(g, w) <= 1e-5
    if T == 1:   # a softmax over one key is exactly 1: the output is Vt
        assert torch.equal(got[0], vt.expand(N * S, hw, m))


@pytest.mark.parametrize("N,S,hw,T,m", [(48, 1, 100, 48, 1024), (8, 4, 100, 1, 1024),
                                        (1, 2, 37, 260, 1000)])
def test_cross_attn_launches_the_schedules_grid(randn, N, S, hw, T, m):
    # the grids the launchers made are those tools/cross_attn_schedule.py
    # emulates (the CPU tests' tile map): the paths' shapes and one past a key block
    from tris_tpu_torch.tools.cross_attn_schedule import block_counts

    want = block_counts(N, S, hw, T, m)
    ins = [randn(N, hw, m).requires_grad_() for _ in range(3)] + \
          [randn(N * S, T, m).requires_grad_() for _ in range(3)]
    with torch.set_grad_enabled(S == 1):
        out = K.cross_attn(*ins, S, math.sqrt(m))
    launches = ["cross_attn"]
    if S == 1:
        torch.autograd.grad(out, ins, [torch.ones_like(o) for o in out])
        launches += ["cross_attn_bwd_a", "cross_attn_bwd_b"]
    for name in launches:
        shape = K.cross_attn_launch_shape(name)
        assert shape["blocks"] == want[name], name
        assert shape["tile_rows"] == want["rows_per_tile"]
        assert shape["cluster"] == (1 if name == "cross_attn_bwd_b" else want["cluster"])


def test_cross_attn_refuses_widths_beyond_its_tiles(randn):
    # m a multiple of 4 up to 2048 (a cluster of 8 slices of 256); HW and T
    # have no limit
    def call(m):
        v, t = randn(1, 10, m), randn(1, 4, m)
        return K.cross_attn(v, v, v, t, t, t, 1, 8.0)

    for m in (66, 2052):
        with pytest.raises(ValueError, match=f"do not take m = {m}"):
            call(m)


# (N images, S sentences, h, w, D, H, W, fused): the eval batch's shape (R = 4), S = 1 (the
# eval forward, R = 8), pair counts that are not a multiple of R (33 at R = 4, 13 at R = 8),
# ragged pixel shares and row bands, W % 4 != 0 (a column a thread), one pair
K3_CASES = [(8, 4, 10, 10, 1024, 320, 320, True), (8, 1, 10, 10, 1024, 320, 320, True),
            (11, 3, 5, 7, 32, 37, 41, False), (13, 1, 4, 6, 48, 64, 64, True),
            (1, 1, 1, 1, 40, 9, 10, False), (40, 4, 3, 3, 16, 24, 24, True)]


@pytest.mark.parametrize("N,S,h,w,D,H,W,fused", K3_CASES)
def test_response_head_equals_the_emulation(dev, N, S, h, w, D, H, W, fused):
    # bit for bit with the schedule tool's emulation of the cluster (each lane's fmaf chain,
    # the shuffles' sum, the upsample's products and sums rounded alone), with the plan the
    # tool gives and the launch the extension made
    from tris_tpu_torch.tools import response_head_schedule as RH

    g = torch.Generator(device=dev).manual_seed(N + D)
    vis_base = F.normalize(torch.randn(N, h * w, D, generator=g, device=dev), dim=-1)
    vis_new = torch.randn(N * S, h * w, D, generator=g, device=dev) if fused else None
    lan = F.normalize(torch.randn(N * S, D, generator=g, device=dev), dim=-1)
    scale = torch.tensor(1 / 0.07, device=dev)
    got = K.response_head(vis_new, vis_base, lan, S, scale, 0.1, (h, w), (H, W))
    plan = K.response_head_plan(N * S, S, h, w, D, H, W)
    assert plan == RH.plan(N * S, S, h, w, D, H, W)
    assert K.response_head_launch_shape() == {
        "blocks": plan["blocks"], "cluster": plan["ranks"], "threads": plan["threads"],
        "vec": plan["vec"], "smem_bytes": plan["smem_bytes"]}
    want = RH.emulate(None if vis_new is None else vis_new.cpu().numpy(), vis_base.cpu().numpy(),
                      lan.cpu().numpy(), S, float(scale), 0.1, (h, w), (H, W))
    assert torch.equal(got.cpu(), torch.from_numpy(want))


def test_response_head_refuses(dev):
    z = torch.zeros(1, 4, 8, device=dev)
    with pytest.raises(ValueError, match="bad shape"):
        K.response_head_plan(70000, 1, 2, 2, 8, 16, 16)
    with pytest.raises(ValueError, match="fit shared memory"):
        K.response_head(None, torch.zeros(1, 240 * 240, 8, device=dev), z[:, 0], 1,
                        torch.tensor(1.0, device=dev), 0.1, (240, 240), (480, 480))


@pytest.mark.parametrize("fused", [True, False])
def test_response_head(randn, dev, fused):
    # 1e-5 of the map's scale: exp(logit_scale) * a 1024-long dot of unit rows
    n, S, hw, D = 2, 3, 100, 1024
    vis_base = F.normalize(randn(n, hw, D), dim=-1)
    vis_new = randn(n * S, hw, D) if fused else None
    lan = F.normalize(randn(n * S, D), dim=-1)
    scale = torch.tensor(1 / 0.07, device=dev)
    args = (vis_new, vis_base, lan, S, scale, 0.1, (10, 10), (320, 288))
    got = K.response_head(*args)
    want = K.response_head_plain(*(a.double() if torch.is_tensor(a) else a for a in args))
    assert got.shape == (n * S, 320, 288) and bool((got >= 0).all())
    assert _err(got, want) <= 1e-5 * float(want.abs().max())


def test_eval_metrics(randn, dev):
    # exact: the kernel samples with the same taps in the same order as its
    # plain version; the all-zero map ties everywhere and must pick index 0
    sizes = [(30, 44), (48, 64), (17, 9)]
    cams = torch.relu(randn(3, 2, 16, 16))
    cams[1, 1] = 0
    tables = K.eval_tables(16, 16, sizes, (48, 64), dev)
    rng = np.random.default_rng(0)
    tgt = np.zeros((3, 48, 64), np.uint8)
    for b, (h, w) in enumerate(sizes):
        tgt[b, :h, :w] = rng.random((h, w)) > 0.5
    tgt = torch.as_tensor(tgt, device=dev)
    boxes = torch.tensor([[5, 3, 30, 20], [0, 0, 10, 10], [2, 2, 6, 12]], device=dev,
                         dtype=torch.float32)
    got = torch.stack(K.eval_metrics(cams, tables, tgt, boxes))
    want = torch.stack(K.eval_metrics_plain(cams, tables, tgt, boxes))
    assert torch.equal(got, want)
    assert torch.equal(K.eval_metrics(cams, tables, want_norm=True),
                       K.eval_metrics_plain(cams, tables, want_norm=True))


def _eval_case(dev, sizes, maps, h, max_hw, seed):
    """Relu maps [B, maps, h, h], tables to ``sizes`` within ``max_hw``, random
    zero-padded gt masks and boxes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(sizes)
    cams = torch.relu(torch.randn(B, maps, h, h, generator=g, device=dev))
    tables = K.eval_tables(h, h, sizes, max_hw, dev)
    tgt = torch.zeros(B, *max_hw, dtype=torch.uint8, device=dev)
    for b, (oh, ow) in enumerate(sizes):
        tgt[b, :oh, :ow] = torch.rand(oh, ow, generator=g, device=dev) > 0.5
    boxes = torch.tensor([[ow // 5, oh // 4, ow // 2, oh // 2] for oh, ow in sizes], device=dev,
                         dtype=torch.float32)
    return cams, tables, tgt, boxes


@pytest.mark.parametrize("maps", [4, 1])
def test_eval_metrics_at_the_main_path_shape(dev, maps):
    # stage-1 eval's [8, 4] maps of 320^2 to originals up to 640^2 (R = 8) and PRMS's
    # selected maps [8, 1] (R = 16 where the card runs such clusters); exact, both outputs,
    # and the launch as the plan says
    from tris_tpu_torch.tools import eval_metrics_schedule as ES

    sizes = [(640, 480), (427, 640), (480, 640), (640, 640), (375, 500), (612, 612),
             (333, 500), (640, 427)]
    cams, tables, tgt, boxes = _eval_case(dev, sizes, maps, 320, (640, 640), 3)
    got = torch.stack(K.eval_metrics(cams, tables, tgt, boxes))
    assert torch.equal(got, torch.stack(K.eval_metrics_plain(cams, tables, tgt, boxes)))
    shape = K.eval_metrics_launch_shape()
    plan = K.eval_metrics_plan(8, maps, 640, 640, 320, 320)
    assert plan == ES.plan(8, maps, 640, 640, 320, 320, plan["max_ranks"])
    assert plan["ranks"] == (8 if maps == 4 else plan["max_ranks"])
    assert (shape["cluster"], shape["blocks"], shape["smem_bytes"]) == (
        plan["ranks"], plan["blocks"], plan["smem_bytes"])
    assert (shape["map_load_bytes"], shape["staged"]) == (16, 1)
    assert torch.equal(K.eval_metrics(cams, tables, want_norm=True),
                       K.eval_metrics_plain(cams, tables, want_norm=True))


def test_eval_metrics_tie_across_ranks(dev):
    # align_corners 16 -> 31 puts even output rows and columns exactly on input pixels:
    # the peak value planted at input rows 2 and 12 appears at output rows 4 and 24, in
    # two ranks' bands; the lower flat index wins (the box holds only it)
    sizes = [(31, 31), (31, 31)]
    cams = torch.rand(2, 3, 16, 16, device=dev)
    cams[:, :, 2, 3] = 5.0
    cams[:, :, 12, 3] = 5.0
    cams[1, 2] = 0          # all ties: index 0
    tables = K.eval_tables(16, 16, sizes, (64, 64), dev)
    tgt = torch.zeros(2, 64, 64, dtype=torch.uint8, device=dev)
    tgt[:, 4, 6] = 1
    boxes = torch.tensor([[5, 3, 7, 5]] * 2, device=dev, dtype=torch.float32)
    assert K.eval_metrics_plan(2, 3, 64, 64, 16, 16)["ranks"] >= 2
    got = torch.stack(K.eval_metrics(cams, tables, tgt, boxes))
    assert torch.equal(got, torch.stack(K.eval_metrics_plain(cams, tables, tgt, boxes)))
    assert got[2, 0].tolist() == [1.0, 1.0, 1.0] and got[3, 0].tolist() == [1.0, 1.0, 1.0]
    assert got[2, 1, 2] == 0.0      # the all-zero map's peak is (0, 0), outside the box


@pytest.mark.parametrize("sizes,max_hw,h", [
    ([(5, 7), (3, 2)], (48, 64), 16),         # oh < R: empty ranks
    ([(37, 29), (17, 9)], (48, 60), 16),     # oh not a multiple of R; maxW % 16 != 0
    ([(17, 9), (48, 64)], (48, 64), 13),     # small originals in a pad; w % 4 != 0
    ([(9, 700), (700, 9)], (700, 700), 20)])  # maxW % 16 != 0, a wide band
def test_eval_metrics_edges(dev, sizes, max_hw, h):
    cams, tables, tgt, boxes = _eval_case(dev, sizes, 3, h, max_hw, 5)
    got = torch.stack(K.eval_metrics(cams, tables, tgt, boxes))
    assert torch.equal(got, torch.stack(K.eval_metrics_plain(cams, tables, tgt, boxes)))
    assert torch.equal(K.eval_metrics(cams, tables, want_norm=True),
                       K.eval_metrics_plain(cams, tables, want_norm=True))


@pytest.mark.parametrize("kind", ["negative", "signed", "tiny"])
def test_eval_metrics_sign_and_scale(dev, kind):
    # every sample below -1e-5 (each divided), signed maps, maps near the subnormal range
    cams, tables, tgt, boxes = _eval_case(dev, [(30, 44), (48, 64), (17, 9)], 2, 16, (48, 64), 8)
    raw = torch.randn(cams.shape, generator=torch.Generator(device=dev).manual_seed(9),
                      device=dev)
    cams = {"negative": -cams - 1.0, "signed": raw, "tiny": raw.abs() * 1e-36}[kind]
    got = torch.stack(K.eval_metrics(cams, tables, tgt, boxes))
    assert torch.equal(got, torch.stack(K.eval_metrics_plain(cams, tables, tgt, boxes)))
    assert torch.equal(K.eval_metrics(cams, tables, want_norm=True),
                       K.eval_metrics_plain(cams, tables, want_norm=True))


def test_eval_metrics_unstaged(dev):
    # originals past the shared memory's reach sample the map from device memory
    from tris_tpu_torch.tools import eval_metrics_schedule as ES

    sizes = [(2400, 2400)]
    assert ES.plan(1, 1, 2400, 2400, 320, 320)["staged"] == 0
    cams, tables, tgt, boxes = _eval_case(dev, sizes, 1, 320, (2400, 2400), 6)
    got = torch.stack(K.eval_metrics(cams, tables, tgt, boxes))
    assert torch.equal(got, torch.stack(K.eval_metrics_plain(cams, tables, tgt, boxes)))
    assert K.eval_metrics_launch_shape()["staged"] == 0


def test_launches_are_counted(randn):
    q = randn(2, 20, 64)
    before = K.launches["mha_short"]
    K.mha_short(q, q, q, 1)
    assert K.launches["mha_short"] == before + 1


def test_eval_metrics_on_selected_maps(randn, dev):
    # PRMS: one map per image, picked by best; exact as above
    sizes = [(30, 44), (48, 64), (17, 9)]
    maps = torch.relu(randn(3, 4, 16, 16))
    best = torch.tensor([3, 0, 2], device=dev)
    sel = maps.gather(1, best[:, None, None, None].expand(3, 1, 16, 16))
    tables = K.eval_tables(16, 16, sizes, (48, 64), dev)
    tgt = torch.zeros(3, 48, 64, dtype=torch.uint8, device=dev)
    for b, (h, w) in enumerate(sizes):       # zero outside each image, as padded
        tgt[b, 5:min(h, 20), 3:min(w, 30)] = 1
    boxes = torch.tensor([[3, 5, 29, 19]] * 3, device=dev, dtype=torch.float32)
    got = torch.stack(K.eval_metrics(sel, tables, tgt, boxes))
    assert got.shape == (4, 3, 1)
    assert torch.equal(got, torch.stack(K.eval_metrics_plain(sel, tables, tgt, boxes)))
    assert torch.equal(K.eval_metrics(sel, tables, want_norm=True),
                       K.eval_metrics_plain(sel, tables, want_norm=True))


@pytest.mark.parametrize("size,out,patch,S", [(320, 224, 32, 4), (64, 64, 16, 2),
                                              (96, 64, 16, 1)])
def test_critic_input(randn, size, out, patch, S):
    # exact: the kernel samples with the plain version's taps in its order
    # and rounds each product and sum alone; 64 -> 64 takes identity taps
    B = 2
    cams = torch.relu(randn(B * S, size, size))
    image = randn(B, 3, size, size)
    got = K.critic_input(cams, image, S, out, patch)
    g = out // patch
    assert got.shape == (B * S * g * g, 3 * patch * patch)
    assert torch.equal(got, K.critic_input_plain(cams, image, S, out, patch))
    if size == out:   # a pure layout change: image b's channel c, pixel (y, x)
        a = got.reshape(B * S, g, g, 3, patch, patch)
        assert torch.equal(a[S, 1, 2, 1, 3, 4], cams[S, patch + 3, 2 * patch + 4]
                           * image[1, 1, patch + 3, 2 * patch + 4])


def test_critic_input_refuses(randn):
    cams, image = randn(4, 64, 64), randn(2, 3, 64, 64)
    with pytest.raises(ValueError, match="bad shapes"):
        K.critic_input(cams, image, 3, 64, 16)       # 4 pairs != 2 images x 3
    with pytest.raises(ValueError, match="bad shapes"):
        K.critic_input(cams, image, 2, 60, 16)       # 60 is not a multiple of 16


@pytest.mark.parametrize("shape", [(8, 320, 320), (1, 7, 5), (3, 1, 1)])
def test_normalize_u8(dev, shape):
    # exact: one rounded multiply and one rounded add, as the plain version
    g = torch.Generator(device=dev).manual_seed(1)
    u8 = torch.randint(0, 256, (*shape, 3), generator=g, device=dev, dtype=torch.uint8)
    got = K.normalize_u8_nchw(u8)
    assert got.dtype == torch.float32 and got.shape == (shape[0], 3, shape[1], shape[2])
    assert torch.equal(got, K.normalize_u8_nchw_plain(u8))


def test_normalize_u8_refuses(dev):
    with pytest.raises(ValueError, match="uint8"):
        K.normalize_u8_nchw(torch.zeros(1, 4, 4, 3, device=dev))
    with pytest.raises(ValueError, match="uint8"):
        K.normalize_u8_nchw(torch.zeros(1, 4, 4, 4, dtype=torch.uint8, device=dev))


# ---- backward kernels (the stage-1 train path) ---------------------------------


def _grads(fn, inputs, cotangents):
    """Gradients of sum(<out_i, cot_i>) with respect to ``inputs``."""
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, c) for o, c in zip(outs, cotangents) if c is not None]
    return torch.autograd.grad([o for o, _ in pairs], inputs, [c for _, c in pairs])


def _leaves(*ts, double=False):
    return [(t.double() if double else t).detach().requires_grad_() for t in ts]


@pytest.mark.parametrize("hd", K1_HEAD_DIMS)
@pytest.mark.parametrize("L,causal,fused", [(1, False, True), (8, True, True), (16, False, True),
                                            (17, True, False), (20, True, True), (50, False, True),
                                            (56, True, True), (57, False, False), (64, True, True),
                                            (65, False, True), (128, True, True),
                                            (128, False, False), (37, True, False)])
def test_mha_short_bwd(randn, L, causal, fused, hd):
    # against autograd of the plain version in float64: 2e-5 of the
    # gradient's scale (f32 sums of up to 128 products); fused: q, k, v are
    # strided column views of one qkv tensor and autograd sums their three
    # gradients into it
    n, H = 3, 4
    C = H * hd
    mask = causal_mask(L, device=randn(1).device) if causal else None
    g = randn(n, L, C)
    if fused:
        (qkv,) = _leaves(randn(n, L, 3 * C))
        (qkv64,) = _leaves(qkv, double=True)
        got = _grads(lambda x: K.mha_short(*x.chunk(3, dim=-1), H, mask), [qkv], [g])
        want = _grads(lambda x: K.mha_short_plain(*x.chunk(3, dim=-1), H,
                                                  None if mask is None else mask.double()),
                      [qkv64], [g.double()])
    else:
        ins = _leaves(randn(n, L, C), randn(n, L, C), randn(n, L, C))
        got = _grads(lambda q, k, v: K.mha_short(q, k, v, H, mask), ins, [g])
        want = _grads(lambda q, k, v: K.mha_short_plain(q, k, v, H, None if mask is None
                                                        else mask.double()),
                      _leaves(*ins, double=True), [g.double()])
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert _err(a, b) <= 2e-5 * max(1.0, float(b.abs().max()))


def test_mha_short_bwd_is_the_same_run_to_run(randn):
    # no atomics and a fixed order of every sum: two backward runs at the
    # critic's training shape agree bit for bit; one launch each
    N, H, L, C = 48, 12, 50, 768
    (qkv,) = _leaves(randn(N, L, 3 * C))
    g = randn(N, L, C)
    K.reset_launches()
    first = _grads(lambda x: K.mha_short(*x.chunk(3, dim=-1), H), [qkv], [g])
    second = _grads(lambda x: K.mha_short(*x.chunk(3, dim=-1), H), [qkv], [g])
    assert K.launches["mha_short"] == 2 and K.launches["mha_short_bwd"] == 2
    assert torch.equal(first[0], second[0])


def test_mha_short_saves_nothing_without_grad(randn):
    # the critic's text tower runs without autograd: no graph, nothing kept
    q = randn(4, 20, 64).requires_grad_()
    with torch.no_grad():
        out = K.mha_short(q, q, q, 1)
    assert out.grad_fn is None
    assert K.mha_short(q.detach(), q.detach(), q.detach(), 1).grad_fn is None


@pytest.mark.parametrize("n,T,hw,m", [
    (3, 1, 100, 256), (3, 48, 100, 256), (3, 5, 37, 256),
    (2, 33, 129, 1024), (3, 70, 37, 256), (2, 48, 100, 1024), (1, 5, 256, 96), (2, 1, 37, 1000),
    (1, 5, 300, 256), (1, 260, 37, 1024), (1, 3, 513, 96)])
def test_cross_attn_bwd(randn, n, T, hw, m):
    # all six input gradients against autograd of the plain version in
    # float64, within 1e-5 of each gradient's scale, at the tiles' edges (see
    # test_cross_attn): T = 1, HW and T across a tile and past a key block
    ins = _leaves(*(torch.relu(randn(n, hw, m)) for _ in range(3)),
                  *(torch.relu(randn(n, T, m)) for _ in range(3)))
    cot = [randn(n, hw, m), randn(n, T, m)]
    got = _grads(lambda *x: K.cross_attn(*x, 1, math.sqrt(m)), ins, cot)
    want = _grads(lambda *x: K.cross_attn_plain(*x, 1, math.sqrt(m)), _leaves(*ins, double=True),
                  [c.double() for c in cot])
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert _err(a, b) <= 1e-5 * max(1.0, float(b.abs().max()))


def test_cross_attn_bwd_is_the_same_run_to_run(randn):
    # no atomics and a fixed order of every sum: two backward runs at the
    # train step's shape (fewer images) agree bit for bit; two launches
    n, hw, T, m = 6, 100, 48, 1024
    ins = _leaves(*(torch.relu(randn(n, hw, m)) for _ in range(3)),
                  *(torch.relu(randn(n, T, m)) for _ in range(3)))
    cot = [randn(n, hw, m), randn(n, T, m)]
    K.reset_launches()
    first = _grads(lambda *x: K.cross_attn(*x, 1, math.sqrt(m)), ins, cot)
    second = _grads(lambda *x: K.cross_attn(*x, 1, math.sqrt(m)), ins, cot)
    assert K.launches["cross_attn"] == 2 and K.launches["cross_attn_bwd"] == 4
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_cross_attn_bwd_refuses_several_sentences(randn):
    qv = randn(2, 10, 64).requires_grad_()
    qt = randn(4, 1, 64)
    with pytest.raises(ValueError, match="S = 1"):
        K.cross_attn(qv, qv, qv, qt, qt, qt, 2, 8.0)


# (B, (h, w), (H, W), d relu_map too): B = 1 (a softmax over bg and one text), identity taps
# (out == hw), several ranks (R = 8 forward and backward at B = 6 and 3), W % 4 != 0 (a column
# a thread), a ragged pixel share (25 pixels over 8 ranks), the train path's B = 48 (R = 2 and 4)
K3_TRAIN_CASES = [(1, (3, 3), (24, 24), False), (4, (10, 10), (10, 10), True),
                  (6, (10, 10), (320, 288), False), (5, (4, 7), (33, 50), True),
                  (3, (5, 5), (96, 96), True), (48, (10, 10), (320, 320), False)]


@pytest.mark.parametrize("B,hw,out,relu", K3_TRAIN_CASES)
def test_stage1_head(randn, dev, B, hw, out, relu):
    # forward outputs and the gradients of vis_p and lan_p against the plain
    # version in float64: 2e-5 of each output's / gradient's scale. B = 1
    # (a softmax over bg and one text) and identity taps (out == hw) are the
    # edges; with relu the map gradient also comes through relu_map; one
    # launch each way
    h, w = hw
    D = 256
    vis = F.normalize(randn(B, h * w, D), dim=-1)
    lan = F.normalize(randn(B, B, D), dim=-1)
    scale = torch.tensor(1 / 0.07, device=dev)
    cot = [randn(B, B), None, randn(B, *out) if relu else None, randn(B, *out)]

    def run(fn, v, l):
        return fn(v, l, scale.to(v.dtype), hw, out, 3.0, 0.01)

    got_out = run(K.stage1_head, vis, lan)
    want_out = run(K.stage1_head_plain, vis.double(), lan.double())
    for a, b in zip(got_out, want_out):
        assert a.shape == b.shape
        assert _err(a, b) <= 2e-5 * max(1.0, float(b.abs().max()))
    K.reset_launches()
    got = _grads(lambda v, l: run(K.stage1_head, v, l), _leaves(vis, lan), cot)
    assert K.launches["stage1_head"] == 1 and K.launches["stage1_head_bwd"] == 1
    want = _grads(lambda v, l: run(K.stage1_head_plain, v, l), _leaves(vis, lan, double=True),
                  [None if c is None else c.double() for c in cot])
    for a, b in zip(got, want):
        assert _err(a, b) <= 2e-5 * max(1.0, float(b.abs().max()))


# (B, (h, w), (H, W), D): the train path's shape, several ranks, W % 4 != 0, B = 1, a ragged
# share, D past one stage but short of the next (96 channels: 24 groups, three a warp, a stage
# half empty), and B = 200 (R = 1, ten passes of 56 x 48 score tiles over D)
K3_TRAIN_EMULATED = [(48, (10, 10), (320, 320), 1024), (6, (10, 10), (320, 288), 256),
                     (5, (4, 7), (33, 50), 48), (1, (3, 3), (24, 24), 32),
                     (3, (5, 5), (96, 96), 96), (200, (10, 10), (64, 64), 64)]


@pytest.mark.parametrize("B,hw,out,D", K3_TRAIN_EMULATED)
def test_stage1_head_equals_the_emulation(dev, B, hw, out, D):
    # the score plane and relu_map bit for bit with the schedule tool's emulation (each
    # score's fmaf chain over the channels in order, the upsample's products and sums rounded
    # alone), with the plan the tool gives and the launches the extension made, forward and
    # backward
    from tris_tpu_torch.tools import stage1_head_schedule as S1

    (h, w), (H, W) = hw, out
    g = torch.Generator(device=dev).manual_seed(B + D)
    vis = F.normalize(torch.randn(B, h * w, D, generator=g, device=dev), dim=-1)
    lan = F.normalize(torch.randn(B, B, D, generator=g, device=dev), dim=-1)
    scale = torch.tensor(1 / 0.07, device=dev)
    ty, tx = taps_on(h, H, False, dev), taps_on(w, W, False, dev)
    score, _, _, _, relu_map, _ = K.build.ops().stage1_head(vis, lan, scale, list(ty), list(tx),
                                                           h, w, 3.0, 0.01, 0)
    want = S1.emulate_forward(vis.cpu().numpy(), lan.cpu().numpy(), float(scale), hw, out, 3.0,
                              0.01)
    assert torch.equal(score.cpu(), torch.from_numpy(want[0]))
    assert torch.equal(relu_map.cpu(), torch.from_numpy(want[3]))
    for backward in (False, True):
        plan = K.stage1_head_plan(B, h, w, D, H, W, backward)
        assert plan == S1.plan(B, h, w, D, H, W, backward)
        leaves = _leaves(vis, lan) if backward else (vis, lan)
        outs = K.stage1_head(*leaves, scale, hw, out, 3.0, 0.01)
        if backward:
            torch.autograd.grad(outs[3].sum(), leaves)
        assert K.stage1_head_launch_shape(backward) == {
            "blocks": plan["blocks"], "cluster": plan["ranks"], "threads": plan["threads"],
            "vec": plan["vec"], "smem_bytes": plan["smem_bytes"]}


@pytest.mark.parametrize("exact", [True, False])
def test_stage1_head_gmp_near_ties(dev, exact):
    # pixels planted at (or within a rounding of) another pixel's scores: GMP's maxima tie or
    # nearly tie. The gradient goes to the first argmax of the kernel's own scores, which the
    # emulation holds bit for bit, so the backward is held to the emulation's (2e-5 of the
    # gradient's scale; the softmax's exps round apart)
    from tris_tpu_torch.tools import stage1_head_schedule as S1

    B, h, w, D, H, W = 6, 5, 5, 128, 40, 40
    g = torch.Generator(device=dev).manual_seed(3)
    vis = F.normalize(torch.randn(B, h * w, D, generator=g, device=dev), dim=-1)
    lan = F.normalize(torch.randn(B, B, D, generator=g, device=dev), dim=-1)
    vis[:, 1:] = 0.2 * vis[:, 1:]          # pixel 0 holds every text's max by far
    eps = 0.0 if exact else 1e-7
    for dst in (7, 18, 24):                # then ties with pixel 0 in every image and text
        vis[:, dst] = vis[:, 0] * (1 + eps * dst)
    scale = torch.tensor(1 / 0.07, device=dev)
    cot = [torch.randn(B, B, generator=g, device=dev), None, None,
           torch.randn(B, H, W, generator=g, device=dev)]
    got = _grads(lambda v, l: K.stage1_head(v, l, scale, (h, w), (H, W), 3.0, 0.01),
                 _leaves(vis, lan), cot)
    ty, tx = taps_on(h, H, False, dev), taps_on(w, W, False, dev)
    score = K.build.ops().stage1_head(vis, lan, scale, list(ty), list(tx), h, w, 3.0, 0.01, 0)[0]
    v_np, l_np = vis.cpu().numpy(), lan.cpu().numpy()
    want_score = S1.emulate_forward(v_np, l_np, float(scale), (h, w), (H, W), 3.0, 0.01)[0]
    assert torch.equal(score.cpu(), torch.from_numpy(want_score))
    if exact:
        assert (want_score[:, 7] == want_score[:, 0]).all()
    want = S1.emulate_backward(cot[0].cpu().numpy(), None, cot[3].cpu().numpy(), v_np, l_np,
                               float(scale), want_score, (h, w), (H, W), 3.0, 0.01)
    for a, b in zip(got, want):
        assert _err(a.cpu(), torch.from_numpy(b)) <= 2e-5 * max(1.0, float(np.abs(b).max()))


# (B, T, offset, (h, w), (H, W), D): a rank's images against the global batch's texts, the
# card check's 2 x 24 against 48 (R = 4 forward, 8 backward) and ragged small ones
K3_RECT = [(24, 48, 0, (10, 10), (320, 320), 1024), (24, 48, 24, (10, 10), (320, 320), 1024),
           (3, 9, 6, (4, 7), (33, 50), 48), (2, 5, 1, (3, 3), (24, 24), 32)]


@pytest.mark.parametrize("B,T,off,hw,out,D", K3_RECT)
def test_stage1_head_rectangular(dev, B, T, off, hw, out, D):
    # B images against T texts, the own ones at off: the score plane and relu_map bit for bit
    # with the emulation, the other outputs and both gradients against the plain version in
    # float64 at test_stage1_head's bars, the plans the tool's, one launch each way
    from tris_tpu_torch.tools import stage1_head_schedule as S1

    (h, w), (H, W) = hw, out
    g = torch.Generator(device=dev).manual_seed(B + T + off)
    vis = F.normalize(torch.randn(B, h * w, D, generator=g, device=dev), dim=-1)
    lan = F.normalize(torch.randn(B, T, D, generator=g, device=dev), dim=-1)
    scale = torch.tensor(1 / 0.07, device=dev)
    ty, tx = taps_on(h, H, False, dev), taps_on(w, W, False, dev)
    score, _, _, _, relu_map, _ = K.build.ops().stage1_head(vis, lan, scale, list(ty), list(tx),
                                                           h, w, 3.0, 0.01, off)
    want = S1.emulate_forward(vis.cpu().numpy(), lan.cpu().numpy(), float(scale), hw, out, 3.0,
                              0.01, offset=off)
    assert torch.equal(score.cpu(), torch.from_numpy(want[0]))
    assert torch.equal(relu_map.cpu(), torch.from_numpy(want[3]))
    for backward in (False, True):
        assert K.stage1_head_plan(B, h, w, D, H, W, backward, T=T) == S1.plan(
            B, h, w, D, H, W, backward, T=T)

    def run(fn, v, l):
        return fn(v, l, scale.to(v.dtype), hw, out, 3.0, 0.01, off)

    got_out = run(K.stage1_head, vis, lan)
    want_out = run(K.stage1_head_plain, vis.double(), lan.double())
    for a, b in zip(got_out, want_out):
        assert a.shape == b.shape
        assert _err(a, b) <= 2e-5 * max(1.0, float(b.abs().max()))
    cot = [torch.randn(B, T, generator=g, device=dev), None,
           torch.randn(B, H, W, generator=g, device=dev),
           torch.randn(B, H, W, generator=g, device=dev)]
    K.reset_launches()
    got = _grads(lambda v, l: run(K.stage1_head, v, l), _leaves(vis, lan), cot)
    assert K.launches["stage1_head"] == 1 and K.launches["stage1_head_bwd"] == 1
    want = _grads(lambda v, l: run(K.stage1_head_plain, v, l), _leaves(vis, lan, double=True),
                  [None if c is None else c.double() for c in cot])
    for a, b in zip(got, want):
        assert _err(a, b) <= 2e-5 * max(1.0, float(b.abs().max()))


def test_stage1_head_bwd_is_the_same_run_to_run(randn, dev):
    # no atomics, the ranks' partials summed in rank order: a second backward is the first
    # bit for bit, through both maps and cls_out
    B, hw, out, D = 48, (10, 10), (320, 320), 1024
    vis = F.normalize(randn(B, hw[0] * hw[1], D), dim=-1)
    lan = F.normalize(randn(B, B, D), dim=-1)
    scale = torch.tensor(1 / 0.07, device=dev)
    cot = [randn(B, B), None, randn(B, *out), randn(B, *out)]
    fn = lambda v, l: K.stage1_head(v, l, scale, hw, out, 3.0, 0.01)  # noqa: E731
    first = _grads(fn, _leaves(vis, lan), cot)
    second = _grads(fn, _leaves(vis, lan), cot)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_stage1_head_refuses(dev):
    scale = torch.tensor(1.0, device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        K.stage1_head(torch.zeros(2, 4, 6, device=dev), torch.zeros(2, 2, 6, device=dev), scale,
                      (2, 2), (8, 8), 3.0, 0.01)
    with pytest.raises(ValueError, match="bad shape"):
        K.stage1_head_plan(70000, 2, 2, 8, 8, 8)
    with pytest.raises(ValueError, match="bad shape"):
        K.stage1_head_plan(4, 2, 2, 8, 8, 8, T=3)
    with pytest.raises(ValueError, match="offset"):
        K.stage1_head(torch.zeros(2, 4, 8, device=dev), torch.zeros(2, 3, 8, device=dev), scale,
                      (2, 2), (8, 8), 3.0, 0.01, offset=2)
    # [400, 72] planes: the forward fits with two buffers, the backward does not, and is refused
    # before the forward runs
    big = torch.zeros(72, 400, 64, device=dev, requires_grad=True)
    K.reset_launches()
    with pytest.raises(ValueError, match="backward's stages must fit shared memory"):
        K.stage1_head(big, torch.zeros(72, 72, 64, device=dev), scale, (20, 20), (64, 64),
                      3.0, 0.01)
    assert K.launches["stage1_head"] == 0


@pytest.mark.parametrize("size,out,patch,S", [(64, 64, 16, 1), (320, 224, 32, 1), (96, 64, 16, 2),
                                              (100, 64, 16, 1)])
def test_critic_input_bwd(randn, size, out, patch, S):
    # the maps' gradient against autograd of the plain version in float64,
    # 1e-5 of its scale; 64 -> 64 takes identity taps; 100 -> 64 at 48 maps
    # takes bands of 8, the last of 4 rows; the image is data; two runs give
    # the same bits (a gather, no atomics)
    B = 48 if size == 100 else 2
    cams = torch.relu(randn(B * S, size, size))
    image = randn(B, 3, size, size)
    g = out // patch
    cot = randn(B * S * g * g, 3 * patch * patch)
    K.reset_launches()
    fn = lambda c: K.critic_input(c, image, S, out, patch)  # noqa: E731
    (got,) = _grads(fn, _leaves(cams), [cot])
    assert K.launches["critic_input_bwd"] == 1
    (want,) = _grads(lambda c: K.critic_input_plain(c, image.double(), S, out, patch),
                     _leaves(cams, double=True), [cot.double()])
    assert _err(got, want) <= 1e-5 * max(1.0, float(want.abs().max()))
    assert torch.equal(got, _grads(fn, _leaves(cams), [cot])[0])
    if size == 100:
        assert K.critic_input_bwd_launch_shape()["band"] == 8
    with pytest.raises(ValueError, match="image is data"):
        K.critic_input(cams, image.requires_grad_(), S, out, patch)


@pytest.mark.parametrize("P,S,size,out,patch", [(48, 1, 320, 224, 32), (6, 2, 96, 64, 16),
                                                (48, 1, 100, 64, 16), (3, 3, 48, 48, 16)])
def test_critic_input_bwd_equals_the_emulation(dev, P, S, size, out, patch):
    # bit for bit with the schedule tool's emulation of the bands (the first design's fmaf
    # chains in its order), with the plan the tool gives and the launch the extension made
    from tris_tpu_torch.tools import critic_input_schedule as CS

    g = torch.Generator(device=dev).manual_seed(P + size)
    cams = torch.rand(P, size, size, generator=g, device=dev, requires_grad=True)
    image = torch.randn(P // S, 3, size, size, generator=g, device=dev)
    cot = torch.randn(P * (out // patch) ** 2, 3 * patch * patch, generator=g, device=dev)
    K.reset_launches()
    (got,) = torch.autograd.grad(K.critic_input(cams, image, S, out, patch), cams, cot)
    plan = K.critic_input_bwd_plan(P, size, size, out)
    assert plan == CS.plan(P, size, size, out)
    assert K.critic_input_bwd_launch_shape() == {
        "blocks": plan["blocks"], "threads": plan["threads"], "band": plan["band"],
        "span_rows": plan["span_rows"], "smem_bytes": plan["smem_bytes"]}
    want = CS.banded_critic_input_bwd(cot.cpu(), image.cpu(), S, out, patch)
    assert torch.equal(got.cpu(), want)


def test_critic_input_bwd_refuses_bands_past_shared_memory(dev):
    # a shape whose backward's band does not fit is refused in Python before any launch
    cams = torch.rand(1, 8, 12000, device=dev, requires_grad=True)
    image = torch.rand(1, 3, 8, 12000, device=dev)
    K.reset_launches()
    with pytest.raises(ValueError, match="must fit shared memory"):
        K.critic_input(cams, image, 1, 4000, 16)
    assert K.launches["critic_input"] == 0
    with torch.no_grad():   # no gradient, no backward: the forward alone is taken
        assert K.critic_input(cams, image, 1, 64, 16).shape == (16, 3 * 16 * 16)


def _directional(fn, x, u, eps):
    """Central difference of sum(fn(x)) along u, in float32."""
    with torch.no_grad():
        return float((fn(x + eps * u).sum() - fn(x - eps * u).sum()) / (2 * eps))


@pytest.mark.parametrize("which", ["mha_short", "cross_attn", "stage1_head", "critic_input"])
def test_backward_kernels_match_finite_differences(randn, dev, which):
    # the kernels' gradient along a random direction against a float32
    # central difference (eps 1e-2, 1e-3 for K3) of the kernels' own
    # forward: agreement within 2 % of the directional derivative, the f32 bar
    eps = 1e-2
    if which == "mha_short":
        x = randn(2, 9, 64)
        fn = lambda t: K.mha_short(t, t, t, 2, causal_mask(9, device=dev))  # noqa: E731
    elif which == "cross_attn":
        x = randn(2, 7, 32)
        t_part = randn(2, 3, 32)
        fn = lambda t: sum(o.square().sum() for o in  # noqa: E731
                           K.cross_attn(t, t, t, t_part, t_part, t_part, 1, 4.0)).reshape(1)
    elif which == "stage1_head":
        lan = F.normalize(randn(3, 3, 32), dim=-1)
        # pixel q of each image is text q's own direction: every channel's
        # GMP argmax is clear of the others by far more than the step
        x = torch.cat([lan, F.normalize(randn(3, 13, 32), dim=-1)], dim=1)
        scale = torch.tensor(2.0, device=dev)
        fn = lambda t: (lambda o: o[0].sum() + o[3].square().sum())(  # noqa: E731
            K.stage1_head(t, lan, scale, (4, 4), (9, 9), 3.0, 0.01)).reshape(1)
        eps = 1e-3   # smaller: GMP's argmax must not move within the step
    else:
        x = torch.relu(randn(2, 20, 20)) + 0.5
        image = randn(2, 3, 20, 20)
        fn = lambda t: K.critic_input(t, image, 1, 16, 8).square()  # noqa: E731
    u = randn(*x.shape)
    (g,) = _grads(lambda t: fn(t).sum(), _leaves(x), [torch.ones((), device=dev)])
    analytic = float((g * u).sum())
    numeric = _directional(fn, x, u, eps)
    assert abs(analytic - numeric) <= 2e-2 * max(abs(numeric), 1e-3), (analytic, numeric)


# ---- the IRNet instance pseudo-mask path (K6 bilinear, K7, K9, K10) ------------------


@pytest.mark.parametrize("shape,size,align_corners", [
    ((2, 64, 30, 40), (120, 160), False),    # an IRNet head's x4
    ((480, 640), (120, 160), True),          # the CAM to the grid
    ((3, 120, 160), (480, 640), False),      # the walk back, x4
    ((5, 7, 9), (13, 4), True), ((1, 1, 1), (3, 5), False), ((4, 6), (4, 11), False),
    ((2, 1, 80, 80), (320, 320), False),     # stage 2's heads x4, x16
    ((2, 1, 20, 20), (320, 320), False),
    ((2, 64, 40, 40), (80, 80), False),      # the decoder's x2 taps
    ((2, 256, 10, 10), (20, 20), False),
    ((60, 80), (240, 320), True)])
def test_bilinear_resize(randn, shape, size, align_corners):
    # exact: the kernel samples with the plain version's taps in its order
    # and rounds each product and sum alone; within 1e-4 of F.interpolate's
    # scale, which computes the source coordinate in float32 where the taps
    # take float64 (4e-5 apart at 480x640 -> 120x160 with align_corners)
    x = randn(*shape)
    got = K.bilinear_resize(x, size, align_corners)
    assert got.shape == (*shape[:-2], *size)
    assert torch.equal(got, K.bilinear_resize_plain(x, size, align_corners))
    lib = F.interpolate(x.reshape(-1, 1, *shape[-2:]), size=size, mode="bilinear",
                        align_corners=align_corners).reshape(got.shape)
    assert _err(got, lib) <= 1e-4 * max(float(lib.abs().max()), 1.0)


@pytest.mark.parametrize("shape,size,align_corners", [
    ((3, 7, 2000), (5, 1001), True),         # column tiles (ow > 1024, odd)
    ((2, 8, 1500), (3, 1500), False),        # column tiles, 16-byte stores
    ((2, 3000), (2, 7), False)])             # t-rows past shared memory: unstaged
def test_bilinear_resize_wide(randn, shape, size, align_corners):
    # exact against the plain version (F.interpolate's float32 source coordinate drifts
    # past 1e-4 at these widths, so it is no reference here)
    x = randn(*shape)
    assert torch.equal(K.bilinear_resize(x, size, align_corners),
                       K.bilinear_resize_plain(x, size, align_corners))


def test_bilinear_resize_misaligned_view(dev):
    # a view 4 bytes past a 16-byte boundary: the rows load floats one by one
    g = torch.Generator(device=dev).manual_seed(1)
    buf = torch.randn(2 * 64 * 40 * 40 + 1, generator=g, device=dev)
    x = buf[1:].view(2, 64, 40, 40)
    assert x.data_ptr() % 16 != 0
    assert torch.equal(K.bilinear_resize(x, (80, 80)), K.bilinear_resize_plain(x, (80, 80)))


@pytest.mark.parametrize("shape,size", [
    ((48, 1, 80, 80), (320, 320)), ((48, 1, 20, 20), (320, 320)), ((48, 64, 40, 40), (80, 80)),
    ((48, 256, 10, 10), (20, 20)), ((2, 256, 60, 80), (120, 160)), ((4, 120, 160), (480, 640)),
    ((480, 640), (120, 160)), ((3, 7, 2000), (5, 1001)), ((2, 3000), (2, 7))])
def test_bilinear_resize_plan_and_launch(dev, shape, size):
    # the extension's rule equals the schedule tool's, and the launch takes it
    from tris_tpu_torch.tools import resize_schedule as RS

    planes = math.prod(shape[:-2])
    plan = K.bilinear_resize_plan(planes, *shape[-2:], *size)
    assert plan == RS.plan(planes, *shape[-2:], *size)
    K.bilinear_resize(torch.zeros(*shape, device=dev), size, False)
    got = K.bilinear_resize_launch_shape()
    assert got == {"blocks": plan["blocks"], "tiles": plan["tiles"], "threads": plan["threads"],
                   "band_rows": plan["band_rows"], "vec": plan["vec"], "staged": plan["staged"],
                   "in_floats": plan["in_floats"], "smem_bytes": plan["smem_bytes"]}


def _path_index(radius, size):
    from tris_tpu_torch.pseudo.indexing import PathIndex

    return PathIndex(radius, size)


@pytest.mark.parametrize("radius,shape", [(5, (133, 170)), (5, (37, 18)), (10, (2, 128, 128)),
                                          (10, (10, 19)), (3, (3, 5, 6))])
def test_path_max_affinity(dev, radius, shape):
    # exact (a max and 1 - m): the walk's padded grid at radius 5, a narrow
    # one, IRN training's batch at radius 10, the narrowest grids each takes
    g = torch.Generator(device=dev).manual_seed(2)
    edge = torch.rand(*shape, generator=g, device=dev)
    pi = _path_index(radius, shape[-2:])
    got = K.path_max_affinity(edge, pi.paths_by_length, pi.radius_floor)
    rf = pi.radius_floor
    assert got.shape == (*shape[:-2], len(pi.search_dst), shape[-2] - rf, shape[-1] - 2 * rf)
    assert torch.equal(got, K.path_max_affinity_plain(edge, pi.paths_by_length, rf))


# K7's forward, tiled: both radii (the walk's padded grid at 5 with its direction groups,
# IRN training's batch at 10), tiles partial in both axes, a map tied everywhere and one of
# four levels, and a radius-13 table, which the plan sends to the direct kernel
K7_FWD = [(5, (133, 170), "rand"), (10, (24, 128, 128), "rand"), (5, (2, 45, 77), "rand"),
          (10, (3, 47, 61), "rand"), (5, (21, 30), "tied"), (10, (2, 45, 77), "levels"),
          (13, (2, 40, 41), "rand"), (3, (1, 3, 5), "rand")]


@pytest.mark.parametrize("radius,shape,kind", K7_FWD)
def test_path_max_affinity_tiled(dev, radius, shape, kind):
    # bit for bit the plain version and the schedule tool's emulation of the launch its plan
    # makes (tiled or direct), with the plan and the launch's shape the tool's
    g = torch.Generator(device=dev).manual_seed(7)
    edge = torch.rand(*shape, generator=g, device=dev)
    if kind == "tied":
        edge = torch.full(shape, 0.625, device=dev)
    elif kind == "levels":
        edge = (edge * 4).floor() / 4
    pi = _path_index(radius, shape[-2:])
    rf, paths = pi.radius_floor, pi.paths_by_length
    steps = K.path_max.path_steps(paths)
    flat = edge.reshape(-1, *shape[-2:])
    plan = K.path_max.forward_plan(flat.shape[0], *shape[-2:], rf, len(steps),
                                   sum(map(len, steps)))
    assert plan == T.forward_plan(flat.shape[0], *shape[-2:], rf, len(steps),
                                  sum(map(len, steps)))
    assert plan["tiled"] == (radius <= 12)
    got = K.path_max_affinity(edge, paths, rf)
    assert torch.equal(got, K.path_max_affinity_plain(edge, paths, rf))
    launch = K.path_max.launch_shape()
    assert launch["tiled"] == plan["tiled"]
    if plan["tiled"]:
        assert launch == {"tiled": 1, "blocks": plan["blocks"], "threads": 256,
                          "rpt": plan["rpt"], "dir_groups": plan["dir_groups"],
                          "smem_bytes": plan["smem_bytes"]}
    want, writes = T.tiled_forward(flat.cpu().numpy(), steps, rf)
    assert (writes == 1).all()
    assert np.array_equal(got.reshape(want.shape).cpu().numpy(), want)


@pytest.mark.parametrize("groups", [1, 2, 3, 4, 8])
def test_path_max_affinity_direction_groups(dev, groups):
    # any count of direction groups covers every direction once (the measurement's
    # override): bit for bit the plan's launch
    pi = _path_index(5, (133, 170))
    edge = torch.rand(1, 133, 170, generator=torch.Generator(device=dev).manual_seed(8),
                      device=dev)
    steps = K.path_max.path_steps(pi.paths_by_length)
    got = K.path_max.forward_kernel(edge, steps, pi.radius_floor, groups)
    assert K.build.ops().path_max_affinity_launch_shape()["dir_groups"] == groups
    assert torch.equal(got, K.path_max_affinity_plain(edge, pi.paths_by_length,
                                                      pi.radius_floor))


@pytest.mark.parametrize("iterations,hw", [(1, (120, 160)), (300, (120, 160)), (300, (7, 5)),
                                           (300, (1, 9)), (300, (200, 200))])
def test_refine_centroids(dev, iterations, hw):
    # exact int32 centroids: a smooth field of a few pixels plus a push
    # towards the corners, so many centroids end clamped on the edge; the
    # 200 x 200 grid's table does not fit shared memory (the direct path);
    # the steps each warp took are the emulation's
    from tris_tpu_torch.tools import centroids_schedule as C

    H, W = hw
    g = torch.Generator(device=dev).manual_seed(3)
    field = F.avg_pool2d(torch.randn(1, 2, H + 8, W + 8, generator=g, device=dev), 9, 1)[0] * 12
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None].expand(H, W)
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :].expand(H, W)
    field = field + torch.stack([torch.sign(yy - H / 2), torch.sign(xx - W / 2)]) * 0.7
    got = K.refine_centroids(field, iterations)
    assert got.dtype == torch.int32 and got.shape == (2, H, W)
    assert torch.equal(got, K.refine_centroids_plain(field, iterations))
    if iterations == 300:   # some centroids end on the clamp edge
        assert bool(((got[0] == 0) | (got[0] == H - 1) | (got[1] == 0) | (got[1] == W - 1)).any())
    plan = K.refine_centroids_plan(H, W)
    assert plan == C.plan(H, W) and plan["staged"] == (hw != (200, 200))
    want, steps = C.refine_centroids_early_exit(field.cpu().numpy(), iterations)
    assert np.array_equal(got.cpu().numpy(), want)
    assert np.array_equal(K.refine_centroids_steps().cpu().numpy(), steps)


@pytest.mark.parametrize("hw", [(120, 160), (200, 200)])
@pytest.mark.parametrize("kind", ["zero", "two_cycle"])
def test_refine_centroids_exit(dev, hw, kind):
    # a zero field: every warp stops after its first step; a two-cycle field
    # (+1 on even columns, -1 on odd) never settles: every warp with a pixel takes all 300
    H, W = hw
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :].expand(H, W)
    field = torch.zeros(2, H, W, device=dev)
    if kind == "two_cycle":
        field[1] = torch.where(xx % 2 == 0, 1.0, -1.0)
    from tris_tpu_torch.tools import centroids_schedule as C

    got = K.refine_centroids(field)
    assert torch.equal(got, K.refine_centroids_plain(field))
    steps = K.refine_centroids_steps().cpu().numpy()
    assert np.array_equal(steps, C.refine_centroids_early_exit(field.cpu().numpy())[1])
    live = C.live_lanes(H, W) > 0   # the direct path's last block has warps with no pixel
    assert (steps[live] == (1 if kind == "zero" else 300)).all()


@pytest.mark.parametrize("H,W", [(32, 32), (64, 32), (32, 64)])
def test_walk_transition(dev, H, W):
    # the walk's buckets; exact against the plain version (the same powf,
    # column sums added in the same order, IEEE quotients), zero off the
    # band, columns summing to 1
    from tris_tpu_torch.pseudo.indexing import _padded_path_index

    pi = _padded_path_index(5, (H + 5, W + 10))
    dirs = np.asarray(pi.search_dst, np.int64)
    edge = F.pad(torch.rand(H, W, generator=torch.Generator(device=dev).manual_seed(4),
                            device=dev), (5, 5, 0, 5), value=1.0)
    aff = K.path_max_affinity(edge, pi.paths_by_length, pi.radius_floor)
    got = K.walk_transition(aff, dirs, H, W, 5 - pi.radius_floor, 10.0)
    want = K.walk_transition_plain(aff, dirs, H, W, 5 - pi.radius_floor, 10.0)
    assert got.shape == (H * W, H * W)
    assert torch.equal(got, want)
    band = (torch.arange(H * W, device=dev)[None] - torch.arange(H * W, device=dev)[:, None]).abs()
    assert bool((got[band > 4 * W + 4] == 0).all())
    assert torch.allclose(got.sum(0), torch.ones(H * W, device=dev), atol=1e-5)


def _banded(dev, M, N, band, seed, signed=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand(M, N, generator=g, device=dev) - (0.5 if signed else 0.0)
    if band is not None:
        off = torch.arange(N, device=dev)[None] - torch.arange(M, device=dev)[:, None]
        a = a * (off.abs() <= band)
    return a


@pytest.mark.parametrize("M,Kd,N,band_a,band_b,signed", [
    (1024, 1024, 1024, 36, 36, False),      # the 32x32 bucket's T squared (band 4 * 32 + 2)
    (1024, 1024, 1024, 288, 288, False),    # a later squaring, bands past a tile
    (2048, 2048, 2048, 1030, 1030, False),  # half the tiles off the product's band
    (16, 1024, 1024, None, 520, False),     # the thin step: 16 maps through T
    (200, 1000 - 1000 % 8, 1000, None, None, True)])  # partial tiles, signed, dense
def test_walk_matmul(dev, M, Kd, N, band_a, band_b, signed):
    # within one float32 rounding of the float64 product (both sum in
    # float64 and round once), zero off the product's band, and bit-equal to
    # the same product run dense: the skipped products are exact zeros
    a = _banded(dev, M, Kd, band_a, 5, signed)
    b = _banded(dev, Kd, N, band_b, 6, signed)
    got = K.walk_matmul(a, b, band_a, band_b)
    want = K.walk_matmul_plain(a, b)
    assert got.shape == (M, N)
    assert _err(got, want) <= float(want.abs().max()) * 2.0 ** -23
    assert torch.equal(got, K.walk_matmul(a, b))
    if band_a is not None and band_b is not None:
        off = torch.arange(N, device=dev)[None] - torch.arange(M, device=dev)[:, None]
        assert bool((got[off.abs() > band_a + band_b] == 0).all())


def _rounding(got, want):
    return _err(got, want) <= float(want.abs().max()) * 2.0 ** -23


@pytest.mark.parametrize("M", [1, 16, 17, 32, 33])
def test_walk_matmul_thin_boundary(dev, M):
    # M <= 32 takes the thin kernel, M = 33 the tensor-core kernel: both
    # within one rounding of the float64 product, banded equal to dense and
    # the same on a rerun, bit for bit; a zero row of a stays zero
    a = _banded(dev, M, 1024, None, 7)
    a[M // 2] = 0.0
    b = _banded(dev, 1024, 1000, 300, 8)
    got = K.walk_matmul(a, b, None, 300)
    assert got.shape == (M, 1000)
    assert _rounding(got, K.walk_matmul_plain(a, b))
    assert torch.equal(got, K.walk_matmul(a, b))
    assert torch.equal(got, K.walk_matmul(a, b, None, 300))
    assert bool((got[M // 2] == 0).all())


@pytest.mark.parametrize("M", [16, 256])
def test_walk_matmul_subnormal(dev, M):
    # float32 subnormals in a and in the result are kept, not flushed:
    # equal to the float64 product rounded once
    a = _banded(dev, M, 512, None, 9) * 1e-41
    b = _banded(dev, 512, 512, None, 10)
    got = K.walk_matmul(a, b)
    assert bool((a != 0).any()) and float(a.abs().max()) < 1.2e-38
    assert bool((got != 0).all()) and float(got.abs().max()) < 1.2e-38
    assert torch.equal(got, K.walk_matmul_plain(a, b))


def _corners(dev, rows, cols, rt, ct, seed):
    # one nonzero per rt x ct tile, at one of its four corners
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.zeros(rows, cols)
    for i in range(0, rows, rt):
        for k in range(0, cols, ct):
            r = min(i + rt, rows) - 1 if torch.rand(1, generator=g) < 0.5 else i
            c = min(k + ct, cols) - 1 if torch.rand(1, generator=g) < 0.5 else k
            x[r, c] = 0.5 + float(torch.rand(1, generator=g))
    return x.to(dev)


def test_walk_matmul_tile_corners(dev):
    # one nonzero per tile of the k-step grid, at its corners, on partial
    # tiles (M, K, N off the 128 / 16 grid): no such product is skipped
    a = _corners(dev, 300, 200, 128, 16, 11)
    b = _corners(dev, 200, 260, 16, 128, 12)
    got = K.walk_matmul(a, b)
    assert _rounding(got, K.walk_matmul_plain(a, b))
    assert bool((got != 0).sum() > 0)
    rows, cols = K.walk_tile_occupancy(a)[0], K.walk_tile_occupancy(b)[1]
    assert bool(rows.all()) and bool(cols.all())


def test_walk_matmul_zero_operand(dev):
    # an all-zero operand: every k-tile skipped, zeros written
    a = torch.zeros(256, 512, device=dev)
    b = _banded(dev, 512, 384, None, 13)
    assert not bool(K.walk_tile_occupancy(a)[0].any())
    assert bool((K.walk_matmul(a, b) == 0).all())
    assert bool((K.walk_matmul(b.T.contiguous(), a.T.contiguous()) == 0).all())
    assert bool((K.walk_matmul(a[:16], b) == 0).all())


def test_walk_matmul_skip_is_exact(dev):
    # T-like powers: a band that underflows to zero far from the diagonal,
    # with whole tiles empty; skip equals no skip and banded equals dense,
    # bit for bit, and some k-tiles are skipped
    n = 2048
    off = (torch.arange(n, device=dev)[None] - torch.arange(n, device=dev)[:, None]).abs()
    t = _banded(dev, n, n, 600, 14) * (off <= 150) + _banded(dev, n, n, 600, 15) * (off > 400)
    t = t * (off <= 600)
    rows, cols = K.walk_tile_occupancy(t)
    assert S.skipped_share(rows, cols, n, n, n, 600, 600)[0] > 0
    got = K.walk_matmul(t, t, 600, 600)
    assert _rounding(got, K.walk_matmul_plain(t, t))
    assert torch.equal(got, K.walk_square(t, t, torch.ones_like(rows), torch.ones_like(cols),
                                          600, 600))
    assert torch.equal(got, K.walk_matmul(t, t))


@pytest.mark.parametrize("R,C", [(2048, 2048), (300, 1000), (16, 20), (129, 132)])
def test_walk_tile_occupancy(dev, R, C):
    # exact against the plain version: random sparse entries, a corner
    # nonzero, an all-zero operand
    g = torch.Generator(device=dev).manual_seed(R + C)
    x = torch.rand(R, C, generator=g, device=dev)
    for case in (x * (x > 0.9995), torch.zeros_like(x), _corners(dev, R, C, 128, 128, R)):
        got, want = K.walk_tile_occupancy(case), K.walk_tile_occupancy_plain(case)
        assert all(torch.equal(g_, w_) for g_, w_ in zip(got, want))
        assert [tuple(m.shape) for m in got] == [(-(-R // 128), -(-C // 16)),
                                                 (-(-R // 16), -(-C // 128))]


def test_irnet_kernels_refuse(dev):
    x = torch.zeros(2, 8, 8, device=dev)
    with pytest.raises(TypeError, match="float32"):
        K.walk_matmul(x[0].bfloat16(), x[0].bfloat16())
    with pytest.raises(ValueError, match="bad shapes"):
        K.walk_matmul(torch.zeros(4, 12, device=dev), torch.zeros(12, 8, device=dev))
    with pytest.raises(TypeError, match="float32"):
        K.bilinear_resize(x.half(), (16, 16))  # bfloat16 is --bf16's: see below
    with pytest.raises(TypeError, match="float32"):
        K.path_max_affinity(x.bfloat16(), _path_index(3, (8, 8)).paths_by_length, 2)
    with pytest.raises(TypeError, match="float32"):
        K.refine_centroids(x.bfloat16())
    with pytest.raises(ValueError, match="share a flat offset"):
        from tris_tpu_torch.pseudo.indexing import transition_matrix

        transition_matrix(torch.zeros(12, 8, device=dev))     # W <= 2 * (radius - 1)
    # the ops themselves take no CPU tensor
    from tris_tpu_torch.kernels.response_head import taps_on

    ty = list(taps_on(8, 16, False, torch.device("cpu")))
    with pytest.raises(RuntimeError):
        K.build.ops().bilinear_resize(x.cpu(), ty, ty)
    with pytest.raises(RuntimeError):
        K.build.ops().refine_centroids(x[:2].cpu(), 3)
    with pytest.raises(RuntimeError):
        K.build.ops().walk_thin(x[0].cpu(), x[0].cpu(), 1, 1)
    with pytest.raises(RuntimeError):
        K.build.ops().walk_square(x[0].cpu(), x[0].cpu(), x[0].cpu().bool(),
                                  x[0].cpu().bool(), 1, 1)
    with pytest.raises(RuntimeError):
        K.build.ops().walk_tile_occupancy(x[0].cpu())


# ---- IRN training: K6's bilinear backward, K7's backward, K8 ------------------------------


def test_differentiable_wrappers_apply_an_autograd_function():
    # static, no card needed: the CUDA branches of each differentiable wrapper
    # (float32, and bfloat16 where --bf16 trains through it) call .apply of a
    # torch.autograd.Function defined beside it, each with a counted backward
    # (a kernel output returned bare would carry no grad_fn, and training
    # would get no gradient without an error)
    import importlib
    import inspect

    bf16_trained = ("mha_short", "cross_attn", "stage1_head", "batch_norm_act")
    wrappers = [("mha", "mha_short"), ("cross_attn", "cross_attn"),
                ("stage1_head", "stage1_head"), ("critic_input", "critic_input"),
                ("resize", "bilinear_resize"), ("path_max", "path_max_affinity"),
                ("irn_affinity", "irn_affinity_loss"), ("pixel_attn", "pixel_attn"),
                ("batch_norm", "batch_norm_act")]
    for mod_name, name in wrappers:
        mod = importlib.import_module(f"tris_tpu_torch.kernels.{mod_name}")
        src = inspect.getsource(getattr(mod, name))
        fns = [c for c in vars(mod).values() if isinstance(c, type)
               and issubclass(c, torch.autograd.Function) and f"{c.__name__}.apply(" in src]
        assert len(fns) == (2 if name in bf16_trained else 1), name
        for fn in fns:
            assert "backward" in vars(fn) and "build.count" in inspect.getsource(fn.backward)


def _input_grads(fn, *inputs, upstream):
    xs = [x.detach().clone().requires_grad_(True) for x in inputs]
    out = fn(*xs)
    out = out[0] if isinstance(out, tuple) else out
    (out * upstream).sum().backward()
    return [x.grad for x in xs]


@pytest.mark.parametrize("shape,size,align_corners", [
    ((2, 32, 64, 64), (128, 128), False),    # an edge tap's x2 at crop 512
    ((2, 32, 32, 32), (128, 128), False),    # the x4 taps
    ((3, 256, 16, 16), (32, 32), False),     # a dp tap's x2
    ((5, 7, 9), (13, 4), True), ((1, 1, 1), (3, 5), False), ((4, 6), (4, 11), False),
    ((2, 9, 13), (5, 6), False)])            # a shrink: taps skip inputs
def test_bilinear_resize_bwd(randn, shape, size, align_corners):
    # the adjoint gathered over tap ranges against autograd through the plain
    # taps (index backward, atomics) and through F.interpolate: 1e-5 of the
    # gradient's scale (f32 sums of up to 64 terms in other orders)
    K.reset_launches()
    x, up = randn(*shape), randn(*shape[:-2], *size)
    kern = lambda t: K.bilinear_resize(t, size, align_corners)  # noqa: E731
    (got,) = _input_grads(kern, x, upstream=up)
    assert K.launches["bilinear_resize"] == 1 and K.launches["bilinear_resize_bwd"] == 1
    (want,) = _input_grads(lambda t: K.bilinear_resize_plain(t, size, align_corners), x,
                           upstream=up)
    lib = F.interpolate
    (lib_g,) = _input_grads(lambda t: lib(t.reshape(-1, 1, *shape[-2:]), size=size,
                                          mode="bilinear", align_corners=align_corners
                                          ).reshape(up.shape), x, upstream=up)
    scale = max(float(want.abs().max()), 1e-30)
    assert got.shape == x.shape
    assert _err(got, want) <= 1e-5 * scale
    assert _err(got, lib_g) <= 1e-4 * scale
    assert torch.equal(got, _input_grads(kern, x, upstream=up)[0])   # no atomics: run to run


@pytest.mark.parametrize("shape,size,align_corners", [
    ((6, 256, 64, 64), (128, 128), False),   # the dp6 tap at 6 images: bands of 16
    ((651, 13, 12), (26, 24), True),         # bands of 16 across planes, a last band of 15
    ((300, 20, 20), (320, 320), False),      # the heads' x16: bands of 2 rows, 82 KB staged
    ((48, 64, 10, 10), (20, 20), False),     # decoder c4: w % 4 != 0, a column a thread
    ((24, 32, 32, 32), (128, 128), False),   # the edge taps' x4: R's lanes on rows
    ((5, 7, 9), (13, 4), True), ((1, 1, 1), (3, 5), False), ((4, 6), (4, 11), False),
    ((2, 9, 13), (5, 6), False),             # a shrink: taps skip inputs
    ((1, 2, 3000), (2, 70000), False)])      # a row's span past shared memory: direct
def test_bilinear_resize_bwd_equals_the_emulation(dev, shape, size, align_corners):
    # bit for bit with the schedule tool's emulation of the bands (the first design's fmaf
    # chains in its order), with the plan the tool gives and the launch the extension made
    from tris_tpu_torch.tools import resize_schedule as RS

    g = torch.Generator(device=dev).manual_seed(len(shape))
    x = torch.randn(*shape, generator=g, device=dev, requires_grad=True)
    up = torch.randn(*shape[:-2], *size, generator=g, device=dev)
    K.reset_launches()
    (got,) = torch.autograd.grad(K.bilinear_resize(x, size, align_corners), x, up)
    planes = math.prod(shape[:-2])
    plan = K.bilinear_resize_bwd_plan(planes, *shape[-2:], *size)
    assert plan == RS.bwd_plan(planes, *shape[-2:], *size)
    assert K.bilinear_resize_bwd_launch_shape() == {
        "blocks": plan["blocks"], "threads": plan["threads"], "band": plan["band"],
        "span_rows": plan["span_rows"], "vec": plan["vec"], "staged": plan["staged"],
        "smem_bytes": plan["smem_bytes"]}
    want = RS.direct_resize_bwd(up.cpu(), shape[-2:], align_corners) if not plan["staged"] \
        else RS.banded_resize_bwd(up.cpu(), shape[-2:], align_corners)
    assert torch.equal(got.cpu(), want)


def test_bilinear_resize_bwd_plan_refuses(dev):
    with pytest.raises(ValueError, match="bad shape"):
        K.bilinear_resize_bwd_plan(2, 0, 4, 8, 8)


def _tied_edge(dev, shape, levels, seed):
    """An edge map of a few distinct values (many exact ties along paths) with
    a patch of noise."""
    g = torch.Generator(device=dev).manual_seed(seed)
    edge = torch.randint(0, levels, shape, generator=g, device=dev).float() / levels
    edge[..., :shape[-2] // 3, :] = torch.rand(*shape[:-2], shape[-2] // 3, shape[-1],
                                               generator=g, device=dev)
    return edge


@pytest.mark.parametrize("radius,shape", [(10, (2, 128, 128)), (5, (1, 37, 18)), (5, (3, 16, 16)),
                                          (10, (1, 19, 23)), (3, (2, 5, 6)), (10, (1, 45, 77))])
@pytest.mark.parametrize("tied", [False, True])
def test_path_max_affinity_bwd(dev, radius, shape, tied):
    # against amax's autograd (which, like JAX's reduce_max VJP, splits a
    # tied max evenly): run in float64, within 1e-6 of the gradient's scale
    # (the kernel adds each pixel's terms, up to 2134 at radius 10, in
    # double and rounds once); in float32, whose sums round at every add,
    # within 1e-5; bit for bit against the schedule tool's emulation of the
    # gather (the same double terms in the same order); ties planted by
    # quantising the edge map; one launch; ragged last tiles at 45 x 77
    pi = _path_index(radius, shape[-2:])
    g = torch.Generator(device=dev).manual_seed(7)
    edge = (_tied_edge(dev, shape, 4, 8) if tied
            else torch.rand(*shape, generator=g, device=dev))
    rf = pi.radius_floor
    up = torch.randn(*shape[:-2], len(pi.search_dst), shape[-2] - rf, shape[-1] - 2 * rf,
                     generator=g, device=dev)
    K.reset_launches()
    (got,) = _input_grads(lambda e: K.path_max_affinity(e, pi.paths_by_length, rf), edge,
                          upstream=up)
    assert K.launches["path_max_affinity_bwd"] == 1
    plain = lambda e: K.path_max_affinity_plain(e, pi.paths_by_length, rf)  # noqa: E731
    (want,) = _input_grads(plain, edge, upstream=up)
    (want64,) = _input_grads(plain, edge.double(), upstream=up.double())
    scale = float(want64.abs().max())
    assert _err(got, want64) <= 1e-6 * scale
    assert _err(got, want) <= 1e-5 * scale
    assert torch.equal(got, _input_grads(lambda e: K.path_max_affinity(e, pi.paths_by_length, rf),
                                         edge, upstream=up)[0])   # the same run to run
    steps = K.path_max.path_steps(pi.paths_by_length)
    e, u = edge.reshape(-1, *shape[-2:]).cpu().numpy(), up.reshape(-1, *up.shape[-3:]).cpu().numpy()
    emulated = T.gather(e, [u[:, d] for d in range(len(steps))], steps, rf)
    assert np.array_equal(got.reshape(emulated.shape).cpu().numpy(), emulated)
    if tied:   # a first-argmax routing would be far off
        ch, cw = shape[-2] - rf, shape[-1] - 2 * rf
        n_tied = 0
        for path in steps:
            w = torch.stack([edge[..., dy:dy + ch, rf + dx:rf + dx + cw] for dy, dx in path])
            n_tied += int(((w == w.amax(0)).sum(0) > 1).sum())
        assert n_tied > 0


def _irn_inputs(dev, B, H, W, radius, seed, edge="random"):
    pi = _path_index(radius, (H, W))
    g = torch.Generator(device=dev).manual_seed(seed)
    labels = torch.tensor([0, 1, 255], dtype=torch.uint8, device=dev)[
        torch.randint(0, 3, (B, H // 4 + 1, W // 4 + 1), generator=g, device=dev)]
    labels = labels.repeat_interleave(4, 1).repeat_interleave(4, 2)[:, :H, :W].contiguous()
    if edge == "tied":       # a few levels (zeros among them: aff = 1) and a patch of noise
        e = _tied_edge(dev, (B, H, W), 4, seed)
    elif edge == "flat":     # one value: every step of every path ties
        e = torch.full((B, H, W), 0.375, device=dev)
    else:
        e = torch.rand(B, H, W, generator=g, device=dev)
    dp = 3 * torch.randn(B, 2, H, W, generator=g, device=dev)
    dp[:, :, : H // 4] = torch.round(dp[:, :, : H // 4])   # exact zeros of |pair - target|
    return pi, labels, e, dp


def _check_irn_affinity(pi, labels, edge, dp, w):
    """The fused loss against the plain version (sums 1e-5 relative, counts
    exact), its launches, and its gradients against the plain version in
    float64 (d edge 1e-6 and d dp 1e-5 of their scales) and bit for bit
    against the schedule tool's emulation of the kernels' arithmetic."""
    IL = importlib.import_module("tris_tpu_torch.kernels.irn_loss")
    K.reset_launches()
    sums, counts = K.irn_affinity_loss(labels, edge, dp, pi)
    want_s, want_c = K.irn_affinity_loss_plain(labels, edge, dp, pi)
    assert K.launches["irn_affinity_loss"] == 2 and K.launches["path_max_affinity"] == 0
    assert counts.dtype == torch.int64 and torch.equal(counts, want_c)
    assert bool(((sums.double() - want_s.double()).abs() <= 1e-5 * want_s.double().abs()).all())
    kern = lambda e, d: K.irn_affinity_loss(labels, e, d, pi)  # noqa: E731
    got_g = _input_grads(kern, edge, dp, upstream=w)
    assert K.launches["irn_affinity_loss_bwd"] == 1 and K.launches["path_max_affinity_bwd"] == 0
    want_g = _input_grads(lambda e, d: K.irn_affinity_loss_plain(labels, e, d, pi), edge.double(),
                          dp.double(), upstream=w.double())
    assert _err(got_g[0], want_g[0]) <= 1e-6 * float(want_g[0].abs().max())
    assert _err(got_g[1], want_g[1]) <= 1e-5 * float(want_g[1].abs().max())
    d_edge, d_dp = T.fused_backward(labels.cpu().numpy(), edge.cpu().numpy(), dp.cpu().numpy(),
                                    w.cpu().numpy(), K.path_max.path_steps(pi.paths_by_length),
                                    pi.radius_floor, IL.EPS, IL.ONE_EPS, IL.MAX_VALID)
    assert np.array_equal(got_g[0].cpu().numpy(), d_edge)
    assert np.array_equal(got_g[1].cpu().numpy(), d_dp)
    again = K.irn_affinity_loss(labels, edge, dp, pi)
    assert torch.equal(again[0], sums) and torch.equal(again[1], counts)   # a fixed order
    assert all(torch.equal(a, b) for a, b in zip(_input_grads(kern, edge, dp, upstream=w), got_g))
    return sums, counts


@pytest.mark.parametrize("B,H,W,radius,edge", [
    (2, 128, 128, 10, "random"), (2, 128, 128, 10, "tied"),    # the training step's shape
    (1, 16, 16, 5, "random"), (3, 21, 30, 5, "tied"), (1, 19, 23, 10, "random"),
    (1, 45, 77, 10, "tied"), (2, 37, 41, 5, "flat")])          # ragged last tiles
def test_irn_loss(dev, B, H, W, radius, edge):
    # IRN's loss fused with K7 (K7 + K8) from the edge map
    pi, labels, e, dp = _irn_inputs(dev, B, H, W, radius, 9, edge)
    w = torch.tensor([0.3, -1.2, 0.7, 2.0, -0.4], device=dev)
    sums, counts = _check_irn_affinity(pi, labels, e, dp, w)
    assert int(counts.sum()) > 0 and (H < 32 or bool((counts > 0).all()))


def test_irn_loss_all_ignored(dev):
    # every label 255: no pair counts, the sums and both gradients are 0
    pi, labels, e, dp = _irn_inputs(dev, 2, 40, 33, 10, 3)
    labels = torch.full_like(labels, 255)
    w = torch.tensor([0.3, -1.2, 0.7, 2.0, -0.4], device=dev)
    sums, counts = _check_irn_affinity(pi, labels, e, dp, w)
    assert counts.tolist() == [0, 0, 0] and not bool(sums.any())
    d_edge, d_dp = _input_grads(lambda a, b: K.irn_affinity_loss(labels, a, b, pi), e, dp,
                                upstream=w)
    assert not bool(d_edge.any()) and not bool(d_dp.any())


def test_irn_loss_honours_another_threshold(dev, monkeypatch):
    # labels 0, 1, 2, 5 and 255 with irn_loss.MAX_VALID at 3 (the launchers'
    # argument): the 5s are as invalid as 255; counts exact and sums within
    # 1e-5 relative of the plain version, the gradients as test_irn_loss's
    IL = importlib.import_module("tris_tpu_torch.kernels.irn_loss")
    pi, labels, e, dp = _irn_inputs(dev, 2, 21, 30, 5, 4, "tied")
    g = torch.Generator(device=dev).manual_seed(5)
    labels = torch.tensor([0, 1, 2, 5, 255], dtype=torch.uint8, device=dev)[
        torch.randint(0, 5, labels.shape, generator=g, device=dev)]
    counts_21 = K.irn_affinity_loss(labels, e, dp, pi)[1]
    monkeypatch.setattr(IL, "MAX_VALID", 3)
    w = torch.tensor([0.3, -1.2, 0.7, 2.0, -0.4], device=dev)
    _, counts = _check_irn_affinity(pi, labels, e, dp, w)
    assert bool((counts > 0).all()) and not torch.equal(counts, counts_21)


@pytest.mark.parametrize("kind,B,H,W,radius", [
    (0, 24, 128, 128, 10), (1, 24, 128, 128, 10), (2, 24, 128, 128, 10),   # the IRN step
    (2, 1, 133, 170, 5), (3, 1, 133, 170, 5),                               # the walk's grid
    (3, 24, 128, 128, 10), (3, 2, 45, 77, 5),
    (0, 1, 45, 77, 10), (1, 1, 45, 77, 10), (2, 3, 21, 30, 5), (1, 2, 5, 6, 3)])
def test_path_tile_plan(dev, kind, B, H, W, radius):
    # the extension's plan is the schedule tool's (launchers.h's rule read twice)
    rf = _path_index(radius, (H, W)).radius_floor
    assert K.path_max.tile_plan(kind, B, H, W, rf) == T.plan(kind, B, H, W, rf)


def test_irn_training_kernels_refuse(dev):
    pi, labels, e, dp = _irn_inputs(dev, 1, 16, 16, 5, 1)
    with pytest.raises(ValueError, match="bad inputs"):
        K.irn_affinity_loss(labels.int(), e, dp, pi)
    with pytest.raises(ValueError, match="bad inputs"):
        K.irn_affinity_loss(labels, e[:, :-1], dp, pi)
    with pytest.raises(TypeError, match="float32"):
        K.irn_affinity_loss(labels, e.double(), dp, pi)
    with pytest.raises(ValueError, match="irn_affinity_loss"):   # no kernel reads aff
        K.irn_loss(labels, K.path_max_affinity(e, pi.paths_by_length, pi.radius_floor), dp,
                   pi.search_dst, pi.radius_floor)
    other = _path_index(5, (16, 16))
    other.search_dst = np.asarray(other.search_dst)[::-1].copy()
    with pytest.raises(ValueError, match="first steps"):
        K.irn_affinity_loss(labels, e, dp, other)
    big = _path_index(13, (40, 40))   # 4652 steps: past the tiled kernels' table
    x = torch.rand(1, 40, 40, device=dev, requires_grad=True)
    with pytest.raises(ValueError, match="at most"):
        K.path_max_affinity(x, big.paths_by_length, big.radius_floor)
    with pytest.raises(ValueError, match="at most"):
        K.irn_affinity_loss(torch.zeros(1, 40, 40, dtype=torch.uint8, device=dev), x.detach(),
                            torch.zeros(1, 2, 40, 40, device=dev), big)
    with torch.no_grad():   # the forward alone takes any table
        K.path_max_affinity(x, big.paths_by_length, big.radius_floor)
    steps, offsets = K.path_max.tile_table(K.path_max.path_steps(pi.paths_by_length),
                                           pi.radius_floor)
    with pytest.raises(RuntimeError, match="5 sums"):
        K.build.ops().irn_affinity_loss_bwd(labels, e, dp, torch.zeros(4, device=dev), steps,
                                            offsets, pi.radius_floor, 1e-5, 1.00001, 21)
    with pytest.raises(RuntimeError, match="do not match"):
        K.build.ops().irn_affinity_loss(labels, e[:, :, :-1].contiguous(), dp, steps, offsets,
                                        pi.radius_floor, 1e-5, 1.00001, 21)


# ---- stage 2: K11 (PixelAttention's attention) and K12 (the EMA update) -------------------


@pytest.mark.parametrize("N,HW,C,T,S", [
    (3, 63, 200, 20, 1),      # 7x9 pixels, channels off the 4-float loads
    (2, 100, 2048, 20, 1),    # c4's shape
    (2, 17, 48, 1, 3),        # one token (softmax of one logit), pairs sharing an image
    (1, 40, 130, 32, 4),      # the most tokens, S = 4 as eval
    # the token buckets' edges (8 | 16 | 20 | 24 | 32), pixels off the 32-pixel tile
    (2, 33, 64, 8, 2), (1, 50, 96, 9, 1), (2, 31, 256, 16, 4), (1, 70, 512, 17, 2),
    (2, 65, 132, 21, 1), (1, 45, 260, 24, 4), (2, 100, 1024, 25, 1),
    # past 8 ranks of 256 channels: sub-slices, with 16-byte and 4-byte loads
    (1, 20, 4100, 20, 1), (1, 37, 2050, 12, 2),
])
def test_pixel_attn(randn, N, HW, C, T, S):
    # forward within 1e-5 of the output's scale, each gradient within 1e-4
    # of its max (dq sums over the image's S pairs), against the plain
    # version's autograd; 4-byte loads where C % 4 != 0; nothing atomic: the
    # same gradient run to run
    q, lk, lv = randn(N, HW, C), randn(N * S, T, C), randn(N * S, T, C)
    K.reset_launches()
    with torch.no_grad():
        got, want = K.pixel_attn(q, lk, lv, S), K.pixel_attn_plain(q, lk, lv, S)
    assert K.launches["pixel_attn"] == 1 and got.shape == (N * S, HW, C)
    assert K.pixel_attn_launch_shape("pixel_attn")["load_bytes"] == (16 if C % 4 == 0 else 4)
    assert _err(got, want) <= 1e-5 * float(want.abs().max())
    up = randn(N * S, HW, C)
    g = _input_grads(lambda *x: K.pixel_attn(*x, S), q, lk, lv, upstream=up)
    w = _input_grads(lambda *x: K.pixel_attn_plain(*x, S), q, lk, lv, upstream=up)
    assert K.launches["pixel_attn_bwd"] == 2
    for name in ("pixel_attn_bwd_probs_dq", "pixel_attn_bwd_dkv"):
        assert K.pixel_attn_launch_shape(name)["load_bytes"] == (16 if C % 4 == 0 else 4)
    for a, b in zip(g, w):
        assert _err(a, b) <= 1e-4 * float(b.abs().max())
    assert all(torch.equal(a, b) for a, b in zip(
        g, _input_grads(lambda *x: K.pixel_attn(*x, S), q, lk, lv, upstream=up)))


@pytest.mark.parametrize("N,HW,C,T,S", [(1, 1600, 512, 40, 1), (1, 400, 1024, 40, 1),
                                         (1, 100, 2048, 40, 1), (2, 45, 260, 33, 2),
                                         (1, 100, 2048, 48, 1), (3, 37, 130, 41, 1)])
def test_pixel_attn_forward_past_32_tokens(randn, N, HW, C, T, S):
    # the forward's buckets 40 and 48 (the demo's two phrases: T = 40 at stage 2's c2, c3 and
    # c4): within 1e-5 of the output's scale against the plain version, one launch, the
    # bucket and grid the schedule tool's; a gradient past 32 tokens is refused
    from tris_tpu_torch.tools.pixel_attn_schedule import block_counts

    q, lk, lv = randn(N, HW, C), randn(N * S, T, C), randn(N * S, T, C)
    K.reset_launches()
    with torch.no_grad():
        got, want = K.pixel_attn(q, lk, lv, S), K.pixel_attn_plain(q, lk, lv, S)
    assert K.launches["pixel_attn"] == 1 and got.shape == (N * S, HW, C)
    assert _err(got, want) <= 1e-5 * float(want.abs().max())
    shape = K.pixel_attn_launch_shape("pixel_attn")
    want_grid = block_counts(N, S, HW, C, T)["pixel_attn"]
    assert shape["t_bucket"] == (40 if T <= 40 else 48)
    assert {k: shape[k] for k in want_grid} == want_grid
    with pytest.raises(ValueError, match="32 with a gradient"):
        K.pixel_attn(q.requires_grad_(), lk, lv, S)


@pytest.mark.parametrize("N,S,HW,C", [(48, 1, 1600, 512), (48, 1, 400, 1024), (48, 1, 100, 2048),
                                      (8, 4, 1600, 512), (8, 4, 100, 2048), (3, 2, 45, 260)])
def test_pixel_attn_launches_the_schedules_grid(randn, N, S, HW, C):
    # the grids the launchers made are those tools/pixel_attn_schedule.py
    # emulates (the CPU tests' tile map): the paths' shapes and one off them
    from tris_tpu_torch.tools.pixel_attn_schedule import block_counts

    want = block_counts(N, S, HW, C, 20)
    q, lk, lv = (x.requires_grad_() for x in (randn(N, HW, C), randn(N * S, 20, C),
                                              randn(N * S, 20, C)))
    out = K.pixel_attn(q, lk, lv, S)
    torch.autograd.grad(out, (q, lk, lv), torch.ones_like(out))
    for name in ("pixel_attn", "pixel_attn_bwd_probs_dq", "pixel_attn_bwd_dkv"):
        got = K.pixel_attn_launch_shape(name)
        assert got["load_bytes"] == 16
        assert {k: got[k] for k in want[name]} == want[name], name


def test_pixel_attn_saves_nothing_without_grad(randn):
    q, lk = randn(2, 9, 64).requires_grad_(), randn(2, 20, 64)
    with torch.no_grad():
        out = K.pixel_attn(q, lk, lk, 1)
    assert out.grad_fn is None


def test_pixel_attn_refuses(randn):
    # the shapes csrc/launchers.h::pixel_attn_takes refuses raise ValueError in
    # Python, before a launch; the extension's rule is the schedule tool's
    from tris_tpu_torch.kernels import build
    from tris_tpu_torch.tools import pixel_attn_schedule

    q, lk = randn(2, 9, 64), randn(2, 33, 64)
    with pytest.raises(ValueError, match="1 to 48 tokens, 32 with a gradient: "
                                         "csrc/launchers.h::pixel_attn_takes"):
        K.pixel_attn(q, randn(2, 49, 64), randn(2, 49, 64), 1)
    with pytest.raises(ValueError, match="do not take T=33, C=64, S=1"):
        K.pixel_attn(q.requires_grad_(), lk, lk, 1)
    with pytest.raises(ValueError, match="bad shapes"):
        K.pixel_attn(q, lk[:, :20], lk[:, :20], 2)
    with pytest.raises(TypeError, match="float32"):
        K.pixel_attn(q.double(), lk[:, :20].double(), lk[:, :20].double(), 1)
    with pytest.raises(RuntimeError):
        K.build.ops().pixel_attn(q.cpu(), lk.cpu(), lk.cpu(), 1, 8.0)
    for T, C, S in [(1, 1, 1), (32, 2048, 64), (33, 64, 1), (0, 64, 1), (20, 0, 1), (20, 64, 0),
                    (20, 4100, 52), (31, 3, 1000), (40, 512, 1), (48, 2048, 3), (49, 64, 1)]:
        for backward in (False, True):
            assert build.ops().pixel_attn_takes(T, C, S, backward) == \
                bool(pixel_attn_schedule.takes(T, C, S, backward))


@pytest.mark.parametrize("decay", [0.0, 0.37003947, 0.9999])
def test_ema_update(dev, decay):
    # one launch over leaves of odd and chunk-straddling lengths, a 0-d leaf
    # and an int64 buffer: float leaves bit for bit as the plain version
    # (each product and the sum rounded alone), the integer one copied
    g = torch.Generator(device=dev).manual_seed(3)
    shapes = [(), (1,), (7, 3), (4097,), (3, 4096 + 5), (2, 2, 3, 3)]
    ema = [torch.randn(s, generator=g, device=dev) for s in shapes] + \
        [torch.tensor(4, device=dev)]
    model = [torch.randn(s, generator=g, device=dev) for s in shapes] + \
        [torch.tensor(9, device=dev)]
    want = [e.clone() for e in ema]
    K.ema_update_plain(want, model, decay)
    table = K.EmaTable(ema, model)
    assert table.n_chunks == 1 + 1 + 1 + 2 + 4 + 1 + 1
    K.reset_launches()
    K.ema_update(ema, model, decay, table=table)
    assert K.launches["ema_update"] == 1
    for e, w in zip(ema, want):
        assert e.dtype == w.dtype and torch.equal(e, w)
    assert int(ema[-1]) == 9
    if decay == 0.0:
        assert all(torch.equal(e, p) for e, p in zip(ema, model))


def test_ema_update_refuses(dev):
    a = torch.zeros(3, device=dev)
    with pytest.raises(ValueError, match="must match"):
        K.ema_update([a], [torch.zeros(4, device=dev)], 0.5)
    with pytest.raises(TypeError, match="float32 or int64"):
        K.ema_update([a.double()], [a.double()], 0.5)
    with pytest.raises(ValueError, match="teacher leaves"):
        K.ema_update([a, a], [a], 0.5)
    with pytest.raises(ValueError, match="expected CUDA"):
        K.ema_update([a], [a.cpu()], 0.5)


# ---- K13: BatchNorm with the activation that follows it -----------------------------------


def _bn_inputs(dev, shape, act, residual, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    C = shape[1]

    def randn(*s):
        return torch.randn(*s, generator=g, device=dev)

    x = 1.5 * randn(*shape) + randn(1, C, 1, 1)
    w, b = 1 + 0.3 * randn(C), 0.5 * randn(C)
    rm, rv = randn(C), 0.5 + torch.rand(C, generator=g, device=dev)
    slope = torch.full((1,), 0.25, device=dev) if act == "prelu" else None
    return x, w, b, rm, rv, slope, randn(*shape) if residual else None


def _bn_call(fn, x, w, b, rm, rv, slope, res, mode, act):
    return fn(x, w, b, rm, rv, training=mode != "eval", update_stats=mode == "train",
              momentum=0.1, eps=1e-5, act=act, slope=slope, residual=res)


def _bn_grads(fn, x, w, b, rm, rv, slope, res, mode, act, cot):
    ins = [t.detach().clone().requires_grad_() for t in (x, w, b, slope, res) if t is not None]
    sl = ins[3] if slope is not None else None
    r = ins[-1] if res is not None else None
    y = _bn_call(fn, ins[0], ins[1], ins[2], rm.clone(), rv.clone(), sl, r, mode, act)
    return torch.autograd.grad(y, ins, cot)


BN_ACTS = [("none", False), ("relu", False), ("relu", True), ("none", True), ("prelu", False)]


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (4, 8, 16, 16), (1, 1, 1, 1), (2, 1, 64, 64),
                                   (3, 5, 1, 3), (2, 16, 10, 10)])
@pytest.mark.parametrize("act,residual", BN_ACTS)
@pytest.mark.parametrize("mode", ["train", "eval", "teacher"])
def test_batch_norm_act(dev, shape, act, residual, mode):
    # y within 1e-5 of its scale against the plain version (the eval fold
    # bit for bit); the running buffers within 1e-6 of their scale from their
    # float64 update (the teacher's untouched); every gradient within 1e-4 of
    # its max against the plain version (eval: dx bit for bit)
    x, w, b, rm, rv, slope, res = _bn_inputs(dev, shape, act, residual, 3)
    rm_k, rv_k, rm_p, rv_p = rm.clone(), rv.clone(), rm.clone(), rv.clone()
    got = _bn_call(K.batch_norm_act, x, w, b, rm_k, rv_k, slope, res, mode, act)
    want = _bn_call(K.batch_norm_act_plain, x, w, b, rm_p, rv_p, slope, res, mode, act)
    if mode == "eval":
        assert torch.equal(got, want)
    assert _err(got, want) <= 1e-5 * float(want.abs().max())
    if mode == "train":
        x64 = x.double()
        n = x[:, 0].numel()
        m64 = x64.mean(dim=(0, 2, 3))
        v64 = ((x64 - m64[:, None, None]) ** 2).mean(dim=(0, 2, 3)) * (n / max(n - 1, 1))
        for buf, old, new in ((rm_k, rm, m64), (rv_k, rv, v64)):
            ref = 0.9 * old.double() + 0.1 * new
            assert _err(buf, ref) <= 1e-6 * float(ref.abs().max())
    else:
        assert torch.equal(rm_k, rm) and torch.equal(rv_k, rv)
    cot = (torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(9), device=dev),)
    got_g = _bn_grads(K.batch_norm_act, x, w, b, rm, rv, slope, res, mode, act, cot)
    want_g = _bn_grads(K.batch_norm_act_plain, x, w, b, rm, rv, slope, res, mode, act, cot)
    for a, c in zip(got_g, want_g):
        assert _err(a, c) <= 1e-4 * max(float(c.abs().max()), 1e-6)
    if mode == "eval":
        assert torch.equal(got_g[0], want_g[0])


def test_batch_norm_act_unaligned_data(dev):
    # a contiguous view 4 bytes into its storage: the scalar loads
    x, w, b, rm, rv, slope, res = _bn_inputs(dev, (2, 6, 8, 8), "relu", True, 4)
    xs = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape).copy_(x)
    rs = torch.empty(res.numel() + 1, device=dev)[1:].view(res.shape).copy_(res)
    for mode in ("train", "eval"):
        got = _bn_call(K.batch_norm_act, xs, w, b, rm.clone(), rv.clone(), None, rs, mode, "relu")
        want = _bn_call(K.batch_norm_act_plain, x, w, b, rm.clone(), rv.clone(), None, res, mode,
                        "relu")
        assert _err(got, want) <= 1e-5 * float(want.abs().max())
        cot = (torch.ones_like(x),)
        got_g = _bn_grads(K.batch_norm_act, xs, w, b, rm, rv, None, rs, mode, "relu", cot)
        want_g = _bn_grads(K.batch_norm_act_plain, x, w, b, rm, rv, None, res, mode, "relu", cot)
        for a, c in zip(got_g, want_g):
            assert _err(a, c) <= 1e-4 * max(float(c.abs().max()), 1e-6)


def _bn_plan(x, training, backward, act):
    from tris_tpu_torch.kernels.batch_norm import ACTS

    N, C = x.shape[:2]
    return dict(K.build.ops().batch_norm_plan(N, C, x[0, 0].numel(), training, backward,
                                              ACTS[act], -1))


@pytest.mark.parametrize("shape,design", [((4, 64, 40, 40), 1), ((1, 2, 256, 256), 0)])
def test_batch_norm_act_launches_and_repeats(dev, shape, design):
    # a train forward and its backward launch what the plan says (fused: 1
    # and 1; two-pass: statistics 2 and apply 1, then 3), an eval forward 1;
    # the backward and the statistics the same bits run to run
    x, w, b, rm, rv, slope, res = _bn_inputs(dev, shape, "relu", True, 5)
    fwd, bwd = _bn_plan(x, True, False, "relu"), _bn_plan(x, True, True, "relu")
    assert fwd["design"] == bwd["design"] == design
    assert (fwd["launches"], bwd["launches"]) == ((1, 1) if design else (3, 3))
    cot = (torch.randn_like(x),)
    K.reset_launches()
    first = _bn_grads(K.batch_norm_act, x, w, b, rm, rv, None, res, "train", "relu", cot)
    assert K.launches["batch_norm"] == fwd["launches"]
    assert K.launches["batch_norm_bwd"] == bwd["launches"]
    again = _bn_grads(K.batch_norm_act, x, w, b, rm, rv, None, res, "train", "relu", cot)
    assert all(torch.equal(a, c) for a, c in zip(first, again))
    ops = K.build.ops()
    s1 = ops.batch_norm_fwd(x, w, b, res, None, None, None, 1, 0.1, 1e-5, -1)[1]
    assert torch.equal(s1, ops.batch_norm_fwd(x, w, b, res, None, None, None, 1, 0.1, 1e-5,
                                              -1)[1])
    assert torch.equal(s1, ops.batch_norm_stats(x, None, None, 0.1, 1e-5)) or design == 1
    K.reset_launches()
    with torch.no_grad():
        _bn_call(K.batch_norm_act, x, w, b, rm, rv, None, None, "eval", "relu")
    assert K.launches["batch_norm"] == 1 and K.launches["batch_norm_bwd"] == 0


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (4, 16, 16, 16), (3, 5, 1, 3)])
@pytest.mark.parametrize("act,residual", BN_ACTS)
def test_batch_norm_cross_rank_route(dev, shape, act, residual):
    # the wrapper's cross-rank route on one process, its gather a stand-in for
    # two ranks that hold the same half: y, dx, dweight, dbias and dslope
    # within 1e-5 of their scale against the route reference's autograd on
    # the concatenated batch (a rank's parameter gradients half of it), the
    # running buffers moved by the global count, and its launches counted
    from tris_tpu_torch.kernels.batch_norm import (
        RANKS_LAUNCHES, batch_norm_act_reference, ranks_backward, ranks_forward)

    x, w, b, rm, rv, slope, res = _bn_inputs(dev, shape, act, residual, 5)
    cot = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(6), device=dev)

    def two_ranks(p):
        return torch.cat([p, p], 1)

    rm_k, rv_k = rm.clone(), rv.clone()
    K.reset_launches()
    y, mean, rstd = ranks_forward(x, w, b, slope, res, rm_k, rv_k, 0.1, 1e-5, act,
                                  gather=two_ranks)
    dx, dw, db, dslope, _ = ranks_backward(cot, x, y if act == "relu" else None, mean, rstd, w, b,
                                           slope, act, residual, gather=two_ranks)
    assert K.launches["batch_norm"] == RANKS_LAUNCHES["fwd"]
    assert K.launches["batch_norm_bwd"] == RANKS_LAUNCHES["bwd"]
    ins = [torch.cat([x, x])] + [t.clone() for t in (w, b)] + ([slope.clone()] if act == "prelu"
                                                               else [])
    ins = [t.requires_grad_() for t in ins]
    rm_r, rv_r = rm.clone(), rv.clone()
    want = batch_norm_act_reference(ins[0], ins[1], ins[2], rm_r, rv_r, training=True,
                                    update_stats=True, momentum=0.1, eps=1e-5, act=act,
                                    slope=ins[3] if act == "prelu" else None,
                                    residual=None if res is None else torch.cat([res, res]))
    grads = torch.autograd.grad(want, ins, torch.cat([cot, cot]))
    n = x.shape[0]
    pairs = [(y, want.detach()[:n]), (dx, grads[0][:n]), (dw, grads[1] / 2), (db, grads[2] / 2)]
    if act == "prelu":
        pairs.append((dslope.reshape(1), grads[3] / 2))
    for got, ref in pairs:
        assert _err(got, ref) <= 1e-5 * max(float(ref.abs().max()), 1e-6)
    for buf, ref in ((rm_k, rm_r), (rv_k, rv_r)):
        assert _err(buf, ref) <= 1e-6 * float(ref.abs().max())


def _bn_against_reference(x, w, b, rm, rv, slope, res, mode, act):
    """The forward against the plain version (1e-5 of its scale) and the route
    reference (bit for bit, or 1e-5 where a channel's statistics round apart
    from the reference's), the backward against the plain version (1e-4 of
    each gradient's max) and bit for bit run to run."""
    from tris_tpu_torch.kernels.batch_norm import batch_stats_plain

    got = _bn_call(K.batch_norm_act, x, w, b, rm.clone(), rv.clone(), slope, res, mode, act)
    want = _bn_call(K.batch_norm_act_plain, x, w, b, rm.clone(), rv.clone(), slope, res, mode,
                    act)
    assert _err(got, want) <= 1e-5 * float(want.abs().max())
    if mode != "eval":
        ref = _bn_call(K.batch_norm_act_reference, x, w, b, rm.clone(), rv.clone(), slope, res,
                       mode, act)
        if not torch.equal(got, ref):
            stats = K.build.ops().batch_norm_fwd(
                x.contiguous(), w, b, None if res is None else res.contiguous(), slope, None,
                None, {"none": 0, "relu": 1, "prelu": 2}[act], 0.1, 1e-5, -1)[1]
            assert not torch.equal(stats, torch.stack(batch_stats_plain(x, 1e-5)))
            assert _err(got, ref) <= 1e-5 * float(ref.abs().max())
    cot = (torch.randn(x.shape, generator=torch.Generator(device=x.device).manual_seed(9),
                       device=x.device),)
    got_g = _bn_grads(K.batch_norm_act, x, w, b, rm, rv, slope, res, mode, act, cot)
    want_g = _bn_grads(K.batch_norm_act_plain, x, w, b, rm, rv, slope, res, mode, act, cot)
    for a, c in zip(got_g, want_g):
        assert _err(a, c) <= 1e-4 * max(float(c.abs().max()), 1e-6)
    again = _bn_grads(K.batch_norm_act, x, w, b, rm, rv, slope, res, mode, act, cot)
    assert all(torch.equal(a, c) for a, c in zip(got_g, again))


@pytest.mark.parametrize("shape", [(5, 3, 7, 7), (1, 4, 6, 6), (6, 5, 1, 1), (48, 3, 5, 5),
                                   (17, 2, 3, 9)])
@pytest.mark.parametrize("act,residual", [("relu", True), ("prelu", False), ("none", False)])
@pytest.mark.parametrize("mode", ["train", "teacher"])
def test_batch_norm_fused_edges(dev, shape, act, residual, mode):
    # the fused design at HW % 4 != 0 (its 4-byte loads), N = 1, HW = 1 and a
    # batch spread over several samples a group
    x, w, b, rm, rv, slope, res = _bn_inputs(dev, shape, act, residual, 21)
    assert _bn_plan(x, True, False, act)["design"] == 1
    assert _bn_plan(x, True, True, act)["design"] == 1
    _bn_against_reference(x, w, b, rm, rv, slope, res, mode, act)


def _largest_plane(N, R, backward):
    """The largest HW (a multiple of 4) whose plan takes R ranks."""
    from tris_tpu_torch.tools import batch_norm_schedule as BS

    best = None
    for HW in range(4, 2 ** 24 // N, 4):
        p = BS.plan(N, 1, HW, True, backward)
        if p["design"] != 1:
            break
        if p["ranks"] == R:
            best = HW
    return best


@pytest.mark.parametrize("R,backward", [(r, False) for r in range(1, 9)]
                         + [(r, True) for r in list(range(1, 9)) + [16]])
def test_batch_norm_fused_largest_plane_per_cluster(dev, R, backward):
    # at N = 48 (every R of 1..8 its own samples a rank), the largest plane
    # the rule gives each cluster size (16: the backward's non-portable
    # cluster), with a residual and ReLU: the plan on the card is the
    # schedule tool's, and the kernel agrees with the plain version and the
    # route reference
    HW = _largest_plane(48, R, backward)
    assert HW is not None
    x, w, b, rm, rv, slope, res = _bn_inputs(dev, (48, 2, 1, HW), "relu", True, 30 + R)
    from tris_tpu_torch.tools import batch_norm_schedule as BS

    got = _bn_plan(x, True, backward, "relu")
    assert got == BS.plan(48, 2, HW, True, backward, "relu", got["max_ranks"])
    if got["max_ranks"] >= R:
        assert got["ranks"] == R
    _bn_against_reference(x, w, b, rm, rv, slope, res, "train", "relu")


@pytest.mark.parametrize("shape", [(1, 2, 256, 256), (1, 2, 257, 257), (2, 1, 400, 400)])
@pytest.mark.parametrize("act,residual", [("relu", True), ("prelu", False)])
def test_batch_norm_two_pass(dev, shape, act, residual):
    # planes too large for the fused design (float4 and 4-byte loads)
    x, w, b, rm, rv, slope, res = _bn_inputs(dev, shape, act, residual, 41)
    assert _bn_plan(x, True, False, act)["design"] == 0
    assert _bn_plan(x, True, True, act)["design"] == 0
    _bn_against_reference(x, w, b, rm, rv, slope, res, "train", act)


@pytest.mark.parametrize("shape", [(48, 64, 20, 20), (48, 4, 80, 80), (7, 3, 9, 11)])
@pytest.mark.parametrize("act,residual", [("relu", True), ("prelu", False)])
def test_batch_norm_designs_agree(dev, shape, act, residual):
    # the fused and the two-pass design on the same inputs: y bit for bit
    # where their statistics do (a sample's sums in another order may round
    # apart at a float32 boundary), the statistics within 1e-6 relative (the
    # mean of its scale), the gradients within 1e-4 of their max; each
    # launch's grid as the plan says
    from tris_tpu_torch.kernels.batch_norm import ACTS

    x, w, b, rm, rv, slope, res = _bn_inputs(dev, shape, act, residual, 51)
    ops = K.build.ops()
    a = ACTS[act]
    outs = {f: ops.batch_norm_fwd(x, w, b, res, slope, None, None, a, 0.1, 1e-5, f)
            for f in (0, 1)}
    plan = dict(ops.batch_norm_plan(*shape[:2], shape[2] * shape[3], True, False, a, 1))
    fused_shape = dict(ops.batch_norm_launch_shape("batch_norm_fwd_fused"))
    assert fused_shape == {"blocks": plan["blocks"], "cluster": plan["ranks"],
                           "threads": plan["threads"], "smem_bytes": plan["smem_bytes"],
                           "load_bytes": 4 if shape[2] * shape[3] % 4 else 16}
    (y0, s0), (y1, s1) = outs[0], outs[1]
    if torch.equal(s0, s1):
        assert torch.equal(y0, y1)
    assert _err(y0, y1) <= 1e-5 * float(y0.abs().max())
    assert _err(s1[0], s0[0]) <= 1e-6 * float(s0[0].abs().max())
    for r in (1, 2):
        assert float(((s1[r] - s0[r]).abs() / s0[r].abs()).max()) <= 1e-6
    g = torch.randn_like(x)
    out = y1 if act == "relu" else None
    grads = {f: ops.batch_norm_bwd(g, x, out, s1[0], s1[2], w, b, slope, a, residual, f)
             for f in (0, 1)}
    for t0, t1 in zip(grads[0], grads[1]):
        if t0 is not None:
            assert _err(t1, t0) <= 1e-4 * max(float(t0.abs().max()), 1e-6)


def test_batch_norm_act_refuses(dev):
    x, w, b, rm, rv, slope, res = _bn_inputs(dev, (2, 4, 6, 6), "prelu", True, 6)
    kw = dict(training=True, update_stats=False, momentum=0.1, eps=1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        K.batch_norm_act(x.transpose(2, 3), w, b, rm, rv, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        K.batch_norm_act(x.to(memory_format=torch.channels_last), w, b, rm, rv, **kw)
    with pytest.raises(TypeError, match="float32"):
        K.batch_norm_act(x.double(), w, b, rm, rv, **kw)
    with pytest.raises(ValueError, match="N, C, H, W"):
        K.batch_norm_act(x[0], w, b, rm, rv, **kw)
    with pytest.raises(ValueError, match="residual"):
        K.batch_norm_act(x, w, b, rm, rv, act="relu", residual=res[:, :, :5].contiguous(), **kw)
    with pytest.raises(ValueError, match="one value"):
        K.batch_norm_act(x, w, b, rm, rv, act="prelu", slope=torch.ones(2, device=dev), **kw)
    with pytest.raises(ValueError, match="weight, bias"):
        K.batch_norm_act(x, w[:3], b, rm, rv, **kw)
    with pytest.raises(ValueError, match="act must be one of"):
        K.batch_norm_act(x, w, b, rm, rv, act="gelu", **kw)


# --bf16: the bfloat16 kernels against their plain versions (which take bfloat16 too), each
# within one bfloat16 ulp of the output's scale of the plain version's distance from a float64
# evaluation of the same inputs; where that distance passes a tenth of the scale (float64 takes
# another branch: a ReLU mask, GMP's maxima), within 4 such ulps of the plain version itself;
# K13's fold bit for bit


def _bf16_ulp(scale: float) -> float:
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


def _within_plain(got, plain, want64):
    scale = float(want64.abs().max())
    assert _err(got, want64) <= _err(plain, want64) + _bf16_ulp(scale)
    if _err(plain, want64) > 0.1 * scale:
        assert _err(got, plain) <= 4 * _bf16_ulp(scale)


@pytest.mark.parametrize("shape,act,with_res", [((2, 8, 6, 8), "relu", False),
                                                ((3, 5, 7, 7), "relu", True),
                                                ((2, 16, 10, 10), "none", True),
                                                ((1, 3, 1, 1), "none", False)])
def test_batch_norm_fold_bf16(randn, shape, act, with_res):
    # 16-byte accesses where HW % 8 == 0, 2-byte ones elsewhere: bit for bit the plain version
    C = shape[1]
    x = (2 * randn(*shape)).bfloat16()
    res = randn(*shape).bfloat16() if with_res else None
    w, b, rm, rv = 1 + 0.3 * randn(C), 0.5 * randn(C), randn(C), 0.5 + randn(C).abs()
    kw = dict(training=False, update_stats=False, momentum=0.1, eps=1e-5, act=act, residual=res)
    before = K.launches["batch_norm.bf16"]
    got = K.batch_norm_act(x, w, b, rm, rv, **kw)
    assert K.launches["batch_norm.bf16"] == before + 1 and got.dtype == torch.bfloat16
    assert torch.equal(got, K.batch_norm_act_plain(x, w, b, rm, rv, **kw))


@pytest.mark.parametrize("L,hd", [(20, 64), (7, 32), (50, 48), (128, 128), (33, 36)])
def test_mha_short_bf16(randn, L, hd):
    # bfloat16 q, k, v with the float32 causal mask, out float32 (hd 36: 2-byte loads)
    n, H = 3, 4
    C = H * hd
    q, k, v = randn(n, L, 3 * C).bfloat16().chunk(3, dim=-1)
    mask = causal_mask(L, device=q.device)
    before = K.launches["mha_short.bf16"]
    got = K.mha_short(q, k, v, H, mask)
    assert K.launches["mha_short.bf16"] == before + 1 and got.dtype == torch.float32
    _within_plain(got, K.mha_short_plain(q, k, v, H, mask),
                  K.mha_short_plain(q.double(), k.double(), v.double(), H, mask.double()))


@pytest.mark.parametrize("vis_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,S,HW,T,m", [(2, 1, 37, 3, 64), (3, 2, 100, 1, 1024),
                                        (1, 3, 256, 5, 260)])
def test_cross_attn_bf16(randn, vis_dtype, N, S, HW, T, m):
    # bfloat16 text projections, vision ones bfloat16 (outputs bfloat16) or float32
    qv, kv, vv = (torch.relu(randn(N, HW, m)).to(vis_dtype) for _ in range(3))
    qt, kt, vt = (torch.relu(randn(N * S, T, m)).bfloat16() for _ in range(3))
    args = (qv, kv, vv, qt, kt, vt, S, math.sqrt(m))
    before = K.launches["cross_attn.bf16"]
    got = K.cross_attn(*args)
    assert K.launches["cross_attn.bf16"] == before + 1
    plain = K.cross_attn_plain(*args)
    want64 = K.cross_attn_plain(*(t.double() for t in args[:6]), S, math.sqrt(m))
    for g, p, w in zip(got, plain, want64):
        assert g.dtype == p.dtype == vis_dtype
        _within_plain(g, p, w)


@pytest.mark.parametrize("new", ["bf16", "f32", None])
@pytest.mark.parametrize("P,S,hw,D,H", [(8, 4, (10, 10), 1024, 320), (3, 1, (3, 5), 34, 17)])
def test_response_head_bf16(randn, new, P, S, hw, D, H):
    # bfloat16 vis_base and lan; vis_new bfloat16, float32 or None; maps float32
    from tris_tpu_torch.ops.dtypes import weak

    N, (h, w) = P // S, hw
    base = F.normalize(randn(N, h * w, D), dim=-1).bfloat16()
    lan = F.normalize(randn(P, D), dim=-1).bfloat16()
    dt = torch.float32 if new == "f32" else torch.bfloat16
    vis_new = None if new is None else (0.03 * randn(P, h * w, D)).to(dt)
    args = (vis_new, base, lan, S, torch.tensor(14.3, device=base.device), weak(0.1, dt), hw,
            (H, H + 3))
    before = K.launches["response_head.bf16"]
    got = K.response_head(*args)
    assert K.launches["response_head.bf16"] == before + 1 and got.dtype == torch.float32
    want64 = K.response_head_plain(None if vis_new is None else vis_new.double(), base.double(),
                                   lan.double(), S, args[4].double(), args[5], hw, (H, H + 3))
    _within_plain(got, K.response_head_plain(*args), want64)


def test_bf16_wrappers_refuse(randn):
    # combinations the kernels do not take raise in Python, naming the dtypes they take; the
    # eval fold is forward only, PReLU in training takes no bfloat16, nor does K2's backward
    # past one key block or K3's head with a float32 lan_p
    bf = torch.bfloat16
    q = randn(2, 8, 64)
    mask = causal_mask(8, device=q.device)
    with pytest.raises(TypeError, match="bfloat16, bfloat16, bfloat16, float32"):
        K.mha_short(q.to(bf), q.to(bf), q, 2, mask)
    v, t = randn(2, 300, 64), randn(2, 1, 64)
    with pytest.raises(TypeError, match="takes dtypes"):
        K.cross_attn(v.to(bf), v, v, t.to(bf), t.to(bf), t.to(bf), 1, 8.0)
    with pytest.raises(ValueError, match="up to 256"):
        K.cross_attn(*(x.to(bf) for x in (v, v, v, t, t, t)), 1, 8.0)
    with pytest.raises(ValueError, match="with gradients takes HW and T up to 256"):
        K.cross_attn(*(x.requires_grad_() for x in (v.clone(), v, v)),
                     *(x.to(bf) for x in (t, t, t)), 1, 8.0)
    base, lan = randn(2, 9, 33).to(bf), randn(2, 33).to(bf)
    scale = torch.tensor(1.0, device=q.device)
    with pytest.raises(ValueError, match="even D"):
        K.response_head(None, base, lan, 1, scale, 0.1, (3, 3), (6, 6))
    with pytest.raises(TypeError, match="takes dtypes"):
        K.response_head(None, base, lan.float(), 1, scale, 0.1, (3, 3), (6, 6))
    x, w = randn(2, 4, 3, 3).to(bf), randn(4)
    kw = dict(update_stats=False, momentum=0.1, eps=1e-5)
    with pytest.raises(ValueError, match="forward only"):
        K.batch_norm_act(x.requires_grad_(), w, w, w, w.abs(), training=False, **kw)
    with pytest.raises(ValueError, match="no bfloat16 PReLU"):
        K.batch_norm_act(x, w, w, w, w.abs(), training=True, act="prelu",
                         slope=torch.ones(1, device=q.device), **kw)
    with pytest.raises(TypeError, match="takes dtypes"):
        K.batch_norm_act(x, w, w, w, w.abs(), training=False, residual=x.float(), **kw)
    with pytest.raises(TypeError, match="takes dtypes"):
        K.stage1_head(randn(2, 4, 8).to(bf), randn(2, 2, 8), scale, (2, 2), (4, 4), 3.0, 0.01)


# --bf16 training: the backward kernels and the train forwards against their plain versions
# from float64, each output and gradient within one bfloat16 ulp of its scale of the plain
# version's distance


@pytest.mark.parametrize("shape,act,with_res", [((3, 8, 10, 10), "relu", True),
                                                ((2, 5, 7, 7), "relu", False),
                                                ((4, 16, 6, 6), "none", False),
                                                ((1, 3, 2, 2), "relu", True)])
def test_batch_norm_train_bf16(randn, shape, act, with_res):
    # K13's train forward and backward on bfloat16 x (8-value accesses where HW % 8 == 0, 4
    # where HW % 4 == 0, else one): three launches each way; y, dx, dweight, dbias and the
    # residual's gradient against the plain version from float64; the running buffers moved
    C = shape[1]
    x = (2 * randn(*shape) + 0.5).bfloat16()
    res = randn(*shape).bfloat16() if with_res else None
    w, b, rm, rv = 1 + 0.3 * randn(C), 0.5 * randn(C), randn(C), 0.5 + randn(C).abs()
    ins = [x, w, b] + ([res] if with_res else [])
    cot = [randn(*shape).bfloat16()]

    def bn(route, rm, rv, update=False):
        def call(*t):
            return route(t[0], t[1], t[2], rm, rv, training=True, update_stats=update,
                         momentum=0.1, eps=1e-5, act=act, residual=t[3] if with_res else None)
        return call

    before = (K.launches["batch_norm.bf16"], K.launches["batch_norm_bwd.bf16"])
    got = _grads(bn(K.batch_norm_act, rm, rv), _leaves(*ins), cot)
    assert (K.launches["batch_norm.bf16"], K.launches["batch_norm_bwd.bf16"]) == \
        (before[0] + 3, before[1] + 3)
    plain = _grads(bn(K.batch_norm_act_plain, rm, rv), _leaves(*ins), cot)
    want = _grads(bn(K.batch_norm_act_plain, rm.double(), rv.double()), _leaves(*ins, double=True),
                  [cot[0].double()])
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    for gk, gp, g64 in zip(got, plain, want):
        _within_plain(gk, gp, g64)
    y = bn(K.batch_norm_act, rm, rv)(*ins)
    y64 = bn(K.batch_norm_act_plain, rm.double(), rv.double())(*(t.double() for t in ins))
    _within_plain(y, bn(K.batch_norm_act_plain, rm, rv)(*ins), y64)
    rm_k, rv_k, rm_p, rv_p = rm.clone(), rv.clone(), rm.clone(), rv.clone()
    bn(K.batch_norm_act, rm_k, rv_k, True)(*ins)
    bn(K.batch_norm_act_plain, rm_p, rv_p, True)(*ins)
    assert _err(rm_k, rm_p) <= 1e-6 and _err(rv_k, rv_p) <= 1e-5 * float(rv_p.abs().max())


@pytest.mark.parametrize("L,hd", [(20, 64), (7, 32), (50, 48), (64, 128), (33, 36)])
def test_mha_short_bwd_bf16(randn, L, hd):
    # K1's backward on bfloat16 q, k, v (column views of one qkv) with the float32 causal mask
    # and a float32 cotangent: dq, dk, dv bfloat16, within the plain version's distance
    n, H = 3, 4
    C = H * hd
    qkv = randn(n, L, 3 * C).bfloat16()
    mask = causal_mask(L, device=qkv.device)
    cot = [randn(n, L, C)]
    before = K.launches["mha_short_bwd.bf16"]
    got = _grads(lambda t: K.mha_short(*t.chunk(3, -1), H, mask), _leaves(qkv), cot)[0]
    assert K.launches["mha_short_bwd.bf16"] == before + 1 and got.dtype == torch.bfloat16
    plain = _grads(lambda t: K.mha_short_plain(*t.chunk(3, -1), H, mask), _leaves(qkv), cot)[0]
    want = _grads(lambda t: K.mha_short_plain(*t.chunk(3, -1), H, mask.double()),
                  _leaves(qkv, double=True), [cot[0].double()])[0]
    for a, b, c in zip(got.chunk(3, -1), plain.chunk(3, -1), want.chunk(3, -1)):
        _within_plain(a, b, c)


@pytest.mark.parametrize("vis_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,HW,T,m", [(2, 37, 3, 64), (3, 100, 48, 1024), (1, 256, 5, 260)])
def test_cross_attn_bwd_bf16(randn, vis_dtype, N, HW, T, m):
    # K2's forward keeping the probabilities and its backward, both mixes: each gradient in
    # its operand's dtype, within the plain version's distance
    vis = [torch.relu(randn(N, HW, m)).to(vis_dtype) for _ in range(3)]
    txt = [torch.relu(randn(N, T, m)).bfloat16() for _ in range(3)]
    cot = [randn(N, HW, m).to(vis_dtype), randn(N, T, m).to(vis_dtype)]
    div = math.sqrt(m)
    before = (K.launches["cross_attn.bf16"], K.launches["cross_attn_bwd.bf16"])
    got = _grads(lambda *t: K.cross_attn(*t, 1, div), _leaves(*vis, *txt), cot)
    assert (K.launches["cross_attn.bf16"], K.launches["cross_attn_bwd.bf16"]) == \
        (before[0] + 1, before[1] + 2)
    plain = _grads(lambda *t: K.cross_attn_plain(*t, 1, div), _leaves(*vis, *txt), cot)
    want = _grads(lambda *t: K.cross_attn_plain(*t, 1, div), _leaves(*vis, *txt, double=True),
                  [c.double() for c in cot])
    for gk, gp, g64, x in zip(got, plain, want, vis + txt):
        assert gk.dtype == x.dtype
        _within_plain(gk, gp, g64)


def _head_case(randn, B, T, hw, D, vis_dtype, tie):
    vis = F.normalize(randn(B, hw, D), dim=-1)
    lan = F.normalize(randn(B, T, D), dim=-1)
    if tie:  # pixels 3 and 5 copy pixel 1, made the largest: every text's GMP may tie three ways
        vis[:, 1] = 3 * vis[:, 1]
        vis[:, 3] = vis[:, 1]
        vis[:, 5] = vis[:, 1]
    return vis.to(vis_dtype), lan.bfloat16()


@pytest.mark.parametrize("vis_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T,hw,out,D,tie", [(4, 4, (3, 4), (10, 14), 32, False),
                                              (6, 6, (5, 5), (40, 40), 128, True),
                                              (48, 48, (10, 10), (320, 320), 1024, False),
                                              (3, 5, (2, 3), (7, 9), 20, True)])
def test_stage1_head_bf16(randn, vis_dtype, B, T, hw, out, D, tie):
    # K3's training head on bfloat16 lan_p and bfloat16 or float32 vis_p, forward and
    # backward, within the plain version's distance from float64; with planted ties the
    # GMP's gradient is split among the tied pixels (as the plain version's amax and float64
    # split it: the kernel's first-argmax rule would miss by the split share)
    vis, lan = _head_case(randn, B, T, hw[0] * hw[1], D, vis_dtype, tie)
    scale = torch.tensor(1 / 0.07, device=vis.device)
    off = T - B
    args = (scale, hw, out, 3.0, 0.01, off)
    cot = [randn(B, T), None, 0.01 * randn(B, *out), 0.01 * randn(B, *out)]
    before = (K.launches["stage1_head.bf16"], K.launches["stage1_head_bwd.bf16"])
    outs = K.stage1_head(vis, lan, *args)
    got = _grads(lambda v, l: K.stage1_head(v, l, *args), _leaves(vis, lan), cot)
    assert (K.launches["stage1_head.bf16"], K.launches["stage1_head_bwd.bf16"]) == \
        (before[0] + 2, before[1] + 1)
    plain_outs = K.stage1_head_plain(vis, lan, *args)
    args64 = (scale.double(),) + args[1:]
    outs64 = K.stage1_head_plain(vis.double(), lan.double(), *args64)
    for i in (0, 2, 3):
        assert outs[i].dtype == torch.float32
        _within_plain(outs[i], plain_outs[i], outs64[i])
    plain = _grads(lambda v, l: K.stage1_head_plain(v, l, *args), _leaves(vis, lan), cot)
    want = _grads(lambda v, l: K.stage1_head_plain(v, l, *args64), _leaves(vis, lan, double=True),
                  [None if c is None else c.double() for c in cot])
    assert got[0].dtype == vis_dtype and got[1].dtype == torch.bfloat16
    for gk, gp, g64 in zip(got, plain, want):
        _within_plain(gk, gp, g64)
    if tie and vis_dtype == torch.bfloat16:
        score = torch.einsum("bpc,bqc->bpq", vis.double(), lan.double())
        top = score.amax(dim=1, keepdim=True)
        assert int(((score == top).sum(dim=1) == 3).sum()) > 0, "no three-way tie planted"


# --bf16 stage-2 eval: K11's forward, K6's bilinear forward and K13's eval fold with PReLU on
# the operands of both leaf regimes


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,S,HW,T,C", [(2, 1, 37, 1, 64), (1, 2, 50, 48, 36),
                                        (2, 4, 100, 20, 60), (1, 1, 33, 40, 30),
                                        (1, 2, 33, 5, 2056)])
def test_pixel_attn_bf16(randn, q_dtype, N, S, HW, T, C):
    # bfloat16 Lk, Lv with bfloat16 q (G bfloat16) or float32 q (G float32): one token and
    # the forward's 48, C % 8 != 0 (36, 60: 16-byte loads) and C % 4 != 0 (30: 4-byte
    # ones), S > 1 pairs on one image, sub-slices past 2048 channels; within the plain
    # version's distance from float64
    q = randn(N, HW, C).to(q_dtype)
    Lk, Lv = (randn(N * S, T, C).bfloat16() for _ in range(2))
    before = (K.launches["pixel_attn.bf16"], K.launches["pixel_attn"])
    got = K.pixel_attn(q, Lk, Lv, S)
    assert (K.launches["pixel_attn.bf16"], K.launches["pixel_attn"]) == (before[0] + 1, before[1])
    assert got.dtype == q_dtype
    want64 = K.pixel_attn_plain(q.double(), Lk.double(), Lv.double(), S)
    _within_plain(got, K.pixel_attn_plain(q, Lk, Lv, S), want64)
    assert K.pixel_attn_launch_shape("pixel_attn_bf16")["t_bucket"] >= T


@pytest.mark.parametrize("shape,size,align_corners", [
    ((32, 64, 40, 40), (80, 80), False),   # the decoder's last x2
    ((1, 1, 80, 80), (320, 320), False),   # the demo's head
    ((3, 5, 7, 9), (13, 22), False),       # sizes not a multiple of 4
    ((3, 5, 7, 9), (13, 22), True),
    ((2, 3, 60, 80), (30, 37), True),      # a downscale: the direct path
])
def test_bilinear_resize_bf16(randn, shape, size, align_corners):
    # bit for bit the plain version (taps rounded to bfloat16, each sum rounded to bfloat16)
    x = randn(*shape).bfloat16()
    before = K.launches["bilinear_resize.bf16"]
    got = K.bilinear_resize(x, size, align_corners)
    assert K.launches["bilinear_resize.bf16"] == before + 1 and got.dtype == torch.bfloat16
    assert torch.equal(got, K.bilinear_resize_plain(x, size, align_corners))


@pytest.mark.parametrize("shape", [(2, 8, 10, 10), (3, 5, 8, 8), (1, 3, 7, 9)])
@pytest.mark.parametrize("slope_dtype", [torch.bfloat16, torch.float32])
def test_batch_norm_fold_prelu_bf16(randn, shape, slope_dtype):
    # planes of 100 and 63 (2-byte accesses) and of 64 (16-byte); a bfloat16 slope gives
    # bfloat16 y, a float32 one float32 y: bit for bit the plain version
    C = shape[1]
    x = (2 * randn(*shape)).bfloat16()
    w, b, rm, rv = 1 + 0.3 * randn(C), 0.5 * randn(C), randn(C), 0.5 + randn(C).abs()
    slope = torch.full((1,), 0.25, device=x.device, dtype=slope_dtype) - 0.3 * randn(1).to(
        slope_dtype)
    kw = dict(training=False, update_stats=False, momentum=0.1, eps=1e-5, act="prelu",
              slope=slope)
    before = K.launches["batch_norm.bf16@prelu"]
    got = K.batch_norm_act(x, w, b, rm, rv, **kw)
    assert K.launches["batch_norm.bf16@prelu"] == before + 1 and got.dtype == slope_dtype
    assert torch.equal(got, K.batch_norm_act_plain(x, w, b, rm, rv, **kw))
    assert bool((got < 0).any())  # the slope's branch taken


def test_bf16_stage2_wrappers_refuse(randn):
    # the mixes the stage-2 instances do not take raise in Python before any launch: K11
    # with float32 keys beside a bfloat16 q, or with a gradient; K6 on float16 or with a
    # gradient; K13's fold with a float16 slope or a residual before PReLU
    bf = torch.bfloat16
    before = dict(K.launches)
    q, k = randn(2, 9, 16), randn(2, 3, 16)
    with pytest.raises(TypeError, match="takes dtypes"):
        K.pixel_attn(q.to(bf), k, k, 1)
    with pytest.raises(ValueError, match="takes no gradient"):
        K.pixel_attn(q.to(bf).requires_grad_(), k.to(bf), k.to(bf), 1)
    x = randn(2, 3, 5, 5)
    with pytest.raises(TypeError, match="takes dtypes"):
        K.bilinear_resize(x.half(), (10, 10))
    with pytest.raises(ValueError, match="takes no gradient"):
        K.bilinear_resize(x.to(bf).requires_grad_(), (10, 10))
    w = randn(3)
    kw = dict(training=False, update_stats=False, momentum=0.1, eps=1e-5, act="prelu")
    with pytest.raises(TypeError, match="takes dtypes"):
        K.batch_norm_act(x.to(bf), w, w, w, w.abs(), slope=torch.ones(1, device=x.device).half(),
                         **kw)
    with pytest.raises(ValueError, match="no residual before a PReLU"):
        K.batch_norm_act(x.to(bf), w, w, w, w.abs(), slope=torch.ones(1, device=x.device),
                         residual=x.to(bf), **kw)
    assert dict(K.launches) == before

