"""K11's tile map on the CPU: the blocks of the card's kernels
(``tris_tpu_torch/kernels/csrc/pixel_attn.cu``, ``pixel_attn_bwd.cu``,
``pixel_attn_tiles.cuh``), which cannot run here.

``tris_tpu_torch/tools/pixel_attn_schedule.py`` walks each kernel's grid with
the tile constants and rules of ``csrc/launchers.h`` and does, in float64,
what each block does: its group of pixel tiles, its channel slice and
sub-slices, each warp's share of the channels, the warps' partials in order,
the cluster's in rank order, the softmax over the real tokens, the products
over tokens and pixels, and the elements it stores. Across the token
buckets' edges (T from 1 to 32, the forward's to 48), channel widths off the 4-float loads and
past 2048 (sub-slices), pixel counts off the 32-pixel tile and S > 1 pairs per
image, every output and gradient element is stored exactly once (dq once
and then added to once per later pair of its image), the forward equals
``pixel_attn_plain`` in float64, the backward equals autograd of it, and both
equal the JAX package's einsums and softmax (``tris_tpu/models/fusion.py:
38-39``, copied below) within the float32 bar. The kernels take every shape
the kernels before them took (that rule is written out below).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tris_tpu_torch.kernels import pixel_attn_plain
from tris_tpu_torch.tools import pixel_attn_schedule as S

torch.set_num_threads(2)

TOKENS = (1, 7, 20, 21, 32)
WIDTHS = (48, 130, 200, 512)
PIXELS = (1, 17, 63, 100)
PAIRS = (1, 3, 4)
# every (T, C), each pixel count and pair count several times
SAMPLE = [(T, C, PIXELS[(i + k) % 4], PAIRS[(2 * i + k) % 3])
          for i, T in enumerate(TOKENS) for k, C in enumerate(WIDTHS)]
# the paths' shapes at T = 20: (N, S, HW, C) -> {launch: (blocks, cluster, groups)}
PATHS = {
    "train c2": ((48, 1, 1600, 512), {"pixel_attn": (1248, 2, 13),
                                      "pixel_attn_bwd_probs_dq": (672, 2, 7),
                                      "pixel_attn_bwd_dkv": (480, 1, 7)}),
    "train c3": ((48, 1, 400, 1024), {"pixel_attn": (1344, 4, 7),
                                      "pixel_attn_bwd_probs_dq": (768, 4, 4),
                                      "pixel_attn_bwd_dkv": (960, 1, 4)}),
    "train c4": ((48, 1, 100, 2048), {"pixel_attn": (1536, 8, 4),
                                      "pixel_attn_bwd_probs_dq": (768, 8, 2),
                                      "pixel_attn_bwd_dkv": (1056, 1, 2)}),
    "eval c2": ((8, 4, 1600, 512), {"pixel_attn": (800, 2, 50)}),
    "eval c3": ((8, 4, 400, 1024), {"pixel_attn": (416, 4, 13)}),
    "eval c4": ((8, 4, 100, 2048), {"pixel_attn": (256, 8, 4)}),
}


def _inputs(N, Sp, HW, C, T, seed, dtype=np.float64):
    """q [N, HW, C] (unit scale, as InstanceNorm'd), Lk at half scale so the
    softmax is neither flat nor one-hot, Lv and dG; numpy from a seed."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((N, HW, C))
    lk = 0.5 * rng.standard_normal((N * Sp, T, C))
    lv = rng.standard_normal((N * Sp, T, C))
    dg = rng.standard_normal((N * Sp, HW, C))
    return [torch.from_numpy(x.astype(dtype)) for x in (q, lk, lv, dg)]


def test_tile_constants_fit_the_thread_layouts():
    # the static_asserts of pixel_attn_tiles.cuh, on the constants read here
    t = S.tiles()
    tile, threads = t["kPixelAttnTile"], t["kPixelAttnThreads"]
    # 8 pixel groups x 4 lanes, 4 pixels a thread; a float4 of a [tile][bucket] tile a thread
    assert tile == 32 and threads == 256 and tile * t["kPixelAttnMaxT"] // 4 <= threads
    assert t["kPixelAttnSlice"] == 2 * 128               # two passes of 128 channels
    assert t["kPixelAttnSliceBwd"] % 4 == 0 and t["kPixelAttnSliceBwd"] <= t["kPixelAttnSlice"]
    assert t["kPixelAttnMaxRanks"] <= 8                  # K2's cluster_sum4 sums at most 8
    assert t["kPixelAttnMaxBlockTiles"] >= 1 and t["kPixelAttnWaveBlocksBwd"] >= 132
    assert S.T_BUCKETS[-1] == t["kPixelAttnMaxT"]
    assert S.T_BUCKETS_FORWARD[-1] == t["kPixelAttnMaxTForward"] > t["kPixelAttnMaxT"]
    for tb in S.T_BUCKETS + S.T_BUCKETS_FORWARD:
        # tokens tg + 4 j on 4 lanes; [pixel][token] rows an odd number of 16-byte units
        assert tb % 4 == 0 and int(S.token_pitch(tb)) % 8 == 4
        for C in (1, 130, 512, 1024, 2048, 2052, 4096, 100000):
            # the forward's buckets past kPixelAttnMaxT have no backward
            for backward in (False, True) if tb in S.T_BUCKETS else (False,):
                h = int(S.held(S.width(C, backward)))
                assert h % 4 == 0 and h <= t["kPixelAttnSlice"] and int(S.pitch(h)) % 8 == 4
                assert int(S.smem(tb, C, backward)) <= t["kPixelAttnMaxSmem"]


def _parent_takes(T, C, Sp, backward):
    """The kernels' rule before this design, written out: 1 to 32 tokens,
    any C and S; the backward's dq kernel also needed its shared memory (dL
    of 32 pixels for each of the image's S pairs, and 128 channels of a
    pair's keys) within 227 KiB."""
    ok = (T >= 1) & (T <= 32) & (C >= 1) & (Sp >= 1)
    if backward:
        ok &= 4 * (32 * Sp * T + 128 * T) <= 227 * 1024
    return ok


@pytest.mark.parametrize("backward", [False, True])
def test_takes_every_shape_the_parent_took(backward):
    T, C, Sp = np.meshgrid(np.arange(1, 33), np.arange(1, 2049), np.arange(1, 65),
                           indexing="ij")
    parent = _parent_takes(T, C, Sp, backward)
    ours = S.takes(T, C, Sp, backward)
    assert parent.any()
    assert not (parent & ~ours).any()
    # wider still, and it refuses outside 1..32 tokens (the forward: 1..48, the demo's
    # phrases of 20 tokens each)
    assert S.takes(20, 1 << 20, 64, backward) and S.takes(32, 3, 1000, backward)
    assert bool(S.takes(48, 2048, 1, backward)) == (not backward)
    assert not S.takes(49 if not backward else 33, 512, 1, backward)
    assert not S.takes(0, 512, 1, backward)
    assert not S.takes(20, 0, 1, backward) and not S.takes(20, 512, 0, backward)


@pytest.mark.parametrize("path", list(PATHS))
def test_block_counts_on_the_paths(path):
    (N, Sp, HW, C), want = PATHS[path]
    got = S.block_counts(N, Sp, HW, C, 20)
    for name, (blocks, cluster, groups) in want.items():
        g = got[name]
        assert (g["blocks"], g["cluster"], g["groups"]) == (blocks, cluster, groups), name
        assert g["t_bucket"] == 20 and g["tile"] == 32 and g["threads"] == 256
    # two forward blocks an SM (228 KiB, 1 KiB each reserved); one of the backward's
    assert 2 * (got["pixel_attn"]["smem_bytes"] + 1024) <= 228 * 1024
    assert got["pixel_attn_bwd_probs_dq"]["smem_bytes"] <= S.tiles()["kPixelAttnMaxSmem"]


@pytest.mark.parametrize("T,C,HW,Sp", SAMPLE)
def test_forward_writes_once_and_equals_plain(T, C, HW, Sp):
    q, lk, lv, _ = _inputs(2, Sp, HW, C, T, seed=T * C + HW)
    out, counts = S.forward(q, lk, lv, Sp)
    assert bool((counts == 1).all())
    want = pixel_attn_plain(q, lk, lv, Sp)
    assert float((out - want).abs().max()) <= 1e-12 * max(1.0, float(want.abs().max()))


def _check_backward(N, Sp, HW, C, T, seed):
    q, lk, lv, dg = _inputs(N, Sp, HW, C, T, seed)
    grads, counts = S.backward(dg, q, lk, lv, Sp)
    for name in ("dq", "dLk", "dLv", "partials"):
        assert bool((counts[name] == 1).all()), name
    assert bool((counts["dq_adds"] == Sp - 1).all())   # the image's later pairs, added on
    leaves = [x.clone().requires_grad_() for x in (q, lk, lv)]
    want = torch.autograd.grad(pixel_attn_plain(*leaves, Sp), leaves, dg)
    for name, a, b in zip(("dq", "dLk", "dLv"), grads, want):
        assert float((a - b).abs().max()) <= 1e-12 * max(1.0, float(b.abs().max())), name


@pytest.mark.parametrize("T,C,HW,Sp", SAMPLE[::2])
def test_backward_writes_once_and_equals_autograd(T, C, HW, Sp):
    _check_backward(2, Sp, HW, C, T, seed=7 * T + C + HW)


@pytest.mark.parametrize("N,Sp,HW,C,T", [
    (1, 1, 33, 4096, 20),    # past 8 x 256 channels: two sub-slices a block
    (1, 2, 64, 2052, 9),     # a last rank's second sub-slice past C
    (2, 1, 70, 513, 8),      # C % 4 != 0 over 3 and 5 ranks
    (75, 1, 900, 48, 7),     # 2 tiles a forward block, 4 a backward one (the grid past its aim)
])
def test_wide_channels_and_tile_groups(N, Sp, HW, C, T):
    q, lk, lv, _ = _inputs(N, Sp, HW, C, T, seed=HW + C)
    out, counts = S.forward(q, lk, lv, Sp)
    assert bool((counts == 1).all())
    want = pixel_attn_plain(q, lk, lv, Sp)
    assert float((out - want).abs().max()) <= 1e-12 * max(1.0, float(want.abs().max()))
    _check_backward(N, Sp, HW, C, T, seed=HW + C + 1)


@pytest.mark.parametrize("T,C,HW,Sp", [(33, 130, 17, 1), (40, 512, 63, 1), (41, 200, 40, 3),
                                        (48, 48, 100, 1), (48, 2052, 33, 1)])
def test_forward_past_32_tokens_writes_once_and_equals_plain(T, C, HW, Sp):
    # the forward's buckets 40 and 48 (the demo's two phrases make T = 40): each output
    # stored once, equal to the plain version in float64; the backward refuses them
    q, lk, lv, _ = _inputs(1, Sp, HW, C, T, seed=T + C)
    out, counts = S.forward(q, lk, lv, Sp)
    assert bool((counts == 1).all())
    want = pixel_attn_plain(q, lk, lv, Sp)
    assert float((out - want).abs().max()) <= 1e-12 * max(1.0, float(want.abs().max()))
    assert S.takes(T, C, Sp, False) and not S.takes(T, C, Sp, True)
    assert int(S.t_bucket(T)) == (40 if T <= 40 else 48)


def _jax_pixel_attn(q, Lk, Lv):
    """tris_tpu/models/fusion.py:38-39: the attention of PixelAttention on one
    sentence per row."""
    Ci = q.shape[-1]
    attn = jax.nn.softmax(jnp.einsum("npc,ntc->npt", q, Lk) / math.sqrt(Ci), axis=2)
    return jnp.einsum("npt,ntc->npc", attn, Lv)


@pytest.mark.parametrize("N,Sp,HW,C,T", [(2, 1, 63, 200, 20), (1, 4, 40, 130, 32),
                                         (2, 2, 17, 512, 7), (1, 1, 50, 256, 40)])
def test_emulation_equals_the_jax_function(N, Sp, HW, C, T):
    # the emulated kernels against the JAX einsums and their vjp (each
    # image's q repeated over its S sentences, as JAX's model feeds it), in
    # float32 at HIGHEST precision (tests/conftest.py): 1e-5 of the output's
    # scale forward, 1e-4 of each gradient's max backward
    q, lk, lv, dg = _inputs(N, Sp, HW, C, T, seed=C + T, dtype=np.float32)
    jq, jk, jv, jg = (jnp.asarray(x.numpy()) for x in (q, lk, lv, dg))
    fn = jax.jit(lambda a, b, c: _jax_pixel_attn(jnp.repeat(a, Sp, axis=0), b, c))
    want, vjp = jax.vjp(fn, jq, jk, jv)
    out, _ = S.forward(q, lk, lv, Sp)
    want = np.asarray(want)
    assert np.abs(out.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    if T > S.tiles()["kPixelAttnMaxT"]:   # the forward alone takes it
        return
    grads, _ = S.backward(dg, q, lk, lv, Sp)
    for a, b in zip(grads, vjp(jg)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * max(1.0, np.abs(b).max())


def test_the_profiler_files_the_kernels_as_hand_written():
    # profile_eval's classes match the names the compiler gives every
    # instantiation of K11's kernels (token bucket, load width), apart from
    # K2's cross_attn_probs_bwd_kernel
    from tris_tpu_torch.tools.profile_eval import kernel_class

    fwd = "void (anonymous namespace)::pixel_attn_kernel<20, true>(float const*, float const*)"
    probs = ("void (anonymous namespace)::pixel_attn_bwd_probs_dq_kernel<32, false>"
             "(float const*, float const*)")
    dkv = "void (anonymous namespace)::pixel_attn_bwd_dkv_kernel<true>(float const*)"
    assert kernel_class(fwd) == "pixel_attn_kernel"
    assert kernel_class(probs) == "pixel_attn_bwd_probs_dq_kernel"
    assert kernel_class(dkv) == "pixel_attn_bwd_dkv_kernel"
    k2 = "void (anonymous namespace)::cross_attn_probs_bwd_kernel<true>(float const*)"
    assert kernel_class(k2) == "cross_attn_probs_bwd_kernel"
