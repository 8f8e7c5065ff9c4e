"""K1's tile map on the CPU: the blocks of the card's kernels
(``tris_tpu_torch/kernels/csrc/mha_short.cu``, ``mha_short_bwd.cu``,
``mha_short_tiles.cuh``), which cannot run here.

``tris_tpu_torch/tools/mha_schedule.py`` walks each kernel's grid, a block
per (sequence, head), with the tile constants of ``csrc/launchers.h`` and
does, in float64, what each block does: the head's operands padded to the
length and head-dim buckets, the logits over chunks of 4 channels, the
softmax, P V over keys in steps of 4, P^T X over rows, and the elements each
thread writes. Across the buckets' edges (L from 1 to 128, hd from 32 to
128 and between buckets), causal or not, on q, k, v read as column views of
one fused qkv tensor, every output and gradient element is written exactly
once, the forward equals ``mha_short_plain`` in float64, the backward equals
autograd of it, and both equal the JAX function
(``tris_tpu/models/layers.py:25``) within the float32 bar. The kernels take
every shape the kernels before them took (the rules of those kernels are
written out below).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tris_tpu.models import layers as jl
from tris_tpu_torch.kernels import mha_short_plain
from tris_tpu_torch.tools import mha_schedule as S

torch.set_num_threads(2)

LENGTHS = (1, 8, 20, 37, 50, 56, 57, 64, 65, 101, 128)
HEAD_DIMS = (32, 48, 64, 80, 128)
# the paths' shapes, hd = 64: (N, heads, L, blocks, forward's and backward's length
# buckets, threads a block in each)
PATHS = {"text eval": (32, 8, 20, 256, (32, 32), (128, 128)),
         "text train": (48, 8, 20, 384, (32, 32), (128, 128)),
         "ViT PRMS": (32, 12, 50, 384, (56, 64), (224, 128)),
         "ViT train": (48, 12, 50, 576, (56, 64), (224, 128)),
         "attnpool": (8, 32, 101, 256, (128, 128), (256, 256))}


def _qkv(N, Lq, Lk, C, seed):
    """q, k, v [N, L, C] as column views of one [N, L, 3C] tensor (row
    stride 3C), as TorchMultiheadAttention feeds K1; float64."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((N, max(Lq, Lk), 3 * C)))
    return qkv[:, :Lq, :C], qkv[:, :Lk, C:2 * C], qkv[:, :Lk, 2 * C:]


def _causal(L):
    return torch.triu(torch.full((L, L), -torch.inf, dtype=torch.float64), 1)


def test_tile_constants_fit_the_thread_layouts():
    # the static_asserts of mha_short_tiles.cuh, on the constants read here
    t = S.tiles()
    X = t["kMhaShortLanes"]
    assert X == 8
    assert S.LEN_BUCKETS[False][-1] == S.LEN_BUCKETS[True][-1] == t["kMhaShortMaxLen"]
    assert S.HD_BUCKETS[-1] == t["kMhaShortMaxHeadDim"]
    for lp in S.LEN_BUCKETS[False] + S.LEN_BUCKETS[True]:
        n, R = S.threads(lp), S.rows(lp)
        assert R == 2 or R % 4 == 0      # float2 or float4 reads of a thread's keys
        assert n % 32 == 0 and n <= 1024 and lp % X == 0 and lp % R == 0
        assert ((lp + 31) // 32 * 32 + t["kMhaShortProbPad"]) % 32 == 8  # P's rows 8 banks apart
        for hdb in S.HD_BUCKETS:
            # float4 channel groups over the lanes; an odd number of 16-byte units a row
            assert hdb % (4 * X) == 0 and (hdb + t["kMhaShortPad"]) % 8 == 4
            assert lp * hdb // 4 % n == 0
            for backward in (False, True):
                assert S.smem(lp, hdb, backward) <= t["kMhaShortMaxSmem"]


def _parent_takes(Lq, Lk, hd, backward):
    """The kernels' rules before this design, written out: L <= 128 and
    head dim <= 128; the backward also needed its shared memory (K and V
    rows of hd + 1 floats, P and dS rows of Lk + 1, a q and a dO row for each
    of 8 warps) within 227 KiB."""
    ok = (Lq <= 128) & (Lk <= 128) & (hd <= 128)
    if backward:
        ok &= 4 * (2 * Lk * (hd + 1) + 2 * Lq * (Lk + 1) + 16 * hd) <= 227 * 1024
    return ok


@pytest.mark.parametrize("backward", [False, True])
def test_takes_every_shape_the_parent_took(backward):
    Lq, Lk, hd = np.meshgrid(*(np.arange(1, 129),) * 3, indexing="ij")
    parent = _parent_takes(Lq, Lk, hd, backward)
    ours = S.takes(Lq, Lk, hd, backward)
    assert parent.any()
    assert not (parent & ~ours).any()
    # and past the longest sequence and the widest head it refuses
    assert not S.takes(129, 1, 64, backward) and not S.takes(1, 129, 64, backward)
    assert not S.takes(20, 20, 129, backward) and not S.takes(0, 20, 64, backward)


@pytest.mark.parametrize("path", list(PATHS))
def test_block_counts_on_the_paths(path):
    N, H, L, blocks, lps, threads = PATHS[path]
    got = S.block_counts(N, H, L, L, 64)
    for name, lp, n in zip(("mha_short", "mha_short_bwd"), lps, threads):
        assert got[name]["blocks"] == blocks
        assert got[name]["lp"] == lp and got[name]["hd_bucket"] == 64
        assert got[name]["threads"] == n
    if L == 50:  # the ViT's backward: three blocks on an SM (228 KiB, 1 KiB each reserved)
        assert 3 * (got["mha_short_bwd"]["smem_bytes"] + 1024) <= 228 * 1024


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("L", LENGTHS)
def test_forward_writes_once_and_equals_plain(L, hd, causal):
    H = 2
    q, k, v = _qkv(2, L, L, H * hd, seed=L * hd)
    mask = _causal(L) if causal else None
    out, counts = S.forward(q, k, v, H, mask)
    assert bool((counts == 1).all())
    want = mha_short_plain(q, k, v, H, mask)
    assert float((out - want).abs().max()) <= 1e-12


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("L", LENGTHS)
def test_backward_writes_once_and_equals_autograd(L, hd, causal):
    H = 2
    q, k, v = _qkv(2, L, L, H * hd, seed=7 * L + hd)
    g = torch.from_numpy(np.random.default_rng(L + hd).standard_normal((2, L, H * hd)))
    mask = _causal(L) if causal else None
    grads, counts = S.backward(g, q, k, v, H, mask)
    for name, c in counts.items():
        assert bool((c == 1).all()), name
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(mha_short_plain(*leaves, H, mask), leaves, g)
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        assert float((a - b).abs().max()) <= 1e-12 * max(1.0, float(b.abs().max())), name


@pytest.mark.parametrize("Lq,Lk,hd", [(20, 50, 64), (50, 20, 64), (128, 3, 37), (1, 128, 80),
                                      (17, 16, 33)])
def test_cross_lengths_and_odd_head_dims(Lq, Lk, hd):
    # Lq != Lk (buckets by the longer), hd off every bucket: the same tile map
    H = 3
    q, k, v = _qkv(2, Lq, Lk, H * hd, seed=Lq + Lk + hd)
    g = torch.from_numpy(np.random.default_rng(hd).standard_normal((2, Lq, H * hd)))
    out, counts = S.forward(q, k, v, H)
    assert bool((counts == 1).all())
    assert float((out - mha_short_plain(q, k, v, H)).abs().max()) <= 1e-12
    grads, counts = S.backward(g, q, k, v, H)
    assert all(bool((c == 1).all()) for c in counts.values())
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(mha_short_plain(*leaves, H), leaves, g)
    for a, b in zip(grads, want):
        assert float((a - b).abs().max()) <= 1e-12 * max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("L,causal", [(20, True), (50, False), (101, False)])
def test_emulation_equals_the_jax_function(L, causal):
    # the emulated kernels against multi_head_attention (layers.py:25) and
    # its vjp, in float32 at HIGHEST precision (tests/conftest.py): 1e-5,
    # of each gradient's scale for the backward
    N, H, C = 2, 2, 128
    q, k, v = (x.float() for x in _qkv(N, L, L, C, seed=L))
    g = torch.from_numpy(np.random.default_rng(L).standard_normal((N, L, C)).astype(np.float32))
    jq, jk, jv, jg = (jnp.asarray(x.numpy()) for x in (q, k, v, g))
    jmask = jl.causal_mask(L) if causal else None
    fn = jax.jit(lambda a, b, c: jl.multi_head_attention(a, b, c, H, jmask))
    want, vjp = jax.vjp(fn, jq, jk, jv)
    mask = _causal(L) if causal else None
    out, _ = S.forward(q, k, v, H, mask)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    grads, _ = S.backward(g, q, k, v, H, mask)
    for a, b in zip(grads, vjp(jg)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * max(1.0, np.abs(b).max())


def test_the_profiler_files_the_kernels_as_hand_written():
    # profile_eval's classes match the names the compiler gives every
    # instantiation of K1's kernels (buckets, load width, residency)
    from tris_tpu_torch.tools.profile_eval import kernel_class

    fwd = "void (anonymous namespace)::mha_short_kernel<64, 64, true>(float const*, float const*)"
    bwd = "void (anonymous namespace)::mha_short_bwd_kernel<128, 128, false, false>(float const*)"
    assert kernel_class(fwd) == "mha_short_kernel"
    assert kernel_class(bwd) == "mha_short_bwd_kernel"
