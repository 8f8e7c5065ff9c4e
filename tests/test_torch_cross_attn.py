"""K2's tile map on the CPU: the blocks of the card's kernels
(``tris_tpu_torch/kernels/csrc/cross_attn.cu``, ``cross_attn_bwd.cu``,
``cross_attn_tiles.cuh``), which cannot run here.

``tris_tpu_torch/tools/cross_attn_schedule.py`` walks each kernel's grid with
the tile sizes of ``csrc/launchers.h`` and does, in float64, what each block
does: its query rows, its channel slice, its chunks, the cluster's sum in
rank order, the rows a block of the backward's first pass owns, and the
elements it writes. At HW and T on both sides of a tile's edge and past a
key block, S > 1 pairs per image and a channel width that ends inside a
slice, every output, scratch and gradient element is written exactly once,
the forward equals ``cross_attn_plain`` in float64 (and, at T = 1, its vision
half is exactly Vt), the backward equals autograd of the plain version, and
the emulated forward equals the JAX package's einsums
(``tris_tpu/models/fusion.py:85-89``) within the float32 bar.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tris_tpu_torch.kernels import cross_attn_plain
from tris_tpu_torch.tools import cross_attn_schedule as S

torch.set_num_threads(2)


def _inputs(N, Sp, HW, T, m, seed):
    """qv, kv, vv [N, HW, m] and qt, kt, vt [N*Sp, T, m], relu'd like the
    projections that feed K2, in float64."""
    rng = np.random.default_rng(seed)
    vis = [np.maximum(rng.standard_normal((N, HW, m)), 0) for _ in range(3)]
    lan = [np.maximum(rng.standard_normal((N * Sp, T, m)), 0) for _ in range(3)]
    return [torch.from_numpy(x) for x in vis + lan]


def test_tile_sizes_fit_the_thread_layouts():
    # the static_asserts of cross_attn_tiles.cuh, on the sizes read here
    t = S.tiles()
    assert t["kCrossAttnRows"] % 16 == 0 and t["kCrossAttnChunk"] % 4 == 0
    assert t["kCrossAttnSlice"] == 256 and t["kCrossAttnKeyChunk"] % 4 == 0
    kb = t["kCrossAttnKeyBlock"]
    assert kb % 32 == 0 and kb <= 256 and kb % t["kCrossAttnKeyChunk"] == 0


def test_block_counts_on_the_paths():
    # the train step (48 images, T = 48, m = 1024: clusters of 4) and
    # response_maps (8 images x 4 pairs, T = 1)
    train = S.block_counts(48, 1, 100, 48, 1024)
    assert train["cluster"] == 4
    assert train["rows_per_tile"] == 32
    assert train["cross_attn"] == 4 * (48 * 2 + 48 * 4) == 1152
    assert train["cross_attn_bwd_a"] == 1152 and train["cross_attn_bwd_b"] == 1152
    assert S.block_counts(8, 4, 100, 1, 1024)["cross_attn"] == 4 * (8 * 1 + 32 * 4)


FORWARD_CASES = [  # N, S, HW, T, m
    (2, 1, 37, 5, 256), (2, 1, 100, 48, 1024), (1, 2, 129, 33, 256), (2, 4, 100, 70, 256),
    (2, 4, 129, 1, 1024), (1, 2, 37, 70, 1000), (1, 1, 256, 33, 96), (3, 1, 100, 1, 256),
    # past a 256-key block: HW = 300, T = 260, and HW = 513 (a last block of one key)
    (1, 1, 300, 5, 96), (1, 2, 37, 260, 64), (1, 1, 513, 3, 32)]


@pytest.mark.parametrize("N,Sp,HW,T,m", FORWARD_CASES)
def test_forward_tiles_write_once_and_equal_plain(N, Sp, HW, T, m):
    ins = _inputs(N, Sp, HW, T, m, seed=HW + T + m)
    div = math.sqrt(m)
    (got_vis, got_lan), (count_vis, count_lan) = S.forward(*ins, Sp, div)
    assert bool((count_vis == 1).all()) and bool((count_lan == 1).all())
    want_vis, want_lan = cross_attn_plain(*ins, Sp, div)
    torch.testing.assert_close(got_vis, want_vis, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(got_lan, want_lan, rtol=1e-12, atol=1e-12)
    if T == 1:  # a softmax over one key is exactly 1
        assert torch.equal(got_vis, ins[5].expand(N * Sp, HW, m))


BACKWARD_CASES = [  # N, HW, T, m
    (2, 37, 5, 256), (2, 100, 48, 1024), (1, 129, 33, 256), (2, 100, 1, 256),
    (1, 37, 70, 1000), (1, 256, 5, 96),
    (1, 300, 5, 96), (1, 37, 260, 64), (1, 513, 2, 32)]


@pytest.mark.parametrize("N,HW,T,m", BACKWARD_CASES)
def test_backward_tiles_write_once_and_equal_autograd(N, HW, T, m):
    ins = _inputs(N, 1, HW, T, m, seed=7 * HW + T + m)
    rng = np.random.default_rng(HW * T)
    cots = [torch.from_numpy(rng.standard_normal((N, rows, m))) for rows in (HW, T)]
    div = math.sqrt(m)
    grads, scratch, counts = S.backward(*cots, *ins, div)
    for name, c in counts.items():
        assert bool((c == 1).all()), name
    leaves = [x.clone().requires_grad_() for x in ins]
    outs = cross_attn_plain(*leaves, 1, div)
    want = torch.autograd.grad(outs, leaves, cots)
    for name, g, w in zip(("dqv", "dkv", "dvv", "dqt", "dkt", "dvt"), grads, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-12 * max(1.0, float(w.abs().max())),
                                   msg=name)
    # the scratch is the plain version's probabilities
    av = torch.softmax(torch.einsum("npm,ntm->npt", ins[0], ins[4]) / div, dim=2)
    torch.testing.assert_close(scratch["pv"], av, rtol=0, atol=1e-14)


def test_forward_equals_the_jax_einsums():
    # the emulated kernel against fusion.py:85-89 in float32 at HIGHEST
    # precision (tests/conftest.py): 1e-5, the card tests' bar
    N, HW, T, m = 2, 100, 48, 256
    ins = _inputs(N, 1, HW, T, m, seed=3)
    qv, kv, vv, qt, kt, vt = (jnp.asarray(x.numpy(), jnp.float32) for x in ins)
    av = jax.nn.softmax(jnp.einsum("npm,ntm->npt", qv, kt) / math.sqrt(m), axis=2)
    at = jax.nn.softmax(jnp.einsum("ntm,npm->ntp", qt, kv) / math.sqrt(m), axis=2)
    want_vis = np.asarray(jnp.einsum("npt,ntm->npm", av, vt))
    want_lan = np.asarray(jnp.einsum("ntp,npm->ntm", at, vv))
    (got_vis, got_lan), _ = S.forward(*(x.float() for x in ins), 1, math.sqrt(m))
    np.testing.assert_allclose(got_vis.numpy(), want_vis, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_lan.numpy(), want_lan, rtol=1e-5, atol=1e-5)
