"""Parity of the PyTorch port's layers and ops with the JAX package, on the
CPU in float32 (the kernel wrappers take their plain versions there).

Inputs are made with numpy from a seed and fed to both sides; weights cross
over through ``tris_tpu_torch.ckpt.from_jax``. Bars are those of
tests/test_layers_parity.py (2e-5 to 1e-4), stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tris_tpu.models import layers as jl
from tris_tpu.ops.normalize import image_input_to_f32 as j_u8
from tris_tpu.ops.resize import bilinear_resize as j_bilinear, nearest_resize as j_nearest
from tris_tpu_torch.ckpt.from_jax import state_dict_from_flax
from tris_tpu_torch.models import layers as tl
from tris_tpu_torch.ops.normalize import image_input_to_f32 as t_u8
from tris_tpu_torch.ops.resize import bilinear_resize as t_bilinear, nearest_resize as t_nearest

torch.set_num_threads(2)


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _init(module, *args, seed=0, **kw):
    v = jax.jit(lambda k: module.init(k, *args, **kw))(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, v)


def _load(module, variables):
    module.load_state_dict(state_dict_from_flax(variables), strict=True)
    return module.eval()


@pytest.mark.parametrize("L,causal", [(20, True), (17, False)])
def test_multi_head_attention(L, causal):
    # 1e-5: einsum + softmax in f32 on both sides, summation order differs
    rng = np.random.default_rng(L)
    N, C, H = 3, 64, 4
    q, k, v = (rng.standard_normal((N, L, C)).astype(np.float32) for _ in range(3))
    jmask = jl.causal_mask(L) if causal else None
    tmask = tl.causal_mask(L) if causal else None
    want = np.asarray(jax.jit(jl.multi_head_attention, static_argnums=3)(q, k, v, H, jmask))
    got = tl.multi_head_attention(*map(torch.from_numpy, (q, k, v)), H, tmask)
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


def test_residual_attention_block():
    # 5e-5: a LayerNorm, attention and a 4x MLP in f32
    rng = np.random.default_rng(1)
    N, L, C, H = 2, 20, 32, 4
    x = rng.standard_normal((N, L, C)).astype(np.float32)
    jmod = jl.ResidualAttentionBlock(C, H)
    v = _init(jmod, x, jl.causal_mask(L))
    want = np.asarray(jax.jit(jmod.apply)(v, x, jl.causal_mask(L)))
    tmod = _load(tl.ResidualAttentionBlock(C, H), v)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), tl.causal_mask(L))
    np.testing.assert_allclose(_np(got), want, rtol=5e-5, atol=5e-5)


def test_attention_pool_2d():
    # 5e-5: positional-embedding resize + 101-token-style attention, f32
    rng = np.random.default_rng(2)
    N, Hs, Ws, C = 2, 3, 4, 64
    x = rng.standard_normal((N, Hs, Ws, C)).astype(np.float32)
    jmod = jl.AttentionPool2d(spacial_dim=2, embed_dim=C, num_heads=4, output_dim=48)
    v = _init(jmod, x)
    g_want, m_want = jax.jit(jmod.apply)(v, x)
    tmod = _load(tl.AttentionPool2d(2, C, 4, 48), v)
    with torch.no_grad():
        g, m = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(_np(g), np.asarray(g_want), rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(_np(m.permute(0, 2, 3, 1)), np.asarray(m_want), rtol=5e-5, atol=5e-5)


def test_instance_norm_2d():
    # 2e-5: mean / biased variance / rsqrt over the spatial axes
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 6, 8)).astype(np.float32) * 3 + 1
    jmod = jl.InstanceNorm2d(8)
    v = {"params": {"scale": rng.standard_normal(8).astype(np.float32),
                    "bias": rng.standard_normal(8).astype(np.float32)}}
    want = np.asarray(jax.jit(jmod.apply)(v, x))
    tmod = _load(tl.InstanceNorm2d(8), v)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), want, rtol=2e-5, atol=2e-5)


def _bn_variables(rng, C):
    return {"params": {"scale": (1 + 0.3 * rng.standard_normal(C)).astype(np.float32),
                       "bias": rng.standard_normal(C).astype(np.float32)},
            "batch_stats": {"mean": rng.standard_normal(C).astype(np.float32),
                            "var": (0.5 + rng.random(C)).astype(np.float32)}}


def test_torch_batch_norm_eval():
    # 2e-5 (the folded x*a+b is the same arithmetic on both sides)
    rng = np.random.default_rng(4)
    C = 6
    x = rng.standard_normal((2, 5, 7, C)).astype(np.float32)
    jmod = jl.TorchBatchNorm()
    v = _bn_variables(rng, C)
    want = np.asarray(jax.jit(lambda v, x: jmod.apply(v, x, use_running_average=True))(v, x))
    tmod = _load(tl.TorchBatchNorm(C), v)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)), want, rtol=2e-5, atol=2e-5)


def test_torch_batch_norm_train():
    # 2e-5: batch statistics normalise, the running variance takes the
    # unbiased batch variance (torch's rule) with momentum 0.1
    rng = np.random.default_rng(5)
    C = 6
    x = (2 * rng.standard_normal((3, 5, 7, C)) + 1).astype(np.float32)
    jmod = jl.TorchBatchNorm()
    v = _bn_variables(rng, C)
    want, upd = jax.jit(lambda v, x: jmod.apply(v, x, use_running_average=False,
                                                 mutable=["batch_stats"]))(v, x)
    tmod = _load(tl.TorchBatchNorm(C), v).train()
    got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)), np.asarray(want), rtol=2e-5, atol=2e-5)
    for leaf, buf in (("mean", tmod.running_mean), ("var", tmod.running_var)):
        np.testing.assert_allclose(_np(buf), np.asarray(upd["batch_stats"][leaf]), rtol=2e-5, atol=2e-5)


def test_prelu():
    # exact: one select and one product
    x = np.random.default_rng(8).standard_normal((2, 3, 4, 5)).astype(np.float32)
    v = {"params": {"alpha": np.array([0.3], np.float32)}}
    want = np.asarray(jl.PReLU().apply(v, x))
    tmod = _load(tl.PReLU(), v)
    with torch.no_grad():
        np.testing.assert_array_equal(_np(tmod(torch.from_numpy(x))), want)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("size", [(13, 29), (5, 4)])
def test_bilinear_resize(align_corners, size):
    # 1e-5: JAX's float64-built matrices vs F.interpolate's float32 weights
    x = np.random.default_rng(5).standard_normal((2, 3, 9, 11)).astype(np.float32)
    want = np.asarray(j_bilinear(jnp.asarray(x), size, align_corners=align_corners))
    got = t_bilinear(torch.from_numpy(x), size, align_corners=align_corners)
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("exact", [True, False])
def test_nearest_resize(exact):
    # exact: pure index selection
    x = np.random.default_rng(6).integers(0, 9, (2, 7, 10)).astype(np.float32)
    for size in ((15, 23), (3, 4)):
        want = np.asarray(j_nearest(jnp.asarray(x), size, exact=exact))
        got = t_nearest(torch.from_numpy(x), size, exact=exact)
        np.testing.assert_array_equal(_np(got), want)


def test_u8_normalize():
    # 1 ulp: the same multiply-add in f32 on both sides
    x = np.random.default_rng(7).integers(0, 256, (2, 6, 5, 3)).astype(np.uint8)
    want = np.asarray(j_u8(jnp.asarray(x)))
    got = t_u8(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)
    f = torch.zeros(1, 2, 2, 3)
    assert t_u8(f) is f  # float input passes through
