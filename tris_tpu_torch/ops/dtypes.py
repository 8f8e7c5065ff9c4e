"""jnp's dtype rules, for the modules that compute in a ``dtype`` (``--bf16``).

The JAX package runs in bfloat16 through flax's ``dtype`` arguments, and jnp
rounds where PyTorch would not:

- a Python scalar takes the array's dtype before the op: ``x * 0.1`` on a
  bfloat16 ``x`` multiplies by bfloat16(0.1) = 0.10009765625, where PyTorch
  would multiply by float32(0.1) (:func:`weak`);
- ``jax.nn.softmax`` is ``exp(x - max) / sum``, each op rounded to x's dtype,
  where ``torch.softmax`` rounds once (:func:`softmax`);
- ``x / jnp.linalg.norm(x)`` is ``sqrt(sum(x * x))``, ``x * x`` rounded
  (:func:`l2_normalize`);
- operands of two dtypes promote (bfloat16 with float32 gives float32), which
  a PyTorch product refuses, and which PyTorch does not do for a 0-d float32
  tensor times a bfloat16 one (:func:`promote`).

On float32 inputs each is the float32 path's own op (``torch.softmax``,
``torch.linalg.vector_norm``). Below float32 the gradients of :func:`softmax`
and :func:`l2_normalize` are JAX's VJPs written out, each op rounded where the
VJP's jaxpr rounds (autograd's own formulas round elsewhere).
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def weak(value: float, dtype: torch.dtype) -> float:
    """``value`` as jnp casts a Python scalar to an array's ``dtype``."""
    return float(torch.tensor(value, dtype=dtype, device="cpu"))


def promote(*tensors) -> torch.dtype:
    """The dtype jnp gives an op on ``tensors`` (None ones skipped)."""
    dtype = None
    for t in tensors:
        if t is not None:
            dtype = t.dtype if dtype is None else torch.promote_types(dtype, t.dtype)
    return dtype


def _sum(x: torch.Tensor, dim) -> torch.Tensor:
    """jnp's sum in x's dtype: accumulated in float32, rounded once."""
    return x.sum(dim=dim, keepdim=True, dtype=torch.float32).to(x.dtype)


def reduce_sum(x: torch.Tensor, dims) -> torch.Tensor:
    """``lax.reduce_sum`` in x's dtype over ``dims`` (kept), the VJPs'
    reductions below float32, as a GPU compile runs it: :func:`_sum`. (XLA's
    CPU compile adds in x's dtype instead, each add rounded, in windows of
    32; the CPU tests against JAX put that order in this function's place.)"""
    return _sum(x, dims)


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, shape):
        ctx.shape = p.shape
        return p.expand(shape)

    @staticmethod
    def backward(ctx, g):
        lead = g.dim() - len(ctx.shape)
        dims = tuple(range(lead)) + tuple(lead + i for i, n in enumerate(ctx.shape)
                                          if n == 1 and g.shape[lead + i] != 1)
        return (reduce_sum(g, dims) if dims else g).reshape(ctx.shape), None


def broadcast_to(p: torch.Tensor, shape) -> torch.Tensor:
    """``p`` broadcast to ``shape`` (a view); below float32 its gradient is
    the cotangent's :func:`reduce_sum` over the broadcast dimensions, as
    JAX's VJP of ``broadcast_in_dim``."""
    if not low(p):
        return p.expand(shape)
    return _Broadcast.apply(p, tuple(shape))


class _SoftmaxLow(torch.autograd.Function):
    """``jax.nn.softmax`` below float32 and its VJP: with ``w`` the rounded
    sum, ``dx = (g / w - sum(g w^-2 e)) e``, each op rounded."""

    @staticmethod
    def forward(ctx, x, dim):
        e = (x - x.amax(dim=dim, keepdim=True)).exp()
        w = _sum(e, dim)
        ctx.dim = dim
        ctx.save_for_backward(e, w)
        return e / w

    @staticmethod
    def backward(ctx, g):
        e, w = ctx.saved_tensors
        t = g * (1 / (w * w)) * e
        return (g / w + -reduce_sum(t, ctx.dim)) * e, None


def low(x: torch.Tensor) -> bool:
    """Whether x's dtype is below float32 (bfloat16): jnp's rounding points apply."""
    return x.dtype.itemsize < 4


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.nn.softmax``: in float32 ``torch.softmax``; in a lower precision
    ``e = exp(x - max)`` then ``e / sum(e)``, each op rounded to x's dtype
    (the sum accumulated in float32), with JAX's VJP; in float64 (a
    reference) the same ops unrounded."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=dim)
    if low(x):
        return _SoftmaxLow.apply(x, dim)
    e = (x - x.amax(dim=dim, keepdim=True)).exp()
    return e / e.sum(dim=dim, keepdim=True)


class _L2NormalizeLow(torch.autograd.Function):
    """``x / norm(x)`` below float32 and JAX's VJP: with ``c`` the rounded
    norm, ``dx = g / c + 2 x (-sum(g c^-2 x) (0.5 / c))``, each op rounded."""

    @staticmethod
    def forward(ctx, x):
        c = _sum(x * x, -1).sqrt()
        ctx.save_for_backward(x, c)
        return x / c

    @staticmethod
    def backward(ctx, g):
        x, c = ctx.saved_tensors
        r = -reduce_sum(g * (1 / (c * c)) * x, -1) * (0.5 / c)
        xr = x * r
        return g / c + (xr + xr)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """``x / jnp.linalg.norm(x, axis=-1, keepdims=True)``: in float32 by
    ``torch.linalg.vector_norm``; in a lower precision ``sqrt(sum(x * x))``,
    each op rounded to x's dtype (the sum accumulated in float32), with JAX's
    VJP; in float64 (a reference) the same ops unrounded."""
    if x.dtype == torch.float32:
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    if low(x):
        return _L2NormalizeLow.apply(x)
    return x / (x * x).sum(dim=-1, keepdim=True).sqrt()
