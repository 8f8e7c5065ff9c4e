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
``torch.linalg.vector_norm``).
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


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.nn.softmax``: in float32 ``torch.softmax``; in a lower precision
    ``e = exp(x - max)`` then ``e / sum(e)``, each op rounded to x's dtype
    (the sum accumulated in float32)."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=dim)
    e = (x - x.amax(dim=dim, keepdim=True)).exp()
    return e / e.sum(dim=dim, keepdim=True)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """``x / jnp.linalg.norm(x, axis=-1, keepdims=True)``: in float32 by
    ``torch.linalg.vector_norm``; in a lower precision ``sqrt(sum(x * x))``,
    each op rounded to x's dtype (the sum accumulated in float32)."""
    if x.dtype == torch.float32:
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / (x * x).sum(dim=-1, keepdim=True).sqrt()
