"""XLA's CPU order for ``lax.reduce_sum`` below float32, for the CPU tests
that hold the port's bfloat16 gradients against JAX's strict compile.

The port's VJPs reduce as a GPU compile does (``tris_tpu_torch.ops.dtypes
.reduce_sum``: accumulated in float32, rounded once). XLA's CPU compile adds
in x's dtype instead, each add rounded: where a reduced dimension is longer
than 32, in windows (each such dimension cut in windows of 32, padded evenly
at both ends, the others whole), each summed row-major, then the windows'
sums reduced alike; else row-major. :func:`use_xla_cpu_sums` puts
:func:`xla_cpu_reduce_sum` in the port's place, so that the two compute the
same roundings; ``tests/test_torch_bf16_sums.py`` holds the port's own
formula against JAX.
"""

from __future__ import annotations

import itertools

import torch

from tris_tpu_torch.models import layers
from tris_tpu_torch.ops import dtypes

XLA_WINDOW = 32  # XLA's CPU compile sums a reduced dimension longer than this in windows


def _in_order(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum along ``dim`` (kept), element by element, each add rounded to
    x's dtype."""
    acc = x.narrow(dim, 0, 1)
    for i in range(1, x.shape[dim]):
        acc = acc + x.narrow(dim, i, 1)
    return acc


def _flat_in_order(x: torch.Tensor, dims) -> torch.Tensor:
    """The sum over ``dims`` (kept), row-major, each add rounded."""
    tail = tuple(range(x.dim() - len(dims), x.dim()))
    moved = x.movedim(dims, tail)
    out = _in_order(moved.reshape(*moved.shape[:x.dim() - len(dims)], -1), -1)
    return out.reshape(*out.shape[:-1], *([1] * len(dims))).movedim(tail, dims)


def _window_starts(n: int) -> list:
    """XLA's windows over a reduced dimension of ``n``: one if it is at most
    32 long, else windows of 32 with the padding split evenly at both ends."""
    if n <= XLA_WINDOW:
        return [(0, n)]
    lo = (-(-n // XLA_WINDOW) * XLA_WINDOW - n) // 2
    return [(max(0, s), min(n, s + XLA_WINDOW)) for s in range(-lo, n, XLA_WINDOW)]


def xla_cpu_reduce_sum(x: torch.Tensor, dims) -> torch.Tensor:
    """``lax.reduce_sum`` in x's dtype over ``dims`` (kept), as XLA's CPU
    compile runs it (the module docstring)."""
    dims = (dims,) if isinstance(dims, int) else dims
    dims = tuple(sorted(d % x.dim() for d in dims))
    if all(x.shape[d] <= XLA_WINDOW for d in dims):
        return _flat_in_order(x, dims)
    cuts = [_window_starts(x.shape[d]) for d in dims]
    shape = list(x.shape)
    for d, c in zip(dims, cuts):
        shape[d] = len(c)
    out = x.new_empty(shape)
    for combo in itertools.product(*(range(len(c)) for c in cuts)):
        part, index = x, [slice(None)] * x.dim()
        for d, c, k in zip(dims, cuts, combo):
            part = part.narrow(d, c[k][0], c[k][1] - c[k][0])
            index[d] = slice(k, k + 1)
        out[tuple(index)] = _flat_in_order(part, dims)
    return xla_cpu_reduce_sum(out, dims)


def use_xla_cpu_sums(monkeypatch) -> None:
    """The port's VJP reductions in XLA's CPU order for one test."""
    for module in (dtypes, layers):
        monkeypatch.setattr(module, "reduce_sum", xla_cpu_reduce_sum)
