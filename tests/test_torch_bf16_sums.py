"""The port's own VJP reductions below float32 against JAX, on the CPU.

The bfloat16 VJPs (the bias broadcast, softmax, InstanceNorm, the
l2-normalise) reduce with ``tris_tpu_torch.ops.dtypes.reduce_sum``:
accumulated in float32, rounded once, as a GPU compile runs it, and as the
port runs it on every device. The other bfloat16 tests put XLA's CPU order
in its place (``tests/xla_cpu_sums.py``), to meet a quarter of the
bfloat16-float32 gap from JAX's strict CPU compile; this file runs the
port's formula itself against that compile, at bars of its own.

A float32 accumulation rounds once where XLA's CPU compile rounds each add,
so the two are two bfloat16 results of one gradient: a gradient that a
reduction forms (a bias's, or one through InstanceNorm's or softmax's
statistics) lies up to about the gap from JAX's (1.24 of it measured, the
bfloat16 leaves' v_proj3.1.bias), and everything else is JAX's bits. The
bars: each value within 1.5 gaps of JAX's bfloat16 one and within 2 gaps of
JAX's float32 one (1.59 measured), and the median over a module's outputs
and gradients within three quarters of the gap of JAX's bfloat16 ones (0 for
the text block, 0.25 and 0.49 for BilateralPrompt's two mixes, 0.39 for the
l2-normalise, measured). Each case prints its numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bf16 import dist, jit_exact, np_of
from tests.test_torch_bf16_train import bilateral_prompt_rows, text_block_rows
from tris_tpu_torch.ops.dtypes import l2_normalize


def l2_normalize_rows():
    """``x / jnp.linalg.norm(x, axis=-1, keepdims=True)`` (stage 1's
    norm_vis and norm_lan) on bfloat16 x of 48 channels, forward and its
    gradient, as :func:`tests.test_torch_bf16_train.text_block_rows`."""
    rng = np.random.default_rng(31)
    x = np.asarray(jnp.asarray(rng.standard_normal((4, 6, 48)), jnp.bfloat16))
    g = rng.standard_normal((4, 6, 48)).astype(np.float32)

    def run(xx, gg):
        out, vjp = jax.vjp(lambda t: t / jnp.linalg.norm(t, axis=-1, keepdims=True), xx)
        return out, vjp(gg.astype(out.dtype))[0]

    want = {dt: jit_exact(run)(np.asarray(x, dt), g) for dt in (jnp.bfloat16, jnp.float32)}
    got = {}
    for dt in (torch.bfloat16, torch.float32):
        xt = torch.from_numpy(np.asarray(x, np.float32)).to(dt).requires_grad_(True)
        y = l2_normalize(xt)
        y.backward(torch.from_numpy(g).to(dt))
        got[dt] = (y, xt.grad)
    assert got[torch.bfloat16][1].dtype == torch.bfloat16
    return [(np_of(got[torch.bfloat16][i]), np_of(got[torch.float32][i]),
             want[jnp.bfloat16][i], want[jnp.float32][i], f"l2-normalise {name}")
            for i, name in enumerate(("y", "dx"))]


CASES = {"text_block": text_block_rows,
         "bilateral_f32_vision": lambda: bilateral_prompt_rows("f32_vision"),
         "bilateral_bf16": lambda: bilateral_prompt_rows("bf16"),
         "l2_normalize": l2_normalize_rows}


@pytest.mark.parametrize("case", list(CASES))
def test_card_sums_match_jax(case):
    shares = []
    for port16, _, jax16, jax32, what in CASES[case]():
        gap = dist(jax16, jax32, jax32)
        got, to_f32 = dist(port16, jax16, jax32), dist(port16, jax32, jax32)
        if gap == 0:  # float32 throughout (the float32-vision mix's v_output.1.bias)
            assert got <= 1e-6, what
            continue
        print(f"{what}: gap {gap:.4g}, the port at {got / gap:.3g} of it from JAX's bfloat16, "
              f"{to_f32 / gap:.3g} of it from JAX's float32")
        assert got <= 1.5 * gap, what
        assert to_f32 <= 2 * gap, what
        shares.append(got / gap)
    print(f"{case}: median {np.median(shares):.3g} of the gap over {len(shares)} values")
    assert np.median(shares) <= 0.75
