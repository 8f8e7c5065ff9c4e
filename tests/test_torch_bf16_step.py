"""``--bf16`` stage-1 training, the whole step: the port's ``stage1_loss``
and every gradient on the CPU (the kernel wrappers take their plain
versions) against the JAX package's strict ``dtype=bfloat16`` compile, in
the three leaf regimes of ``tests/test_torch_bf16_train.py`` (whose fixtures
this file shares), with and without negatives and on the u8 feed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_bf16 import dist, np_of
from tests.test_torch_bf16_train import (  # noqa: F401  (the fixtures)
    F32,
    critic,
    jax_step,
    port_stage1,
    port_step,
    stage1,
    xla_cpu_sums,
)
from tests.test_torch_train import make_batch
from tris_tpu.train.stage1 import Stage1LossWeights as JWeights, stage1_loss as j_stage1_loss
from tris_tpu_torch.ckpt.from_jax import grads_from_flax


_DEFAULT = {}
PLANTED = (-1.0, 0.0, 2.0, 1.1)  # the planted faults the test counts: a value times these


def jax_step_default(model, variables, jc, cv, batch):
    """JAX's step as ``jax.jit`` compiles it by default (XLA free to keep
    bfloat16 intermediates in float32): a second legitimate bfloat16 step."""
    key = id(model)
    if key not in _DEFAULT:
        _DEFAULT[key] = jax.jit(jax.value_and_grad(
            lambda p, s, cv, b: j_stage1_loss(p, s, model, jc, cv, b, JWeights()), has_aux=True))
    (_, (_, metrics)), grads = _DEFAULT[key](variables["params"], variables["batch_stats"], cv,
                                             {k: jnp.asarray(a) for k, a in batch.items()})
    return {k: float(m) for k, m in metrics.items()}, grads


@pytest.mark.parametrize("regime,u8,negatives", [("seeded", True, True),
                                                 ("seeded", False, False),
                                                 ("pretrain", True, True),
                                                 ("clip", True, True)])
def test_stage1_loss_bf16_matches_jax(stage1, critic, regime, u8, negatives):
    # stage1_loss and every parameter's gradient of the port's bfloat16 step
    # against JAX's strict bfloat16 compile. A whole step is chaotic in
    # bfloat16: one ulp anywhere (a batch mean summed in another order, a
    # convolution's sums) flips a rounding, which a ReLU network spreads, so
    # JAX's own default compile lies about the bf16-f32 gap from its strict
    # one (median over the losses and leaves 0.83 to 1.10 of the gap,
    # measured), and no route that is not XLA's bit for bit comes within a
    # quarter of it. The bars are therefore JAX's own spread: over the
    # losses and leaves the port's median distance from the strict compile
    # is at most 1.25 times the default compile's; each one within 4 times
    # the larger of the gap and the default compile's distance (the tail of
    # that spread: 3.4 measured); and the port's median distance from its
    # own float32 route at least half the gap (it computes in bfloat16).
    # Leaves with no gradient and the biases right before an InstanceNorm
    # (rounding noise) are skipped as in the float32 test. The four places
    # this slice repaired are held bit for bit by the module tests above.
    # What the per-leaf bar can see: the gap on a whole step is a median 0.34
    # to 0.49 of a leaf's largest gradient, so a leaf's gradient off by 10 %
    # moves it by about a quarter of the gap, within the spread; no bar on
    # the leaf's own default-compile distance holds it either (the port lies
    # up to 10.6 times that distance, where the two compiles happen to
    # agree). The test prints, from its own values, how many losses and
    # leaves a planted fault (the value negated, zeroed, doubled or 10 %
    # too large) would fail the bar on.
    j32, j16, regimes, v32 = stage1
    jc, cv, tc = critic
    v = regimes[regime]
    batch = make_batch(13 if u8 else 14, u8=u8, negatives=negatives)
    jm16, jg16 = jax_step(j16, v, jc, cv, batch)
    jm32, jg32 = jax_step(j32, v32, jc, cv, batch)
    jmd, jgd = jax_step_default(j16, v, jc, cv, batch)
    pm16, t16 = port_step(port_stage1(v), tc, batch)
    pm32, t32 = port_step(port_stage1(v32, F32), tc, batch)
    rows = [(k, pm16[k], pm32[k], jm16[k], jm32[k], jmd[k])
            for k in ("loss", "l1", "l4") + (("l5",) if negatives else ())]
    w16, w32, wd = grads_from_flax(jg16), grads_from_flax(jg32), grads_from_flax(jgd)
    p16, p32 = dict(t16.named_parameters()), dict(t32.named_parameters())
    for k in w16:
        if not float(w32[k].abs().max()) > 0 or ("attn_fusion.v_" in k and k.endswith(".0.bias")):
            continue
        assert p16[k].grad.dtype == w16[k].dtype, k
        rows.append((f"d {k}", *(np_of(t) for t in (p16[k].grad, p32[k].grad, w16[k], w32[k],
                                                     wd[k]))))
    got, floor, away, gaps = [], [], [], []
    caught = dict.fromkeys(PLANTED, 0)
    for what, port16, port32, jax16, jax32, jaxd in rows:
        gap = dist(jax16, jax32, jax32)
        assert gap > 0, what
        gaps.append(gap)
        got.append(dist(port16, jax16, jax32) / gap)
        floor.append(dist(jaxd, jax16, jax32) / gap)
        away.append(dist(port16, port32, jax32) / gap)
        bar = 4 * max(1.0, floor[-1])
        assert got[-1] <= bar, (what, got[-1], floor[-1])
        for f in PLANTED:
            caught[f] += dist(f * np.asarray(port16, np.float64), jax16, jax32) / gap > bar
    worst = int(np.argmax(np.asarray(got) / np.maximum(1.0, floor)))
    print(f"{regime}: {len(rows)} losses and leaves; median shares of the gap: the port "
          f"{np.median(got):.3f} from JAX strict, JAX default {np.median(floor):.3f}, the port "
          f"{np.median(away):.3f} from its float32 route; worst {rows[worst][0]} at "
          f"{got[worst]:.3f} (JAX default {floor[worst]:.3f}); the gap a median "
          f"{np.median(gaps):.3f} of the scale; the port at most "
          f"{max(g / f for g, f in zip(got, floor) if f > 0):.3g} times JAX default's distance; "
          "a planted fault fails the bar "
          + ", ".join(f"on {n} (the value times {f})" for f, n in caught.items()))
    assert np.median(got) <= 1.25 * np.median(floor)
    assert np.median(away) >= 0.5


