"""``--bf16`` on stage 2's eval path, the whole model: the port's
``TRISStage2`` in bfloat16 (its eval forward, ``response_maps``, ``validate
--stage 2`` and the demo's ``norm_cam``) against the JAX package's strict
``dtype=bfloat16`` compile, on the CPU, in the seeded and the float32-checkpoint
leaf regimes, with ``tests/test_torch_bf16_stage2.py``'s fixtures (its
modules, each the same bits as JAX's, and the dtype table are held there).

Bars, in shares of JAX's bfloat16-float32 gap (distances
``max |a - b| / max |f32|``, ``tests/test_torch_bf16.py``):

- the whole model (the eval forward, ``response_maps``, the demo's map):
  chaotic in bfloat16. One float32 sum rounded apart (a convolution's, in
  oneDNN's order where XLA takes Eigen's; the float32 text stream's, on
  float32 leaves) flips a bfloat16 rounding, which the decoder's PReLUs and
  the attention's softmax spread, so JAX's own default compile lies 0.53 to
  1.6 of the gap from its strict one at these inputs (max distance; 0.53 to
  1.5 in mean distance, ``mean |a - b| / mean |a32 - b16|``), and no route
  short of XLA's bits comes within a quarter of it (the port: 0.30 to 0.89,
  its first flips in ``reduced_c1``'s convolution and in the SOT token's
  text features, every module upstream the same bits). As for stage 1's
  whole train step (``tests/test_torch_bf16_step.py``), the bars are JAX's
  own spread, measured in the test: the port's mean distance within 1.25
  times the default compile's (measured 0.02 to 0.56 against 0.53 to 1.5),
  its max within twice the larger of a quarter and the default compile's
  (0.30 to 0.89 against 0.53 to 1.6), and at least half the gap from its
  own float32 route;
- ``validate --stage 2``: each metric within a quarter of JAX's gap, or
  1e-4, or 1.25 times JAX's two compiles' distance, whichever is largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bf16 import _jax_exact, dist, jit_exact, np_of
from tests.test_torch_bf16_stage2 import (  # noqa: F401  (the fixtures)
    BF16,
    F32,
    REGIMES,
    TEXT,
    _eval_forward,
    _nchw,
    image_path,
    port_stage2,
    refdata,
    stage2,
)
from tests.test_torch_models import make_inputs
from tris_tpu.cli import demo as jdemo
from tris_tpu.data.dataset import Loader as JLoader, ReferSegDataset as JDataset
from tris_tpu.eval.validate import resize_to_original_np as j_resize, validate as j_validate
from tris_tpu_torch.cli import demo
from tris_tpu_torch.data.dataset import Loader, ReferSegDataset
from tris_tpu_torch.eval.validate import validate

torch.set_num_threads(2)

SPREAD_SHARE = 1.25   # the whole model's bars: times JAX's own two compiles' mean distance,
TAIL_SHARE = 2.0      # and times the larger of a quarter and their max distance
METRIC_FLOOR = 1e-4


def mean_dist(a, b, scale) -> float:
    """``mean |a - b| / mean |scale|``: the central counterpart of ``dist``."""
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return float(np.abs(a - b).mean() / np.abs(np.asarray(scale, np.float64)).mean())


def spread_bars(port16, port32, jax16, jax32, jax16_default, what):
    """The whole model's bars (the module docstring), in shares of JAX's
    bfloat16-float32 gap: the mean distance from JAX's strict compile within
    ``SPREAD_SHARE`` times JAX's default compile's, the max within
    ``TAIL_SHARE`` times the larger of a quarter and the default compile's
    max, and at least half the gap from the port's float32 route. Returns
    the shares."""
    gap, mgap = dist(jax16, jax32, jax32), mean_dist(jax16, jax32, jax32)
    got = dist(port16, jax16, jax32) / gap
    mgot = mean_dist(port16, jax16, jax32) / mgap
    spread = dist(jax16_default, jax16, jax32) / gap
    mspread = mean_dist(jax16_default, jax16, jax32) / mgap
    away = dist(port16, port32, jax32) / gap
    print(f"{what}: gap {gap:.4g} (mean {mgap:.4g}); the port at {got:.3g} of it (mean "
          f"{mgot:.3g}), JAX's two compiles {spread:.3g} apart (mean {mspread:.3g}), the port "
          f"{away:.3g} of it from its float32 route")
    assert gap > 0, f"{what}: bfloat16 and float32 agree, the test is vacuous"
    assert mgot <= SPREAD_SHARE * mspread, f"{what}: mean {mgot:.3g}, JAX's {mspread:.3g}"
    assert got <= TAIL_SHARE * max(0.25, spread), f"{what}: max {got:.3g}, JAX's {spread:.3g}"
    assert away >= 0.5, f"{what}: port bf16 only {away:.3g} of the gap from port f32"
    return got, mgot




_JAX = {}


def jax_outputs(stage2, regime, name, fn, *inputs):
    """JAX's (strict bfloat16, default bfloat16, strict float32) outputs of
    ``fn(model, variables, *inputs)`` in ``regime``, each compile once a module."""
    key = (regime, name)
    if key not in _JAX:
        j32, j16, regimes, v32 = stage2
        v = regimes[regime]
        _JAX[key] = (jit_exact(lambda v, *a: fn(j16, v, *a))(v, *inputs),
                     jax.jit(lambda v, *a: fn(j16, v, *a))(v, *inputs),
                     jit_exact(lambda v, *a: fn(j32, v, *a))(v32, *inputs))
    return _JAX[key]


def _response_maps(m, v, img, ids):
    return m.apply(v, img, ids, method="response_maps")


@pytest.mark.parametrize("regime", REGIMES)
def test_eval_forward_bf16_matches_jax(stage2, regime):
    # TRISStage2's eval forward (out1, bfloat16 logits in both regimes: the head's last
    # 1x1 convolution), 2 images at 64 px (measured: the port 0.30 and 0.84 of the gap
    # from JAX's strict compile, JAX's default compile 0.89 and 1.17)
    _, _, regimes, v32 = stage2
    img, ids = make_inputs(2, 1, seed=1)
    ids = ids[:, 0]
    want16, want_default, want32 = jax_outputs(stage2, regime, "eval", _eval_forward, img, ids)
    with torch.no_grad():
        got16 = port_stage2(regimes[regime])(_nchw(img), torch.from_numpy(ids))
        got32 = port_stage2(v32, F32)(_nchw(img), torch.from_numpy(ids))
    assert got16.dtype == BF16 and want16.dtype == jnp.bfloat16
    assert tuple(got16.shape) == (2, 1, 64, 64)
    p = lambda t: np_of(t).transpose(0, 2, 3, 1)  # noqa: E731
    spread_bars(p(got16), p(got32), want16, want32, want_default, f"eval forward ({regime})")


@pytest.mark.parametrize("regime", REGIMES)
def test_response_maps_bf16_matches_jax(stage2, regime):
    # the eval maps of 2 images x 2 sentences: the port's trunk, reduced_c1 and
    # PixelAttention's per-image half once an image, JAX's pyramid repeated
    _, _, regimes, v32 = stage2
    img, ids = make_inputs(2, 2, seed=6)
    want16, want_default, want32 = jax_outputs(stage2, regime, "maps", _response_maps, img, ids)
    with torch.no_grad():
        got16 = port_stage2(regimes[regime]).response_maps(_nchw(img), torch.from_numpy(ids))
        got32 = port_stage2(v32, F32).response_maps(_nchw(img), torch.from_numpy(ids))
    assert got16.dtype == BF16 and want16.dtype == jnp.bfloat16
    spread_bars(np_of(got16), np_of(got32), want16, want32, want_default,
                f"response maps ({regime})")


@pytest.mark.parametrize("regime", REGIMES)
def test_validate_stage2_bf16_matches_jax(stage2, refdata, regime, monkeypatch):
    # validate --stage 2 on 6 refs x 2 sentences at 64 px in batches of 4 with the box
    # metrics: the maps cast to float32 before the metrics, as JAX casts them
    j32, j16, regimes, v32 = stage2
    v = regimes[regime]
    kw = dict(with_boxes=True, device_resize=True, host_threads=1)
    jds = JDataset(refdata, split="train", size=64, eval_mode=True)
    tds = ReferSegDataset(refdata, split="train", size=64, eval_mode=True)
    jl = lambda: JLoader(jds, 4, shuffle=False, drop_last=False, num_threads=1)  # noqa: E731
    tl = lambda: Loader(tds, 4, shuffle=False, drop_last=False, num_threads=1)  # noqa: E731
    want16 = _jax_exact(monkeypatch, lambda: j_validate(j16, v, jl(), **kw))
    want_default = j_validate(j16, v, jl(), **kw)
    want32 = j_validate(j32, v32, jl(), **kw)
    got16 = validate(port_stage2(v), tl(), **kw)
    got32 = validate(port_stage2(v32, F32), tl(), **kw)
    print(f"validate --stage 2 ({regime}): " + ", ".join(
        f"{k} {got16[k]:.4f} (JAX bf16 {want16[k]:.4f}, default {want_default[k]:.4f}, f32 "
        f"{want32[k]:.4f})" for k in ("mIoU", "oIoU", "hit")))
    assert set(got16) == set(want16) == set(want32)
    for k in want16:
        bar = max(abs(want16[k] - want32[k]) / 4, METRIC_FLOOR,
                  SPREAD_SHARE * abs(want_default[k] - want16[k]))
        assert abs(got16[k] - want16[k]) <= bar, (regime, k, got16[k], want16[k], bar)
        assert abs(got32[k] - want32[k]) <= METRIC_FLOOR, (regime, k)
    assert 0 < got16["mIoU"] < 100


@pytest.mark.parametrize("regime", REGIMES)
def test_demo_cam_bf16_matches_jax(stage2, image_path, regime):
    # the demo's compute with --bf16: one eval forward on the image array and the two
    # phrases' 40 tokens (K11's bucket 40), the logits cast to float32, the upsample to
    # the original size and the min-max normalisation; the logits and norm_cam held to
    # the whole model's bars, norm_cam against JAX's own on the same logits' route
    _, _, regimes, v32 = stage2
    img, ids, h, w, _ = demo.prepare_data(image_path, TEXT, 64, 20)
    want16, want_default, want32 = jax_outputs(stage2, regime, "demo", _eval_forward,
                                               img[None], ids[None])
    got16 = demo.norm_cam_of(port_stage2(regimes[regime]), img, ids, h, w)
    got32 = demo.norm_cam_of(port_stage2(v32, F32), img, ids, h, w)
    cams = [jdemo.get_norm_cam(j_resize(np.asarray(o)[0, :, :, 0], h, w))
            for o in (want16, want_default, want32)]
    assert got16.shape == (90, 120) and got16.dtype == np.float32
    spread_bars(got16, got32, *cams, f"demo norm_cam ({regime})")
    with torch.no_grad():
        logits = port_stage2(regimes[regime])(_nchw(img[None]), torch.from_numpy(ids[None]))
    assert logits.dtype == BF16
