"""K5's banded backward on the CPU: ``tris_tpu_torch/tools/critic_input_schedule.py``
runs the kernel's partition (a block a band of one map's source rows, the
output rows their adjoint ranges cover formed once in the block: d cam_n's
rows, then their column adjoint, then the band's row adjoint), which must
equal the first design's two passes through the scratch bit for bit (the
same fmaf chains, emulated rounded once), write every element of d cams
once and read no row outside its band's span; both must agree with the
plain version's autograd and with ``jax.vjp`` of the JAX package's resize
and product (``tris_tpu/train/stage1.py:70-73``) laid out as
``tris_tpu/models/clip.py:199-200`` lays out the patches, within 1e-5 of
the gradient's scale (the float32 sums of the JAX matrix products and of
autograd's scatter run in other orders). The plan is pinned at the train
step's shape to ``csrc/launchers.h``'s answer, worked from the rule by hand
(the card's tests hold the extension's own answer to the tool's), and the
shapes the kernel cannot take are refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tris_tpu.train.stage1 import _resize_nhwc
from tris_tpu_torch import kernels
from tris_tpu_torch.kernels.critic_input import check_bwd_plan
from tris_tpu_torch.tools import critic_input_schedule as CS

torch.set_num_threads(2)

TRAIN_PLAN = CS.plan(48, 320, 320, 224)   # the stage-1 train step's: 48 maps, 320 -> 224

# (name, maps P, sentences S, source size, critic size, patch, planned maps): the plan
# emulated is the kernel's at the case's own shape (None) or at that many maps, cut to P
CASES = [
    ("identity_64", 2, 1, 64, 64, 16, None),             # 64 -> 64: identity taps, band 1
    ("identity_bands", 3, 3, 48, 48, 16, 48),            # identity taps in bands of 4
    ("s2_96_to_64", 4, 2, 96, 64, 16, None),             # two sentences an image
    ("train_320_to_224", 2, 1, 320, 224, 32, 48),        # the train step's bands of 8
    ("partial_band", 2, 1, 100, 64, 16, 48),             # bands of 8: the last has 4 rows
]


def _plan(P, size, n, planned):
    return CS.plan(planned or P, size, size, n)


def _inputs(P, S, size, n, ps, seed):
    rng = np.random.default_rng(seed)
    cams = rng.random((P, size, size), dtype=np.float32)
    image = rng.standard_normal((P // S, 3, size, size)).astype(np.float32)
    dA = rng.standard_normal((P * (n // ps) ** 2, 3 * ps * ps)).astype(np.float32)
    return cams, image, dA


def _jax_critic_input(cams, image, S, n, ps):
    """``tris_tpu/train/stage1.py:70-72`` (the maps and the image resized to
    the critic's size, align_corners=True, their product, an image's S
    sentences sharing it) and the patch layout of ``models/clip.py:199-200``,
    its columns (py, px, c) taken to the port's (c, py, px)."""
    P = cams.shape[0]
    cam = _resize_nhwc(cams[..., None], n)                          # [P, n, n, 1]
    img = _resize_nhwc(jnp.transpose(image, (0, 2, 3, 1)), n)      # [P/S, n, n, 3]
    x = cam * jnp.repeat(img, S, axis=0)
    g = n // ps
    p = x.reshape(P, g, ps, g, ps, 3).transpose(0, 1, 3, 2, 4, 5)   # clip.py:199
    p = p.reshape(P, g * g, ps, ps, 3).transpose(0, 1, 4, 2, 3)     # columns (c, py, px)
    return p.reshape(P * g * g, 3 * ps * ps)


@pytest.mark.parametrize("name,P,S,size,n,ps,planned", CASES, ids=[c[0] for c in CASES])
def test_banded_bwd_equals_the_first_design(name, P, S, size, n, ps, planned):
    cams, image, dA = _inputs(P, S, size, n, ps, len(name))
    visits = np.zeros((P, size, size), np.int64)
    plan = _plan(P, size, n, planned)
    if name == "partial_band":
        assert plan["band"] == 8 and size % plan["band"] == 4
    got = CS.banded_critic_input_bwd(dA, image, S, n, ps, plan=plan, visits=visits)
    assert got.shape == (P, size, size) and got.dtype == torch.float32
    assert (visits == 1).all()
    assert torch.equal(got, CS.direct_critic_input_bwd(dA, image, S, n, ps))


@pytest.mark.parametrize("name,P,S,size,n,ps,planned", CASES, ids=[c[0] for c in CASES])
def test_banded_bwd_matches_the_plain_version_and_jax(name, P, S, size, n, ps, planned):
    cams, image, dA = _inputs(P, S, size, n, ps, len(name))
    got = CS.banded_critic_input_bwd(dA, image, S, n, ps, plan=_plan(P, size, n, planned))
    c = torch.from_numpy(cams).requires_grad_()
    out = kernels.critic_input(c, torch.from_numpy(image), S, n, ps)    # the plain version
    assert torch.equal(out, kernels.critic_input_plain(c, torch.from_numpy(image), S, n, ps))
    (plain,) = torch.autograd.grad(out, c, torch.from_numpy(dA))
    _, vjp = jax.vjp(lambda m: _jax_critic_input(m, jnp.asarray(image), S, n, ps),
                     jnp.asarray(cams))
    (want,) = vjp(jnp.asarray(dA))
    want = torch.from_numpy(np.array(want))
    scale = max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert float((got - plain).abs().max()) <= 1e-5 * scale


def test_plan_at_the_train_step():
    # worked by hand from launchers.h's rule: bands of 8 rows give 48 x 40 = 1920 blocks, at
    # least the 396 of three blocks an SM; a band of 8 rows spans at most
    # bilinear_resize_bwd_span_rows(7, 320, 224) = 10 output rows and samples 10 image rows:
    # 4 * (3 * 10 * 320 + 10 * 224 + 4 * (224 + 320) + 4 * (10 + 8)) = 56352 bytes, within
    # 74 KiB; a thread a column of the larger of n and W, 320
    assert TRAIN_PLAN == {"fits": 1, "band": 8, "span_rows": 10, "img_rows": 10,
                          "threads": 320, "blocks": 1920, "smem_bytes": 56352}
    assert CS.constants() == {"kCriticBwdMaxThreads": 1024, "kCriticBwdMaxBand": 8,
                              "kCriticBwdPrefetchRows": 10, "kCriticBwdWaveBlocks": 396,
                              "kCriticBwdSmem": 75776, "kCriticBwdSmemMax": 232448}
    # the run's dA rows a thread holds in registers cover the train step's span
    assert TRAIN_PLAN["span_rows"] <= CS.constants()["kCriticBwdPrefetchRows"]


@pytest.mark.parametrize("P,H,W,n", [(48, 320, 320, 224), (2, 100, 100, 64), (1, 48, 48, 48),
                                     (7, 333, 517, 224), (1, 2, 2, 5), (64, 640, 640, 224)])
def test_span_bound_holds_for_every_band(P, H, W, n):
    # every band's output rows within the plan's span_rows, and the bands cover [0, H) once
    p = CS.plan(P, H, W, n)
    spans = CS.band_spans(H, n, p["band"])
    assert max(b[3] for b in spans) <= p["span_rows"]
    assert max(b[5] for b in spans) <= p["img_rows"]      # the image rows it stages
    assert all(Y0 - 1 <= r0 and r0 + nr <= Y1 + 1 for Y0, Y1, _, S, r0, nr in spans if S)
    assert [b[0] for b in spans] == list(range(0, H, p["band"])) and spans[-1][1] == H
    assert p["blocks"] == P * len(spans)


@pytest.mark.parametrize("P,H,W,n", [(1, 320, 60000, 224), (2, 8, 12000, 4000)])
def test_plans_past_shared_memory_are_refused(P, H, W, n):
    # one row's band past 227 KiB (its image rows, d cam_n's rows, the taps), or more columns
    # than a block's threads: the plan says so and the wrapper's check refuses it before any
    # launch
    p = CS.plan(P, H, W, n)
    assert p["band"] == 1 and not p["fits"] and p["smem_bytes"] > 232448
    with pytest.raises(ValueError, match="must fit shared memory"):
        check_bwd_plan(p, P, H, W, n)
    ok = CS.plan(48, 320, 320, 224)
    assert check_bwd_plan(ok, 48, 320, 320, 224) is ok


def test_emulated_sampling_is_the_forward():
    # the image as the backward samples it is the plain forward's resize, bit for bit
    _, image, _ = _inputs(2, 1, 100, 64, 16, 3)
    ones = torch.ones(2, 100, 100)
    fwd = kernels.critic_input_plain(ones, torch.from_numpy(image), 1, 64, 16)
    got = torch.from_numpy(CS.sampled_image(image, 64))               # [2, 3, 64, 64]
    g = 64 // 16
    want = fwd.reshape(2, g, g, 3, 16, 16).permute(0, 3, 1, 4, 2, 5).reshape(2, 3, 64, 64)
    assert torch.equal(got, want)
