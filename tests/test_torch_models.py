"""Parity of the PyTorch port's models with the JAX package, on the CPU in
float32 (the kernel wrappers take their plain versions there): CLIP-RN
towers, BilateralPrompt, TRISStage1's eval paths, and the state_dict key
layout (round trip through the JAX package's own converter).

Weights: the JAX init, with every norm scale/bias and BN running statistic
redrawn from a seeded numpy generator (the init's ones and zeros would make
the response maps trivially constant), crossed over with
``tris_tpu_torch.ckpt.from_jax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from tests.helpers import TINY_RESNET_CLIP
from tris_tpu.ckpt.convert_tris import convert_stage1_state_dict
from tris_tpu.models.clip import CLIP as JCLIP
from tris_tpu.models.fusion import BilateralPrompt as JBilateral
from tris_tpu.models.stage1 import Stage1Config as JStage1Config, TRISStage1 as JStage1
from tris_tpu_torch.ckpt.from_jax import stage1_state_dict_from_flax, state_dict_from_flax
from tris_tpu_torch.models.clip import CLIP, CLIPConfig
from tris_tpu_torch.models.fusion import BilateralPrompt
from tris_tpu_torch.models.stage1 import Stage1Config, TRISStage1

torch.set_num_threads(2)

TINY = CLIPConfig(**dataclasses.asdict(TINY_RESNET_CLIP))
HIDDEN = 32


def randomize_norms(variables, seed: int):
    """Redraw norm scales/biases and BN statistics; keep the init's kernels."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, a in flatten_dict(variables).items():
        a = np.asarray(a, np.float32)
        n = rng.standard_normal(a.shape).astype(np.float32)
        if k[0] == "batch_stats":
            a = 0.1 * n if k[-1] == "mean" else 1 + 0.2 * np.abs(n)
        elif k[-1] == "scale":
            a = 1 + 0.1 * n
        elif k[-1] == "bias":
            a = 0.1 * n
        out[k] = a
    return unflatten_dict(out)


def make_stage1_pair(seed: int = 1):
    """(JAX model, its variables, the port's model with the same weights)."""
    jm = JStage1(JStage1Config(hidden_dim=HIDDEN, clip_override=TINY_RESNET_CLIP))
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 64, 64, 3)), jnp.ones((1, 20), jnp.int32),
                                  train=False))(jax.random.PRNGKey(seed))
    v = randomize_norms(jax.tree_util.tree_map(np.asarray, v), seed)
    tm = TRISStage1(Stage1Config(hidden_dim=HIDDEN, clip_override=TINY)).eval()
    tm.load_state_dict(stage1_state_dict_from_flax(v), strict=True)
    return jm, v, tm


def make_inputs(B: int, S: int, size: int = 64, seed: int = 0):
    """Seeded NHWC images and CLIP-shaped ids: <sot> 3 tokens <eot> 0-pad."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, size, size, 3)).astype(np.float32)
    ids = np.zeros((B, S, 20), np.int32)
    ids[..., 0] = 49406
    ids[..., 1:4] = rng.integers(1, 49000, (B, S, 3))
    ids[..., 4] = 49407
    return img, ids


def _nchw(img):
    return torch.from_numpy(img).permute(0, 3, 1, 2).contiguous()


@pytest.fixture(scope="module")
def stage1():
    return make_stage1_pair()


def test_clip_rn_encoders():
    # 1e-4: 5 conv stages (folded BN) and 2 text blocks in f32
    jm = JCLIP(TINY_RESNET_CLIP)
    img, ids = make_inputs(2, 1)
    v = jax.jit(lambda k: jm.init(k, jnp.asarray(img), jnp.asarray(ids[:, 0])))(jax.random.PRNGKey(3))
    v = randomize_norms(jax.tree_util.tree_map(np.asarray, v), 3)
    tm = CLIP(TINY).eval()
    tm.load_state_dict(state_dict_from_flax(v), strict=True)
    want_img = jax.jit(lambda v, x: jm.apply(v, x, method="encode_image"))(v, img)
    want_seq, want_eot = jax.jit(lambda v, t: jm.apply(v, t, method="encode_text"))(v, ids[:, 0])
    with torch.no_grad():
        got_img = tm.encode_image(_nchw(img))
        got_seq, got_eot = tm.encode_text(torch.from_numpy(ids[:, 0]))
        assert tm.encode_image(_nchw(img), pool=False)[4] is None
    for g, w in zip(got_img[:4], want_img[:4]):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_img[4][0].numpy(), np.asarray(want_img[4][0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_img[4][1].permute(0, 2, 3, 1).numpy(), np.asarray(want_img[4][1]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_seq.numpy(), np.asarray(want_seq), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_eot.numpy(), np.asarray(want_eot), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("T,S", [(1, 2), (3, 1)])
def test_bilateral_prompt(T, S):
    # T=1: the vision->text softmax is over one key, so new_vis is a
    # spatially constant plane; v_output's InstanceNorm then normalises
    # rounding noise (x - mean ~ 1 ulp, times rsqrt(1e-5) ~ 316). That noise
    # differs between the frameworks, so new_vis is held at 2e-3 absolute
    # there; it enters the response map scaled by 0.1 and averaged over D
    # channels, where test_response_maps holds 1e-4. new_lan: 1e-5.
    # S=2: the port runs v_proj once per image, JAX on the repeated planes.
    rng = np.random.default_rng(10 + T)
    N, Hs, Ws, D = 2, 3, 4, 16
    vis = rng.standard_normal((N, Hs, Ws, D)).astype(np.float32)
    lan = rng.standard_normal((N * S, T, D)).astype(np.float32)
    jm = JBilateral(D, D)
    vis_rep = np.repeat(vis, S, axis=0)
    v = jax.jit(lambda k: jm.init(k, vis_rep, lan))(jax.random.PRNGKey(T))
    v = randomize_norms(jax.tree_util.tree_map(np.asarray, v), T)
    want_vis, want_lan = jax.jit(jm.apply)(v, vis_rep, lan)
    tm = BilateralPrompt(D, D).eval()
    tm.load_state_dict(state_dict_from_flax(v), strict=True)
    with torch.no_grad():
        got_vis, got_lan = tm(torch.from_numpy(vis).reshape(N, Hs * Ws, D), torch.from_numpy(lan), S)
    vis_tol = 2e-3 if T == 1 else 1e-5
    np.testing.assert_allclose(got_vis.numpy(), np.asarray(want_vis).reshape(N * S, Hs * Ws, D),
                               rtol=vis_tol, atol=vis_tol)
    np.testing.assert_allclose(got_lan.numpy(), np.asarray(want_lan), rtol=1e-5, atol=1e-5)


def test_response_maps(stage1):
    # 1e-4 relative to the map's scale: the whole stage-1 eval forward
    jm, v, tm = stage1
    img, ids = make_inputs(2, 3)
    want = np.asarray(jax.jit(lambda v, i, w: jm.apply(v, i, w, method="response_maps"))(v, img, ids))
    with torch.no_grad():
        got = tm.response_maps(_nchw(img), torch.from_numpy(ids)).numpy()
    assert got.shape == (2, 3, 64, 64) and (want > 0).mean() > 0.2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_forward_eval(stage1):
    # 1e-4 relative to the map's scale; the fusion sees all B texts (T=B)
    jm, v, tm = stage1
    img, ids = make_inputs(3, 1, seed=4)
    want = np.asarray(jax.jit(lambda v, i, w: jm.apply(v, i, w, train=False))(v, img, ids[:, 0]))
    with torch.no_grad():
        got = tm(_nchw(img), torch.from_numpy(ids[:, 0])).numpy()
    assert got.shape == (3, 1, 64, 64)
    np.testing.assert_allclose(got[:, 0], want[..., 0], rtol=1e-4, atol=1e-4 * np.abs(want).max())
    # train=True (ported since; held against JAX in test_torch_train.py)
    # returns the head's five outputs, and with the running statistics its
    # relu map is this map: image b's pixels against its own fused text
    with torch.no_grad():
        cls_out, cls_fg, relu_map, sig_map, scale = tm(_nchw(img), torch.from_numpy(ids[:, 0]),
                                                       train=True)
    assert cls_out.shape == (3, 3) and cls_fg.shape == (3,) and scale.shape == ()
    assert relu_map.shape == sig_map.shape == (3, 1, 64, 64)
    np.testing.assert_allclose(relu_map.numpy(), got, rtol=1e-5, atol=1e-5 * np.abs(got).max())


@pytest.mark.parametrize("fusion", [True, False])
def test_response_maps_match_batch1_forward(stage1, fusion):
    # the eval protocol: response_maps (trunk shared over S sentences,
    # per-pair fusion) equals one batch-1 forward per (image, sentence)
    # pair; 2e-5 / 1e-5 as the JAX package's own test of this holds
    if fusion:
        tm = stage1[2]
    else:
        with torch.random.fork_rng():
            torch.manual_seed(0)
            tm = TRISStage1(Stage1Config(hidden_dim=HIDDEN, attn_multi=0.0,
                                         clip_override=TINY)).eval()
    img, ids = make_inputs(2, 3, seed=1)
    with torch.no_grad():
        got = tm.response_maps(_nchw(img), torch.from_numpy(ids)).numpy()
        for b in range(2):
            for s in range(3):
                want = tm(_nchw(img[b:b + 1]), torch.from_numpy(ids[b, s][None])).numpy()
                np.testing.assert_allclose(got[b, s], want[0, 0], atol=2e-5, rtol=1e-5)


def test_state_dict_round_trip(stage1):
    # the port's keys are the reference's: the JAX package's converter maps
    # them back onto the flax variables leaf for leaf, exactly
    _, v, tm = stage1
    back = convert_stage1_state_dict({k: t.numpy() for k, t in tm.state_dict().items()})
    a, b = flatten_dict(back), flatten_dict(v)
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))
