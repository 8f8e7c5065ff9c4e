"""Parity of the PyTorch port's stage-2 slice with the JAX package, on the CPU
in float32 (the kernel wrappers take their plain versions there, so the
gradients are autograd's of the plain versions): ``PixelAttention``,
``TRISStage2`` in train and eval mode and its ``response_maps``, the BN
buffers, ``stage2_loss`` with the EMA teacher and every gradient, the EMA
teacher across ema_pytorch's gate and through a training checkpoint, the
stage-2 parameter groups, the ``state_dict`` layout, and
``cli.train_stage2`` -> ``cli.validate --stage 2``.

Tiny configs (``tests/helpers.py``), 64 px, B = 2 (S = 2 for the eval maps).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from tests.fixtures import make_fake_refcoco
from tests.helpers import TINY_RESNET_CLIP
from tests.test_torch_models import TINY, make_inputs, randomize_norms
from tris_tpu.ckpt.convert_tris import convert_stage2_state_dict
from tris_tpu.models.fusion import PixelAttention as JPixelAttention
from tris_tpu.models.stage2 import Stage2Config as JStage2Config, TRISStage2 as JStage2
from tris_tpu.train.stage2 import Stage2TrainConfig as JTrainConfig
from tris_tpu.train.stage2 import make_train_step as j_make_train_step
from tris_tpu.train.stage2 import stage2_loss as j_stage2_loss
from tris_tpu.train.state import _label_params as j_label_params
from tris_tpu.train.state import create_train_state as j_create_train_state
from tris_tpu_torch.ckpt.from_jax import stage2_grads_from_flax, stage2_state_dict_from_flax
from tris_tpu_torch.ckpt.io import resume_train_state, save_train_checkpoint
from tris_tpu_torch.cli import train_stage2 as cli_train2
from tris_tpu_torch.cli import validate as cli_validate
from tris_tpu_torch.config import get_parser
from tris_tpu_torch.data.dataset import ReferSegDataset
from tris_tpu_torch.models import clip as clip_mod
from tris_tpu_torch.models.fusion import PixelAttention
from tris_tpu_torch.models.stage2 import Stage2Config, TRISStage2
from tris_tpu_torch.train.stage2 import (
    Stage2TrainConfig,
    batch_to_device,
    ema_decay,
    stage2_loss,
    train_step,
    update_teacher,
)
from tris_tpu_torch.train.state import (
    create_train_state,
    ema_leaves,
    label_params,
    make_teacher,
)

torch.set_num_threads(2)

SIZE, B = 64, 2


def _nchw(img):
    return torch.from_numpy(img).permute(0, 3, 1, 2).contiguous()


def make_stage2_pair(seed: int):
    """(JAX model, its variables, the port's model with the same weights)."""
    jm = JStage2(JStage2Config(clip_override=TINY_RESNET_CLIP))
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((1, SIZE, SIZE, 3)), jnp.ones((1, 20), jnp.int32),
                                  train=True))(jax.random.PRNGKey(seed))
    v = randomize_norms(jax.tree_util.tree_map(np.asarray, v), seed)
    tm = TRISStage2(Stage2Config(clip_override=TINY))
    tm.load_state_dict(stage2_state_dict_from_flax(v), strict=True)
    return jm, v, tm


def make_batch(seed: int) -> dict:
    """A Loader-shaped stage-2 batch: u8 NHWC image, ids, 0/1 pseudo-mask."""
    rng = np.random.default_rng(seed)
    _, ids = make_inputs(B, 1, seed=seed)
    return {"image": rng.integers(0, 256, (B, SIZE, SIZE, 3), dtype=np.uint8),
            "word_ids": ids[:, 0],
            "pseudo": (rng.random((B, SIZE, SIZE, 1)) > 0.6).astype(np.float32)}


@pytest.fixture(scope="module")
def pair():
    return make_stage2_pair(0)


@pytest.fixture(scope="module")
def teacher_vars():
    # the teacher of the loss tests: another init, so l5 is live
    return make_stage2_pair(1)[1]


# ---- PixelAttention --------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 2])
def test_pixel_attention_matches_jax(S):
    # 1e-5 of the output's scale; with S = 2 the port's per-image half runs
    # once per image, JAX's on the image repeated for each pair
    jmod = JPixelAttention(48, 24)
    rng = np.random.default_rng(S)
    N, H, W, T = 2, 5, 7, 20
    vis = rng.standard_normal((N, H, W, 48)).astype(np.float32)
    lan = rng.standard_normal((N * S, T, 24)).astype(np.float32)
    v = jax.jit(jmod.init)(jax.random.PRNGKey(S), jnp.repeat(vis, S, 0), lan)
    v = randomize_norms(jax.tree_util.tree_map(np.asarray, v), S)
    want = np.asarray(jax.jit(jmod.apply)(v, jnp.repeat(vis, S, 0), lan))
    sd = stage2_state_dict_from_flax({"params": {"attention2": v["params"]}})
    tmod = PixelAttention(48, 24)
    tmod.load_state_dict({k.split(".", 1)[1]: t for k, t in sd.items()}, strict=True)
    assert tmod.Wk.weight.shape == (48, 24, 1) and tmod.Wq.weight.shape == (48, 48, 1, 1)
    with torch.no_grad():
        got = tmod(torch.from_numpy(vis.reshape(N, H * W, 48)), torch.from_numpy(lan), S)
    want = want.reshape(N * S, H * W, 48)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


# ---- the model ------------------------------------------------------------------------------


def test_stage2_train_forward_and_bn_buffers_match_jax(pair):
    # the four side outputs within 1e-4 of their scale (stage 1's maps bar),
    # the BN buffers JAX's batch_stats after one train forward within 1e-4,
    # num_batches_tracked 1; a teacher (update_stats off) gives the same
    # outputs (batch statistics: the same bar, as the CPU's threaded sums
    # round differently run to run and BatchNorm over B = 2 amplifies it)
    # and leaves its own buffers as they were
    jm, v, tm = pair
    tm = copy.deepcopy(tm).train()
    teacher = make_teacher(tm).train()
    before = {k: b.clone() for k, b in teacher.named_buffers()}
    img, ids = make_inputs(B, 1, seed=1)
    want, mut = jax.jit(lambda v, i, w: jm.apply(v, i, w, train=True, mutable=["batch_stats"]))(
        v, img, ids[:, 0])
    with torch.no_grad():
        got = tm(_nchw(img), torch.from_numpy(ids[:, 0]))
        got_t = teacher(_nchw(img), torch.from_numpy(ids[:, 0]))
    assert len(got) == 4
    for g, gt, w in zip(got, got_t, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert tuple(g.shape) == (B, 1, SIZE, SIZE)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())
        np.testing.assert_allclose(gt.numpy(), g.numpy(), rtol=0, atol=1e-4 * np.abs(w).max())
    stats = stage2_state_dict_from_flax({"batch_stats": mut["batch_stats"]})
    buffers = dict(tm.named_buffers())
    assert stats.keys() == buffers.keys()
    for k, w in stats.items():
        if k.endswith("num_batches_tracked"):
            assert int(buffers[k]) == 1, k
        else:
            np.testing.assert_allclose(buffers[k].numpy(), w.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=k)
    for k, b in teacher.named_buffers():
        assert torch.equal(b, before[k]), k


def test_stage2_eval_and_response_maps_match_jax(pair):
    # eval out1 within 2e-5 of its scale; response_maps over S = 2 (the
    # trunk, reduced_c1 and PixelAttention's per-image half once per image)
    # against JAX's, which repeats the pyramid, within 1e-4 of its scale
    jm, v, tm = pair
    tm = copy.deepcopy(tm).eval()
    img, ids = make_inputs(B, 2, seed=2)
    want = np.asarray(jax.jit(lambda v, i, w: jm.apply(v, i, w, train=False))(v, img, ids[:, 0]))
    want_maps = np.asarray(jax.jit(lambda v, i, w: jm.apply(v, i, w, method="response_maps"))(
        v, img, ids))
    with torch.no_grad():
        got = tm(_nchw(img), torch.from_numpy(ids[:, 0]))
        maps = tm.response_maps(_nchw(img), torch.from_numpy(ids))
    want = want.transpose(0, 3, 1, 2)
    assert tuple(got.shape) == (B, 1, SIZE, SIZE) and tuple(maps.shape) == (B, 2, SIZE, SIZE)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max())
    np.testing.assert_allclose(maps.numpy(), want_maps, rtol=0,
                               atol=1e-4 * np.abs(want_maps).max())
    np.testing.assert_allclose(maps[:, 0:1].numpy(), got.numpy(), rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ---- the loss and every gradient -----------------------------------------------------------


@pytest.mark.parametrize("consistency", ["mse", "kl"])
def test_stage2_loss_and_grads_match_jax(pair, teacher_vars, consistency):
    # the five terms and the loss within 1e-5 relative; every parameter's
    # gradient within 1e-4 of its leaf's max-abs gradient, compared by name.
    # Parameters the step never uses (the attention pool's, CLIP's
    # text_projection and logit_scale) have zero gradient in JAX and none
    # here. Four biases of each PixelAttention have a zero gradient in exact
    # arithmetic: Wq's and Ww's feed an InstanceNorm, which removes them;
    # Wk's adds the same q.b to each of a pixel's logits, which the softmax
    # removes; Wv's adds b to every G row (the weights sum to 1), which Ww
    # and ins_w remove. So is the text tower's ln_final.bias, the same
    # vector added to every token, which reaches only Wk and Wv. Both sides
    # hold rounding noise there, each within 1e-4 of the model's largest
    # gradient. A PReLU slope's gradient (*.relu.weight, one element) is one
    # sum over the negative half of its input, 65 k terms of both signs that
    # can cancel to 1e-3 of the largest gradient: it is held within 1e-4 of
    # its value or 1e-6 of the largest gradient
    jm, v, tm = pair
    tm = copy.deepcopy(tm).train()
    teacher = make_teacher(tm).train()
    teacher.load_state_dict(stage2_state_dict_from_flax(teacher_vars), strict=True)
    batch = make_batch(3)
    jcfg = JTrainConfig(use_ema=True, consistency=consistency)
    fn = jax.value_and_grad(
        lambda p: j_stage2_loss(p, v["batch_stats"], teacher_vars["params"],
                                teacher_vars["batch_stats"], jm,
                                {k: jnp.asarray(a) for k, a in batch.items()}, jcfg),
        has_aux=True)
    (_, (_, j_metrics)), j_grads = jax.jit(fn)(v["params"])
    loss, metrics = stage2_loss(tm, teacher, batch_to_device(batch, "cpu"),
                                Stage2TrainConfig(use_ema=True, consistency=consistency))
    loss.backward()
    for k in ("loss", "l1", "l2", "l3", "l4", "l5"):
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]), rtol=1e-5, atol=0,
                                   err_msg=k)
    assert float(j_metrics["l5"]) > 0
    want = stage2_grads_from_flax(j_grads)
    params = dict(tm.named_parameters())
    assert want.keys() == params.keys()
    unused = sorted(k for k, w in want.items() if not w.abs().max() > 0)
    assert "backbone.text_projection" in unused and "backbone.logit_scale" in unused
    assert all("attnpool" in k or k in ("backbone.text_projection", "backbone.logit_scale")
               for k in unused)
    top = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        g = params[k].grad
        if k in unused:
            assert g is None, k
            continue
        assert g.shape == w.shape, k
        if k.split(".", 1)[1] in ("Wq.bias", "Wk.bias", "Wv.bias", "Ww.bias", "ln_final.bias"):
            noise = 1e-4 * top
            assert float(g.abs().max()) <= noise and float(w.abs().max()) <= noise, k
            continue
        atol = 1e-4 * float(w.abs().max())
        if k.endswith(".relu.weight"):
            atol = max(atol, 1e-6 * top)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=atol, err_msg=k)
    assert all(p.grad is None for p in teacher.parameters())


# ---- the EMA teacher ------------------------------------------------------------------------


def test_ema_decay_is_jax_float32_arithmetic():
    # the gate and the decay, bit for bit, against the JAX step's own
    # float32 expressions (train/stage2.py:106-115), at the default gate
    # and at the tests' (update_after 1, update_every 2)
    counters = np.arange(0, 2000)
    for after, every in ((100, 10), (1, 2), (0, 1)):
        cfg = Stage2TrainConfig(use_ema=True, ema_update_after=after, ema_update_every=every)
        epoch = jnp.maximum(counters - after - 1, 0).astype(jnp.float32)
        want = np.asarray(jnp.where(epoch <= 0.0, 0.0,
                                    jnp.minimum(0.9999, 1.0 - jnp.power(1.0 + epoch, -2.0 / 3.0))))
        for c in counters:
            got = ema_decay(int(c), cfg)
            if c % every:
                assert got is None
            else:
                assert np.float32(got) == want[c], (after, every, c)
                assert got == float(want[c])


@pytest.fixture(scope="module")
def jax_ema_run(pair):
    """Five JAX stage-2 steps with the EMA on, update_after 1 and
    update_every 2: the student and the teacher after each step."""
    jm, v, _ = pair
    jcfg = JTrainConfig(use_ema=True, consistency="mse", ema_update_every=2, ema_update_after=1)
    state = j_create_train_state(jm, v, total_steps=10, stage="stage2", with_ema=True)
    step = j_make_train_step(jm, jcfg, donate=False)
    out = []
    for s in range(5):
        batch = {k: jnp.asarray(a) for k, a in make_batch(10 + s).items()}
        state, _ = step(state, batch)
        out.append(jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats,
            "ema_params": state.ema_params, "ema_batch_stats": state.ema_batch_stats}))
    return out


def test_ema_teacher_follows_jax_across_the_gate(pair, jax_ema_run):
    # counters 0-4 at update_after 1, update_every 2: a copy (0), a skip (1),
    # a copy (2: epoch still 0), a skip (3) and a decay step (4: 1 - 3^-2/3).
    # Each step the port's student is set to JAX's (so the update's inputs
    # are the same on both sides) and the gate runs; the teacher's
    # parameters and BN buffers equal JAX's ema_params / ema_batch_stats
    # within 1 ulp of each leaf's scale (XLA may fuse e*d + p*(1-d) into an
    # FMA; the port rounds each product and the sum). num_batches_tracked,
    # which JAX lacks, is copied on updates
    _, v, tm = pair
    model = copy.deepcopy(tm)
    state = create_train_state(model, total_steps=10, stage="stage2", with_ema=True)
    assert state.ema_table is None   # CPU leaves: the plain version, no table
    cfg = Stage2TrainConfig(use_ema=True, ema_update_every=2, ema_update_after=1)
    decays = []
    for s, j in enumerate(jax_ema_run):
        model.load_state_dict(stage2_state_dict_from_flax(j), strict=True)
        model.get_buffer("reduced_c1.bn.num_batches_tracked").fill_(s + 1)
        state.step = s + 1
        decays.append(update_teacher(state, cfg))
        want = stage2_state_dict_from_flax({"params": j["ema_params"],
                                            "batch_stats": j["ema_batch_stats"]})
        got = state.ema.state_dict()
        for k, w in want.items():
            if k.endswith("num_batches_tracked"):
                continue
            ulp = float(np.spacing(np.float32(max(float(w.abs().max()), 1e-30))))
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=ulp,
                                       err_msg=f"step {s + 1}: {k}")
    assert decays[:4] == [0.0, None, 0.0, None]
    assert decays[4] == ema_decay(4, cfg) == pytest.approx(1 - 3 ** (-2 / 3), rel=1e-6)
    assert int(state.ema.get_buffer("reduced_c1.bn.num_batches_tracked")) == 5
    # the teacher is the last decay step's mix, not a copy of the student
    assert not torch.equal(state.ema.get_parameter("attention2.Wq.weight"),
                           model.get_parameter("attention2.Wq.weight"))


def test_train_step_updates_the_teacher_through_the_gate(pair):
    # three port train steps at update_after 0, update_every 1: copies at
    # counters 0 and 1, then decay 1 - 2^-2/3 at counter 2, each leaf equal
    # to the plain rule applied to the student before and after step 3; the
    # teacher has its own storage, no gradients, no optimizer group, and its
    # BN buffers follow the student's through the EMA alone
    _, _, tm = pair
    model = copy.deepcopy(tm)
    state = create_train_state(model, total_steps=10, stage="stage2", with_ema=True)
    teacher = state.ema
    in_groups = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert not any(id(p) in in_groups or p.requires_grad for p in teacher.parameters())
    assert all(e.data_ptr() != p.data_ptr()
               for e, p in zip(ema_leaves(teacher), ema_leaves(model)))
    cfg = Stage2TrainConfig(use_ema=True, ema_update_every=1, ema_update_after=0)
    for s in range(3):
        if s == 2:
            before = [t.clone() for t in ema_leaves(model)]
        metrics = train_step(state, batch_to_device(make_batch(20 + s), "cpu"), cfg)
        assert np.isfinite(float(metrics["loss"]))
        if s == 1:
            for e, p in zip(ema_leaves(teacher), ema_leaves(model)):
                assert torch.equal(e, p)
    d = ema_decay(2, cfg)
    assert d == pytest.approx(1 - 2 ** (-2 / 3), rel=1e-6)
    for (k, e), b, p in zip(list(teacher.named_parameters()) + list(teacher.named_buffers()),
                            before, ema_leaves(model)):
        if e.is_floating_point():
            want = b * d + p * float(np.float32(1) - np.float32(d))
            assert torch.equal(e, want), k
        else:
            assert torch.equal(e, p) and int(p) == 3, k
    assert state.step == 3


def test_resume_restores_the_teacher_and_the_step(pair, tmp_path):
    # a stage-2 training checkpoint carries the teacher; resuming it restores
    # the teacher's parameters and buffers and the step the EMA gate counts
    _, _, tm = pair
    cfg = Stage2TrainConfig(use_ema=True, ema_update_every=1, ema_update_after=0)
    state = create_train_state(copy.deepcopy(tm), total_steps=10, stage="stage2", with_ema=True)
    for s in range(3):
        train_step(state, batch_to_device(make_batch(30 + s), "cpu"), cfg)
    path = save_train_checkpoint(str(tmp_path / "ckpt.pth"), state.model, state.optimizer,
                                 state.scheduler, extra={"epoch": 0}, ema=state.ema)
    other = create_train_state(copy.deepcopy(tm), total_steps=10, stage="stage2", with_ema=True)
    other.step, epoch = resume_train_state(path, other.model, other.optimizer, other.scheduler,
                                           ema=other.ema)
    assert (other.step, epoch) == (3, 1)
    want = state.ema.state_dict()
    for k, t in other.ema.state_dict().items():
        assert torch.equal(t, want[k]), k
    assert not torch.equal(other.ema.get_parameter("attention2.Wq.weight"),
                           tm.get_parameter("attention2.Wq.weight"))


# ---- the groups and the keys ---------------------------------------------------------------


def test_label_params_match_jax_stage2(pair):
    # every parameter's group against JAX's _label_params(..., "stage2"): the
    # backbone's positional embeddings (the text tower's and the attention
    # pool's) in head, the rest of the backbone in backbone, the rest head
    _, v, tm = pair
    codes = {"backbone": 0.0, "head": 1.0, "frozen": 2.0}
    j_labels = flatten_dict(j_label_params(v["params"], "stage2"))
    tree = {k: np.full(np.shape(flatten_dict(v["params"])[k]), codes[lab], np.float32)
            for k, lab in j_labels.items()}
    from flax.traverse_util import unflatten_dict

    want = {k: int(t.flatten()[0]) for k, t in stage2_grads_from_flax(unflatten_dict(tree)).items()}
    got = {k: int(codes[lab]) for k, lab in label_params(tm, "stage2").items()}
    assert got == want
    assert got["backbone.positional_embedding"] == 1
    assert got["backbone.visual.attnpool.positional_embedding"] == 1
    assert got["backbone.logit_scale"] == 0 and got["attention2.Wk.weight"] == 1
    assert label_params(tm)["backbone.logit_scale"] == "backbone"   # no top-level logit_scale


def test_state_dict_round_trips_through_convert_stage2(pair):
    # the JAX package's converter reads the port's state_dict leaf for leaf
    # (it raises on any key it does not know) back into the JAX variables
    _, v, tm = pair
    back = convert_stage2_state_dict({k: t.numpy() for k, t in tm.state_dict().items()})
    want = flatten_dict({"params": v["params"], "batch_stats": v["batch_stats"]})
    got = flatten_dict(back)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(w), err_msg="/".join(k))


# ---- the entry points ------------------------------------------------------------------------


def test_cli_train_stage2_then_validate_stage2(monkeypatch, tmp_path):
    # python -m tris_tpu_torch.cli.train_stage2 --device cpu --model_ema for
    # one epoch on the fake RefCOCO data with pseudo-mask dicts as
    # make_ins_seg writes them (6 train refs, batch 2: three steps), tiny
    # backbone; it writes the best and hit checkpoints (with the teacher),
    # reloads the best, validates on the train split; cli.validate --stage 2
    # reads it, and --prms with --stage 2 exits
    monkeypatch.setitem(clip_mod.CLIP_CONFIGS, "RN50", TINY)
    root, _ = make_fake_refcoco(str(tmp_path / "data"))
    pseudo = tmp_path / "ins_seg"
    pseudo.mkdir()
    ds = ReferSegDataset(root, "refcoco", "unc", "train", size=SIZE)
    rng = np.random.default_rng(0)
    for i in range(len(ds)):
        info = ds.ref_info(i)
        h, w = info["img"]["height"], info["img"]["width"]
        np.save(pseudo / f"{i}_{info['ref']['image_id']}.npy",
                {"score": np.ones(2, np.float32), "mask": rng.random((2, h, w)) > 0.7,
                 "class": np.zeros(2, np.int64), "cam": np.zeros((h, w), np.float32)})
    out = tmp_path / "out"
    common = ["--dataset", "refcoco", "--splitBy", "unc", "--refer_data_root", root,
              "--size", str(SIZE), "--eval_batch", "2", "--device", "cpu", "--host_threads", "1"]
    res = cli_train2.main(get_parser().parse_args(common + [
        "--pseudo_path", str(pseudo), "--batch_size", "2", "--epoch", "1", "--test_split", "val",
        "--output", str(out), "--print-freq", "1", "--model_ema", "--ema_eval"]))
    assert set(res) == {"val", "train"}
    assert sorted(os.listdir(out)) == ["ckpt_320_epoch_0_best.pth", "ckpt_320_epoch_0_hit.pth"]
    best = str(out / "ckpt_320_epoch_0_best.pth")
    payload = torch.load(best, weights_only=True)
    assert payload["step"] == 3 and payload["ema"].keys() == payload["model"].keys()
    res = cli_validate.main(get_parser().parse_args(common + ["--test_split", "val", "--stage", "2",
                                                              "--pretrain", best]))
    assert 0.0 <= res["val"]["mIoU"] <= 100.0
    with pytest.raises(SystemExit, match="use --stage 1"):
        cli_validate.main(get_parser().parse_args(common + ["--stage", "2", "--prms"]))
