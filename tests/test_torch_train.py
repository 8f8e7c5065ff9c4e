"""Parity of the PyTorch port's stage-1 training slice with the JAX package,
on the CPU in float32 (the kernel wrappers take their plain versions there,
so the gradients are autograd's of the plain versions): the losses,
``forward(train=True)`` with BatchNorm's batch statistics, ``stage1_loss``
and every parameter's gradient, the optimizer and LR schedule, the
checkpoints and the ``cli.train_stage1`` entry point.

Tiny configs (``tests/helpers.py``), hidden 32, B = 4 with 2 negatives. The
stage-1 input is 96 px and the tiny critic's 64, so K5 really resizes.
"""

import copy
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from tests.fixtures import make_fake_refcoco
from tests.test_torch_models import HIDDEN, TINY, make_stage1_pair
from tests.test_torch_prms import TINY_VIT, make_critic_pair
from tris_tpu import losses as jlosses
from tris_tpu.train.stage1 import Stage1LossWeights as JWeights, stage1_loss as j_stage1_loss
from tris_tpu.train.state import make_optimizer as j_make_optimizer
from tris_tpu.train.state import poly_epoch_schedule as j_poly_epoch, poly_schedule as j_poly
from tris_tpu_torch import losses
from tris_tpu_torch.ckpt.from_jax import grads_from_flax, state_dict_from_flax
from tris_tpu_torch.ckpt.io import (
    BestCheckpointKeeper,
    resume_train_state,
    save_train_checkpoint,
)
from tris_tpu_torch.cli import train_stage1 as cli_train
from tris_tpu_torch.cli import validate as cli_validate
from tris_tpu_torch.cli.common import load_pretrained
from tris_tpu_torch.config import get_parser
from tris_tpu_torch.eval.validate import image_to_nchw
from tris_tpu_torch.models import clip as clip_mod
from tris_tpu_torch.models.stage1 import Stage1Config, TRISStage1
from tris_tpu_torch.train.stage1 import Stage1LossWeights, batch_to_device, stage1_loss, train_step
from tris_tpu_torch.train.state import (
    apply_gradients,
    label_params,
    make_optimizer,
    poly_epoch_schedule,
)

torch.set_num_threads(2)

SIZE, B, NEG = 96, 4, 2


def make_batch(seed: int, u8: bool, negatives: bool) -> dict:
    """A Loader-shaped train batch: NHWC image (u8, or normalised-scale f32),
    ids of 3-12 tokens, and [B, NEG, 20] negatives."""
    rng = np.random.default_rng(seed)
    if u8:
        image = rng.integers(0, 256, (B, SIZE, SIZE, 3), dtype=np.uint8)
    else:
        image = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)

    def ids(shape):
        out = np.zeros(shape + (20,), np.int32)
        for idx in np.ndindex(*shape):
            n = int(rng.integers(3, 13))
            out[idx][0], out[idx][n + 1] = 49406, 49407
            out[idx][1:n + 1] = rng.integers(1, 49000, n)
        return out

    batch = {"image": image, "word_ids": ids((B,))}
    if negatives:
        batch["neg_word_ids"] = ids((B, NEG))
    return batch


@pytest.fixture(scope="module")
def pair():
    jm, v, tm = make_stage1_pair(seed=3)
    # critic seed 7: every image-text cosine of the batches below is above
    # max_loss's 1e-4 clamp, so l1's gradient reaches the maps through K5
    jc, cv, tc = make_critic_pair(7)
    return jm, v, tm.train(), jc, cv, tc.requires_grad_(False)


def jax_loss(jm, v, jc, cv, batch):
    """JAX's (loss, metrics, new batch_stats, grads) of one batch."""
    fn = jax.value_and_grad(
        lambda p, s: j_stage1_loss(p, s, jm, jc, cv, {k: jnp.asarray(a) for k, a in batch.items()},
                                   JWeights()), has_aux=True)
    (loss, (stats, metrics)), grads = jax.jit(fn)(v["params"], v["batch_stats"])
    return float(loss), {k: float(m) for k, m in metrics.items()}, stats, grads


# ---- losses -------------------------------------------------------------------


@pytest.mark.parametrize("name", ["max_loss", "clip_similarity", "cbs_loss",
                                  "multilabel_soft_margin_loss", "bce_with_logits",
                                  "sigmoid_mse_consistency", "sigmoid_kl_consistency",
                                  "l2_normalize"])
def test_losses_match_jax(name):
    # 1e-6: the same few f32 operations in both frameworks
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 8)).astype(np.float32)
    y = rng.standard_normal((5, 8)).astype(np.float32)
    args = {
        "max_loss": (rng.uniform(-0.2, 1.2, (7,)).astype(np.float32),),
        "clip_similarity": (x, y),
        "cbs_loss": (x, rng.standard_normal((5, 3, 8)).astype(np.float32)),
        "multilabel_soft_margin_loss": (x, (y > 0).astype(np.float32)),
        "bce_with_logits": (x, (y > 0).astype(np.float32)),
        "sigmoid_mse_consistency": (x, y),
        "sigmoid_kl_consistency": (x, y),
        "l2_normalize": (x,),
    }[name]
    got = getattr(losses, name)(*(torch.from_numpy(a) for a in args)).numpy()
    want = np.asarray(getattr(jlosses, name)(*(jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---- forward(train=True) and BatchNorm's batch statistics ------------------------


def test_forward_train_matches_jax(pair):
    # the five outputs within 1e-4 of their scale (the maps' bar), the BN
    # buffers JAX's batch_stats after one step, num_batches_tracked 1
    jm, v, tm, *_ = pair
    tm = copy.deepcopy(tm).train()
    batch = make_batch(1, u8=False, negatives=False)
    want, mut = jax.jit(lambda v, i, w: jm.apply(v, i, w, train=True, mutable=["batch_stats"]))(
        v, jnp.asarray(batch["image"]), jnp.asarray(batch["word_ids"]))
    with torch.no_grad():
        got = tm(image_to_nchw(torch.from_numpy(batch["image"])),
                 torch.from_numpy(batch["word_ids"]), train=True)
    shapes = [(B, B), (B,), (B, 1, SIZE, SIZE), (B, 1, SIZE, SIZE), ()]
    for g, w, shape in zip(got, want, shapes):
        w = np.asarray(w)
        if w.ndim == 4:
            w = w.transpose(0, 3, 1, 2)
        assert tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(w).max()))
    stats = state_dict_from_flax({"batch_stats": mut["batch_stats"]})
    buffers = dict(tm.named_buffers())
    assert stats.keys() == buffers.keys()
    for k, w in stats.items():
        if k.endswith("num_batches_tracked"):
            assert int(buffers[k]) == 1, k
        else:
            np.testing.assert_allclose(buffers[k].numpy(), w.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=k)


# ---- the loss and every gradient --------------------------------------------------


@pytest.mark.parametrize("u8,negatives", [(True, True), (False, False)])
def test_stage1_loss_and_grads_match_jax(pair, u8, negatives):
    # loss and each term within 1e-5 relative (l5 = 0 without negatives);
    # every parameter's gradient within 1e-4 of its leaf's max-abs gradient,
    # compared by name through grads_from_flax (parameters the step never
    # uses, the attention pool's and CLIP's own logit_scale, have zero
    # gradient in JAX and none here). The biases of the 1x1 convs right
    # before an InstanceNorm (v_proj*.0, v_output.0) have a zero gradient in
    # exact arithmetic, since the norm removes them: both sides hold rounding
    # noise there, each held within 1e-4 of the model's largest gradient
    jm, v, tm, jc, cv, tc = pair
    tm = copy.deepcopy(tm).train()
    batch = make_batch(2, u8=u8, negatives=negatives)
    j_loss, j_metrics, _, j_grads = jax_loss(jm, v, jc, cv, batch)
    loss, metrics = stage1_loss(tm, tc, batch_to_device(batch, "cpu"), Stage1LossWeights())
    loss.backward()
    for k in ("loss", "l1", "l4", "l5", "cls_fg"):
        np.testing.assert_allclose(float(metrics[k]), j_metrics[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert (j_metrics["l5"] == 0.0) is not negatives
    assert j_metrics["l1"] < -np.log(1e-4) - 1e-3      # no similarity clamped: l1 is live
    want = grads_from_flax(j_grads)
    params = dict(tm.named_parameters())
    assert want.keys() == params.keys()
    unused = [k for k, w in want.items() if not w.abs().max() > 0]
    top = max(float(w.abs().max()) for w in want.values())
    assert any("attnpool" in k for k in unused) and "backbone.logit_scale" in unused
    for k, w in want.items():
        g = params[k].grad
        g = torch.zeros_like(w) if g is None else g
        assert g.shape == w.shape, k
        if re.fullmatch(r"attn_fusion\.(v_proj[123]|v_output)\.0\.bias", k):
            noise = 1e-4 * top
            assert float(g.abs().max()) <= noise and float(w.abs().max()) <= noise, k
            continue
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * float(w.abs().max()) + 1e-12, err_msg=k)
    assert all(tm.get_parameter(k).grad is None for k in unused if k != "logit_scale")
    assert tm.logit_scale.grad is not None     # the plain version's d scale exists


# ---- the optimizer and the LR schedule ---------------------------------------------


@pytest.mark.parametrize("lr,wd", [(5e-5, 0.01), (1e-2, 0.5)])
def test_optimizer_matches_make_optimizer(pair, lr, wd):
    # three steps fed identical gradients, against optax's make_optimizer
    # (also at lr 1e-2 and decay 0.5, to make the decay visible in float32):
    # parameters within 1e-6 of each leaf's scale, or within 3e-5 of the lr
    # where that is larger (a leaf that starts at zero, or a large lr): optax
    # rounds Adam's bias correction 1 - b2^t in float32 (1.3e-5 off at
    # t = 1) and the update carries it. Backbone
    # updates at 0.1x the head's; logit_scale unchanged; parameters without
    # a gradient (None here, zeros in JAX) decayed, as optax decays them
    _, v, tm, *_ = pair
    tm = copy.deepcopy(tm)
    total = 10
    rng = np.random.default_rng(5)
    flat = flatten_dict(v["params"])
    j_params = v["params"]
    tx = j_make_optimizer(j_params, base_lr=lr, weight_decay=wd, total_steps=total)
    opt_state = tx.init(j_params)
    update = jax.jit(tx.update)
    optimizer, scheduler = make_optimizer(tm, base_lr=lr, weight_decay=wd, total_steps=total)
    params = dict(tm.named_parameters())
    labels = label_params(tm)
    unused = [k for k in params if "attnpool" in k]
    p0 = {k: p.detach().clone() for k, p in params.items()}
    for step in range(3):
        j_grads = {k: (np.zeros_like(a) if "attnpool" in "/".join(k) else
                       rng.standard_normal(a.shape).astype(np.float32)) for k, a in flat.items()}
        j_grads = unflatten_dict(j_grads)
        updates, opt_state = update(j_grads, opt_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        prev = {k: p.detach().clone() for k, p in params.items()}
        for k, g in grads_from_flax(j_grads).items():
            params[k].grad = None if k in unused else g
        lrs = {g["name"]: g["lr"] for g in optimizer.param_groups}
        apply_gradients(optimizer, scheduler)
        want = state_dict_from_flax({"params": j_params})
        for k, p in params.items():
            w = want[k].numpy()
            atol = max(1e-6 * np.abs(w).max(), 3e-5 * lr)
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-6, atol=atol, err_msg=k)
        if step == 0 and lr > 1e-3:
            # the Adam part of the first update (the decay taken out) is
            # lr * g / (|g| + eps): its size is the group's lr
            adam = {k: (params[k].detach() - prev[k] * (1 - lrs[labels[k]] * wd)).abs()
                    for k in params if k not in unused and labels[k] != "frozen"}
            size = {name: float(torch.cat([a.flatten() for k, a in adam.items()
                                           if labels[k] == name]).median())
                    for name in ("backbone", "head")}
            assert np.isclose(size["backbone"] / size["head"], 0.1, rtol=1e-3)
    assert labels["logit_scale"] == "frozen"
    assert torch.equal(params["logit_scale"].detach(), p0["logit_scale"])
    decay = np.prod([1 - float(j_poly(lr * 0.1, total)(s)) * wd for s in range(3)])
    for k in unused:
        np.testing.assert_allclose(params[k].detach().numpy(), p0[k].numpy() * decay,
                                   rtol=1e-6, atol=1e-9, err_msg=k)
        if lr > 1e-3:
            assert not torch.equal(params[k].detach(), p0[k])


@pytest.mark.parametrize("kind", ["poly", "poly_epoch"])
def test_lr_schedule_matches_poly_schedule(pair, kind):
    # the lr each update uses, at updates 0, 1 and total-1, against the JAX
    # schedule: optax evaluates it before counting the update, LambdaLR
    # after the step. poly_epoch: the reference's PolynomialLRDecay through
    # schedule_factory (2 steps an epoch, decay over 3 epochs)
    _, _, tm, *_ = pair
    tm = copy.deepcopy(tm)
    total = 7
    if kind == "poly":
        want = {base: j_poly(base, total) for base in (5e-6, 5e-5)}
        factory = None
    else:
        want = {base: j_poly_epoch(base, 1e-6, 1.0, 3, 2) for base in (5e-6, 5e-5)}
        factory = lambda base: poly_epoch_schedule(base, 1e-6, 1.0, 3, 2)  # noqa: E731
    optimizer, scheduler = make_optimizer(tm, base_lr=5e-5, lr_multi=0.1, total_steps=total,
                                          schedule_factory=factory)
    seen = {}
    for step in range(total):
        seen[step] = [g["lr"] for g in optimizer.param_groups]
        for p in tm.parameters():
            p.grad = torch.zeros_like(p)
        apply_gradients(optimizer, scheduler)
    for step in (0, 1, total - 1):
        for got, base in zip(seen[step], (5e-6, 5e-5)):
            np.testing.assert_allclose(got, float(want[base](step)), rtol=1e-6)
    assert [g["name"] for g in optimizer.param_groups] == ["backbone", "head"]


# ---- checkpoints -------------------------------------------------------------------


def test_resume_then_step_equals_two_unbroken_steps(pair, tmp_path):
    # model, BN buffers, optimizer moments and the schedule all come back
    _, _, tm, _, _, tc = pair
    batches = [batch_to_device(make_batch(s, u8=True, negatives=True), "cpu") for s in (7, 8)]

    def fresh():
        model = copy.deepcopy(tm).train()
        return (model, *make_optimizer(model, total_steps=4))

    a = fresh()
    for b in batches:
        train_step(a[0], tc, a[1], a[2], b)
    first = fresh()
    train_step(first[0], tc, first[1], first[2], batches[0])
    path = save_train_checkpoint(str(tmp_path / "ckpt.pth"), *first, extra={"epoch": 0})
    resumed = fresh()
    step, epoch = resume_train_state(path, *resumed)
    assert (step, epoch) == (1, 1)
    train_step(resumed[0], tc, resumed[1], resumed[2], batches[1])
    for (k, x), (_, y) in zip(a[0].state_dict().items(), resumed[0].state_dict().items()):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-6, atol=0, err_msg=k)
    assert resumed[2].last_epoch == a[2].last_epoch == 2


@pytest.mark.parametrize("rank", [0, 1])
def test_keeper_writes_on_rank_0_only(tmp_path, rank):
    # the intended divergence from the JAX package, whose BestCheckpointKeeper
    # (tris_tpu/ckpt/io.py:183-196) writes from every process: here rank 0
    # alone writes, the others keep the same record. The previous best goes.
    keeper = BestCheckpointKeeper(str(tmp_path), rank=rank)

    def save(path):
        torch.save({"model": {}}, path)

    keeper.update(0, 10.0, 50.0, save)
    keeper.update(1, 20.0, 40.0, save)
    best = keeper.update(2, 15.0, 60.0, save)
    assert best["path"].endswith("ckpt_320_epoch_1_best.pth")
    assert best["hit_path"].endswith("ckpt_320_epoch_2_hit.pth")
    files = sorted(os.listdir(tmp_path))
    assert files == (["ckpt_320_epoch_1_best.pth", "ckpt_320_epoch_2_hit.pth"] if rank == 0 else [])


def test_best_checkpoint_loads_through_load_pretrained(pair, tmp_path):
    # a training checkpoint's "model" keeps the TRIS keys: --pretrain reads it
    _, _, tm, *_ = pair
    model = copy.deepcopy(tm)
    optimizer, scheduler = make_optimizer(model)
    path = save_train_checkpoint(str(tmp_path / "ckpt_320_epoch_0_best.pth"), model, optimizer,
                                 scheduler, extra={"epoch": 0})
    with torch.random.fork_rng():
        torch.manual_seed(9)
        other = TRISStage1(Stage1Config(hidden_dim=HIDDEN, clip_override=TINY))
    load_pretrained(get_parser().parse_args(["--pretrain", path]), other)
    for k, t in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], t), k


# ---- the entry point ------------------------------------------------------------


def test_cli_train_stage1_end_to_end(monkeypatch, tmp_path):
    # python -m tris_tpu_torch.cli.train_stage1 --device cpu for one epoch on
    # the fake RefCOCO data (6 train refs, batch 4: one step) with tiny
    # backbones; it writes the best and hit checkpoints, reloads the best
    # and validates on the train split, and cli.validate --pretrain reads it
    monkeypatch.setitem(clip_mod.CLIP_CONFIGS, "RN50", TINY)
    monkeypatch.setitem(clip_mod.CLIP_CONFIGS, "ViT-B-32", TINY_VIT)
    root, _ = make_fake_refcoco(str(tmp_path / "data"))
    out = tmp_path / "out"
    common = ["--dataset", "refcoco", "--splitBy", "unc", "--refer_data_root", root,
              "--size", str(SIZE), "--eval_batch", "2", "--hidden_dim", str(HIDDEN),
              "--device", "cpu", "--host_threads", "1"]
    res = cli_train.main(get_parser().parse_args(common + [
        "--batch_size", "4", "--negative_samples", "2", "--epoch", "1", "--test_split", "val",
        "--output", str(out), "--print-freq", "1"]))
    assert set(res) == {"val", "train"}
    assert sorted(os.listdir(out)) == ["ckpt_320_epoch_0_best.pth", "ckpt_320_epoch_0_hit.pth"]
    best = str(out / "ckpt_320_epoch_0_best.pth")
    payload = torch.load(best, weights_only=True)
    assert payload["step"] == 1 and payload["extra"] == {"epoch": 0}
    res = cli_validate.main(get_parser().parse_args(common + ["--test_split", "val",
                                                              "--pretrain", best]))
    assert 0.0 <= res["val"]["mIoU"] <= 100.0
