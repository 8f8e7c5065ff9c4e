"""The port's data parallelism (``tris_tpu_torch/parallel``) on the CPU: two
real processes in a ``gloo`` group, each with half the global batch, against
the JAX package's one-process step on the global batch, at the stage parity
bars of ``tests/test_torch_train.py`` and ``tests/test_torch_stage2.py``
(losses 1e-5 relative, every gradient 1e-4 of its leaf's max-abs gradient):

- stage 1 under DDP, each rank's images scored against the gathered texts
  of the global batch and ``l4``'s identity offset by the rank, on
  ``tests/_mp_worker.py``'s synthetic data sharded by the ``Loader`` (the
  JAX package's own two-process test's batches);
- stage 2 under DDP with the EMA teacher, whose BatchNorms take the global
  batch's statistics too;
- BatchNorm across ranks: the plain version's outputs, gradients and running
  buffers against one process on the concatenated batch, and the kernels'
  statistics (``batch_stats_plain``, their arithmetic) bit for bit;
- IRN training's per-process slices against the JAX package's, and the
  empty slice that raises where the JAX package fills it;
- the ins-seg pass's fan-out over several devices, equal to the serial pass.

The workers are spawned once for the module (``mp_results``) and load what
the parent saved; they import nothing of JAX.
"""

import copy
import json
import os
import re
import socket

import numpy as np
import pytest
import torch

WORLD = 2
STAGE2_B = 2     # the global stage-2 batch of tests/test_torch_stage2.py: one image a rank


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---- the workers (spawned: module-level, JAX-free) -----------------------------------------


def _bn_job(rank, out_dir):
    from tris_tpu_torch.kernels.batch_norm import batch_norm_act_plain, batch_stats_plain

    d = torch.load(os.path.join(out_dir, "bn.pt"))
    n = d["x"].shape[0] // WORLD
    rows = slice(rank * n, (rank + 1) * n)
    x = d["x"][rows].clone().requires_grad_()
    w, b = (d[k].clone().requires_grad_() for k in ("weight", "bias"))
    rm, rv = d["running_mean"].clone(), d["running_var"].clone()
    y = batch_norm_act_plain(x, w, b, rm, rv, training=True, update_stats=True, momentum=0.1,
                             eps=1e-5, act="relu", residual=d["residual"][rows])
    (y * d["g"][rows]).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw": w.grad, "db": b.grad, "rm": rm, "rv": rv,
            "kernel_stats": batch_stats_plain(d["x"][rows], 1e-5)}


def _grads(model):
    return {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}


def _stage1_job(rank, out_dir):
    from tests import _mp_worker as W
    from tris_tpu_torch.data.dataset import Loader
    from tris_tpu_torch.parallel import mean_over_ranks, wrap_ddp
    from tris_tpu_torch.train.stage1 import Stage1LossWeights, batch_to_device, stage1_loss

    tm, tc = torch.load(os.path.join(out_dir, "stage1.pt"), weights_only=False)
    loader = Loader(W.SynthDS(), batch_size=W.LOCAL_BATCH, shuffle=True, seed=7, num_threads=1,
                    process_index=rank, process_count=WORLD)
    local = next(iter(loader.epoch(0)))
    ddp = wrap_ddp(tm.train(), "cpu")  # held until the backward: its hooks reduce the grads
    loss, metrics = stage1_loss(ddp, tc, batch_to_device(local, "cpu"), Stage1LossWeights())
    loss.backward()
    return {"local": local, "metrics": mean_over_ranks(metrics), "grads": _grads(tm),
            "buffers": {k: v.clone() for k, v in tm.named_buffers()}}


def _stage2_job(rank, out_dir):
    from tris_tpu_torch.parallel import mean_over_ranks, wrap_ddp
    from tris_tpu_torch.train.stage2 import Stage2TrainConfig, batch_to_device, stage2_loss

    tm, teacher, batch = torch.load(os.path.join(out_dir, "stage2.pt"), weights_only=False)
    n = STAGE2_B // WORLD
    local = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
    ddp = wrap_ddp(tm.train(), "cpu")
    teacher.train()
    loss, metrics = stage2_loss(ddp, teacher, batch_to_device(local, "cpu"),
                                Stage2TrainConfig(use_ema=True, consistency="mse"))
    loss.backward()
    return {"metrics": mean_over_ranks(metrics), "grads": _grads(tm)}


JOBS = {"bn": _bn_job, "stage1": _stage1_job, "stage2": _stage2_job}


def _worker(rank, port, out_dir):
    import torch.distributed as dist

    from tris_tpu_torch import parallel

    torch.set_num_threads(1)
    parallel.init_process_group("cpu", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=WORLD)
    try:
        assert parallel.rank_world() == (rank, WORLD) and parallel.distributed()
        out = {name: job(rank, out_dir) for name, job in JOBS.items()}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---- the parent's inputs and references ---------------------------------------------------


def _stage2_pair_and_teacher():
    """``tests/test_torch_stage2.py``'s pair (seed 0) and its teacher's
    variables (seed 1), from one compiled init."""
    import jax
    import jax.numpy as jnp

    from tests.helpers import TINY_RESNET_CLIP
    from tests.test_torch_models import TINY, randomize_norms
    from tests.test_torch_stage2 import SIZE
    from tris_tpu.models.stage2 import Stage2Config as JStage2Config, TRISStage2 as JStage2
    from tris_tpu_torch.ckpt.from_jax import stage2_state_dict_from_flax
    from tris_tpu_torch.models.stage2 import Stage2Config, TRISStage2

    jm = JStage2(JStage2Config(clip_override=TINY_RESNET_CLIP))
    init = jax.jit(lambda k: jm.init(k, jnp.zeros((1, SIZE, SIZE, 3)), jnp.ones((1, 20), jnp.int32),
                                     train=True))
    v, tv = (randomize_norms(jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(s))), s)
             for s in (0, 1))
    tm = TRISStage2(Stage2Config(clip_override=TINY))
    tm.load_state_dict(stage2_state_dict_from_flax(v), strict=True)
    return jm, v, tm, tv


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The JAX pairs and the inputs the workers load."""
    import jax

    from tests.test_torch_models import make_stage1_pair
    from tests.test_torch_prms import make_critic_pair
    from tests.test_torch_stage2 import make_batch as make_stage2_batch
    from tris_tpu_torch.ckpt.from_jax import stage2_state_dict_from_flax
    from tris_tpu_torch.train.state import make_teacher

    out = tmp_path_factory.mktemp("dp")
    jm, v, tm = make_stage1_pair(seed=3)
    jc, cv, tc = make_critic_pair(7)
    torch.save((tm, tc.requires_grad_(False)), out / "stage1.pt")

    jm2, v2, tm2, tv = _stage2_pair_and_teacher()
    teacher = make_teacher(tm2)
    teacher.load_state_dict(stage2_state_dict_from_flax(tv), strict=True)
    # the stage-2 parity test's own batch: at the tiny configs' 4 x 4 c3 grid, the attention3
    # leaves' gradients are sums that cancel to 1e-3 of their terms, and on other batches the
    # one-process port already misses JAX's bar there by its summation order alone
    batch2 = make_stage2_batch(3)
    assert batch2["image"].shape[0] == STAGE2_B
    torch.save((tm2, teacher, batch2), out / "stage2.pt")

    g = torch.Generator().manual_seed(0)
    C = 6
    bn = {"x": torch.randn(4, C, 5, 7, generator=g) * 3 + 1,
          "residual": torch.randn(4, C, 5, 7, generator=g),
          "g": torch.randn(4, C, 5, 7, generator=g),
          "weight": torch.rand(C, generator=g) + 0.5, "bias": torch.randn(C, generator=g),
          "running_mean": torch.randn(C, generator=g), "running_var": torch.rand(C, generator=g)}
    torch.save(bn, out / "bn.pt")
    del jax
    return {"dir": out, "stage1": (jm, v, tm, jc, cv, tc), "stage2": (jm2, v2, tm2, tv, batch2),
            "bn": bn}


@pytest.fixture(scope="module")
def mp_results(refs):
    import torch.multiprocessing as mp

    try:
        port = _free_port()
    except OSError:
        pytest.skip("environment forbids sockets")
    mp.start_processes(_worker, args=(port, str(refs["dir"])), nprocs=WORLD, join=True,
                       start_method="spawn")
    return [torch.load(refs["dir"] / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _check_grads(got, want, top, noise_keys, unused_ok):
    """Each leaf within 1e-4 of its max-abs gradient (the parity bars); the
    leaves whose exact gradient is zero (``noise_keys``, and any JAX gives
    exactly zero: at 32 px the c4 grid is one pixel, so more of the fusion's
    biases cancel) within 1e-4 of the largest; the unused leaves none."""
    for k, w in want.items():
        g = got.get(k, torch.zeros_like(w))
        if unused_ok(k):
            assert float(g.abs().max()) == 0.0 and not w.abs().max() > 0, k
            continue
        if noise_keys(k) or not w.abs().max() > 0:
            assert float(g.abs().max()) <= 1e-4 * top and float(w.abs().max()) <= 1e-4 * top, k
            continue
        atol = 1e-4 * float(w.abs().max())
        if k.endswith(".relu.weight"):
            atol = max(atol, 1e-6 * top)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=atol, err_msg=k)


# ---- stage 1 ---------------------------------------------------------------------------------


def test_two_rank_stage1_step_equals_the_jax_step_on_the_global_batch(refs, mp_results):
    from tests.test_torch_train import jax_loss
    from tris_tpu_torch.ckpt.from_jax import grads_from_flax, state_dict_from_flax

    jm, v, tm, jc, cv, tc = refs["stage1"]
    locals_ = [r["stage1"]["local"] for r in mp_results]
    batch = {k: np.concatenate([np.asarray(loc[k]) for loc in locals_]) for k in locals_[0]}
    assert batch["image"].shape[0] == 8 and batch["neg_word_ids"].shape[:2] == (8, 2)
    _, j_metrics, j_stats, j_grads = jax_loss(jm, v, jc, cv, batch)
    for r in mp_results:
        for k in ("loss", "l1", "l4", "l5", "cls_fg"):
            np.testing.assert_allclose(float(r["stage1"]["metrics"][k]), j_metrics[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    assert j_metrics["l5"] > 0
    g0, g1 = (r["stage1"]["grads"] for r in mp_results)
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)  # DDP
    want = grads_from_flax(j_grads)
    assert set(g0) <= set(want)
    # the frozen logit_scale: in no group, so the optimizer ignores the gradient the plain
    # version forms for it (test_torch_train.py holds the same)
    assert "logit_scale" in g0
    want.pop("logit_scale")
    top = max(float(w.abs().max()) for w in want.values())
    _check_grads(g0, want, top,
                 lambda k: re.fullmatch(r"attn_fusion\.(v_proj[123]|v_output)\.0\.bias", k),
                 lambda k: "attnpool" in k or k == "backbone.logit_scale")
    # BatchNorm's running buffers moved by the global batch's statistics, on both ranks
    stats = state_dict_from_flax({"batch_stats": j_stats})
    for r in mp_results:
        buffers = r["stage1"]["buffers"]
        for k, w in stats.items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(buffers[k].numpy(), w.numpy(), rtol=1e-4, atol=1e-4,
                                           err_msg=k)


def test_the_text_gather_carries_the_gradient_back_to_every_rank(refs, mp_results):
    # the text tower's leaves: their gradient on each rank is the mean over the ranks of
    # what every rank's images sent back through the gather (zero without it: a rank's own
    # texts would see only its own images)
    g0 = mp_results[0]["stage1"]["grads"]
    text = [k for k in g0 if k.startswith("backbone.transformer.") or k == "lan_project.weight"]
    assert text and all(float(g0[k].abs().max()) > 0 for k in text)


# ---- stage 2 ---------------------------------------------------------------------------------


def test_two_rank_stage2_step_equals_the_jax_step_on_the_global_batch(refs, mp_results):
    import jax
    import jax.numpy as jnp

    from tris_tpu.train.stage2 import Stage2TrainConfig as JTrainConfig
    from tris_tpu.train.stage2 import stage2_loss as j_stage2_loss
    from tris_tpu_torch.ckpt.from_jax import stage2_grads_from_flax

    jm, v, tm, tv, batch = refs["stage2"]
    fn = jax.value_and_grad(
        lambda p: j_stage2_loss(p, v["batch_stats"], tv["params"], tv["batch_stats"], jm,
                                {k: jnp.asarray(a) for k, a in batch.items()},
                                JTrainConfig(use_ema=True, consistency="mse")), has_aux=True)
    (_, (_, j_metrics)), j_grads = jax.jit(fn)(v["params"])
    for r in mp_results:
        for k in ("loss", "l1", "l2", "l3", "l4", "l5"):
            np.testing.assert_allclose(float(r["stage2"]["metrics"][k]), float(j_metrics[k]),
                                       rtol=1e-5, atol=0, err_msg=k)
    assert float(j_metrics["l5"]) > 0
    g0, g1 = (r["stage2"]["grads"] for r in mp_results)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    want = stage2_grads_from_flax(j_grads)
    top = max(float(w.abs().max()) for w in want.values())
    _check_grads(g0, want, top,
                 lambda k: k.split(".", 1)[1] in ("Wq.bias", "Wk.bias", "Wv.bias", "Ww.bias",
                                                  "ln_final.bias"),
                 lambda k: "attnpool" in k or k in ("backbone.text_projection",
                                                    "backbone.logit_scale"))


# ---- BatchNorm across ranks ------------------------------------------------------------------


def test_cross_rank_batch_norm_equals_one_rank_on_the_concatenated_batch(refs, mp_results):
    from tris_tpu_torch.kernels.batch_norm import batch_norm_act_plain, batch_stats_plain

    d = refs["bn"]
    x = d["x"].clone().requires_grad_()
    w, b = (d[k].clone().requires_grad_() for k in ("weight", "bias"))
    rm, rv = d["running_mean"].clone(), d["running_var"].clone()
    y = batch_norm_act_plain(x, w, b, rm, rv, training=True, update_stats=True, momentum=0.1,
                             eps=1e-5, act="relu", residual=d["residual"])
    (y * d["g"]).sum().backward()
    got = [r["bn"] for r in mp_results]
    scale = float(y.abs().max())
    assert float((torch.cat([r["y"] for r in got]) - y).abs().max()) <= 1e-6 * scale
    assert float((torch.cat([r["dx"] for r in got]) - x.grad).abs().max()) <= (
        1e-5 * float(x.grad.abs().max()))
    # dweight and dbias are each rank's own sums (DDP averages them), summing to one rank's
    for key, want in (("dw", w.grad), ("db", b.grad)):
        total = got[0][key] + got[1][key]
        assert float((total - want).abs().max()) <= 1e-5 * float(want.abs().max()), key
    for r in got:
        np.testing.assert_allclose(r["rm"].numpy(), rm.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["rv"].numpy(), rv.numpy(), rtol=1e-6, atol=1e-6)
        # the kernels' statistics: the gathered per-sample moments, combined in batch order
        for a, b_ in zip(r["kernel_stats"], batch_stats_plain(d["x"], 1e-5)):
            assert torch.equal(a, b_)


# ---- IRN training's slices ------------------------------------------------------------------


def _irn_data(root, n):
    from PIL import Image

    from tests.fixtures import make_fake_refcoco

    make_fake_refcoco(str(root), n_images=n, img_hw=(40, 48))
    names = [f"{i}_{i + 1}" for i in range(n)]
    (root / "ir").mkdir()
    rng = np.random.default_rng(2)
    for name in names:
        lab = rng.choice(np.array([0, 1, 255], np.uint8), (40, 48))
        Image.fromarray(lab).save(root / "ir" / f"{name}.png")
    return names


@pytest.mark.parametrize("count", [2, 3])
def test_irn_train_batches_slices_equal_the_jax_packages(tmp_path, count):
    from tris_tpu.pseudo.pipeline import PseudoConfig as JConfig
    from tris_tpu.pseudo.pipeline import irn_train_batches as j_batches
    from tris_tpu_torch.pseudo.pipeline import PseudoConfig, irn_train_batches

    names = _irn_data(tmp_path, 7)
    common = dict(data_root=str(tmp_path / "train2014"), ir_label_dir=str(tmp_path / "ir"),
                  crop_size=32)
    for index in range(count):
        got = list(irn_train_batches(PseudoConfig(**common), names, None, 2, 2, seed=5,
                                     num_threads=1, process_index=index, process_count=count))
        want = list(j_batches(JConfig(**common), names, None, 2, 2, seed=5, num_threads=1,
                              process_index=index, process_count=count))
        assert len(got) == len(want) == 2 * -(-(7 // count) // 2)
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b) == ["image", "reduced_label"]
            for k in a:
                np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)


def test_irn_train_batches_refuse_an_empty_slice(tmp_path):
    # the JAX pass fills an empty slice with the whole permutation (that process then trains
    # on the others' examples); the port raises
    from tris_tpu_torch.pseudo.pipeline import PseudoConfig, irn_train_batches

    names = _irn_data(tmp_path, 2)
    cfg = PseudoConfig(data_root=str(tmp_path / "train2014"), ir_label_dir=str(tmp_path / "ir"),
                       crop_size=32)
    with pytest.raises(ValueError, match="no examples"):
        next(irn_train_batches(cfg, names, None, 2, 1, process_index=2, process_count=3))
    assert len(list(irn_train_batches(cfg, names, None, 2, 1, num_threads=1,
                                      process_index=1, process_count=2))) == 1


# ---- the ins-seg pass's fan-out ------------------------------------------------------------


def test_ins_seg_fan_out_equals_the_serial_pass(tmp_path):
    from tests.test_torch_irnet import _ins_seg_data
    from tris_tpu_torch.pseudo.irnet import build_irnet
    from tris_tpu_torch.pseudo.pipeline import PseudoConfig, run_make_ins_seg

    names = _ins_seg_data(tmp_path, n=3)
    common = dict(train_list=str(tmp_path / "names.json"), data_root=str(tmp_path / "train2014"),
                  cam_dir=str(tmp_path / "cam"), exp_times=3)
    model = build_irnet(None, "cpu")
    run_make_ins_seg(PseudoConfig(ins_seg_dir=str(tmp_path / "serial"), **common), model=model,
                     log=lambda *a: None, device="cpu")
    run_make_ins_seg(PseudoConfig(ins_seg_dir=str(tmp_path / "fan"), **common),
                     model=copy.deepcopy(model), log=lambda *a: None, device="cpu",
                     devices=["cpu", "cpu"])
    assert sorted(os.listdir(tmp_path / "fan")) == sorted(f"{n}.npy" for n in names)
    assert json.loads((tmp_path / "names.json").read_text()) == names
    for name in names:
        a = np.load(tmp_path / "serial" / f"{name}.npy", allow_pickle=True).item()
        b = np.load(tmp_path / "fan" / f"{name}.npy", allow_pickle=True).item()
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}: {k}")
