"""Data parallelism on one card: ``chip_smoke.py``'s phase 12.

    python -m tris_tpu_torch.tools.dp_check [--out PATH]

Two processes on ``cuda:0`` in a ``gloo`` group with CUDA tensors (NCCL
refuses two ranks on one device) each take half of a full-width step's
batch; the same step then runs in this process, outside any group, on the
whole batch, and the two are held to each other:

- K13 at the stage-1 trunk's stem (two-pass on one process) and layer-1
  tail (fused on one process) and stage 2's output1 (PReLU, its slope a
  leaf): each rank normalises its half of the same seeded batch across the
  ranks through ``kernels.batch_norm_act``; the batch statistics, the output
  and the running buffers equal one process's on the whole batch bit for
  bit, dx within 1e-5 of its scale, the ranks' dweight and dbias sum to one
  process's within 1e-5 and their dslope within 1e-6, relative; and the
  ranks' y, dx, dweight, dbias and dslope are held the same way against
  ``batch_norm_act_reference``'s autograd on the whole batch (dslope within
  1e-5: the reference rounds each of its products to float32);
- stage 1: RN50 (hidden 1024, 320 px, 3 negatives, the ViT-B/32 critic),
  2 x 24 images against the 48 texts of the global batch (K3's rectangular
  head, its own texts at ``rank * 24``) under DDP, against one step on the
  48: the loss terms within 1e-5 relative, every gradient leaf within 1e-4
  of its max-abs gradient (a PReLU slope, one cancelling sum, 1e-6 of the
  largest gradient, as ``tests/test_torch_stage2.py`` holds it) or 4x that
  leaf's noise: the larger of two measured moves of the one-process step's
  gradient, each a rounding the ranks' step also takes. One is the step at
  a rank's shapes, every convolution and linear layer run on 24 of the 48
  at a time (cuDNN and cuBLAS take other algorithms, so other rounding, at
  24 images than at 48); the other the step on the batch reversed (the
  order of the sums over the batch, which the ranks split in two and which
  the kernels' and the other layers' backward take too). Per leaf, the
  summary says which move set the floor and how often the ranks' gradient
  lies nearer the step at their shapes than the step at 48
  (``grad_dp_vs_rank_shapes``). The launches of
  K3's head and of K13's cross-rank route (3 forward and 4 backward a
  call) are counted, and how many K13 calls' statistics came out bit for
  bit (where the convolutions before a norm round otherwise at 24 images,
  its inputs are not the same bits);
- stage 2 (RN50, B = 2 x 24, the EMA teacher's batch statistics across the
  ranks too) and IRN training (the full-width frozen trunk, B = 2 x 12, crop
  512, radius 10), held the same way;
- then, in this process, a one-process NCCL group: the stage-1 step under
  DDP against the step without a group (losses within 1e-5, gradients at
  the bars above against the no-group step's own run-to-run noise), and an
  exact gather.

Rank 0 writes its gradients to a temporary directory for the comparison;
every process this starts is joined before it returns. Launch counts come
from ``kernels.launches``, statistics from :func:`record_statistics`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import sys
import tempfile
import time

import numpy as np
import torch

WORLD = 2
TXT_LEN, SIZE = 20, 320
S1_B, S1_NEG = 48, 3
S2_B = 48
IRN_B, IRN_CROP, IRN_RADIUS = 24, 512, 10
JOBS = ("stage1", "stage2", "irn")
# K13's checks: (name, x shape, activation, residual)
BN_CASES = (("stem", (S1_B, 64, 160, 160), "relu", False),
            ("layer1_tail", (S1_B, 256, 80, 80), "relu", True),
            ("stage2_output1", (S2_B, 32, 80, 80), "prelu", False))


@contextlib.contextmanager
def record_statistics():
    """Within the block, the batch statistics ``(mean, rstd)`` [C] of each
    train-mode K13 call on CUDA tensors, one process's or a rank's, are
    appended to the list this yields: the extension's two ops that return
    them are wrapped for the block."""
    from tris_tpu_torch.kernels import build

    ops, tape = build.ops(), []
    fwd, final = ops.batch_norm_fwd, ops.batch_norm_stats_final

    def fused(*args):
        y, stats = fwd(*args)
        tape.append((stats[0].clone(), stats[2].clone()))
        return y, stats

    def stats_final(*args):
        stats = final(*args)
        tape.append((stats[0].clone(), stats[2].clone()))
        return stats

    ops.batch_norm_fwd, ops.batch_norm_stats_final = fused, stats_final
    try:
        yield tape
    finally:
        ops.batch_norm_fwd, ops.batch_norm_stats_final = fwd, final


@contextlib.contextmanager
def at_rank_shapes(whole: int):
    """Within the block, a convolution or linear layer whose input's first
    dimension is a multiple of ``whole`` (the global batch, or it times the
    negatives or the pixels, batch-major) runs as ``WORLD`` chunks along it,
    concatenated: one process's step at a rank's shapes, the algorithms cuDNN
    and cuBLAS pick there and so their rounding. The same function: each row
    of such an input is computed alone."""
    import torch.nn.functional as F

    conv2d, linear = F.conv2d, F.linear

    def chunked(op):
        def run(x, *args, **kw):
            if x.dim() >= 2 and x.shape[0] % whole == 0:
                return torch.cat([op(c, *args, **kw) for c in x.chunk(WORLD)])
            return op(x, *args, **kw)
        return run

    F.conv2d, F.linear = chunked(conv2d), chunked(linear)
    try:
        yield
    finally:
        F.conv2d, F.linear = conv2d, linear


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def token_ids(rng, shape):
    """[*shape, 20] CLIP ids of 6 to 18 tokens."""
    out = np.zeros(shape + (TXT_LEN,), np.int32)
    for idx in np.ndindex(*shape):
        n_tok = int(rng.integers(6, 19))
        out[idx][0], out[idx][n_tok - 1] = 49406, 49407
        out[idx][1:n_tok - 1] = rng.integers(1, 49000, n_tok - 2)
    return out


def batch(job: str) -> dict:
    """The global batch of ``job``, the same in every process (numpy, seeded)."""
    rng = np.random.default_rng({"stage1": 12, "stage2": 13, "irn": 14}[job])
    if job == "stage1":
        return {"image": rng.integers(0, 256, (S1_B, SIZE, SIZE, 3), dtype=np.uint8),
                "word_ids": token_ids(rng, (S1_B,)),
                "neg_word_ids": token_ids(rng, (S1_B, S1_NEG))}
    if job == "stage2":
        blocks = rng.random((S2_B, SIZE // 8, SIZE // 8, 1)) > 0.6
        return {"image": rng.integers(0, 256, (S2_B, SIZE, SIZE, 3), dtype=np.uint8),
                "word_ids": token_ids(rng, (S2_B,)),
                "pseudo": blocks.repeat(8, 1).repeat(8, 2).astype(np.float32)}
    q = IRN_CROP // 4
    return {"image": rng.standard_normal((IRN_B, IRN_CROP, IRN_CROP, 3)).astype(np.float32),
            "reduced_label": rng.choice(np.array([0, 1, 255], np.uint8), (IRN_B, q, q),
                                        p=(0.45, 0.35, 0.2))}


def models(job: str, dev):
    """The seeded full-width models of ``job``, as ``chip_smoke.py`` builds them."""
    from tris_tpu_torch.cli.common import build_critic
    from tris_tpu_torch.config import get_parser

    if job == "stage1":
        from tris_tpu_torch.models.stage1 import Stage1Config, TRISStage1

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = TRISStage1(Stage1Config(backbone="RN50", hidden_dim=1024,
                                            txt_length=TXT_LEN))
        critic = build_critic(get_parser().parse_args(["--max_query_len", str(TXT_LEN)]), dev)
        return model.to(dev).train(), critic
    if job == "stage2":
        from tris_tpu_torch.models.stage2 import Stage2Config, TRISStage2

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = TRISStage2(Stage2Config(backbone="RN50", txt_length=TXT_LEN))
        return model.to(dev).train(), None
    from tris_tpu_torch.pseudo.irnet import IRNet

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = IRNet()  # the trunk frozen, as run_train_irn trains it
    return model.to(dev).train(), None


def step(job: str, dev, rows: slice, init, ddp_model=None, rank_shapes: bool = False,
         reverse: bool = False):
    """One training step of ``job`` from a copy of ``init`` (``models(job)``)
    on ``rows`` of its global batch (its convolutions and linear layers at a
    rank's shapes when asked, :func:`at_rank_shapes`; the rows reversed when
    asked): ``(metrics, grads, statistics, launches)``; under a process group
    the model runs under DDP (``ddp_model`` forces a DDP wrapper of the
    caller's)."""
    import copy

    from tris_tpu_torch import kernels as K
    from tris_tpu_torch import parallel

    data = {k: v[rows] for k, v in batch(job).items()}
    if reverse:
        data = {k: v[::-1].copy() for k, v in data.items()}
    model, critic = copy.deepcopy(init[0]), init[1]
    net = ddp_model(model) if ddp_model else parallel.wrap_ddp(model, dev)
    torch.cuda.synchronize()
    K.reset_launches()
    shapes = at_rank_shapes(rows.stop - rows.start) if rank_shapes else contextlib.nullcontext()
    with record_statistics() as tape, shapes:
        if job == "stage1":
            from tris_tpu_torch.train.stage1 import batch_to_device, train_step
            from tris_tpu_torch.train.state import make_optimizer

            opt, sched = make_optimizer(model, total_steps=100)
            metrics = train_step(net, critic, opt, sched, batch_to_device(data, dev))
        elif job == "stage2":
            from tris_tpu_torch.train.stage2 import Stage2TrainConfig, batch_to_device
            from tris_tpu_torch.train.stage2 import train_step
            from tris_tpu_torch.train.state import create_train_state

            state = create_train_state(model, total_steps=100, stage="stage2", with_ema=True)
            state.ddp = net if net is not model else None
            metrics = train_step(state, batch_to_device(data, dev),
                                 Stage2TrainConfig(use_ema=True, ema_update_after=0,
                                                   ema_update_every=1))
        else:
            from tris_tpu_torch.pseudo.indexing import PathIndex
            from tris_tpu_torch.pseudo.train_irn import (
                IRNTrainConfig, batch_to_device, make_irn_optimizer, train_step)

            q = IRN_CROP // 4
            opt, sched = make_irn_optimizer(model, IRNTrainConfig(
                crop_size=IRN_CROP, radius=IRN_RADIUS, batch_size=IRN_B), 100)
            metrics = train_step(net, opt, sched, PathIndex(IRN_RADIUS, (q, q)),
                                 batch_to_device(data, dev))
    torch.cuda.synchronize()
    launches = dict(K.launches)
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    return {k: float(v) for k, v in metrics.items()}, grads, tape, launches


def bn_case(case, dev, rows: slice, reference: bool = False) -> dict:
    """K13 on ``rows`` of a case's seeded batch (the same bits in every
    process), train mode with the running buffers moved, and its backward
    from a seeded cotangent: statistics, output, running buffers, dx,
    dweight, dbias, dslope (PReLU) and the launches; with ``reference``,
    ``batch_norm_act_reference`` and its autograd in place of the kernels."""
    from tris_tpu_torch import kernels as K
    from tris_tpu_torch.kernels.batch_norm import batch_norm_act_reference

    name, shape, act, residual = case
    g = torch.Generator(device=dev).manual_seed(BN_CASES.index(case))
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5)[rows].contiguous()
    res = torch.randn(shape, generator=g, device=dev)[rows].contiguous() if residual else None
    cot = torch.randn(shape, generator=g, device=dev)[rows].contiguous()
    C = shape[1]
    w = (torch.rand(C, generator=g, device=dev) + 0.5).requires_grad_()
    b = torch.randn(C, generator=g, device=dev).requires_grad_()
    rm, rv = torch.zeros(C, device=dev), torch.ones(C, device=dev)
    slope = torch.full((1,), 0.25, device=dev).requires_grad_() if act == "prelu" else None
    x.requires_grad_()
    K.reset_launches()
    fn = batch_norm_act_reference if reference else K.batch_norm_act
    with record_statistics() as tape:
        y = fn(x, w, b, rm, rv, training=True, update_stats=True, momentum=0.1, eps=1e-5,
               act=act, slope=slope, residual=res)
    leaves = (x, w, b) + ((slope,) if slope is not None else ())
    dx, dw, db, *dslope = torch.autograd.grad(y, leaves, cot)
    torch.cuda.synchronize()
    return {"stats": tape[0] if tape else None, "y": y.detach(), "rm": rm, "rv": rv, "dx": dx,
            "dw": dw, "db": db, "dslope": dslope[0] if dslope else None,
            "launches": {k: v for k, v in K.launches.items() if v}}


def _worker(rank: int, port: int, out_dir: str) -> None:
    from tris_tpu_torch import parallel

    parallel.init_process_group("cuda", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=WORLD, backend="gloo")
    dev = torch.device("cuda", 0)
    try:
        for case in BN_CASES:
            n = case[1][0] // WORLD
            out = bn_case(case, dev, slice(rank * n, (rank + 1) * n))
            torch.save({k: (tuple(t.cpu() for t in v) if isinstance(v, tuple) else
                            v.cpu() if torch.is_tensor(v) else v) for k, v in out.items()},
                       os.path.join(out_dir, f"bn_{case[0]}_{rank}.pt"))
            del out
        for job in JOBS:
            n = batch(job)["image"].shape[0] // WORLD
            t0 = time.perf_counter()
            metrics, grads, tape, launches = step(job, dev, slice(rank * n, (rank + 1) * n),
                                                  models(job, dev))
            secs = time.perf_counter() - t0
            if rank == 0:
                torch.save({"metrics": metrics, "launches": launches, "seconds": secs,
                            "tape": [(m.cpu(), r.cpu()) for m, r in tape],
                            "grads": {k: g.cpu() for k, g in grads.items()}},
                           os.path.join(out_dir, f"{job}.pt"))
            del grads, tape
            torch.cuda.empty_cache()
    finally:
        torch.distributed.destroy_process_group()


def _term_errors(got: dict, want: dict) -> dict:
    """Each loss term's error relative to itself, or to 1e-6 of the loss where
    the term is about zero (stage 2's first-step consistency between the
    student and its copy, rounding noise on both sides)."""
    floor = 1e-6 * abs(want["loss"])
    return {k: abs(got[k] - want[k]) / max(abs(want[k]), floor, 1e-30) for k in want if k in got}


def _grad_errors(what, got: dict, want: dict, noises: dict, dev, failures) -> dict:
    """Each gradient leaf of ``got`` within 1e-4 of ``want``'s max-abs or 4x
    its noise there: the largest move of ``want`` to any gradient set of
    ``noises`` (``{name: grads}``). A PReLU slope is one
    value, a sum over the negative half of its input that cancels to 1e-3 of
    the largest gradient: its bar is 1e-6 of the largest gradient, as
    ``tests/test_torch_stage2.py`` holds it. A leaf the step does not use (the
    attention pool's) has no gradient on one process and DDP's zeros across
    the ranks; stage 1's frozen ``logit_scale`` is in no group."""
    worst, by_floor = (0.0, ""), {}
    top = max(float(g.abs().max()) for g in want.values())
    for k in sorted(set(want) | set(got)):
        if k == "logit_scale":
            continue
        g = want[k] if k in want else torch.zeros_like(got[k], device=dev)
        d = got[k].to(dev) if k in got else torch.zeros_like(g)
        err = float((d - g).abs().max())
        moves = {n: float((grads[k] - g).abs().max()) for n, grads in noises.items()
                 if k in grads}
        by = max(moves, key=moves.get) if moves else None
        floor = moves[by] if moves else 0.0
        bar = 1e-4 * float(g.abs().max())
        if k.endswith(".relu.weight"):
            bar = max(bar, 1e-6 * top)
        if err <= bar:
            worst = max(worst, (err / bar * 1e-4 if bar > 0 else 0.0, k))
        elif err <= 4 * floor:
            by_floor[k] = {"err": err, "noise": floor, "noise_of": by}
        else:
            failures.append(f"{what}: gradient {k} {err} > its bar ({bar}) and > 4x its "
                            f"noise ({floor})")
    return {"grad_leaves": len(want), "grad_worst_rel_err": worst[0], "grad_worst_leaf": worst[1],
            "grad_within_noise": by_floor}


def _compare(job, dp, dev, failures):
    """The one-process step on the whole batch against rank 0's: returns the
    summary; appends what fails to ``failures``."""
    from tris_tpu_torch.kernels.batch_norm import RANKS_LAUNCHES

    whole = slice(0, batch(job)["image"].shape[0])
    init = models(job, dev)
    metrics, grads, tape, _ = step(job, dev, whole, init)
    noises = {"rank_shapes": step(job, dev, whole, init, rank_shapes=True)[1],
              "reversed": step(job, dev, whole, init, reverse=True)[1]}
    del init
    out = {"metrics_dp": dp["metrics"], "metrics_one": metrics, "dp_step_s": dp["seconds"]}
    # per leaf: is the ranks' gradient nearer the step at their shapes than the step at 48?
    near = [float((dp["grads"][k].to(dev) - g).abs().max()) /
            max(float((dp["grads"][k].to(dev) - grads[k]).abs().max()), 1e-30)
            for k, g in noises["rank_shapes"].items() if k in dp["grads"] and k in grads]
    out["grad_dp_vs_rank_shapes"] = {
        "leaves": len(near), "nearer_rank_shapes": sum(r < 1 for r in near),
        "median_err_ratio": float(np.median(near)),
        "slopes": {k: {"err_vs_one": float((dp["grads"][k].to(dev) - grads[k]).abs().max()),
                       **{f"noise_{n}": float((v[k] - grads[k]).abs().max())
                          for n, v in noises.items()}}
                   for k in grads if k.endswith(".relu.weight")}}
    # how many K13 calls' statistics came out bit for bit (their inputs are the convolutions'
    # at 24 images against 48); the rank's calls are one process's, one for one
    same = [torch.equal(a.to(dev), c) and torch.equal(b.to(dev), d)
            for (a, b), (c, d) in zip(dp["tape"], tape)]
    out["bn_calls"] = [len(dp["tape"]), len(tape)]
    out["bn_stats_bit_equal"] = sum(same)
    if len(dp["tape"]) != len(tape):
        failures.append(f"dp {job}: {len(dp['tape'])} K13 calls across the ranks, {len(tape)} "
                        f"on one process")
    rel = _term_errors(dp["metrics"], metrics)
    out["loss_rel_err"] = rel
    if not max(rel.values()) <= 1e-5:
        failures.append(f"dp {job}: loss terms {rel} > 1e-5 relative")
    out.update(_grad_errors(f"dp {job}", dp["grads"], grads, noises, dev, failures))
    launches = dp["launches"]
    out["launches"] = {k: v for k, v in launches.items() if v}
    n_bn = len(dp["tape"])
    want = {"batch_norm": RANKS_LAUNCHES["fwd"] * n_bn}
    if job == "stage1":
        want.update(stage1_head=1, stage1_head_bwd=1)
    if job == "stage2":
        # the student's calls have a backward; the teacher's none
        want["batch_norm_bwd"] = RANKS_LAUNCHES["bwd"] * (n_bn // 2)
    if job == "stage1":
        want["batch_norm_bwd"] = RANKS_LAUNCHES["bwd"] * n_bn
    for name, n in want.items():
        if launches.get(name) != n:
            failures.append(f"dp {job}: {name} launched {launches.get(name)} times, want {n}")
    out["launches_expected"] = want
    del grads, noises
    torch.cuda.empty_cache()
    return out


def _compare_bn(case, tmp, dev, failures) -> dict:
    from tris_tpu_torch.kernels.batch_norm import RANKS_LAUNCHES, plan

    name, shape = case[0], case[1]
    ranks = [torch.load(os.path.join(tmp, f"bn_{name}_{r}.pt")) for r in range(WORLD)]
    one = bn_case(case, dev, slice(0, shape[0]))
    ref = bn_case(case, dev, slice(0, shape[0]), reference=True)
    cat = {k: torch.cat([r[k] for r in ranks]).to(dev) for k in ("y", "dx")}
    out = {"shape": list(shape), "one_process_design": plan(
        shape[0], shape[1], shape[2] * shape[3], True, False, case[2])["design"],
        "launches_per_rank": ranks[0]["launches"]}
    checks = {
        "stats": all(torch.equal(a.to(dev), b) for r in ranks
                     for a, b in zip(r["stats"], one["stats"])),
        "y": torch.equal(cat["y"], one["y"]),
        "running": all(torch.equal(r["rm"].to(dev), one["rm"]) and
                       torch.equal(r["rv"].to(dev), one["rv"]) for r in ranks)}
    out.update(checks)
    keys = ("dw", "db") + (("dslope",) if one["dslope"] is not None else ())
    # the ranks' parameter gradients summed in double, as DDP's sum would be exact here
    summed = {k: sum(r[k].double() for r in ranks).to(dev) for k in keys}

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()) / float(b.abs().max())

    bars = {"dw": 1e-5, "db": 1e-5, "dslope": 1e-6}
    for against, want in (("one", one), ("reference", ref)):
        errs = {"y": rel(cat["y"], want["y"]), "dx": rel(cat["dx"], want["dx"]),
                **{k: rel(summed[k], want[k]) for k in keys}}
        out[f"rel_err_vs_{against}"] = errs
        for k, e in errs.items():
            bar = 1e-5 if against == "reference" and k == "dslope" else bars.get(k, 1e-5)
            if not e <= bar:
                failures.append(f"dp k13 {name}: {k} against {against} {e} > {bar} relative")
    want = {"batch_norm": RANKS_LAUNCHES["fwd"], "batch_norm_bwd": RANKS_LAUNCHES["bwd"]}
    if not (all(checks.values()) and ranks[0]["launches"] == want):
        failures.append(f"dp k13 {name}: {out} (launches wanted {want})")
    return out


def nccl_check(dev, failures):
    """A one-process NCCL group: the stage-1 step under DDP against the step
    outside a group (the bars of :func:`_compare`, the noise the no-group
    step's own run to run: cuDNN's weight gradients need not repeat bit for
    bit), and an exact gather."""
    from torch.nn.parallel import DistributedDataParallel

    from tris_tpu_torch import parallel

    whole = slice(0, S1_B // WORLD)
    init = models("stage1", dev)
    metrics, grads, _, _ = step("stage1", dev, whole, init)
    _, grads_again, _, _ = step("stage1", dev, whole, init)
    parallel.init_process_group("cuda", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                                world_size=1)
    try:
        backend = torch.distributed.get_backend()
        t = torch.arange(6.0, device=dev)
        gathered = parallel.gather_stacked(t)
        metrics_n, grads_n, _, _ = step("stage1", dev, whole, init, ddp_model=lambda m: (
            DistributedDataParallel(m, device_ids=[dev], find_unused_parameters=True)))
    finally:
        torch.distributed.destroy_process_group()
    nccl_failures = []
    out = {"backend": backend, "metrics": metrics_n,
           "loss_rel_err": _term_errors(metrics_n, metrics),
           "grads_bit_equal": all(torch.equal(grads[k], grads_n[k]) for k in grads),
           "gather_exact": bool(torch.equal(gathered[0], t)),
           **_grad_errors("dp nccl", grads_n, grads, {"run_to_run": grads_again}, dev,
                          nccl_failures)}
    if not (backend == "nccl" and out["gather_exact"]
            and max(out["loss_rel_err"].values()) <= 1e-5):
        nccl_failures.append(f"dp nccl: {out}")
    failures += nccl_failures
    return out


def run() -> tuple:
    """Phase 12: the two-rank steps, the comparisons, the NCCL group.
    Returns ``(summary, failures)``."""
    import torch.multiprocessing as mp

    dev = torch.device("cuda", 0)
    failures, summary = [], {"world": WORLD, "backend": "gloo (CUDA tensors, one card)"}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.start_processes(_worker, args=(_free_port(), tmp), nprocs=WORLD, join=True,
                               start_method="spawn")
        except Exception as e:  # noqa: BLE001 - a worker's failure becomes the phase's
            failures.append(f"dp: the two-rank run failed: {str(e)[-3000:]}")
            return summary, failures
        summary["two_rank_s"] = time.perf_counter() - t0
        summary["k13"] = {}
        for case in BN_CASES:
            summary["k13"][case[0]] = _compare_bn(case, tmp, dev, failures)
        for job in JOBS:
            dp = torch.load(os.path.join(tmp, f"{job}.pt"))
            summary[job] = _compare(job, dp, dev, failures)
            del dp
    summary["nccl"] = nccl_check(dev, failures)
    summary["seconds"] = time.perf_counter() - t0
    return summary, failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None, help="write the summary JSON here")
    args = p.parse_args(argv)
    summary, failures = run()
    text = json.dumps({"summary": summary, "failures": failures}, indent=1, default=str)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text[-6000:])
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
