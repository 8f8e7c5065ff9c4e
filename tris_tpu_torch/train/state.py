"""Optimizer, parameter groups, LR schedules and the EMA teacher of the
trainers.

Port of ``tris_tpu/train/state.py`` (the reference's train_stage1.py:133-144
recipe) in PyTorch's idiom: ``torch.optim.AdamW`` parameter groups and a
``LambdaLR`` stepped after every optimizer step.

- AdamW, base lr 5e-5, weight decay 0.01, betas (0.9, 0.999), eps 1e-8; the
  backbone at ``lr * lr_multi``.
- Per-iteration polynomial decay ``(1 - step/total)^power`` (power 0.9 in
  stage 1). optax evaluates a schedule at the update count before
  incrementing it, so the first update uses the base lr; ``LambdaLR`` does
  the same when ``scheduler.step()`` follows ``optimizer.step()``.
- ``logit_scale`` is frozen in stage 1 (the reference puts it in no group):
  it is in no group here, so it never moves and is never decayed.
- Stage 2 puts every backbone parameter whose name holds
  ``positional_embedding`` (the text tower's and the attention pool's) in
  the head group (model_stage2.py:93-103 of the reference).
- optax's ``adamw`` decays every leaf, including those whose gradient is
  zero because the step never uses them (the attention pool's). AdamW here
  skips a parameter whose ``.grad`` is None, so :func:`apply_gradients`
  gives such parameters zero gradients first.
- ``--bf16``: on a bfloat16 leaf optax computes in bfloat16, each op
  rounded, and keeps the leaf's moments in bfloat16; :class:`AdamW` follows
  it there op for op (``torch.optim.AdamW`` on the float32 leaves).
- The stage-2 EMA teacher (``create_train_state(with_ema=True)``) is a
  copy of the model with storage of its own, its parameters without
  gradients and in no group, its BatchNorms normalising by batch statistics
  without updating their buffers (those move only through the EMA).
  :func:`ema_update` is K12 over a leaf table built once per train state.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from tris_tpu_torch import kernels
from tris_tpu_torch.models.layers import TorchBatchNorm
from tris_tpu_torch.ops.dtypes import weak

Schedule = Callable[[int], float]


def poly_schedule(base_lr: float, total_steps: int, power: float = 0.9) -> Schedule:
    """``base_lr * (1 - clip(step/total, 0, 1))^power``, per iteration."""

    def schedule(step: int) -> float:
        frac = min(max(step / total_steps, 0.0), 1.0)
        return base_lr * (1.0 - frac) ** power

    return schedule


def poly_epoch_schedule(base_lr: float, end_lr: float, power: float, max_decay_steps: int,
                        steps_per_epoch: int) -> Schedule:
    """The reference's ``PolynomialLRDecay`` (utils/poly_lr_decay.py:3-39):
    ``(base - end) * (1 - epoch/max)^power + end`` with ``epoch = step //
    steps_per_epoch``, frozen at ``end_lr`` after ``max_decay_steps`` epochs."""

    def schedule(step: int) -> float:
        epoch = min(step // steps_per_epoch, max_decay_steps)
        return (base_lr - end_lr) * (1.0 - epoch / max_decay_steps) ** power + end_lr

    return schedule


def label_params(model: nn.Module, stage: str = "stage1") -> Dict[str, str]:
    """Each parameter's group: ``backbone``, ``head`` or ``frozen``
    (``_label_params`` of the JAX package, by ``named_parameters`` name;
    ``stage`` is ``"stage1"`` or ``"stage2"``)."""
    labels = {}
    for name, _ in model.named_parameters():
        if stage == "stage1" and name == "logit_scale":
            labels[name] = "frozen"
        elif name.split(".")[0] == "backbone":
            head = stage == "stage2" and "positional_embedding" in name
            labels[name] = "head" if head else "backbone"
        else:
            labels[name] = "head"
    return labels


class AdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` on float32 parameters; on a bfloat16 parameter
    (``--bf16``'s leaves) optax 0.2.6's ``adamw`` as XLA runs it, each op in
    bfloat16 and rounded, its moments held in bfloat16 (under torch's state
    keys, so that ``state_dict`` and ``load_state_dict`` keep them):

        m = bf16(1 - b1) g + bf16(b1) m;   v = bf16(1 - b2) (g g) + bf16(b2) v
        u = (m / bf16(1 - b1^t)) / (sqrt(v / bf16(1 - b2^t)) + bf16(eps))
        p = p + bf16(-lr) (u + bf16(wd) p)

    with ``t`` the updates counted including this one, ``b^t`` in float32
    (float64 rounded once) and ``lr`` the group's, rounded to float32 then
    to bfloat16."""

    @torch.no_grad()
    def step(self, closure=None):
        low = [(group, p, p.grad) for group in self.param_groups for p in group["params"]
               if p.grad is not None and p.dtype != torch.float32]
        for _, p, _ in low:
            p.grad = None           # torch's step skips them
        try:
            loss = super().step(closure)
        finally:
            for _, p, g in low:
                p.grad = g
        scalars = {}
        for group, p, g in low:
            self._step_low(group, p, g, scalars)
        return loss

    def _step_low(self, group: dict, p: torch.Tensor, g: torch.Tensor, scalars: dict) -> None:
        state = self.state[p]
        if not state:
            state["step"] = torch.tensor(0.0)
            state["exp_avg"] = torch.zeros_like(p)
            state["exp_avg_sq"] = torch.zeros_like(p)
        state["step"] += 1
        t, dt = int(state["step"]), p.dtype
        key = (id(group), t, dt)
        if key not in scalars:  # the step's constants, once a group
            b1, b2 = group["betas"]
            scalars[key] = (weak(1 - b1, dt), weak(b1, dt), weak(1 - b2, dt), weak(b2, dt),
                            _bias_correction(b1, t, dt), _bias_correction(b2, t, dt),
                            weak(group["eps"], dt), weak(group["weight_decay"], dt),
                            _low(-float(torch.tensor(group["lr"], dtype=torch.float32)), dt))
        c1, b1, c2, b2, bc1, bc2, eps, wd, lr = scalars[key]
        g = g.to(dt)
        m = c1 * g + b1 * state["exp_avg"]
        v = c2 * (g * g) + b2 * state["exp_avg_sq"]
        state["exp_avg"].copy_(m)
        state["exp_avg_sq"].copy_(v)
        # divisors as tensors: a division by a Python number may run as a product with its
        # reciprocal, which rounds otherwise
        m_hat = m / torch.full_like(m, bc1)
        v_hat = v / torch.full_like(v, bc2)
        u = m_hat / (v_hat.sqrt() + eps)
        p.copy_(p + lr * (u + wd * p))


def _low(value: float, dtype: torch.dtype) -> float:
    """A float32 ``value`` rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(value, dtype=torch.float32).to(dtype))


def _bias_correction(b: float, t: int, dtype: torch.dtype) -> float:
    """optax's ``1 - b^t``: in float32 (the power in float64, rounded once),
    then rounded to ``dtype``."""
    bt = float(torch.tensor(float(torch.tensor(b, dtype=torch.float32)) ** t,
                            dtype=torch.float32))
    return _low(float(torch.tensor(1.0 - bt, dtype=torch.float32)), dtype)


def make_optimizer(model: nn.Module, base_lr: float = 5e-5, lr_multi: float = 0.1,
                   weight_decay: float = 0.01, total_steps: int = 1, power: float = 0.9,
                   schedule_factory: Optional[Callable[[float], Schedule]] = None,
                   stage: str = "stage1"):
    """``(AdamW, LambdaLR)`` over the ``backbone`` (``base_lr * lr_multi``)
    and ``head`` (``base_lr``) groups; ``frozen`` parameters are in none.
    ``schedule_factory(group_base_lr) -> schedule(step) -> lr`` replaces the
    per-step poly decay (the reference's PolynomialLRDecay branch)."""
    labels = label_params(model, stage)
    params = dict(model.named_parameters())
    groups: List[dict] = []
    schedules: List[Schedule] = []
    for label, scale in (("backbone", lr_multi), ("head", 1.0)):
        group_lr = base_lr * scale
        groups.append({"params": [p for n, p in params.items() if labels[n] == label],
                       "lr": group_lr, "name": label})
        schedules.append(schedule_factory(group_lr) if schedule_factory is not None
                         else poly_schedule(group_lr, total_steps, power))
    optimizer = AdamW(groups, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                      weight_decay=weight_decay)
    lambdas = [(lambda step, f=f, lr=g["lr"]: f(step) / lr if lr else 0.0)
               for f, g in zip(schedules, groups)]
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, lambdas)


@dataclasses.dataclass
class TrainState:
    """A model with its optimizer and LR schedule (the model holds the
    parameters and BatchNorm's buffers that the JAX ``TrainState`` holds),
    the optimizer steps taken, and with stage 2's EMA the teacher and the
    K12 table pairing its leaves with the model's."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0
    ema: Optional[nn.Module] = None
    ema_table: Optional[kernels.EmaTable] = None
    # the model under DDP in a process group of several ranks (parallel.wrap_ddp), which the
    # train step runs forward; None on one process
    ddp: Optional[nn.Module] = None


def ema_leaves(model: nn.Module) -> List[torch.Tensor]:
    """The leaves the EMA reads or writes: every parameter, then every
    buffer, in ``named_parameters`` / ``named_buffers`` order."""
    return [p.data for p in model.parameters()] + list(model.buffers())


def make_teacher(model: nn.Module) -> nn.Module:
    """The EMA teacher: a copy of ``model`` with its own storage, its
    parameters without gradients, its BatchNorms leaving their buffers to
    the EMA."""
    teacher = copy.deepcopy(model).requires_grad_(False)
    for m in teacher.modules():
        if isinstance(m, TorchBatchNorm):
            m.update_stats = False
    return teacher


def create_train_state(model: nn.Module, total_steps: int, base_lr: float = 5e-5,
                       lr_multi: float = 0.1, weight_decay: float = 0.01,
                       schedule_factory: Optional[Callable[[float], Schedule]] = None,
                       stage: str = "stage1", with_ema: bool = False) -> TrainState:
    optimizer, scheduler = make_optimizer(model, base_lr=base_lr, lr_multi=lr_multi,
                                          weight_decay=weight_decay, total_steps=total_steps,
                                          schedule_factory=schedule_factory, stage=stage)
    state = TrainState(model, optimizer, scheduler)
    if with_ema:
        state.ema = make_teacher(model)
        if next(model.parameters()).is_cuda:
            state.ema_table = kernels.EmaTable(ema_leaves(state.ema), ema_leaves(model))
    return state


def ema_update(state: TrainState, decay: float) -> None:
    """The teacher's every leaf ``e * decay + p * (1 - decay)`` from the
    model's, in place (K12 on the card, one launch over the state's table);
    integer buffers copied."""
    kernels.ema_update(ema_leaves(state.ema), ema_leaves(state.model), decay,
                       table=state.ema_table)


def apply_gradients(optimizer: torch.optim.Optimizer, scheduler) -> None:
    """One update: parameters of a group that got no gradient take a zero
    one (so AdamW decays them, as optax does), then the optimizer steps and
    the schedule advances."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    optimizer.step()
    scheduler.step()
