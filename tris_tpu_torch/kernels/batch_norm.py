"""K13: BatchNorm (batch statistics or the eval fold) with the activation that
follows it, forward (``csrc/batch_norm.cu``) and backward
(``csrc/batch_norm_bwd.cu``), and the plain PyTorch version.

Replaces ``tris_tpu/models/layers.py:181`` ``TorchBatchNorm`` (train path
``:219-229``, eval fold ``:213-217``) together with what its callers apply
next: ReLU (CLIP's stem and a bottleneck's first two norms,
``tris_tpu/models/clip.py:95-100``), the residual add then ReLU (a
bottleneck's tail), nothing (its downsample), or the channel-shared PReLU
``where(y >= 0, y, a * y)`` (stage 2's ``ConvBNRelu``,
``tris_tpu/models/stage2.py:35-50``).

Train: per-channel mean and biased variance over N*H*W, ``((x - mean) *
rstd) * weight + bias``; with ``update_stats`` the running statistics move
by ``momentum`` with the unbiased variance, ``n / max(n - 1, 1)``. Eval: the
running statistics fold into one affine ``x * a + b``. The plain version
is the JAX package's arithmetic. On CUDA tensors the kernels form the
statistics as :func:`batch_stats_plain` does (each sample's sums in double,
the batch in float32 in order), and apply the norm with each product and sum
rounded alone in the plain version's order; :func:`batch_norm_act_reference`,
the plain version on those statistics, is the routes' comparison on the card:
its forward is the kernels' bit for bit (but for a sample sum whose double
value lies within an ulp of double of a float32 rounding boundary).
The wrapper is then a ``torch.autograd.Function``; its forward keeps x, the
mean and rstd, and its output where the activation is ReLU (whose mask that
output is); PReLU's pre-activation is recomputed from x.

Which design a call takes, fused (one launch, each input read once) or
two-pass, is ``csrc/launchers.h::batch_norm_plan``'s rule on the shape; the
extension's ``batch_norm_plan`` op gives it on the card, and the wrapper
counts its launches from it.

Across ranks (a train-mode call in a ``torch.distributed`` group of several
processes, as ``SyncBatchNorm``): the statistics are the global batch's. On
the card the call takes the two-pass design's stages apart: each rank forms
its samples' partial sums (shifted by rank 0's first value of each channel,
the shift one process takes on the whole batch), the ranks gather them in
rank order along the batch, and the final launch combines every sample's,
so the statistics equal one process's on the concatenated batch bit for
bit; the backward gathers its partials the same way for dx's coefficients,
while dweight, dbias and dslope are this rank's sums (DDP averages them, as
``SyncBatchNorm``'s). The plain version takes the global sums by
``all_reduce`` in the JAX package's arithmetic, with their gradient.

``--bf16``: the eval fold on bfloat16 x (and residual), a and b formed in
float32 and rounded to bfloat16 as the JAX package rounds them, then
``bf16(bf16(x * a) + b)`` [``+ residual``, rounded], each op rounded as the
plain version's bfloat16 ops round: one launch of ``batch_norm_fold_bf16``
(counted as ``batch_norm.bf16``), forward only, act "none" or "relu". In
training (stage 1's trunk, ``tris_tpu/models/layers.py:219-229`` on
bfloat16 x): the statistics of x's values as the float32 route forms them,
``y = bf16(norm(x))`` [``+ residual``, rounded], then ReLU; the running
buffers float32; the backward from bfloat16 g to dx rounded to bfloat16 once,
dweight and dbias float32 and the residual's gradient the masked g. Three
launches each way, the two-pass design at every shape (``batch_norm_fwd_bf16``
and ``batch_norm_bwd_bf16``, counted as ``batch_norm.bf16`` and
``batch_norm_bwd.bf16``). PReLU (stage 2) and the cross-rank route take no
bfloat16 and raise before any launch.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from tris_tpu_torch import parallel
from tris_tpu_torch.kernels import build

# the activation codes of csrc/launchers.h (kBatchNormAct*) and its kBatchNormMaxBatch
ACTS = {"none": 0, "relu": 1, "prelu": 2}
MAX_BATCH = 4096
BF16 = torch.bfloat16


def _check_act(act, slope, residual):
    """The fused forms: the residual before a ReLU or alone; PReLU with its
    slope and no residual. Raises on any other."""
    if act not in ACTS:
        raise ValueError(f"batch_norm_act: act must be one of {sorted(ACTS)}, got {act!r}")
    if (act == "prelu") != (slope is not None):
        raise ValueError("batch_norm_act: a slope goes with act='prelu' and only with it")
    if act == "prelu" and residual is not None:
        raise ValueError("batch_norm_act: no residual before a PReLU")


def _update_running_stats(running_mean, running_var, mean, var, n: int, momentum: float) -> None:
    """torch's rule: the running variance takes the unbiased batch variance."""
    with torch.no_grad():
        running_mean.mul_(1 - momentum).add_(momentum * mean)
        running_var.mul_(1 - momentum).add_(momentum * var * (n / max(n - 1, 1)))


def _fold(weight, bias, running_mean, running_var, eps: float):
    """The eval path's per-channel affine (a, b): the JAX package's fold."""
    inv = weight * torch.rsqrt(running_var + eps)
    return inv, bias - running_mean * inv


def _activate(y, act: str, slope=None, residual=None):
    if residual is not None:
        y = y + residual
    if act == "relu":
        return F.relu(y)
    if act == "prelu":
        return torch.where(y >= 0, y, slope * y)
    return y


def batch_stats_plain(xf, eps: float):
    """The batch statistics as the kernels form them, (mean, var, rstd) [C]
    in float32: each sample's mean m_n and sum of squared deviations q_n in
    float64, rounded once; then in float32, the samples in batch order:
    mean = (sum m_n) / N, var = (sum q_n + HW * sum (m_n - mean)^2) / M;
    rstd = 1 / sqrt(var + eps) in float64, rounded once. A sample's moments
    are exact to float32, and the batch combine keeps float32's dependence
    on the batch order, as the JAX package's float32 means have."""
    N, HW = xf.shape[0], xf.shape[2] * xf.shape[3]
    x64 = xf.double()
    m64 = x64.mean(dim=(2, 3))                                       # [N, C]
    m = m64.float()
    q = (x64 - m64[:, :, None, None]).square().sum(dim=(2, 3)).float()
    if parallel.distributed():  # every rank's samples, in rank order
        m, q = (parallel.gather_stacked(t).flatten(0, 1) for t in (m, q))
        N = m.shape[0]
    s, qs = m[0], q[0]
    for n in range(1, N):
        s, qs = s + m[n], qs + q[n]
    # divisors as tensors: a division by a Python number may run as a product with its
    # reciprocal, which rounds otherwise than the kernels' division
    mean = s / torch.full_like(s, N)
    t = m[0] - mean
    between = t * t
    for n in range(1, N):
        t = m[n] - mean
        between = between + t * t
    var = (qs + float(HW) * between) / torch.full_like(s, N * HW)
    return mean, var, torch.rsqrt(var.double() + eps).float()


def jax_batch_stats(xf, eps: float):
    """The JAX package's batch statistics op for op: float32 means, the
    variance of x - mean, rstd in float32. Across ranks the sums are
    ``all_reduce``'s of each rank's (with their gradient), over the global
    count."""
    if parallel.distributed():
        count = xf.numel() // xf.shape[1] * parallel.rank_world()[1]
        mean = parallel.all_reduce_sum(xf.sum(dim=(0, 2, 3))) / count
        var = parallel.all_reduce_sum((xf - mean[:, None, None]).square().sum(dim=(0, 2, 3)))
        var = var / count
        return mean, var, torch.rsqrt(var + eps)
    mean = xf.mean(dim=(0, 2, 3))
    var = (xf - mean[:, None, None]).square().mean(dim=(0, 2, 3))
    return mean, var, torch.rsqrt(var + eps)


def _batch_count(x) -> int:
    """The values a channel's statistics take: N * HW, over every rank's batch."""
    return x.numel() // x.shape[1] * parallel.rank_world()[1]


def batch_norm_act_plain(x, weight, bias, running_mean, running_var, *, training: bool,
                         update_stats: bool, momentum: float, eps: float, act: str = "none",
                         slope=None, residual=None):
    """The plain version: the JAX package's arithmetic op for op (its eval
    fold, then its batch normalisation with :func:`jax_batch_stats`), then
    the activation."""
    _check_act(act, slope, residual)
    if not training:
        a, b = (t.to(x.dtype) for t in _fold(weight, bias, running_mean, running_var, eps))
        return _activate(x * a[:, None, None] + b[:, None, None], act, slope, residual)
    xf = x.float()
    mean, var, rstd = jax_batch_stats(xf, eps)
    if update_stats:
        _update_running_stats(running_mean, running_var, mean, var, _batch_count(x), momentum)
    y = (xf - mean[:, None, None]) * rstd[:, None, None]
    y = y * weight[:, None, None] + bias[:, None, None]
    return _activate(y.to(x.dtype), act, slope, residual)


def batch_norm_act_reference(x, weight, bias, running_mean, running_var, *, training: bool,
                             update_stats: bool, momentum: float, eps: float,
                             act: str = "none", slope=None, residual=None):
    """The plain version with the kernels' rounding: the routes' comparison
    on the card, not a speed baseline (its Python loops over the batch are
    slow). Batch statistics from :func:`batch_stats_plain`, so that both
    routes normalise by the same bits: statistics rounded otherwise move y
    by an ulp, which flips a ReLU's mask wherever its input is that close to
    zero, and a random network's gradients then differ by their batch-order
    noise. Weight, bias and the slope enter broadcast from float64, so that
    their gradients are summed in float64 as the kernels sum them: a float32
    sum of a random network's cancelling terms can be off by 1e-2 of the
    gradient, more than its batch-order noise shows (a sample's partial sums
    move together when the batch turns). The eval fold is the plain
    version's."""
    if not training:
        return batch_norm_act_plain(x, weight, bias, running_mean, running_var,
                                    training=training, update_stats=update_stats,
                                    momentum=momentum, eps=eps, act=act, slope=slope,
                                    residual=residual)
    _check_act(act, slope, residual)
    xf = x.float()
    mean, var, rstd = batch_stats_plain(xf, eps)
    if update_stats:
        _update_running_stats(running_mean, running_var, mean, var, _batch_count(x), momentum)
    y = (xf - mean[:, None, None]) * rstd[:, None, None]
    weight, bias = (_from_double(t[:, None, None], y) for t in (weight, bias))
    slope = None if slope is None else _from_double(slope, y)
    return _activate((y * weight + bias).to(x.dtype), act, slope, residual)


def _from_double(p, like):
    """``p`` broadcast to ``like``'s shape through float64: the same values,
    and a gradient summed in float64."""
    return p.double().expand(like.shape).float()


@functools.lru_cache(maxsize=1024)
def plan(N: int, C: int, HW: int, training: bool, backward: bool, act: str) -> dict:
    """The design a call of x [N, C, HW] takes on the card and its launch
    count: the extension's ``batch_norm_plan`` (``csrc/launchers.h``'s rule,
    a wide cluster where the card fits one)."""
    return build.ops().batch_norm_plan(N, C, HW, training, backward, ACTS[act], -1)


def _gather_batch(partial):
    """Every rank's per-sample partials [C, N, slices, k], concatenated along
    the batch in rank order: [C, W * N, slices, k]."""
    stacked = parallel.gather_stacked(partial)                      # [W, C, N, slices, k]
    W, C, N = stacked.shape[:3]
    return stacked.transpose(0, 1).reshape(C, W * N, *stacked.shape[3:])


# launches of the cross-rank route: the forward's partial, final and apply; the backward's
# partial, final twice (every rank's partials for dx's coefficients, this rank's for its
# dweight, dbias and slope sums) and apply
RANKS_LAUNCHES = {"fwd": 3, "bwd": 4}


def ranks_forward(x, weight, bias, slope, residual, running_mean, running_var, momentum: float,
                  eps: float, act: str, gather=_gather_batch):
    """The cross-rank forward on CUDA tensors, three launches: this rank's
    per-sample partials (shifted by rank 0's first value of each channel,
    the shift one process takes on the whole batch), ``gather``'s of them
    (every rank's, in rank order), the final over those (the running buffers,
    where given, moved by the global count), the apply. Returns ``(y, mean,
    rstd)``. ``gather`` is a measurement's hook: ``chip_smoke.py`` times the
    route on one process with a gather of its own."""
    ops = build.ops()
    N, C = x.shape[:2]
    HW = x.numel() // (N * C)
    shift = parallel.from_rank0(x.reshape(N, C, HW)[0, :, 0].contiguous())
    partial = ops.batch_norm_stats_partial(x, shift)
    stats = ops.batch_norm_stats_final(gather(partial), shift, HW, running_mean, running_var,
                                       momentum, eps)
    mean, rstd = stats[0].contiguous(), stats[2].contiguous()
    y = ops.batch_norm_apply(x, mean, rstd, weight, bias, residual, slope, ACTS[act])
    build.count("batch_norm", n=RANKS_LAUNCHES["fwd"])
    return y, mean, rstd


def ranks_backward(g, x, out, mean, rstd, weight, bias, slope, act: str, has_residual: bool,
                   gather=_gather_batch):
    """The cross-rank backward on CUDA tensors, four launches: this rank's
    per-sample partials, the final over ``gather``'s of them (dx's
    coefficients, from every rank's), the final over this rank's own (its
    dweight, dbias and the slope's sums: DDP averages them), the apply.
    Returns ``(dx, dweight, dbias, dslope, dresidual)``."""
    ops = build.ops()
    HW = x.numel() // (x.shape[0] * x.shape[1])
    partial = ops.batch_norm_bwd_partial(g, x, out, mean, rstd, weight, bias, slope, ACTS[act])
    coef = ops.batch_norm_bwd_final(gather(partial), HW, False)[0]
    _, dw, db, sums = ops.batch_norm_bwd_final(partial, HW, slope is not None)
    dx, dslope, dres = ops.batch_norm_bwd_apply(g, x, out, mean, rstd, weight, bias, slope, coef,
                                                sums if slope is not None else None, ACTS[act],
                                                has_residual)
    build.count("batch_norm_bwd", n=RANKS_LAUNCHES["bwd"])
    return dx, dw, db, dslope, dres


class _BatchNormAct(torch.autograd.Function):
    """K13 on one process, or in train mode across the ranks of a process
    group (``ranks``): the two-pass stages with every rank's per-sample
    partials gathered between them."""

    @staticmethod
    def forward(ctx, x, weight, bias, slope, residual, running_mean, running_var, training,
                momentum, eps, act, save, ranks):
        ops = build.ops()
        N, C = x.shape[:2]
        HW = x.numel() // (N * C)
        mean = rstd = None
        if ranks:
            y, mean, rstd = ranks_forward(x, weight, bias, slope, residual, running_mean,
                                          running_var, momentum, eps, act)
        elif training:
            y, stats = ops.batch_norm_fwd(x, weight, bias, residual, slope, running_mean,
                                          running_var, ACTS[act], momentum, eps, -1)
            mean, rstd = stats[0], stats[2]
            build.count("batch_norm", n=plan(N, C, HW, training, False, act)["launches"])
        else:
            y = ops.batch_norm_apply(x, None, None, weight, bias, residual, slope, ACTS[act])
            build.count("batch_norm", n=plan(N, C, HW, training, False, act)["launches"])
        ctx.meta = (act, residual is not None, (N, C, HW, training), ranks)
        if save:  # nothing is kept when no input needs a gradient
            ctx.save_for_backward(x, y if act == "relu" else None, mean, rstd, weight, bias,
                                  slope)
        return y

    @staticmethod
    def backward(ctx, g):
        x, out, mean, rstd, weight, bias, slope = ctx.saved_tensors
        act, has_residual, (N, C, HW, training), ranks = ctx.meta
        g = g.contiguous()
        if ranks:
            dx, dw, db, dslope, dres = ranks_backward(g, x, out, mean, rstd, weight, bias, slope,
                                                      act, has_residual)
        else:
            dx, dw, db, dslope, dres = build.ops().batch_norm_bwd(
                g, x, out, mean, rstd, weight, bias, slope, ACTS[act], has_residual, -1)
            build.count("batch_norm_bwd", n=plan(N, C, HW, training, True, act)["launches"])
        return (dx, dw, db, None if slope is None else dslope.reshape(slope.shape),
                dres if has_residual else None, None, None, None, None, None, None, None, None)


BF16_LAUNCHES = 3  # the bfloat16 train route's launches each way (the two-pass design)


class _BatchNormActBf16(torch.autograd.Function):
    """K13's train forward and backward on bfloat16 x, three launches each."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, running_mean, running_var, momentum, eps, act,
                save):
        y, stats = build.ops().batch_norm_fwd_bf16(x, weight, bias, residual, running_mean,
                                                   running_var, ACTS[act], momentum, eps)
        build.count("batch_norm.bf16", n=BF16_LAUNCHES)
        ctx.meta = (act, residual is not None)
        if save:  # nothing is kept when no input needs a gradient
            ctx.save_for_backward(x, y if act == "relu" else None, stats[0], stats[2], weight,
                                  bias)
        return y

    @staticmethod
    def backward(ctx, g):
        x, out, mean, rstd, weight, bias = ctx.saved_tensors
        act, has_residual = ctx.meta
        dx, dw, db, dres = build.ops().batch_norm_bwd_bf16(g.contiguous(), x, out, mean, rstd,
                                                           weight, bias, ACTS[act], has_residual)
        build.count("batch_norm_bwd.bf16", n=BF16_LAUNCHES)
        return dx, dw, db, dres if has_residual else None, None, None, None, None, None, None



def batch_norm_act(x, weight, bias, running_mean, running_var, *, training: bool,
                   update_stats: bool, momentum: float, eps: float, act: str = "none",
                   slope=None, residual=None):
    """K13 on CUDA tensors; the plain version on CPU tensors.

    x [N, C, H, W] contiguous float32, or bfloat16 (with a bfloat16 residual,
    act "none" or "relu", on one process) (N * H * W >= 1, fewer than 2^31
    elements); weight, bias, running_mean, running_var [C]; act "none",
    "relu" (with an optional residual of x's shape added first) or "prelu"
    (with ``slope``, PReLU's one-element weight). ``training``: batch
    statistics, the running buffers moved in place when ``update_stats``;
    else the eval fold. Launches: :func:`plan`'s (train: fused 1, two-pass 3;
    eval 1; backward: fused 1, with PReLU 2, two-pass 3); in train mode
    across the ranks of a group, ``RANKS_LAUNCHES`` (3 and 4)."""
    _check_act(act, slope, residual)
    if x.device.type == "cpu":
        return batch_norm_act_plain(x, weight, bias, running_mean, running_var,
                                    training=training, update_stats=update_stats,
                                    momentum=momentum, eps=eps, act=act, slope=slope,
                                    residual=residual)
    if x.dtype == BF16:
        build.require_cuda("batch_norm_act", x, residual, accepted=((BF16, None), (BF16, BF16)))
        build.require_cuda("batch_norm_act", weight, bias, running_mean, running_var)
        if act == "prelu":
            raise ValueError("batch_norm_act: bfloat16 takes act 'none' or 'relu' (no bfloat16 "
                             "PReLU kernel yet)")
        if training and parallel.distributed():
            raise ValueError("batch_norm_act: bfloat16 training runs on one process (the "
                             "cross-rank route takes float32 only)")
    else:
        build.require_cuda("batch_norm_act", x, weight, bias, running_mean, running_var, slope,
                           residual)
    C = x.shape[1] if x.dim() == 4 else -1
    if (x.dim() != 4 or x.numel() == 0 or x.numel() >= 2 ** 31
            or x.numel() // x.shape[1] >= 2 ** 24 or x.shape[0] > MAX_BATCH):
        raise ValueError(f"batch_norm_act: expected x [N, C, H, W] with 1 to 2^31 - 1 "
                         f"elements, below 2^24 a channel and N <= {MAX_BATCH}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("batch_norm_act: x must be contiguous NCHW (not channels-last or a "
                         "strided view)")
    if any(t.shape != (C,) for t in (weight, bias, running_mean, running_var)):
        raise ValueError(f"batch_norm_act: expected [{C}] weight, bias and running statistics")
    if residual is not None and (residual.shape != x.shape or not residual.is_contiguous()):
        raise ValueError(f"batch_norm_act: the residual must be contiguous {tuple(x.shape)}")
    if slope is not None and slope.numel() != 1:
        raise ValueError("batch_norm_act: PReLU's slope must be one value (channel-shared)")
    if x.dtype == BF16:
        grad = torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                               for t in (x, weight, bias, residual))
        if training:
            rm, rv = (running_mean, running_var) if update_stats else (None, None)
            return _BatchNormActBf16.apply(x, weight, bias, residual, rm, rv, momentum, eps, act,
                                           grad)
        if grad:
            raise ValueError("batch_norm_act: bfloat16's eval fold is forward only (no backward "
                             "kernel)")
        a, b = (t.to(BF16) for t in _fold(weight, bias, running_mean, running_var, eps))
        y = build.ops().batch_norm_fold_bf16(x, a, b, residual, ACTS[act])
        build.count("batch_norm.bf16")
        return y
    if training:
        w_eff, b_eff = weight, bias
        rm, rv = (running_mean, running_var) if update_stats else (None, None)
    else:
        w_eff, b_eff = _fold(weight, bias, running_mean, running_var, eps)
        rm = rv = None
    save = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, w_eff, b_eff, slope, residual))
    return _BatchNormAct.apply(x, w_eff, b_eff, slope, residual, rm, rv, training, momentum,
                               eps, act, save, training and parallel.distributed())
