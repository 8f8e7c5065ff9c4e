"""Data parallelism over a ``torch.distributed`` process group.

Port of ``tris_tpu/parallel/mesh.py``'s semantics, which are the reference's
(DDP, ``DistributedSampler``, ``SyncBatchNorm``, ``all_reduce``):

- ``--batch_size`` is per process; the global batch is ``batch_size x
  world``, the ranks' batches concatenated in rank order (the ``Loader``
  shards the refs as ``DistributedSampler`` does);
- a step on W ranks equals one step on the global batch: each rank's loss is
  the mean over its own samples and DDP averages the gradients, so a loss
  that is a mean over samples gets the global mean's gradient;
- BatchNorm takes the global batch's statistics (K13 gathers its per-sample
  moments across the ranks, ``kernels/batch_norm.py``), and stage 1's head
  scores each rank's images against the texts of the global batch
  (:func:`all_gather`, which carries the gradient back).

Where the JAX package builds one mesh over its devices, here each process
owns one device: ``cuda:LOCAL_RANK`` with the ``nccl`` backend on the card,
the CPU with ``gloo``. The gathers are ``all_gather``'s, which both backends
take on CPU and CUDA tensors (``gloo`` also on CUDA tensors, which puts
several ranks on one card); a gradient comes back by ``all_reduce``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def rank_world() -> Tuple[int, int]:
    """(rank, world size) of an initialised ``torch.distributed`` group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def distributed() -> bool:
    """Whether this process is one of several in a group."""
    return rank_world()[1] > 1


def init_process_group(device: str = "cuda", init_method: str = "env://",
                       rank: Optional[int] = None, world_size: Optional[int] = None,
                       backend: Optional[str] = None) -> Tuple[int, int, torch.device]:
    """Join the process group and pick this process's device; returns
    ``(rank, world, device)``.

    By default from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); ``init_method``,
    ``rank`` and ``world_size`` give them explicitly (``tcp://localhost:<port>``).
    ``device="cuda"``: the ``nccl`` backend on ``cuda:LOCAL_RANK``;
    ``"cpu"``: ``gloo``. ``backend`` overrides the choice (``gloo`` with
    CUDA tensors puts several ranks on one card, which NCCL refuses)."""
    from tris_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    kw = {}
    if rank is not None:
        kw.update(rank=rank, world_size=world_size)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method, **kw)
    r, w = rank_world()
    return r, w, dev


def gather_stacked(t: torch.Tensor) -> torch.Tensor:
    """The ranks' ``t`` (one shape on every rank) stacked in rank order,
    [W, *t.shape]; no gradient."""
    out = t.new_empty((rank_world()[1],) + tuple(t.shape))
    dist.all_gather(list(out.unbind(0)), t.contiguous())
    return out


def from_rank0(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``t`` (one shape on every rank) on every rank; ``t`` itself
    when there is one process."""
    if not distributed():
        return t
    out = t.contiguous().clone()
    dist.broadcast(out, src=0)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        ctx.rows = t.shape[0]
        return gather_stacked(t.contiguous()).flatten(0, 1)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)  # every rank's loss reaches this rank's rows
        rank = rank_world()[0]
        return g[rank * ctx.rows:(rank + 1) * ctx.rows]


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """The ranks' ``t`` concatenated along dim 0 in rank order, with the
    gradient: each rank's rows get the sum over the ranks of the gradients
    their losses send them. ``t`` itself when there is one process."""
    if not distributed():
        return t
    return _AllGather.apply(t)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        out = t.contiguous().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The ranks' ``t`` summed, with the gradient (the sum of the ranks'
    gradients); ``t`` itself when there is one process."""
    if not distributed():
        return t
    return _AllReduceSum.apply(t)


def mean_over_ranks(metrics: dict) -> dict:
    """Each 0-d tensor of ``metrics`` averaged over the ranks (one
    ``all_reduce``), so every rank holds the global batch's; ``metrics``
    itself on one process."""
    if not distributed():
        return metrics
    keys = list(metrics)
    stacked = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(stacked)
    stacked /= rank_world()[1]
    return dict(zip(keys, stacked.unbind()))


def wrap_ddp(model: torch.nn.Module, device) -> torch.nn.Module:
    """``model`` under ``DistributedDataParallel`` in a group of several
    processes (gradients averaged over the ranks after each backward; some
    parameters, such as the attention pool stage 1 skips, get none), else
    ``model`` itself."""
    if not distributed():
        return model
    from torch.nn.parallel import DistributedDataParallel

    device = torch.device(device)
    return DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        find_unused_parameters=True)
