"""Data parallelism over a ``torch.distributed`` process group
(``parallel/mesh.py``, the counterpart of ``tris_tpu/parallel/mesh.py``)."""

from tris_tpu_torch.parallel.mesh import (  # noqa: F401
    all_gather,
    all_reduce_sum,
    distributed,
    from_rank0,
    gather_stacked,
    init_process_group,
    mean_over_ranks,
    rank_world,
    wrap_ddp,
)
