"""Hand-written Hopper kernels of the stage-1 eval and PRMS paths, each
beside its plain PyTorch version.

A wrapper launches its CUDA kernel when given CUDA tensors and uses the
plain version when given CPU tensors; there is no other switch. The
extension is built from ``csrc/`` at the first launch (``build.py``).
"""

from tris_tpu_torch.kernels.build import KERNELS, build_all, launches, reset_launches
from tris_tpu_torch.kernels.critic_input import critic_input, critic_input_plain
from tris_tpu_torch.kernels.cross_attn import cross_attn, cross_attn_plain
from tris_tpu_torch.kernels.eval_metrics import eval_metrics, eval_metrics_plain, eval_tables
from tris_tpu_torch.kernels.mha import mha_short, mha_short_plain
from tris_tpu_torch.kernels.normalize import normalize_u8_nchw, normalize_u8_nchw_plain
from tris_tpu_torch.kernels.response_head import response_head, response_head_plain

__all__ = [
    "KERNELS", "build_all", "launches", "reset_launches",
    "mha_short", "mha_short_plain", "cross_attn", "cross_attn_plain",
    "response_head", "response_head_plain", "eval_metrics", "eval_metrics_plain", "eval_tables",
    "critic_input", "critic_input_plain", "normalize_u8_nchw", "normalize_u8_nchw_plain",
]
