"""JAX package variables -> this package's ``state_dict``.

``stage1_state_dict_from_flax`` turns the JAX ``TRISStage1`` variables (a
nested dict of numpy arrays: ``{"params": ..., "batch_stats": ...}``) into a
``state_dict`` that ``TRISStage1.load_state_dict(..., strict=True)`` takes;
``state_dict_from_flax`` does the same for any ported module (a CLIP, a
block, a layer). The inverse of ``tris_tpu/ckpt/convert*.py``:

- Dense kernel [in, out] -> weight [out, in], or [out, in, 1, 1] for the
  reference's 1x1 convs (``vis_project``, ``v_proj*.0``, ``v_output.0``);
- conv kernel HWIO -> OIHW;
- ``in_proj_kernel`` [C, 3C] -> ``in_proj_weight`` [3C, C];
- BN and InstanceNorm ``scale``/``bias``/``mean``/``var`` ->
  ``weight``/``bias``/``running_mean``/``running_var`` (plus a zero
  ``num_batches_tracked`` per BN);
- LayerNorm ``<name>/ln/scale`` -> ``<name>.weight``; PReLU ``alpha`` ->
  ``weight``.

``stage2_state_dict_from_flax`` adds stage 2's: ``<ConvBNRelu>/act`` ->
``<ConvBNRelu>.relu``, ``final_segN/conv1`` / ``conv2`` -> ``final_segN.0`` /
``.1``, and PixelAttention's Dense kernels to the reference's 1x1 convs
(``Wk``/``Wv`` Conv1d [out, in, 1], ``Wq``/``Wm``/``Ww``/``Wo`` Conv2d).

Each leaf keeps the dtype JAX holds it in: float32, or bfloat16 for the
leaves a ``dtype=bfloat16`` JAX module makes in its dtype (load them with
``tris_tpu_torch.ckpt.io.load_state``, which keeps the loaded dtypes).

``irnet_state_dict_from_flax`` adds IRNet's module names: ``trunk`` ->
``resnet50``, ``<head>_conv`` / ``<head>_gn`` -> ``<head>.0`` / ``<head>.1``,
``fc_dp7_conv1`` / ``fc_dp7_gn`` / ``fc_dp7_conv2`` -> ``fc_dp7.0`` / ``.1``
/ ``.3``, and the ``mean_shift`` statistic -> ``mean_shift.running_mean``.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

# flax module names -> torch module paths
_MODULE_RULES = [
    (re.compile(r"layer([1-4])_(\d+)"), r"layer\1.\2"),
    (re.compile(r"ds_conv"), "downsample.0"),
    (re.compile(r"ds_bn"), "downsample.1"),
    (re.compile(r"block_(\d+)"), r"transformer.resblocks.\1"),
    (re.compile(r"mlp_(c_fc|c_proj)"), r"mlp.\1"),
    (re.compile(r"(v_proj[123]|v_output|t_proj[123]|t_output)_fc"), r"\1.0"),
    (re.compile(r"(v_proj[123]|v_output)_in"), r"\1.1"),
]
_CONV1X1 = re.compile(r"(^|\.)(vis_project|v_proj[123]\.0|v_output\.0)$")
_LEAVES = {"scale": "weight", "mean": "running_mean", "var": "running_var",
           "embedding": "weight", "in_proj_kernel": "in_proj_weight", "alpha": "weight"}


def _flatten(tree: dict, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_module(path: Tuple[str, ...]) -> str:
    out = []
    for p in path:
        if p == "ln":                      # LayerNormFp32 wraps an inner "ln"
            continue
        for pat, rep in _MODULE_RULES:
            if pat.fullmatch(p):
                p = pat.sub(rep, p)
                break
        out.append(p)
    return ".".join(out)


def _key(mod: str, leaf: str) -> str:
    return f"{mod}.{leaf}" if mod else leaf


def state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """JAX variables of a ported module -> that module's state_dict here."""
    sd: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, val in _flatten(variables.get(coll, {})):
            bf16 = np.asarray(val).dtype.name == "bfloat16"   # ml_dtypes' bfloat16
            arr = np.asarray(val, np.float32)
            mod, leaf = _torch_module(path[:-1]), path[-1]
            if leaf == "kernel":
                if arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)
                else:
                    arr = arr.T
                    if _CONV1X1.search(mod):
                        arr = arr[:, :, None, None]
                leaf = "weight"
            elif leaf == "in_proj_kernel":
                arr = arr.T
            if coll == "batch_stats" and leaf == "mean":
                sd[_key(mod, "num_batches_tracked")] = torch.tensor(0, dtype=torch.long)
            # copy: C order, and 0-d leaves stay 0-d
            t = torch.from_numpy(arr.copy())
            sd[_key(mod, _LEAVES.get(leaf, leaf))] = t.to(torch.bfloat16) if bf16 else t
    return sd


def stage1_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """JAX ``TRISStage1`` variables -> this package's ``TRISStage1`` state_dict."""
    return state_dict_from_flax(variables)


_PIXEL_ATTN_CONV = re.compile(r"attention[234]\.(W[kv]|W[qmwo])\.weight")


def _conv_bn_relu(tree: dict) -> dict:
    return {("relu" if k == "act" else k): v for k, v in tree.items()}


def _stage2_tree(tree: dict) -> dict:
    """A JAX ``TRISStage2`` collection with stage 2's module names renamed."""
    out = {}
    for k, v in tree.items():
        if k.startswith("final_seg"):
            v = {{"conv1": "0", "conv2": "1"}[sub]: (_conv_bn_relu(leaf) if sub == "conv1"
                                                     else leaf) for sub, leaf in v.items()}
        elif k.startswith(("reduced_c", "output")):
            v = _conv_bn_relu(v)
        out[k] = v
    return out


def stage2_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """JAX ``TRISStage2`` variables -> this package's ``TRISStage2`` state_dict."""
    sd = state_dict_from_flax({coll: _stage2_tree(dict(variables[coll]))
                               for coll in ("params", "batch_stats") if coll in variables})
    for k, t in sd.items():
        m = _PIXEL_ATTN_CONV.fullmatch(k)
        if m:
            sd[k] = t[:, :, None] if m.group(1) in ("Wk", "Wv") else t[:, :, None, None]
    return sd


def stage2_grads_from_flax(grads) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree of ``TRISStage2`` params -> ``{name: tensor}``
    under this package's parameter names and layouts."""
    return stage2_state_dict_from_flax({"params": grads})


_IRNET_RULES = [
    (re.compile(r"trunk"), "resnet50"),
    (re.compile(r"(fc_edge[1-5]|fc_dp[1-6])_conv"), r"\1.0"),
    (re.compile(r"(fc_edge[1-5]|fc_dp[1-6])_gn"), r"\1.1"),
    (re.compile(r"fc_dp7_conv1"), "fc_dp7.0"),
    (re.compile(r"fc_dp7_gn"), "fc_dp7.1"),
    (re.compile(r"fc_dp7_conv2"), "fc_dp7.3"),
]


def _irnet_module(name: str) -> str:
    for pat, rep in _IRNET_RULES:
        if pat.fullmatch(name):
            return pat.sub(rep, name)
    return name


def irnet_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """JAX ``IRNet`` variables -> this package's ``IRNet`` state_dict."""
    stats = dict(variables.get("batch_stats", {}))
    mean_shift = stats.pop("mean_shift")
    sd = state_dict_from_flax({
        "params": {_irnet_module(k): v for k, v in variables["params"].items()},
        "batch_stats": {_irnet_module(k): v for k, v in stats.items()},
    })
    sd["mean_shift.running_mean"] = torch.from_numpy(np.asarray(mean_shift, np.float32).copy())
    return sd


def grads_from_flax(grads) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree of a ported module's ``params`` -> ``{name:
    tensor}`` under the port's parameter names, moved into the port's
    layouts as :func:`state_dict_from_flax` moves the parameters, so a test
    compares ``p.grad`` by name."""
    return state_dict_from_flax({"params": grads})


def irnet_grads_from_flax(grads) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree of ``IRNet`` params -> ``{name: tensor}`` under
    this package's IRNet parameter names and layouts (the trunk's leaves
    included: the JAX package's are zeros behind its ``stop_gradient``)."""
    return state_dict_from_flax({"params": {_irnet_module(k): v for k, v in grads.items()}})
