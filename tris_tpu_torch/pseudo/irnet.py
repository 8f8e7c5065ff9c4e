"""IRNet: the edge and displacement heads over a frozen ResNet-50, their
training losses, and the flip-averaged inference of the instance
pseudo-mask pass.

Port of ``tris_tpu/pseudo/irnet.py`` (``FrozenBatchNorm``, the torchvision
bottleneck and trunk with strides (2, 2, 2, 1), ``IRNet``,
``to_pair_displacement``, ``affinity_displacement_losses``,
``edge_displacement_infer``), NCHW throughout, convolutions on cuDNN. The
heads' upsamples go through K6 (``kernels.bilinear_resize``) and the pair
affinities through K7 (``kernels.path_max_affinity``). Parameter
names are the reference IRNet's (``resnet50.*``, ``fc_edge{1-6}``,
``fc_dp{1-7}``, ``mean_shift.running_mean``), so its ``res50_irn.pth``
loads strictly once the aliases of the same modules are dropped
(:func:`load_irnet_weights`).

The GroupNorms use PyTorch's eps, 1e-5, as the reference's
``nn.GroupNorm(groups, ch)`` does; the JAX package's flax GroupNorm uses
1e-6 (its default), a divergence this port does not copy.
"""

from __future__ import annotations

import re

import torch
import torch.nn as nn
import torch.nn.functional as F

from tris_tpu_torch import kernels as K
from tris_tpu_torch.kernels.irn_loss import loss_fields, pair_displacement

GN_EPS = 1e-5  # torch.nn.GroupNorm's default, the reference IRNet's


class FrozenBatchNorm(nn.Module):
    """BatchNorm on stored statistics in every mode, computed in float32 as
    the JAX package does: ``x * inv + (bias - mean * inv)``,
    ``inv = rsqrt(var + eps) * weight``."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return x * inv[:, None, None] + (self.bias - self.running_mean * inv)[:, None, None]


class Bottleneck(nn.Module):
    """The torchvision bottleneck (stride on conv2) with frozen BatchNorm."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * 4
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(nn.Conv2d(inplanes, out, 1, stride, bias=False),
                                            FrozenBatchNorm(out))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class ResNet50(nn.Module):
    """The torchvision ResNet-50 trunk with strides (2, 2, 2, 1); returns the
    post-maxpool features and the four stages' outputs."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        inplanes = 64
        for stage, (planes, blocks, stride) in enumerate(
                [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 1)], start=1):
            layers = []
            for i in range(blocks):
                layers.append(Bottleneck(inplanes, planes, stride if i == 0 else 1))
                inplanes = planes * 4
            setattr(self, f"layer{stage}", nn.Sequential(*layers))

    def forward(self, x):
        h = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        feats = [h]
        for stage in range(1, 5):
            h = getattr(self, f"layer{stage}")(h)
            feats.append(h)
        return feats


def _gn_block(cin: int, cout: int, groups: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 1, bias=False), nn.GroupNorm(groups, cout, GN_EPS))


class MeanShift(nn.Module):
    """The displacement field's running-mean buffer (subtracted at inference)."""

    def __init__(self, channels: int = 2):
        super().__init__()
        self.register_buffer("running_mean", torch.zeros(channels))


def _up(x: torch.Tensor, factor: int) -> torch.Tensor:
    """NCHW bilinear upsample by an integer factor (align_corners=False), K6."""
    return K.bilinear_resize(x, (x.shape[2] * factor, x.shape[3] * factor), False)


class IRNet(nn.Module):
    """Edge and displacement network over the frozen trunk.
    ``forward(x [B, 3, H, W])`` -> (edge logits [B, 1, h4, w4], displacement
    [B, 2, h4, w4]); :data:`UP_CALLS` K6 launches per forward. The trunk
    runs without autograd (the JAX package's ``stop_gradient`` of its
    features): only the heads train."""

    UP_CALLS = 6  # e3, e4, e5, d4, d5 and the dp6 tap

    def __init__(self):
        super().__init__()
        self.resnet50 = ResNet50()
        for i, (cin, groups) in enumerate([(64, 4), (256, 4), (512, 4), (1024, 4), (2048, 4)], 1):
            setattr(self, f"fc_edge{i}", _gn_block(cin, 32, groups))
        self.fc_edge6 = nn.Conv2d(160, 1, 1, bias=True)
        for i, (cin, cout) in enumerate([(64, 64), (256, 128), (512, 256), (1024, 256),
                                         (2048, 256), (768, 256)], 1):
            setattr(self, f"fc_dp{i}", _gn_block(cin, cout, 8 if i == 1 else 16))
        self.fc_dp7 = nn.Sequential(nn.Conv2d(448, 256, 1, bias=False),
                                    nn.GroupNorm(16, 256, GN_EPS), nn.ReLU(),
                                    nn.Conv2d(256, 2, 1, bias=False))
        self.mean_shift = MeanShift(2)

    def forward(self, x: torch.Tensor, apply_mean_shift: bool = False):
        with torch.no_grad():
            x1, x2, x3, x4, x5 = self.resnet50(x)

        def tap(block, x, up=1, crop_to=None):
            y = block(x)
            y = F.relu(_up(y, up) if up > 1 else y)
            return y if crop_to is None else y[:, :, :crop_to[0], :crop_to[1]]

        hw2, hw3 = x2.shape[2:], x3.shape[2:]
        e = torch.cat([tap(self.fc_edge1, x1), tap(self.fc_edge2, x2),
                       tap(self.fc_edge3, x3, 2, hw2), tap(self.fc_edge4, x4, 4, hw2),
                       tap(self.fc_edge5, x5, 4, hw2)], 1)
        edge_out = self.fc_edge6(e)
        d3 = torch.cat([tap(self.fc_dp3, x3), tap(self.fc_dp4, x4, 2, hw3),
                        tap(self.fc_dp5, x5, 2, hw3)], 1)
        d = torch.cat([tap(self.fc_dp1, x1), tap(self.fc_dp2, x2), tap(self.fc_dp6, d3, 2, hw2)], 1)
        dp_out = self.fc_dp7(d)
        if apply_mean_shift:
            dp_out = dp_out - self.mean_shift.running_mean[None, :, None, None]
        return edge_out, dp_out


def to_pair_displacement(disp: torch.Tensor, path_index) -> torch.Tensor:
    """disp [B, 2, H, W] -> the pairs' displacement difference source minus
    destination, [B, 2, n_dirs, n_pairs] (resnet50_irn.py:183-199)."""
    pair = pair_displacement(disp, path_index.search_dst, path_index.radius_floor)
    return pair.flatten(3)


def affinity_displacement_losses(edge_out: torch.Tensor, dp_out: torch.Tensor, path_index):
    """The per-pair loss fields (resnet50_irn.py:204-222): edge logits
    [B, 1, H, W] and displacement [B, 2, H, W] -> (pos_aff_loss and
    neg_aff_loss [B, n_dirs * n_pairs], dp_fg_loss and dp_bg_loss
    [B, 2, n_dirs, n_pairs]); the affinity through K7. The training step
    on the device-label feed reads K8's sums instead
    (``train_irn.irn_loss``), which never materialise these fields."""
    B, rf = edge_out.shape[0], path_index.radius_floor
    aff = K.path_max_affinity(torch.sigmoid(edge_out[:, 0]), path_index.paths_by_length, rf)
    pos, neg, dp_fg, dp_bg = loss_fields(aff.reshape(B, -1), dp_out, path_index.search_dst, rf)
    return pos, neg, dp_fg.flatten(3), dp_bg.flatten(3)


@torch.no_grad()
def edge_displacement_infer(model: IRNet, image: torch.Tensor, stride: int = 4):
    """The inference head (resnet50_irn.py:225-243 of the reference): the
    batch [image, its left-right flip], the edge logits averaged (the
    second flipped back) and squashed, the displacement of the unflipped
    pass with the mean shift applied.

    image [H, W, 3] float32 (normalised) on the model's device -> (edge
    [h4, w4], disp [2, h4, w4]), h4 = ceil(H / stride)."""
    H, W = image.shape[:2]
    fh, fw = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = image.permute(2, 0, 1)
    edge_out, dp_out = model(torch.stack([x, x.flip(-1)]), apply_mean_shift=True)
    edge_out = edge_out[:, 0, :fh, :fw]
    edge = torch.sigmoid(edge_out[0] / 2 + edge_out[1].flip(-1) / 2)
    return edge, dp_out[0, :, :fh, :fw]


# the reference IRNet's aliases of modules it also holds under resnet50.* and
# fc_* (resnet50_irn.py: stage1-5, edge_layers, dp_layers, backbone), and the
# mean shift inside fc_dp7's Sequential
_ALIASES = re.compile(r"(stage[1-5]|edge_layers|dp_layers|backbone)\.|fc_dp7\.4\.running_mean$")


def irnet_state_dict_from_reference(state_dict: dict) -> dict:
    """A reference ``res50_irn.pth`` state_dict -> this IRNet's: the alias
    keys dropped (as ``tris_tpu/ckpt/convert_tris.py::convert_irnet_state_dict``
    skips them), everything else as it is."""
    return {k: v for k, v in state_dict.items() if not _ALIASES.match(k)}


def load_irnet_weights(model: IRNet, path: str) -> IRNet:
    """Load a torch IRNet checkpoint (the reference's ``res50_irn.pth``, or
    this package's ``torch.save`` of a state_dict) strictly."""
    if not path.endswith((".pth", ".pt")):
        raise SystemExit(
            f"IRNet weights {path}: this package reads torch checkpoints (.pth/.pt); convert "
            "JAX variables with tris_tpu_torch.ckpt.from_jax.irnet_state_dict_from_flax first")
    from tris_tpu_torch.ckpt.convert import load_torch_checkpoint

    model.load_state_dict(irnet_state_dict_from_reference(load_torch_checkpoint(path)),
                          strict=True)
    return model


def build_irnet(weights: str | None = None, device="cuda", seed: int = 0) -> IRNet:
    """An IRNet in eval mode on ``device`` (``"cuda"`` unless the caller asks
    for the CPU), loaded from ``weights`` when given, else seeded random."""
    from tris_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = IRNet()
    if weights:
        load_irnet_weights(model, weights)
    return model.requires_grad_(False).to(dev).eval()
