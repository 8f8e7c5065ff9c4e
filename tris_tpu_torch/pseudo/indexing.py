"""Pixel-pair paths and the random walk of IRNet's instance pseudo-masks.

Port of ``tris_tpu/pseudo/indexing.py`` in its reference formulation
(float32 matrices, every one of ``exp_times`` squarings, one final
product): the JAX package's TPU options (bf16 storage, fewer squarings
with more thin steps, the band-domain prefix) are not ported. Its products
sum in float32; the port's in float64 (``kernels/walk.py``).

- :class:`PathIndex`: host precomputation of the discrete line of every
  direction within ``radius`` (a copy of the JAX package's).
- :func:`transition_matrix`: the padded edge map -> K7's path-max
  affinities -> K10's column-normalised [HW, HW] transition; on CPU tensors
  of grids too small for the band assembly, the scatter build
  (:func:`edge_to_affinity`, :func:`affinity_to_dense`).
- :func:`propagate_to_edge`: ``exp_times`` squarings of the transition and
  one product with the masked score maps (K10's banded products,
  :func:`square` and :func:`thin_step`).
- :func:`propagate_to_edge_bucketed`: the same on (H, W) padded to multiples
  of ``bucket`` with edge 1, which no walk enters or leaves.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tris_tpu_torch import kernels as K


class PathIndex:
    """Host-side precomputation of within-radius pixel-pair paths."""

    def __init__(self, radius: int, size: Tuple[int, int]):
        self.radius = radius
        self.radius_floor = int(np.ceil(radius) - 1)
        self.size = tuple(size)

        self.paths_by_length, self.search_dst = self._search_paths(radius)
        self.path_indices, self.src_indices, self.dst_indices = self._path_indices(self.size)

    @staticmethod
    def _search_paths(max_radius: int):
        """Enumerate displacement directions and the pixel chain of each
        direction's discrete line, grouped by chain length."""
        search_dirs = [(0, x) for x in range(1, max_radius)]
        for y in range(1, max_radius):
            for x in range(-max_radius + 1, max_radius):
                if x * x + y * y < max_radius ** 2:
                    search_dirs.append((y, x))

        by_length: dict = {}
        for dy, dx in search_dirs:
            length_sq = dy * dy + dx * dx
            ys = sorted((0, dy))
            xs = sorted((0, dx))
            coords = []
            for y in range(ys[0], ys[1] + 1):
                for x in range(xs[0], xs[1] + 1):
                    # squared distance of (y, x) from the line to (dy, dx)
                    if (dy * x - dx * y) ** 2 / length_sq < 1:
                        coords.append([y, x])
            coords.sort(key=lambda c: -abs(c[0]) - abs(c[1]))
            by_length.setdefault(len(coords), []).append(coords)

        paths_by_length = [np.asarray(v) for _, v in sorted(by_length.items())]
        # grouped by ascending path length; the destination is each path's
        # first coordinate (its farthest point)
        dst = np.concatenate([p[:, 0] for p in paths_by_length], axis=0)
        return paths_by_length, dst

    def _path_indices(self, size: Tuple[int, int]):
        h, w = size
        rf = self.radius_floor
        full = np.arange(h * w, dtype=np.int64).reshape(h, w)
        ch = h - rf
        cw = w - 2 * rf
        if ch <= 0 or cw <= 0:
            raise ValueError(
                f"PathIndex size {size} too small for radius {self.radius}: "
                f"needs height > {rf} and width > {2 * rf} "
                f"(IRNet: crop_size/4 must exceed 2*(radius-1))"
            )

        path_indices = []
        for paths in self.paths_by_length:
            per_len = []
            for path in paths:
                rows = []
                for dy, dx in path:
                    window = full[dy : dy + ch, rf + dx : rf + dx + cw].reshape(-1)
                    rows.append(window)
                per_len.append(rows)
            path_indices.append(np.asarray(per_len))  # [n_paths, path_len, n_pairs]

        src = full[:ch, rf : rf + cw].reshape(-1)
        dst = np.concatenate([p[:, 0] for p in path_indices], axis=0)
        return path_indices, src, dst


@functools.lru_cache(maxsize=8)
def _padded_path_index(radius: int, size: Tuple[int, int]) -> PathIndex:
    return PathIndex(radius, size)


def edge_to_affinity(edge_flat: torch.Tensor, path_indices: Sequence[np.ndarray]) -> torch.Tensor:
    """edge_flat [B, HW] -> affinities [B, n_pairs_total], ``1 - max(edge
    over the path connecting the pair)``, by gathers."""
    affs: List[torch.Tensor] = []
    for ind in path_indices:
        gathered = edge_flat[:, torch.as_tensor(ind, device=edge_flat.device)]
        affs.append(1.0 - gathered.amax(2))                  # [B, n_paths, n_pairs]
    return torch.cat([a.reshape(a.shape[0], -1) for a in affs], 1)


def affinity_to_dense(aff: torch.Tensor, src: np.ndarray, dst: np.ndarray, n: int) -> torch.Tensor:
    """Symmetric dense [n, n] affinity with unit diagonal from one image's
    pair values (pairs: ``src`` tiled per direction against ``dst``)."""
    dev = aff.device
    ind_from = torch.as_tensor(np.tile(src, dst.shape[0]), device=dev)
    ind_to = torch.as_tensor(dst.reshape(-1), device=dev)
    flat = aff.reshape(-1)
    dense = aff.new_zeros(n, n)
    dense.index_put_((ind_from, ind_to), flat, accumulate=True)
    dense.index_put_((ind_to, ind_from), flat, accumulate=True)
    diag = torch.arange(n, device=dev)
    dense[diag, diag] += 1.0
    return dense


@functools.lru_cache(maxsize=16)
def transition_band(radius: int, W: int) -> int:
    """How far off its diagonal the transition of a grid ``W`` wide has
    nonzeros: the largest flat offset ``dy * W + dx`` of a direction."""
    return max(int(dy) * W + int(dx) for dy, dx in PathIndex._search_paths(radius)[1])


def transition_matrix(edge: torch.Tensor, radius: int = 5, beta: float = 10.0) -> torch.Tensor:
    """edge [H, W] -> the column-normalised transition ``A ** beta / colsum``
    [HW, HW], zero more than :func:`transition_band` off its diagonal: the
    edge map padded with 1 (right and left by ``radius``, below by
    ``radius``), K7 at the padded size, then K10 on the cropped grid."""
    H, W = edge.shape
    ver, hor = H + radius, W + 2 * radius
    pi = _padded_path_index(radius, (ver, hor))
    edge_padded = F.pad(edge, (radius, radius, 0, radius), value=1.0)
    if 2 * transition_band(radius, W) + 1 <= H * W + 1:
        aff_grids = K.path_max_affinity(edge_padded, pi.paths_by_length, pi.radius_floor)
        return K.walk_transition(aff_grids, np.asarray(pi.search_dst, np.int64), H, W,
                                 radius - pi.radius_floor, beta)
    if edge.device.type != "cpu":
        raise ValueError(f"transition_matrix: a {H}x{W} grid is too small for K10's band "
                         f"build (an offset spans several rows); the scatter build takes CPU "
                         f"tensors only")
    # tiny grids on the host: the scatter build at the padded size, cropped
    aff = edge_to_affinity(edge_padded.reshape(1, -1), pi.path_indices)[0]
    dense = affinity_to_dense(aff, pi.src_indices, pi.dst_indices, ver * hor)
    dense = dense.reshape(ver, hor, ver, hor)[:-radius, radius:-radius, :-radius, radius:-radius]
    scaled = dense.reshape(H * W, H * W).pow(beta)
    return scaled / scaled.sum(0, keepdim=True)


def square(trans: torch.Tensor, times: int, band=None):
    """``trans ** (2 ** times)`` by ``times`` squarings (K10's products),
    with ``trans`` zero more than ``band`` off its diagonal (None: dense).
    Returns the power and its band (each squaring doubles it)."""
    n = trans.shape[0]
    band = n if band is None else min(int(band), n)
    for _ in range(times):
        trans = K.walk_matmul(trans, trans, band, band)
        band = min(2 * band, n)
    return trans, band


def thin_step(x: torch.Tensor, edge: torch.Tensor, trans: torch.Tensor, band=None):
    """The score maps x [K, H, W], masked by ``1 - edge``, through ``trans``
    (zero more than ``band`` off its diagonal; None: dense)."""
    n_maps, H, W = x.shape
    x_masked = (x * (1.0 - edge)[None]).reshape(n_maps, H * W)
    return K.walk_matmul(x_masked, trans, None, band).reshape(n_maps, H, W)


def propagate_to_edge(x: torch.Tensor, edge: torch.Tensor, radius: int = 5, beta: float = 10.0,
                      exp_times: int = 8) -> torch.Tensor:
    """Random-walk propagation of score maps x [K, H, W] along low-edge paths
    (edge [H, W]): ``x * (1 - edge)`` times the transition raised to
    ``2 ** exp_times``. Returns [K, H, W]."""
    trans, band = square(transition_matrix(edge, radius, beta), exp_times,
                         transition_band(radius, edge.shape[1]))
    return thin_step(x, edge, trans, band)


def bucket_pad(x, edge, bucket: int = 32, max_instances: int = 16, device=None):
    """x [K, H, W] and edge [H, W] (numpy or tensors) padded to (H, W) rounded
    up to ``bucket`` and K up to ``max_instances``: maps with 0, the edge
    with 1. Tensors on ``device``: by default a tensor ``x``'s own device,
    else the card."""
    n_maps, H, W = x.shape
    Hp = -(-H // bucket) * bucket
    Wp = -(-W // bucket) * bucket
    Kp = min(-(-n_maps // max_instances) * max_instances, max(n_maps, max_instances))
    if not isinstance(x, torch.Tensor):
        from tris_tpu_torch.device import resolve_device

        device = resolve_device(device or "cuda")
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    edge = torch.as_tensor(edge, dtype=torch.float32, device=x.device)
    return (F.pad(x, (0, Wp - W, 0, Hp - H, 0, Kp - n_maps)),
            F.pad(edge, (0, Wp - W, 0, Hp - H), value=1.0))


def propagate_to_edge_bucketed(x, edge, radius: int = 5, beta: float = 10.0, exp_times: int = 8,
                               bucket: int = 32, max_instances: int = 16,
                               device=None) -> torch.Tensor:
    """:func:`propagate_to_edge` on the bucketed grid (:func:`bucket_pad`),
    cropped back to [K, H, W]. The padding is exact: padded pixels have
    edge 1, so every path through them has affinity 0, and their maps are
    0. Returns a tensor on the device (dispatch is asynchronous)."""
    n_maps, H, W = x.shape
    x_p, edge_p = bucket_pad(x, edge, bucket, max_instances, device)
    return propagate_to_edge(x_p, edge_p, radius, beta, exp_times)[:n_maps, :H, :W]
