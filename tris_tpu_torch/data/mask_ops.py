"""COCO mask operations: RLE codec + polygon rasterization.

Replaces the reference's ``pycocotools._mask`` C dependency
(`reference/dataset/refer.py:40,279-292`,
`dataset/Dataset_referit.py:141-144`). Implements the COCO mask *format
specification* (column-major run-length encoding; 5x-supersampled boundary
rasterization for polygons) in vectorized NumPy, so masks are bit-identical
with pycocotools' output. Copy of the JAX package's module: decoding and
polygon fill take the native library (``tris_tpu_torch.native``) by default,
as the JAX package does where its library is built; ``backend="numpy"``
takes the numpy code here, their plain version (equal masks,
``tests/test_torch_native.py``). A native library that cannot be built
raises.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

RLE = Dict[str, object]  # {"size": [h, w], "counts": bytes | list[int]}
BACKENDS = ("native", "numpy")


def _native(backend: str):
    """The native binding for ``backend="native"``, None for ``"numpy"``."""
    if backend not in BACKENDS:
        raise ValueError(f"mask_ops: backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "numpy":
        return None
    from tris_tpu_torch import native

    return native


# ---------------------------------------------------------------------------
# counts <-> compressed string (LEB128-style with sign + continuation bits)
# ---------------------------------------------------------------------------

def counts_to_string(counts: Sequence[int]) -> bytes:
    """Compress run lengths to the COCO ascii format (delta-coded from idx>=2)."""
    out = bytearray()
    prev2 = 0
    for i, c in enumerate(counts):
        x = int(c)
        if i >= 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            chunk = x & 0x1F
            x >>= 5
            more = not (x == 0 and not (chunk & 0x10) or x == -1 and (chunk & 0x10))
            if more:
                chunk |= 0x20
            out.append(chunk + 48)
    return bytes(out)


def string_to_counts(s: Union[bytes, str]) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        shift = 0
        while True:
            c = s[i] - 48
            i += 1
            x |= (c & 0x1F) << shift
            shift += 5
            if not (c & 0x20):
                if c & 0x10:  # sign-extend
                    x |= -1 << shift
                break
        if len(counts) >= 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, dtype=np.int64)


def _get_counts(rle: RLE) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        return string_to_counts(counts)
    return np.asarray(counts, dtype=np.int64)


# ---------------------------------------------------------------------------
# decode / encode / area / merge
# ---------------------------------------------------------------------------

def rle_decode(rle: Union[RLE, Sequence[RLE]], backend: str = "native") -> np.ndarray:
    """Decode RLE(s) to a binary mask [h, w] or [h, w, n] (column-major runs),
    matching ``pycocotools.mask.decode``."""
    if isinstance(rle, (list, tuple)):
        masks = [rle_decode(r, backend) for r in rle]
        return np.stack(masks, axis=-1)
    h, w = rle["size"]
    counts = _get_counts(rle)
    nat = _native(backend)
    if nat is not None:
        return nat.rle_decode(counts, h, w)
    flat = np.zeros(h * w, dtype=np.uint8)
    ends = np.cumsum(counts)
    starts = ends - counts
    for i in range(1, len(counts), 2):
        flat[starts[i] : ends[i]] = 1
    return flat.reshape((w, h)).T  # column-major


def rle_encode(mask: np.ndarray) -> RLE:
    """Encode a binary [h, w] mask, matching ``pycocotools.mask.encode``."""
    h, w = mask.shape
    flat = np.asfortranarray(mask.astype(bool)).T.reshape(-1)
    # run-length: positions where value changes
    changes = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    boundaries = np.concatenate([[0], changes, [flat.size]])
    counts = np.diff(boundaries)
    if flat.size and flat[0]:  # first run must be zeros
        counts = np.concatenate([[0], counts])
    return {"size": [h, w], "counts": counts_to_string(counts)}


def rle_area(rle: Union[RLE, Sequence[RLE]]) -> Union[int, List[int]]:
    if isinstance(rle, (list, tuple)):
        return [rle_area(r) for r in rle]
    counts = _get_counts(rle)
    return int(counts[1::2].sum())


def rle_merge(rles: Sequence[RLE]) -> np.ndarray:
    """Union of RLEs as a binary mask (reference uses decode().sum(2))."""
    return (rle_decode(list(rles)).sum(axis=-1) > 0).astype(np.uint8)


# ---------------------------------------------------------------------------
# polygon -> RLE (exact COCO 5x-supersampled boundary algorithm)
# ---------------------------------------------------------------------------

_SCALE = 5.0


def polygon_to_rle(poly: Sequence[float], h: int, w: int, backend: str = "native") -> RLE:
    """Rasterize one polygon [x0, y0, x1, y1, ...] to RLE with COCO semantics."""
    nat = _native(backend)
    if nat is not None:
        counts = nat.polygon_to_counts(np.asarray(poly, np.float64), h, w)
        return {"size": [h, w], "counts": counts_to_string(counts)}
    xy = np.asarray(poly, dtype=np.float64)
    k = len(xy) // 2
    # COCO uses (int)(scale*v+.5): truncation toward zero for positive coords
    x = (_SCALE * xy[0::2] + 0.5).astype(np.int64)
    y = (_SCALE * xy[1::2] + 0.5).astype(np.int64)
    x = np.append(x, x[0])
    y = np.append(y, y[0])

    # densely walk every edge at the supersampled resolution
    us: List[np.ndarray] = []
    vs: List[np.ndarray] = []
    for j in range(k):
        xs, xe, ys, ye = x[j], x[j + 1], y[j], y[j + 1]
        dx = abs(xe - xs)
        dy = abs(ye - ys)
        m = int(max(dx, dy)) + 1
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe, ys, ye = xe, xs, ye, ys
        t = np.arange(m, dtype=np.int64)
        if dx >= dy:
            s = (ye - ys) / dx if dx > 0 else 0.0
            u = xs + t
            v = np.trunc(ys + s * t + 0.5).astype(np.int64)
        else:
            s = (xe - xs) / dy if dy > 0 else 0.0
            v = ys + t
            u = np.trunc(xs + s * t + 0.5).astype(np.int64)
        if flip:
            u = u[::-1]
            v = v[::-1]
        us.append(u)
        vs.append(v)
    u = np.concatenate(us)
    v = np.concatenate(vs)

    # keep vertical crossings, downsample to pixel grid
    du = np.flatnonzero(u[1:] != u[:-1]) + 1
    if len(du) == 0:
        return {"size": [h, w], "counts": counts_to_string([h * w])}
    uj, ujm1 = u[du], u[du - 1]
    vj, vjm1 = v[du], v[du - 1]
    xd = np.where(uj < ujm1, uj, uj - 1).astype(np.float64)
    xd = (xd + 0.5) / _SCALE - 0.5
    keep = (np.floor(xd) == xd) & (xd >= 0) & (xd <= w - 1)
    xd = xd[keep]
    yd = np.where(vj < vjm1, vj, vjm1)[keep].astype(np.float64)
    yd = (yd + 0.5) / _SCALE - 0.5
    yd = np.clip(yd, 0, h)
    yd = np.ceil(yd)

    # convert boundary points to column-major positions, then to runs
    pos = (xd.astype(np.int64) * h + yd.astype(np.int64))
    pos = np.sort(pos)
    pos = np.append(pos, h * w)
    diffs = np.empty_like(pos)
    diffs[0] = pos[0]
    diffs[1:] = pos[1:] - pos[:-1]

    # collapse zero diffs by merging with the following run (parity fill)
    counts: List[int] = []
    j = 0
    n = len(diffs)
    while j < n:
        d = int(diffs[j])
        if d > 0 or j == 0:
            counts.append(d)
            j += 1
        else:
            j += 1
            if j < n:
                counts[-1] += int(diffs[j])
                j += 1
    return {"size": [h, w], "counts": counts_to_string(counts)}


def fr_poly_objects(polys: Sequence[Sequence[float]], h: int, w: int) -> List[RLE]:
    """``pycocotools.mask.frPyObjects`` for a list of polygons."""
    return [polygon_to_rle(p, h, w) for p in polys]


def segmentation_to_mask(segmentation, h: int, w: int) -> np.ndarray:
    """COCO annotation 'segmentation' (polygons or RLE) -> uint8 mask [h, w].

    Matches REFER.getMask (refer.py:279-292): multiple polygons are decoded
    separately and summed.
    """
    if isinstance(segmentation, list) and segmentation and isinstance(segmentation[0], list):
        rles = fr_poly_objects(segmentation, h, w)
        m = rle_decode(rles).sum(axis=-1)
        return m.astype(np.uint8)
    if isinstance(segmentation, dict):
        if isinstance(segmentation["counts"], list):
            segmentation = {"size": segmentation["size"], "counts": np.asarray(segmentation["counts"])}
            h_, w_ = segmentation["size"]
            counts = np.asarray(segmentation["counts"], dtype=np.int64)
            flat = np.zeros(h_ * w_, dtype=np.uint8)
            ends = np.cumsum(counts)
            starts = ends - counts
            for i in range(1, len(counts), 2):
                flat[starts[i] : ends[i]] = 1
            return flat.reshape((w_, h_)).T
        return rle_decode(segmentation)
    raise ValueError(f"unsupported segmentation: {type(segmentation)}")
