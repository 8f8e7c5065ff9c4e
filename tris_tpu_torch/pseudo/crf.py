"""Dense CRF mean-field refinement of label maps, on the host.

Port of ``tris_tpu/pseudo/crf.py`` (the reference's ``pydensecrf`` call,
IRNet ``misc/imutils.py:169-183``): label-map unaries (``gt_prob=0.7``), a
Gaussian pairwise kernel (sxy=3, compat=3) and a bilateral pairwise kernel
(sxy=50, srgb=5, compat=10), 10 mean-field steps, filtered through the
permutohedral lattice (Adams et al. 2010) with densecrf's symmetric
normalisation.

Two lattices compute it: the native one (``tris_tpu_torch.native``, this
package's copy of ``native/tris_native.cpp``), the default, and the
vectorised numpy one here, its plain version, which a caller takes by
passing ``backend="numpy"``. They agree to float rounding
(``tests/test_torch_native.py``). Where the native library cannot be built
or loaded, the default raises: the JAX package warns once and falls back to
numpy, which is several times slower per core and would hide the fault as a
slow pass (``ROADMAP.md`` §3). ``threads`` is the native call's OpenMP team
(default 1: the ir-label pass runs one process per core). The CRF is host
code in both packages (the reference runs it in CPU worker processes), not a
device kernel.
"""

from __future__ import annotations

import numpy as np


def unary_from_labels(labels: np.ndarray, n_labels: int, gt_prob: float = 0.7) -> np.ndarray:
    """Negative-log unaries [n_labels, H*W] from a hard label map (pydensecrf
    ``unary_from_labels`` with zero_unsure=False)."""
    flat = labels.reshape(-1)
    p_other = (1.0 - gt_prob) / (n_labels - 1)
    u = np.full((n_labels, flat.size), -np.log(p_other), dtype=np.float32)
    u[flat, np.arange(flat.size)] = -np.log(gt_prob)
    return u


class _PermutohedralLattice:
    """Vectorised numpy permutohedral lattice (Adams et al. 2010): splat onto
    the enclosing simplex vertices, blur along the d+1 lattice axes, slice
    back (the construction of ``native/csrc/tris_native.cpp::Permutohedral``)."""

    def __init__(self, features: np.ndarray):
        f = np.ascontiguousarray(features, np.float32)  # [n, d]
        n, d = f.shape
        self.n, self.d = n, d

        inv_std_dev = np.sqrt(2.0 / 3.0) * (d + 1)
        scale = (inv_std_dev / np.sqrt((np.arange(d) + 2.0) * (np.arange(d) + 1.0))).astype(np.float32)
        cf = f * scale                                           # [n, d]

        # embed into the sum-zero hyperplane: elevated[j] = sum_{i>=j} cf[i] - j*cf[j-1]
        elevated = np.empty((n, d + 1), np.float32)
        tail = np.concatenate([np.cumsum(cf[:, ::-1], axis=1)[:, ::-1],
                               np.zeros((n, 1), np.float32)], axis=1)  # tail[:, j] = sum_{i>=j} cf[i]
        elevated[:, 0] = tail[:, 0]
        elevated[:, 1:] = tail[:, 1:] - np.arange(1, d + 1) * cf

        # nearest remainder-0 lattice point (round half away from zero, like C++)
        down = elevated / (d + 1)
        rd = np.trunc(down + np.copysign(0.5, down)).astype(np.int32)
        rem0 = rd * (d + 1)                                      # [n, d+1] int32
        s = rd.sum(axis=1)

        # rank differential: descending sort of (elevated - rem0), stable ties
        diff = (elevated - rem0).astype(np.float64)
        order = np.argsort(-diff, axis=1, kind="stable")
        rank = np.empty((n, d + 1), np.int32)
        np.put_along_axis(rank, order, np.broadcast_to(np.arange(d + 1, dtype=np.int32), (n, d + 1)), axis=1)
        rank = rank + s[:, None]
        low = rank < 0
        high = rank > d
        rank = rank + np.where(low, d + 1, 0) - np.where(high, d + 1, 0)
        rem0 = rem0 + np.where(low, d + 1, 0) - np.where(high, d + 1, 0)

        # barycentric coordinates
        delta = ((elevated - rem0) / (d + 1)).astype(np.float32)
        bary = np.zeros((n, d + 3), np.float32)
        rows = np.repeat(np.arange(n), d + 1)
        bidx = (d - rank).reshape(-1)
        np.add.at(bary, (rows, bidx), delta.reshape(-1))
        np.add.at(bary, (rows, bidx + 1), -delta.reshape(-1))
        bary = bary[:, : d + 2]
        bary[:, 0] += 1.0 + bary[:, d + 1]
        self.bary = bary[:, : d + 1]                             # [n, d+1]

        # simplex vertex keys: for vertex rm, coord i (i < d) is
        # rem0[i] + (rm - (d+1) if rank[i] >= d+1-rm else rm)
        rm = np.arange(d + 1, dtype=np.int32)
        keys = rem0[:, None, :d] + np.where(
            rank[:, None, :d] >= (d + 1 - rm)[None, :, None], rm[None, :, None] - (d + 1),
            rm[None, :, None],
        )                                                        # [n, d+1, d]
        flat_keys = keys.reshape(-1, d).astype(np.int64)
        # mixed-radix packing of key rows into one int64 (collision-free):
        # per-dim ranges from the data, with a d+1 margin so blur-neighbor
        # keys (key +- 1 or -+ d) still pack in range.
        self._mins = flat_keys.min(axis=0) - (d + 1)
        spans = flat_keys.max(axis=0) + (d + 1) - self._mins + 1
        if float(np.prod(spans.astype(np.float64))) >= 2.0 ** 62:
            raise OverflowError("lattice key range too large to pack")  # pragma: no cover
        self._strides = np.concatenate([np.cumprod(spans[::-1])[::-1][1:], [1]]).astype(np.int64)
        packed = self._pack(flat_keys)
        uniq, inv = np.unique(packed, return_inverse=True)
        self.offsets = inv.reshape(n, d + 1).astype(np.int64)    # [n, d+1]
        self.m = uniq.size
        self._uniq = uniq

        # one representative key row per unique lattice point (first occurrence)
        first = np.full(self.m, inv.size, np.int64)
        np.minimum.at(first, inv, np.arange(inv.size))
        ukeys = flat_keys[first]                                 # [m, d]

        n1 = np.empty((self.m, d + 1), np.int64)
        n2 = np.empty((self.m, d + 1), np.int64)
        for j in range(d + 1):
            k1 = ukeys + 1
            k2 = ukeys - 1
            if j < d:
                k1[:, j] = ukeys[:, j] - d
                k2[:, j] = ukeys[:, j] + d
            n1[:, j] = self._lookup(self._pack(k1))
            n2[:, j] = self._lookup(self._pack(k2))
        self.blur_n1, self.blur_n2 = n1, n2

    def _pack(self, keys: np.ndarray) -> np.ndarray:
        return (keys - self._mins) @ self._strides

    def _lookup(self, packed: np.ndarray) -> np.ndarray:
        pos = np.searchsorted(self._uniq, packed)
        pos = np.clip(pos, 0, self.m - 1)
        return np.where(self._uniq[pos] == packed, pos, -1)

    def compute(self, x: np.ndarray) -> np.ndarray:
        """Apply the (unnormalized) Gaussian kernel: x [n, vd] -> [n, vd]."""
        vd = x.shape[1]
        d = self.d
        values = np.zeros((self.m + 1, vd), np.float32)  # slot 0 = missing-neighbor pad
        contrib = (self.bary[:, :, None] * x[:, None, :]).reshape(-1, vd)
        np.add.at(values, self.offsets.reshape(-1) + 1, contrib)
        for j in range(d + 1):
            v1 = values[self.blur_n1[:, j] + 1]
            v2 = values[self.blur_n2[:, j] + 1]
            nxt = np.zeros_like(values)
            nxt[1:] = values[1:] + 0.5 * (v1 + v2)
            values = nxt
        alpha = 1.0 / (1.0 + 2.0 ** (-d))
        sliced = values[self.offsets + 1]                        # [n, d+1, vd]
        return alpha * np.einsum("nk,nkc->nc", self.bary, sliced)


class _NormalizedLatticeFilter:
    """densecrf-style symmetric-normalized lattice filter over [L, H, W] maps."""

    def __init__(self, features: np.ndarray, shape):
        self.shape = shape
        self.lat = _PermutohedralLattice(features)
        norm = self.lat.compute(np.ones((features.shape[0], 1), np.float32))[:, 0]
        self.norm = 1.0 / np.sqrt(np.maximum(norm, 1e-20))

    def __call__(self, x: np.ndarray) -> np.ndarray:
        L = x.shape[0]
        flat = x.reshape(L, -1).T.astype(np.float32) * self.norm[:, None]
        out = self.lat.compute(flat) * self.norm[:, None]
        return out.T.reshape(L, *self.shape)


def _gaussian_features(h: int, w: int, sxy: float) -> np.ndarray:
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    return np.stack([xx.reshape(-1) / sxy, yy.reshape(-1) / sxy], axis=1)


def _bilateral_features(image: np.ndarray, sxy: float, srgb: float) -> np.ndarray:
    h, w = image.shape[:2]
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    rgb = image.reshape(-1, 3).astype(np.float32) / srgb
    return np.concatenate(
        [np.stack([xx.reshape(-1) / sxy, yy.reshape(-1) / sxy], axis=1), rgb], axis=1
    )


class _GaussianFilter(_NormalizedLatticeFilter):
    """Spatial Gaussian term via the lattice (the feature layout of
    ``native/csrc/tris_native.cpp::tris_dense_crf_multi``)."""

    def __init__(self, shape, sxy: float):
        super().__init__(_gaussian_features(shape[0], shape[1], sxy), shape)


class _BilateralFilter(_NormalizedLatticeFilter):
    """Bilateral (x, y, r, g, b) term via the lattice."""

    def __init__(self, image: np.ndarray, sxy: float, srgb: float):
        super().__init__(_bilateral_features(image, sxy, srgb), image.shape[:2])


BACKENDS = ("native", "numpy")


def _check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"dense_crf: backend must be one of {BACKENDS}, got {backend!r}")
    return backend


def _softmax0(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=0, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=0, keepdims=True)


def dense_crf_inference(
    image: np.ndarray,
    unary: np.ndarray,
    n_iters: int = 10,
    gaussian_sxy: float = 3.0,
    gaussian_compat: float = 3.0,
    bilateral_sxy: float = 50.0,
    bilateral_srgb: float = 5.0,
    bilateral_compat: float = 10.0,
    backend: str = "native",
    threads: int = 1,
) -> np.ndarray:
    """Mean-field dense CRF. image: [H, W, 3] uint8; unary: [L, H*W] -log p.

    Returns Q [L, H, W], from the native lattice (on ``threads`` OpenMP
    threads) or, with ``backend="numpy"``, the numpy one."""
    h, w = image.shape[:2]
    L = unary.shape[0]
    if _check_backend(backend) == "native":
        from tris_tpu_torch import native

        return native.crf.dense_crf_inference(
            image, unary.reshape(L, h, w), n_iters, gaussian_sxy, gaussian_compat,
            bilateral_sxy, bilateral_srgb, bilateral_compat, threads)
    u = unary.reshape(L, h, w).astype(np.float32)
    gauss = _GaussianFilter((h, w), gaussian_sxy)
    bilat = _BilateralFilter(image, bilateral_sxy, bilateral_srgb)

    Q = _softmax0(-u)
    for _ in range(n_iters):
        msg = gaussian_compat * gauss(Q) + bilateral_compat * bilat(Q)
        Q = _softmax0(-u + msg)
    return Q


def dense_crf_inference_multi(
    image: np.ndarray,
    unaries: np.ndarray,
    n_iters: int = 10,
    gaussian_sxy: float = 3.0,
    gaussian_compat: float = 3.0,
    bilateral_sxy: float = 50.0,
    bilateral_srgb: float = 5.0,
    bilateral_compat: float = 10.0,
    backend: str = "native",
    threads: int = 1,
) -> np.ndarray:
    """K independent mean-field problems over one image, sharing the lattice
    build and fusing the K*L filter channels. unaries: [K, L, H*W] -log p.
    Returns Q [K, L, H, W]. Roughly 1.7x faster than K separate calls for
    K=2 (the cam_to_ir_label fg/bg pair, cam_to_ir_label.py:61-69).
    ``backend`` and ``threads`` as :func:`dense_crf_inference`'s."""
    h, w = image.shape[:2]
    K, L = unaries.shape[:2]
    if _check_backend(backend) == "native":
        from tris_tpu_torch import native

        return native.crf.dense_crf_inference_multi(
            image, unaries.reshape(K, L, h, w), n_iters, gaussian_sxy, gaussian_compat,
            bilateral_sxy, bilateral_srgb, bilateral_compat, threads)

    # the filters are shared across the K problems
    u = unaries.reshape(K, L, h, w).astype(np.float32)
    gauss = _GaussianFilter((h, w), gaussian_sxy)
    bilat = _BilateralFilter(image, bilateral_sxy, bilateral_srgb)
    flat = u.reshape(K * L, h, w)
    Q = np.stack([_softmax0(-u[k]) for k in range(K)]).reshape(K * L, h, w)
    for _ in range(n_iters):
        msg = gaussian_compat * gauss(Q) + bilateral_compat * bilat(Q)
        nxt = (-flat + msg).reshape(K, L, h, w)
        Q = np.stack([_softmax0(nxt[k]) for k in range(K)]).reshape(K * L, h, w)
    return Q.reshape(K, L, h, w)


def crf_inference_label(
    image: np.ndarray,
    labels: np.ndarray,
    t: int = 10,
    n_labels: int = 2,
    gt_prob: float = 0.7,
    backend: str = "native",
) -> np.ndarray:
    """Refine a hard label map (imutils.py:169-183). Returns argmax labels [H, W]."""
    unary = unary_from_labels(labels, n_labels, gt_prob)
    Q = dense_crf_inference(image, unary, n_iters=t, backend=backend)
    return np.argmax(Q, axis=0)


def crf_inference_label_multi(
    image: np.ndarray,
    label_maps: np.ndarray,
    t: int = 10,
    n_labels: int = 2,
    gt_prob: float = 0.7,
    backend: str = "native",
) -> np.ndarray:
    """Refine K hard label maps over the same image in one fused CRF run.

    label_maps: [K, H, W] -> argmax labels [K, H, W]."""
    unaries = np.stack([unary_from_labels(m, n_labels, gt_prob) for m in label_maps])
    Q = dense_crf_inference_multi(image, unaries, n_iters=t, backend=backend)
    return np.argmax(Q, axis=1)
