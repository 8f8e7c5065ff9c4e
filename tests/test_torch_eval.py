"""Parity of the PyTorch port's stage-1 evaluation with the JAX package, on
the CPU in float32: K4's plain version (``kernels.eval_metrics_plain``)
against the JAX device resize/normalise/metrics programs, and the port's
``validate`` against the JAX ``validate`` end to end on the fake RefCOCO
fixture with shared weights.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import make_fake_refcoco
from tests.test_torch_models import make_stage1_pair
from tris_tpu.data.dataset import Loader as JLoader, ReferSegDataset as JDataset
from tris_tpu.eval.validate import (
    _device_metrics,
    _device_resize_norm,
    _padded_resize_matrix,
    validate as j_validate,
)
from tris_tpu_torch import kernels
from tris_tpu_torch.data.dataset import Loader, ReferSegDataset
from tris_tpu_torch.eval.validate import _host_pool, validate

torch.set_num_threads(2)

SIZES = [(30, 44), (48, 64), (17, 9)]
MAXH, MAXW = 48, 64


def _maps(seed: int):
    """Relu maps [3, 2, 16, 16] with one all-zero map (every cell ties)."""
    rng = np.random.default_rng(seed)
    cams = np.maximum(rng.standard_normal((len(SIZES), 2, 16, 16)), 0).astype(np.float32)
    cams[1, 1] = 0.0
    return cams


def _jax_mats(h, w):
    Ah = np.stack([_padded_resize_matrix(h, s[0], MAXH) for s in SIZES])
    Aw = np.stack([_padded_resize_matrix(w, s[1], MAXW) for s in SIZES])
    return jnp.asarray(Ah), jnp.asarray(Aw)


def test_eval_metrics_plain_matches_device_resize_norm():
    # <= 1e-6 relative: the JAX matmul at HIGHEST and K4's two taps sum the
    # same non-negative terms in another order; zero outside each image
    cams = _maps(0)
    want = np.asarray(_device_resize_norm(jnp.asarray(cams), *_jax_mats(16, 16)))
    tables = kernels.eval_tables(16, 16, SIZES, (MAXH, MAXW), "cpu")
    got = kernels.eval_metrics(torch.from_numpy(cams), tables, want_norm=True).numpy()
    assert got.shape == want.shape == (len(SIZES), 2, MAXH, MAXW)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    for b, (oh, ow) in enumerate(SIZES):
        assert not got[b, :, oh:].any() and not got[b, :, :, ow:].any()


def test_eval_metrics_plain_matches_device_metrics():
    # exact: pred = norm > 1e-9 gives the same I and U; the peaks of this
    # seeded data are tie-free (and the all-zero map ties to index 0 on both
    # sides), so hit and hitm agree too
    cams = _maps(1)
    rng = np.random.default_rng(2)
    targets = np.zeros((len(SIZES), MAXH, MAXW), np.uint8)
    for b, (oh, ow) in enumerate(SIZES):
        targets[b, :oh, :ow] = rng.random((oh, ow)) > 0.5
    boxes = np.array([[5, 3, 30, 20], [0, 0, 40, 30], [2, 2, 6, 12]], np.float32)
    want = _device_metrics(jnp.asarray(cams), *_jax_mats(16, 16), jnp.asarray(targets),
                           jnp.asarray(boxes))
    tables = kernels.eval_tables(16, 16, SIZES, (MAXH, MAXW), "cpu")
    got = kernels.eval_metrics(torch.from_numpy(cams), tables, torch.from_numpy(targets),
                               torch.from_numpy(boxes))
    for name, g, w in zip(("I", "U", "hit", "hitm"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert float(got[2].sum()) > 0 and float(got[3].sum()) > 0  # not vacuous


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    root, _ = make_fake_refcoco(str(tmp_path_factory.mktemp("refdata")))
    jm, v, tm = make_stage1_pair()
    jds = JDataset(root, split="train", size=64, eval_mode=True)
    tds = ReferSegDataset(root, split="train", size=64, eval_mode=True)
    return jm, v, tm, jds, tds


@pytest.mark.parametrize("device_resize", [True, False])
@pytest.mark.parametrize("with_boxes", [False, True])
def test_validate_matches_jax(slice_setup, with_boxes, device_resize):
    # the slice as a whole: 6 refs x 2 sentences in batches of 4 (the last
    # one padded), shared weights; mIoU/oIoU/hit/hitm (and the box metrics)
    # within 1e-4 absolute, the bar of the JAX package's own path-vs-path tests
    jm, v, tm, jds, tds = slice_setup
    kw = dict(with_boxes=with_boxes, device_resize=device_resize, host_threads=1)
    want = j_validate(jm, v, JLoader(jds, 4, shuffle=False, drop_last=False, num_threads=1), **kw)
    got = validate(tm, Loader(tds, 4, shuffle=False, drop_last=False, num_threads=1), **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    assert 0 < got["mIoU"] < 100


class _BareLoader:
    """A loader whose dataset cannot say its largest original size."""

    def __init__(self, loader):
        self.epoch = loader.epoch


def test_validate_device_resize_needs_max_orig_size(slice_setup):
    # device_resize pads to loader.ds.max_orig_size(): without it validate
    # raises rather than quietly doing the resize on the host; the host path
    # is what device_resize=False asks for, and gives the same numbers
    jm, v, tm, jds, tds = slice_setup
    loader = Loader(tds, 4, shuffle=False, drop_last=False, num_threads=1)
    with pytest.raises(TypeError, match="max_orig_size"):
        validate(tm, _BareLoader(loader), device_resize=True)
    want = validate(tm, loader, device_resize=False, host_threads=1)
    got = validate(tm, _BareLoader(loader), device_resize=False, host_threads=1)
    assert got == want


@pytest.mark.parametrize("host_threads,workers", [(1, None), (3, 3), (0, "cpus")])
def test_host_pool_honours_host_threads(host_threads, workers):
    # 1 runs the host work inline; n > 1 builds a pool of n; 0 takes cpu_count
    import os

    if workers == "cpus":
        workers = os.cpu_count() if (os.cpu_count() or 1) > 1 else None
    pool = _host_pool(host_threads)
    try:
        assert (None if pool is None else pool._max_workers) == workers
    finally:
        if pool is not None:
            pool.shutdown()
