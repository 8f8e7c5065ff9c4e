"""The hand-written kernels against their plain PyTorch versions on the card.

Marked ``cuda``: they need an NVIDIA GPU (sm_90a) and ``nvcc``, and skip
elsewhere. Run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest sets up JAX, which the card's
machine need not have.)

Shapes are small but cover the edges the main path does not: the longest
sequence K1 takes, several text tokens in K2, K3 without the fusion, ties in
K4's peak, and the inputs every wrapper refuses.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tris_tpu_torch import kernels as K
from tris_tpu_torch.models.layers import causal_mask

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels are built with nvcc for sm_90a")
    K.build_all()
    return torch.device("cuda")


@pytest.fixture
def randn(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    return lambda *shape: torch.randn(*shape, generator=g, device=dev)


def _err(a, b):
    return float((a.double() - b.double()).abs().max())


@pytest.mark.parametrize("L,causal", [(20, True), (101, False), (128, True), (1, False)])
def test_mha_short(randn, L, causal):
    # 2e-5 against float64 on N(0, 1) inputs: f32 sums of 64 products
    n, C, H = 3, 256, 4
    qkv = randn(n, L, 3 * C)
    q, k, v = qkv.chunk(3, dim=-1)          # read in place, row stride 3C
    mask = causal_mask(L, device=q.device) if causal else None
    got = K.mha_short(q, k, v, H, mask)
    torch.cuda.synchronize()
    want = K.mha_short_plain(q.double(), k.double(), v.double(), H,
                             None if mask is None else mask.double())
    assert torch.isfinite(got).all()
    assert _err(got, want) <= 2e-5


def test_mha_short_refuses(randn):
    q = randn(2, 129, 64)
    with pytest.raises(ValueError, match="L <= 128"):
        K.mha_short(q, q, q, 1)
    with pytest.raises(TypeError, match="float32"):
        K.mha_short(q.bfloat16(), q.bfloat16(), q.bfloat16(), 1)


@pytest.mark.parametrize("T,S", [(1, 4), (3, 2), (8, 1)])
def test_cross_attn(randn, T, S):
    # 1e-5 against float64 on relu'd inputs (logits of O(10))
    n, hw, m = 2, 100, 256
    qv, kv, vv = (torch.relu(randn(n, hw, m)) for _ in range(3))
    qt, kt, vt = (torch.relu(randn(n * S, T, m)) for _ in range(3))
    args = (qv, kv, vv, qt, kt, vt, S, math.sqrt(m))
    got = K.cross_attn(*args)
    want = K.cross_attn_plain(*(a.double() for a in args[:6]), S, math.sqrt(m))
    for g, w in zip(got, want):
        assert _err(g, w) <= 1e-5
    if T == 1:   # a softmax over one key is exactly 1: the output is Vt
        assert torch.equal(got[0], vt.expand(n * S, hw, m))


@pytest.mark.parametrize("fused", [True, False])
def test_response_head(randn, dev, fused):
    # 1e-5 of the map's scale: exp(logit_scale) * a 1024-long dot of unit rows
    n, S, hw, D = 2, 3, 100, 1024
    vis_base = F.normalize(randn(n, hw, D), dim=-1)
    vis_new = randn(n * S, hw, D) if fused else None
    lan = F.normalize(randn(n * S, D), dim=-1)
    scale = torch.tensor(1 / 0.07, device=dev)
    args = (vis_new, vis_base, lan, S, scale, 0.1, (10, 10), (320, 288))
    got = K.response_head(*args)
    want = K.response_head_plain(*(a.double() if torch.is_tensor(a) else a for a in args))
    assert got.shape == (n * S, 320, 288) and bool((got >= 0).all())
    assert _err(got, want) <= 1e-5 * float(want.abs().max())


def test_eval_metrics(randn, dev):
    # exact: the kernel samples with the same taps in the same order as its
    # plain version; the all-zero map ties everywhere and must pick index 0
    sizes = [(30, 44), (48, 64), (17, 9)]
    cams = torch.relu(randn(3, 2, 16, 16))
    cams[1, 1] = 0
    tables = K.eval_tables(16, 16, sizes, (48, 64), dev)
    rng = np.random.default_rng(0)
    tgt = np.zeros((3, 48, 64), np.uint8)
    for b, (h, w) in enumerate(sizes):
        tgt[b, :h, :w] = rng.random((h, w)) > 0.5
    tgt = torch.as_tensor(tgt, device=dev)
    boxes = torch.tensor([[5, 3, 30, 20], [0, 0, 10, 10], [2, 2, 6, 12]], device=dev,
                         dtype=torch.float32)
    got = torch.stack(K.eval_metrics(cams, tables, tgt, boxes))
    want = torch.stack(K.eval_metrics_plain(cams, tables, tgt, boxes))
    assert torch.equal(got, want)
    assert torch.equal(K.eval_metrics(cams, tables, want_norm=True),
                       K.eval_metrics_plain(cams, tables, want_norm=True))


def test_launches_are_counted(randn):
    q = randn(2, 20, 64)
    before = K.launches["mha_short"]
    K.mha_short(q, q, q, 1)
    assert K.launches["mha_short"] == before + 1
