"""``--bf16`` of the PyTorch port on stage 2's eval path (``cli.validate
--stage 2 --bf16`` and ``cli.demo --bf16``) against the JAX package's
``TRISStage2(cfg, dtype=bfloat16)``, on the CPU (the kernel wrappers take
their plain versions there), at the tests' tiny RN50 config.

The reference is the JAX module compiled with XLA's
``xla_allow_excess_precision`` off (``tests/test_torch_bf16.py::jit_exact``).
Leaf regimes, as a user meets them: the seeded ``dtype=bfloat16`` init (31
leaf kinds bfloat16 at this config: the CLIP backbone's 7, the three
PixelAttentions' 12 InstanceNorm leaves and the 12 PReLU slopes), a float32
checkpoint (``--pretrain``: every leaf float32) and, for the dtype table,
``--clip_weights`` (the backbone float32, the other 24 bfloat16).

Bars, with distances ``max |a - b| / max |f32|`` (``tests/test_torch_bf16.py``):

- the modules holding this slice's kernels (PixelAttention at S = 1 and 2,
  ``ConvBNRelu`` in eval, ``bilinear_resize`` on bfloat16): the port within
  a quarter of JAX's bfloat16-float32 gap, at least half of it from the
  port's float32 route, dtypes JAX's (measured: the same bits; the resize bit
  for bit at every shape);
- the interception of the kernels' operands: ``KERNEL_DTYPES``, the port's
  wrappers and JAX's modules alike in each of the three regimes;
- the CLIs: the bfloat16 leaf set JAX's; ``cli.validate --stage 2 --bf16``
  and ``cli.demo --bf16`` run.

The whole model (the eval forward, ``response_maps``, ``validate --stage
2`` and the demo's map), chaotic in bfloat16, is held to JAX's own spread
in ``tests/test_torch_bf16_stage2_model.py``, which shares this file's
fixtures (two files, so that pytest-xdist's ``--dist loadfile`` puts them
on two workers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from PIL import Image

from tests.fixtures import make_fake_refcoco
from tests.helpers import TINY_RESNET_CLIP
from tests.test_torch_bf16 import bf16_keys, check_bars, dist, jit_exact, np_of, with_leaves
from tests.test_torch_models import TINY, make_inputs, randomize_norms
from tris_tpu.models import stage2 as js2
from tris_tpu.models.fusion import PixelAttention as JPixelAttention
from tris_tpu.ops.resize import bilinear_resize as j_bilinear_resize
from tris_tpu_torch import kernels
from tris_tpu_torch.ckpt.from_jax import stage2_state_dict_from_flax
from tris_tpu_torch.ckpt.io import load_state
from tris_tpu_torch.cli import common, demo
from tris_tpu_torch.config import get_parser
from tris_tpu_torch.models import stage2 as ts2
from tris_tpu_torch.models.fusion import PixelAttention

torch.set_num_threads(2)

BF16, F32 = torch.bfloat16, torch.float32
REGIMES = ("seeded", "pretrain")
TEXT = "man on the left, a red umbrella"  # the demo's two phrases: 40 tokens


@pytest.fixture(scope="module")
def stage2():
    """(JAX float32 model, JAX bfloat16 model, {regime: variables}, float32
    variables): the float32 init with randomized norms (tests/test_torch_models.py),
    and per regime its leaves in the dtypes that regime gives them."""
    cfg = js2.Stage2Config(clip_override=TINY_RESNET_CLIP)
    j32, j16 = js2.TRISStage2(cfg), js2.TRISStage2(cfg, dtype=jnp.bfloat16)
    args = (jnp.zeros((1, 64, 64, 3)), jnp.ones((1, 20), jnp.int32))
    keys = bf16_keys(jax.eval_shape(lambda k: j16.init(k, *args, train=True),
                                    jax.random.PRNGKey(1)))
    init = jax.jit(lambda k: j32.init(k, *args, train=True))(jax.random.PRNGKey(1))
    v32 = randomize_norms(jax.tree_util.tree_map(np.asarray, init), 1)
    head = {k for k in keys if k[1] != "backbone"}
    assert len(keys) == 31 and len(head) == 24
    regimes = {"seeded": with_leaves(v32, keys), "pretrain": v32, "clip": with_leaves(v32, head)}
    return j32, j16, regimes, v32


def port_stage2(variables, dtype=BF16) -> ts2.TRISStage2:
    tm = ts2.TRISStage2(ts2.Stage2Config(clip_override=TINY), dtype).eval()
    load_state(tm, stage2_state_dict_from_flax(variables))
    return tm


def _nchw(img):
    return torch.from_numpy(np.asarray(img, np.float32)).permute(0, 3, 1, 2).contiguous()


def _eval_forward(m, v, img, ids):
    return m.apply({k: v[k] for k in ("params", "batch_stats")}, img, ids, train=False)


@pytest.fixture(scope="module")
def refdata(tmp_path_factory):
    root, _ = make_fake_refcoco(str(tmp_path_factory.mktemp("refdata")))
    return root


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    """A 90 x 120 PNG (tests/test_torch_demo.py's)."""
    path = tmp_path_factory.mktemp("demo") / "demo.png"
    rng = np.random.default_rng(2)
    Image.fromarray(rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)).save(path)
    return str(path)


# ---- the modules that hold this slice's kernels -------------------------------------------


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("regime", REGIMES)
def test_pixel_attention_bf16_matches_jax(S, regime):
    # K11 with its Dense layers and InstanceNorms: on bfloat16 leaves q, Lk, Lv and G
    # bfloat16; on float32 leaves the InstanceNorm's float32 scale makes q and G float32
    # (Lk, Lv bfloat16); the output bfloat16 both ways (Wo's Dense). With S = 2 the port's
    # per-image half runs once an image, JAX's on the image repeated (measured: the same
    # bits, gaps 0.0099 to 0.017)
    rng = np.random.default_rng(10 + S)
    N, H, W, C, Ct, T = 2, 5, 7, 48, 24, 20
    vis = np.asarray(jnp.asarray(rng.standard_normal((N, H, W, C)), jnp.bfloat16))
    lan = np.asarray(jnp.asarray(rng.standard_normal((N * S, T, Ct)), jnp.bfloat16))
    j32, j16 = JPixelAttention(C, Ct), JPixelAttention(C, Ct, dtype=jnp.bfloat16)
    init = jax.jit(j16.init)(jax.random.PRNGKey(S), jnp.repeat(vis, S, 0), lan)
    keys = bf16_keys(init)
    assert len(keys) == 4  # ins_q and ins_w, scale and bias
    v32 = randomize_norms(jax.tree_util.tree_map(np.asarray, init), S)
    v = v32 if regime == "pretrain" else with_leaves(v32, keys)
    want16 = jit_exact(j16.apply)(v, jnp.repeat(vis, S, 0), lan)
    want32 = jit_exact(j32.apply)(v32, np.repeat(np.asarray(vis, np.float32), S, 0),
                                  np.asarray(lan, np.float32))
    got = {}
    for dt, var in ((BF16, v), (F32, v32)):
        sd = stage2_state_dict_from_flax({"params": {"attention2": var["params"]}})
        tm = PixelAttention(C, Ct, dt)
        load_state(tm, {k.split(".", 1)[1]: t for k, t in sd.items()})
        with torch.no_grad():
            got[dt] = tm(torch.from_numpy(np.asarray(vis, np.float32)).reshape(N, H * W, C).to(dt),
                         torch.from_numpy(np.asarray(lan, np.float32)).to(dt), S)
    assert str(got[BF16].dtype)[6:] == str(want16.dtype) == "bfloat16"
    shape = want16.shape
    check_bars(np_of(got[BF16]).reshape(shape), np_of(got[F32]).reshape(shape), want16, want32,
               f"PixelAttention S={S} ({regime})")


@pytest.mark.parametrize("regime", REGIMES)
def test_conv_bn_relu_eval_bf16_matches_jax(regime):
    # K13's eval fold with PReLU after a bfloat16 convolution: a bfloat16 slope gives a
    # bfloat16 output, a float32 one (a checkpoint's) a float32 output, as jnp promotes
    # where(y >= 0, y, a * y) (measured: the same bits, gap 0.0052)
    rng = np.random.default_rng(3)
    x = np.asarray(jnp.asarray(rng.standard_normal((2, 8, 8, 16)), jnp.bfloat16))
    j32, j16 = js2.ConvBNRelu(6), js2.ConvBNRelu(6, dtype=jnp.bfloat16)
    init = jax.jit(lambda k: j16.init(k, x))(jax.random.PRNGKey(3))
    keys = bf16_keys(init)
    assert keys == {("params", "act", "alpha")}
    v32 = randomize_norms(jax.tree_util.tree_map(np.asarray, init), 3)
    v = v32 if regime == "pretrain" else with_leaves(v32, keys)
    want16 = jit_exact(j16.apply)(v, x)
    want32 = jit_exact(j32.apply)(v32, np.asarray(x, np.float32))
    got = {}
    for dt, var in ((BF16, v), (F32, v32)):
        sd = stage2_state_dict_from_flax({c: {"output1": var[c]} for c in var})
        tm = ts2.ConvBNRelu(16, 6, dtype=dt).eval()
        load_state(tm, {k.split(".", 1)[1]: t for k, t in sd.items()})
        with torch.no_grad():
            got[dt] = tm(_nchw(x).to(dt)).permute(0, 2, 3, 1)
    want_dtype = "float32" if regime == "pretrain" else "bfloat16"
    assert str(got[BF16].dtype)[6:] == str(want16.dtype) == want_dtype
    check_bars(np_of(got[BF16]), np_of(got[F32]), want16, want32, f"ConvBNRelu ({regime})")


@pytest.mark.parametrize("shape,size,align_corners", [
    ((3, 4, 10, 10), (20, 20), False),    # the decoder's x2 upsamples
    ((2, 1, 20, 20), (80, 80), False),    # the head's x4 to the input size
    ((2, 3, 7, 9), (13, 22), False),      # sizes not a multiple of 4
    ((2, 3, 7, 9), (13, 22), True),
    ((1, 2, 5, 6), (5, 11), False),       # one axis unchanged
])
def test_bilinear_resize_bf16_bit_for_bit_jax(shape, size, align_corners):
    # K6 on bfloat16 planes: the matrices cast to bfloat16, two products rows first, each
    # summed in float32 and rounded to bfloat16: the plain version (the kernel's arithmetic)
    # equals JAX's strict compile bit for bit, bfloat16 out
    x = np.asarray(jnp.asarray(np.random.default_rng(sum(shape)).standard_normal(shape),
                               jnp.bfloat16))
    want = jit_exact(lambda a: j_bilinear_resize(a, size, align_corners=align_corners))(x)
    got = kernels.bilinear_resize(torch.from_numpy(np.asarray(x, np.float32)).to(BF16), size,
                                  align_corners)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np_of(got), np.asarray(want, np.float32))
    want32 = jit_exact(lambda a: j_bilinear_resize(a, size, align_corners=align_corners))(
        np.asarray(x, np.float32))
    assert dist(np_of(got), want32, want32) > 0  # the bfloat16 route, not float32's


# ---- the kernels' operands --------------------------------------------------------------

# (operand dtypes) -> (output dtypes) of the kernels in the eval forward, by regime, as the
# JAX package's dtype rules give them: K11's (q, Lk, Lv) -> G; K13's (x, slope) -> y at the
# decoder's ConvBNRelus (the trunk's folds take no slope: bfloat16 in and out); K6's planes
# -> out
KERNEL_DTYPES = {
    "seeded": {"pixel_attn": {(("bfloat16",) * 3, ("bfloat16",))},
               "prelu": {(("bfloat16", "bfloat16"), ("bfloat16",))},
               "bilinear_resize": {(("bfloat16",), ("bfloat16",))}},
    "pretrain": {"pixel_attn": {(("float32", "bfloat16", "bfloat16"), ("float32",))},
                 "prelu": {(("bfloat16", "float32"), ("float32",))},
                 "bilinear_resize": {(("float32",), ("float32",)), (("bfloat16",), ("bfloat16",))}},
}
KERNEL_DTYPES["clip"] = KERNEL_DTYPES["seeded"]


def _jax_kernel_dtypes(model, variables, img, ids):
    """The dtypes of the operands JAX's stage 2 hands the functions the port's
    kernels replace, by interception: K11's q (ins_q's output), Lk and Lv (Wk's
    and Wv's) and G (Ww's input); each ConvBNRelu's norm input and PReLU slope
    and output; each _up_to's input and output."""
    log, pa = {}, {}

    def intercept(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        mod, name = context.module, context.module.name
        if context.method_name != "__call__":
            return out
        if name in ("ins_q", "Wk", "Wv"):
            pa[name] = str(out.dtype)
        elif name == "Ww":
            log.setdefault("pixel_attn", set()).add(
                ((pa["ins_q"], pa["Wk"], pa["Wv"]), (str(args[0].dtype),)))
        elif type(mod).__name__ == "TorchBatchNorm" and type(mod.parent).__name__ == "ConvBNRelu":
            pa["bn_in"] = str(args[0].dtype)
        elif type(mod).__name__ == "PReLU":
            slope = str(mod.variables["params"]["alpha"].dtype)
            log.setdefault("prelu", set()).add(((pa["bn_in"], slope), (str(out.dtype),)))
        return out

    resize = js2.bilinear_resize

    def resize_log(x, size, align_corners=False):
        out = resize(x, size, align_corners=align_corners)
        log.setdefault("bilinear_resize", set()).add(((str(x.dtype),), (str(out.dtype),)))
        return out

    js2.bilinear_resize = resize_log
    try:
        with fnn.intercept_methods(intercept):
            jax.eval_shape(lambda v, i, t: _eval_forward(model, v, i, t), variables, img, ids)
    finally:
        js2.bilinear_resize = resize
    return log


@pytest.mark.parametrize("regime", ("seeded", "pretrain", "clip"))
def test_kernel_operand_dtypes(stage2, regime, monkeypatch):
    # the dtypes K11, K13's fold with PReLU and K6 receive in the port's eval forward,
    # against the table, and JAX's modules' the same; the trunk's K13 folds bfloat16 in and
    # out in every regime (no slope)
    _, j16, regimes, _ = stage2
    img, ids = make_inputs(2, 1, seed=1)
    ids = ids[:, 0]
    log = {}

    def record(name, fn, key):
        def wrapper(*args, **kw):
            out = fn(*args, **kw)
            dts = key(*args, **kw)
            log.setdefault(name, set()).add((dts, (str(out.dtype)[6:],)))
            return out
        monkeypatch.setattr(kernels, fn.__name__, wrapper)

    dt = lambda t: str(t.dtype)[6:]  # noqa: E731
    record("pixel_attn", kernels.pixel_attn, lambda q, k, v, S=1: (dt(q), dt(k), dt(v)))
    record("bilinear_resize", kernels.bilinear_resize, lambda x, *a, **kw: (dt(x),))
    record("batch_norm_act", kernels.batch_norm_act,
           lambda x, *a, slope=None, **kw: (dt(x),) + (() if slope is None else (dt(slope),)))
    with torch.no_grad():
        port_stage2(regimes[regime])(_nchw(img), torch.from_numpy(ids))
    jlog = _jax_kernel_dtypes(j16, regimes[regime], img, ids)
    print(f"{regime}: port {sorted((k, sorted(s)) for k, s in log.items())}")
    print(f"{regime}: JAX {sorted((k, sorted(s)) for k, s in jlog.items())}")
    prelu = {e for e in log["batch_norm_act"] if len(e[0]) == 2}
    assert {e for e in log["batch_norm_act"] if len(e[0]) == 1} == {(("bfloat16",),
                                                                    ("bfloat16",))}
    want = KERNEL_DTYPES[regime]
    assert prelu == want["prelu"] == jlog["prelu"]
    assert log["pixel_attn"] == want["pixel_attn"] == jlog["pixel_attn"]
    assert log["bilinear_resize"] == want["bilinear_resize"] == jlog["bilinear_resize"]


# ---- the CLIs ------------------------------------------------------------------------------


def _args(*extra):
    return get_parser().parse_args(["--bf16", "--device", "cpu", *extra])


def _tiny_stage2_config(monkeypatch):
    cfg = ts2.Stage2Config(clip_override=TINY)
    monkeypatch.setattr(common, "Stage2Config", lambda **kw: dataclasses.replace(
        cfg, txt_length=kw["txt_length"]))


def test_cli_builds_bf16_stage2(stage2, monkeypatch):
    # cli.validate --stage 2's and the demo's model under --bf16: the seeded init in bfloat16
    # with JAX's bfloat16 leaves, by name (31 at the tiny config), in eval mode; a float32
    # checkpoint loads as float32 leaves
    _, _, regimes, v32 = stage2
    _tiny_stage2_config(monkeypatch)
    model = common.build_stage2(_args())
    assert not model.training
    jax_bf16 = {k for k, t in stage2_state_dict_from_flax(regimes["seeded"]).items()
                if t.dtype == BF16}
    assert {k for k, t in model.state_dict().items() if t.dtype == BF16} == jax_bf16
    assert len(jax_bf16) == 31 and model.reduced_c1.relu.weight.dtype == BF16
    assert model.attention2.ins_q.weight.dtype == BF16
    load_state(model, stage2_state_dict_from_flax(v32))
    assert all(t.dtype == F32 for t in model.state_dict().values() if t.is_floating_point())


def test_cli_validate_and_demo_bf16(refdata, image_path, tmp_path, monkeypatch):
    # cli.validate --stage 2 --bf16 logs its metrics and cli.demo --bf16 writes the overlay,
    # at the tiny config on the CPU
    _tiny_stage2_config(monkeypatch)
    res = __import__("tris_tpu_torch.cli.validate", fromlist=["main"]).main(_args(
        "--stage", "2", "--dataset", "refcoco", "--refer_data_root", refdata, "--size", "64",
        "--test_split", "val", "--eval_batch", "2"))
    assert 0 <= res["val"]["mIoU"] <= 100
    monkeypatch.chdir(tmp_path)
    cam = demo.main(_args("--img", image_path, "--text", TEXT))
    assert cam.shape == (90, 120) and np.isfinite(cam).all()
    assert (tmp_path / "figs" / f"demo_({TEXT}).png").is_file()
