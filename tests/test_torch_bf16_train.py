"""``--bf16`` stage-1 training of the PyTorch port against the JAX package's
``dtype=bfloat16`` step, on the CPU (the kernel wrappers take their plain
versions there), at the tests' tiny RN50 config, hidden 32, B = 4.

Three leaf regimes, as a user meets them, each sending its own dtypes to
the kernels (``PERF.md`` §6's table, which :func:`test_kernel_operand_dtypes`
prints and checks):

- ``seeded``: the ``--bf16`` init, the 15 leaf kinds flax makes in the
  module's dtype bfloat16;
- ``pretrain``: a ``.pth`` loaded with ``--pretrain``, every leaf float32;
- ``clip``: ``--clip_weights``, the backbone replaced by a float32 release,
  the fusion's 8 InstanceNorm leaves still bfloat16.

The reference is the JAX step compiled with XLA's
``xla_allow_excess_precision`` off (``tests/test_torch_bf16.py::jit_exact``);
the port's bfloat16 VJP reductions take that compile's order here
(``tests/xla_cpu_sums.py``), and ``tests/test_torch_bf16_sums.py`` holds
the port's own (float32 sums, rounded once) against it.
Distances are ``max |a - b| / max |f32|``; the bars are eval's
(``tests/test_torch_bf16.py``): the port's
bfloat16 value within a quarter of the gap between JAX's bfloat16 and
float32 values, at least half the gap from the port's own float32 route,
and in JAX's dtype. Each test prints the gap and the share reached.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from flax.traverse_util import flatten_dict, unflatten_dict

from tests.test_torch_bf16 import (
    BF16,
    REGIMES as EVAL_REGIMES,
    _jax_exact,
    _metric_bars,
    bf16_keys,
    check_bars,
    dist,
    jit_exact,
    np_of,
    with_leaves,
)
from tests.test_torch_models import HIDDEN, TINY, randomize_norms
from tests.test_torch_prms import make_critic_pair
from tests.test_torch_referit import referit_multi  # noqa: F401  (the fixture)
from tests.test_torch_train import B, make_batch
from tests.helpers import TINY_RESNET_CLIP
from tests.xla_cpu_sums import use_xla_cpu_sums
from tris_tpu.data import referit as JR
from tris_tpu.eval.validate_referit import validate_referit as j_validate_referit
from tris_tpu.models import clip as jclip, layers as jlayers
from tris_tpu.models.fusion import BilateralPrompt as JBilateral
from tris_tpu.models.stage1 import (
    Stage1Config as JStage1Config,
    TRISStage1 as JStage1,
    focal_penalty,
)
from tris_tpu.ops.resize import bilinear_resize as j_resize
from tris_tpu.train.stage1 import Stage1LossWeights as JWeights, stage1_loss as j_stage1_loss
from tris_tpu.train.state import make_optimizer as j_make_optimizer
from tris_tpu_torch import kernels
from tris_tpu_torch.ckpt.from_jax import grads_from_flax, state_dict_from_flax
from tris_tpu_torch.ckpt.io import (
    BestCheckpointKeeper,
    load_state,
    resume_train_state,
    save_train_checkpoint,
)
from tris_tpu_torch.cli import common, demo, train_stage1 as cli_train
from tris_tpu_torch.config import get_parser
from tris_tpu_torch.data import referit as R
from tris_tpu_torch.eval.validate import image_to_nchw
from tris_tpu_torch.eval.validate_referit import validate_referit
from tris_tpu_torch.kernels.stage1_head import stage1_head_plain
from tris_tpu_torch.models import clip as tclip, layers as tlayers
from tris_tpu_torch.models.fusion import BilateralPrompt
from tris_tpu_torch.models.stage1 import Stage1Config, TRISStage1
from tris_tpu_torch.models.stage2 import Stage2Config
from tris_tpu_torch.train.stage1 import Stage1LossWeights, batch_to_device, stage1_loss, train_step
from tris_tpu_torch.train.state import apply_gradients, make_optimizer

torch.set_num_threads(2)

F32 = torch.float32
REGIMES = ("seeded", "pretrain", "clip")


@pytest.fixture(scope="module")
def stage1():
    """(JAX float32 model, JAX bfloat16 model, {regime: variables}, the
    float32 variables): the float32 init with randomized norms and, per
    regime, its leaves in the dtypes that regime gives them."""
    cfg = JStage1Config(hidden_dim=HIDDEN, clip_override=TINY_RESNET_CLIP)
    j32, j16 = JStage1(cfg), JStage1(cfg, dtype=jnp.bfloat16)
    args = (jnp.zeros((1, 64, 64, 3)), jnp.ones((1, 20), jnp.int32))
    keys = bf16_keys(jax.eval_shape(lambda k: j16.init(k, *args, train=False),
                                    jax.random.PRNGKey(3)))
    init = jax.jit(lambda k: j32.init(k, *args, train=False))(jax.random.PRNGKey(3))
    v32 = randomize_norms(jax.tree_util.tree_map(np.asarray, init), 3)
    fusion = {k for k in keys if k[1] != "backbone"}
    assert len(keys) == 15 and len(fusion) == 8
    regimes = {"seeded": with_leaves(v32, keys), "pretrain": v32,
               "clip": with_leaves(v32, fusion)}
    return j32, j16, regimes, v32


@pytest.fixture(scope="module")
def critic():
    # seed 7: every image-text cosine of the batches is above max_loss's clamp (l1 is live)
    jc, cv, tc = make_critic_pair(7)
    return jc, cv, tc.requires_grad_(False)


@pytest.fixture(autouse=True)
def xla_cpu_sums(monkeypatch):
    """The port's VJP reductions in XLA's CPU order, the strict compile's
    (``tests/xla_cpu_sums.py``), for every test here."""
    use_xla_cpu_sums(monkeypatch)


def port_stage1(variables, dtype=BF16) -> TRISStage1:
    tm = TRISStage1(Stage1Config(hidden_dim=HIDDEN, clip_override=TINY), dtype).train()
    load_state(tm, state_dict_from_flax(variables))
    return tm


_STEPS = {}


def jax_step(model, variables, jc, cv, batch):
    """JAX's (loss, metrics, grads) of one batch, compiled strictly once per
    model and signature."""
    key = id(model)
    if key not in _STEPS:
        _STEPS[key] = jit_exact(jax.value_and_grad(
            lambda p, s, cv, b: j_stage1_loss(p, s, model, jc, cv, b, JWeights()), has_aux=True))
    (loss, (_, metrics)), grads = _STEPS[key](variables["params"], variables["batch_stats"], cv,
                                              {k: jnp.asarray(a) for k, a in batch.items()})
    return {k: float(m) for k, m in metrics.items()}, grads


def bars(port16, port32, jax16, jax32, what):
    """``check_bars``; where JAX's bfloat16 and float32 values agree (a value
    bfloat16 rounds nowhere on its way, as the float32-vision mix's forward),
    the port's within 1e-6 of the scale instead."""
    if dist(jax16, jax32, jax32) == 0:
        got = dist(port16, jax16, jax32)
        print(f"{what}: no gap (float32 throughout), the port {got:.3g} of the scale from JAX")
        assert got <= 1e-6, what
        return 0.0, 0.0
    return check_bars(port16, port32, jax16, jax32, what)


def port_step(tm, tc, batch):
    tm = copy.deepcopy(tm)
    loss, metrics = stage1_loss(tm, tc, batch_to_device(batch, "cpu"), Stage1LossWeights())
    loss.backward()
    return {k: float(m) for k, m in metrics.items()}, tm


# ---- dtypes -----------------------------------------------------------------------


def _record(monkeypatch, mod, name, log):
    fn = getattr(mod, name)

    def wrapper(*args, **kw):
        dts = tuple(str(a.dtype)[6:] for a in args if isinstance(a, torch.Tensor))
        out = fn(*args, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        log.setdefault(name, set()).add((dts, tuple(str(o.dtype)[6:] for o in outs
                                                    if isinstance(o, torch.Tensor))))
        return out

    monkeypatch.setattr(mod, name, wrapper)


def _jax_module_dtypes(model, variables, batch):
    """The dtypes JAX's TorchBatchNorm, multi_head_attention and
    BilateralPrompt see (in and out) in the train forward, by interception."""
    log = {}

    def intercept(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        name = type(context.module).__name__
        if context.method_name == "__call__" and name in ("TorchBatchNorm", "BilateralPrompt"):
            dts = tuple(str(a.dtype) for a in args if hasattr(a, "dtype"))
            outs = out if isinstance(out, tuple) else (out,)
            log.setdefault(name, set()).add((dts, tuple(str(o.dtype) for o in outs)))
        return out

    mha = jlayers.multi_head_attention

    def mha_log(q, k, v, n_head, attn_mask=None):
        out = mha(q, k, v, n_head, attn_mask)
        if q.shape[1] == 20:  # the text tower's (the attention pool's is unused in training)
            log.setdefault("mha", set()).add(
                (tuple(str(a.dtype) for a in (q, k, v, attn_mask)), (str(out.dtype),)))
        return out

    jlayers.multi_head_attention = mha_log
    try:
        with fnn.intercept_methods(intercept):
            jax.eval_shape(lambda v, i, w: model.apply(v, i, w, train=True,
                                                        mutable=["batch_stats"]),
                           variables, jnp.asarray(batch["image"]), jnp.asarray(batch["word_ids"]))
    finally:
        jlayers.multi_head_attention = mha
    return log


# the operand and output dtypes each kernel receives, per regime (PERF.md §6)
KERNEL_DTYPES = {
    "seeded": {"mha_short": {(("bfloat16",) * 3 + ("float32",), ("float32",))},
               "cross_attn": {(("bfloat16",) * 6, ("bfloat16",) * 2)},
               "stage1_head": {(("bfloat16", "bfloat16", "float32"), ("float32",) * 4)}},
    "pretrain": {"mha_short": {(("float32",) * 4, ("float32",))},
                 "cross_attn": {(("float32",) * 3 + ("bfloat16",) * 3, ("float32",) * 2)},
                 "stage1_head": {(("float32", "bfloat16", "float32"), ("float32",) * 4)}},
    "clip": {"mha_short": {(("float32",) * 4, ("float32",))},
             "cross_attn": {(("bfloat16",) * 6, ("bfloat16",) * 2)},
             "stage1_head": {(("bfloat16", "bfloat16", "float32"), ("float32",) * 4)}},
}


@pytest.mark.parametrize("regime", REGIMES)
def test_kernel_operand_dtypes(stage1, regime, monkeypatch):
    # the dtypes K1, K2, K3's training head and K13 receive in the port's train
    # forward, against the table; JAX's modules' in/out dtypes the same (K13
    # bfloat16 in and out in every regime, its 19 calls; BilateralPrompt's
    # (vis, lan) -> (new_vis, new_lan); the text tower's q, k, v and mask)
    _, j16, regimes, _ = stage1
    v = regimes[regime]
    batch = make_batch(11, u8=True, negatives=False)
    log = {}
    for name in ("batch_norm_act", "mha_short", "cross_attn", "stage1_head"):
        _record(monkeypatch, kernels, name, log)
    tm = port_stage1(v)
    with torch.no_grad():
        tm(image_to_nchw(torch.from_numpy(batch["image"])), torch.from_numpy(batch["word_ids"]),
           train=True)
    jlog = _jax_module_dtypes(j16, v, batch)
    print(f"{regime}: port {sorted((k, sorted(s)) for k, s in log.items())}")
    print(f"{regime}: JAX {sorted((k, sorted(s)) for k, s in jlog.items())}")
    bn = {(d[:1] + d[-1:] if len(d) > 6 else d[:1], o) for d, o in log["batch_norm_act"]}
    assert {d[0] for d, _ in bn} == {"bfloat16"} and {o for _, o in bn} == {("bfloat16",)}
    assert jlog["TorchBatchNorm"] == {(("bfloat16",), ("bfloat16",))}
    for name in ("mha_short", "cross_attn", "stage1_head"):
        assert log[name] == KERNEL_DTYPES[regime][name], (regime, name, log[name])
    assert jlog["mha"] == KERNEL_DTYPES[regime]["mha_short"]
    (j_in, j_out), = jlog["BilateralPrompt"]
    (p_in, p_out), = log["cross_attn"]
    assert j_in == ("bfloat16", "bfloat16")        # norm_vis and norm_lan
    # JAX's fusion outputs (after its output projections) against the port's K2 inputs
    assert j_out[1] == "bfloat16" and j_out[0] == ("float32" if regime == "pretrain"
                                                    else "bfloat16")


@pytest.mark.parametrize("regime", REGIMES)
def test_train_dtypes_match_jax(stage1, critic, regime):
    # the forward's outputs (float32 in every regime), each gradient leaf's
    # dtype and each optimizer moment's: JAX's, leaf by leaf (seeded: 15
    # bfloat16 gradients and 30 bfloat16 moments at this config)
    _, j16, regimes, _ = stage1
    jc, cv, tc = critic
    v = regimes[regime]
    batch = make_batch(12, u8=True, negatives=True)
    tm = port_stage1(v)
    with torch.no_grad():
        outs = copy.deepcopy(tm)(image_to_nchw(torch.from_numpy(batch["image"])),
                                 torch.from_numpy(batch["word_ids"]), train=True)
    j_outs = jax.eval_shape(lambda v, i, w: j16.apply(v, i, w, train=True,
                                                       mutable=["batch_stats"])[0],
                            v, jnp.asarray(batch["image"]), jnp.asarray(batch["word_ids"]))
    assert [str(o.dtype)[6:] for o in outs] == [str(o.dtype) for o in j_outs] == ["float32"] * 5
    j_grads = jax.eval_shape(jax.grad(
        lambda p: j_stage1_loss(p, v["batch_stats"], j16, jc, cv,
                                {k: jnp.asarray(a) for k, a in batch.items()}, JWeights())[0]),
        v["params"])
    want = {k: np_dtype(g) for k, g in grads_from_flax(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), j_grads)).items()}
    _, got = port_step(tm, tc, batch)
    params = dict(got.named_parameters())
    assert want.keys() == params.keys()
    for k, dt in want.items():
        assert str(params[k].dtype)[6:] == dt, k
        if params[k].grad is not None:
            assert str(params[k].grad.dtype)[6:] == dt, k
    n_low = sum(dt == "bfloat16" for dt in want.values())
    assert n_low == {"seeded": 15, "pretrain": 0, "clip": 8}[regime]
    tx = j_make_optimizer(v["params"], total_steps=10)
    j_state = jax.eval_shape(tx.init, v["params"])
    j_low = sum(a.dtype == jnp.bfloat16 for a in jax.tree_util.tree_leaves(j_state))
    optimizer, scheduler = make_optimizer(got, total_steps=10)
    for p in got.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    optimizer.step()
    moments = [t for st in optimizer.state.values() for k, t in st.items() if k != "step"]
    assert sum(t.dtype == BF16 for t in moments) == j_low == 2 * n_low
    for p, st in optimizer.state.items():
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == p.dtype


# ---- the modules that hold a kernel, forward and gradients -----------------------------


def _cotangent(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def jax_fwd_bwd(fn, primals, cts, has_aux=False):
    """``fn(*primals)`` and its vjp at ``cts`` (cast to the outputs' dtypes),
    compiled strictly: ``(out, grads, aux)``."""
    def run(primals, cts):
        if has_aux:
            out, vjp, aux = jax.vjp(fn, *primals, has_aux=True)
        else:
            (out, vjp), aux = jax.vjp(fn, *primals), None
        cts = jax.tree_util.tree_map(lambda c, o: c.astype(o.dtype), cts, out)
        return out, vjp(cts), aux

    return jit_exact(run)(primals, cts)


def test_bottleneck_train_matches_jax():
    # K13 in training (batch statistics, the residual then ReLU, ReLU, and the
    # downsample's "none") in a strided bottleneck on bfloat16 x, its leaves
    # float32 (as in every regime): y, the running buffers, d x and each
    # parameter's gradient, against jax.vjp of the bfloat16 module
    rng = np.random.default_rng(21)
    x = np.asarray(jnp.asarray(rng.standard_normal((3, 8, 8, 16)), jnp.bfloat16))
    j32 = jclip.Bottleneck(planes=8, stride=2)
    j16 = jclip.Bottleneck(planes=8, stride=2, dtype=jnp.bfloat16)
    v = jax.jit(lambda k: j32.init(k, jnp.asarray(x, jnp.float32)))(jax.random.PRNGKey(21))
    v = randomize_norms(jax.tree_util.tree_map(np.asarray, v), 21)
    g = _cotangent((3, 4, 4, 32), 22)
    want = {}
    for dt, m in ((jnp.bfloat16, j16), (jnp.float32, j32)):
        def f(params, xx, m=m):
            return m.apply({"params": params, "batch_stats": v["batch_stats"]}, xx, train=True,
                           mutable=["batch_stats"])
        y, (dp, dx), mut = jax_fwd_bwd(f, (v["params"], np.asarray(x, dt)), g, has_aux=True)
        want[dt] = (y, dx, dp, mut)
    got = {}
    for dt in (BF16, F32):
        tm = tclip.Bottleneck(16, 8, 2, dtype=dt).train()
        tm.load_state_dict(state_dict_from_flax(v), strict=True)
        xt = torch.from_numpy(np.asarray(x, np.float32)).permute(0, 3, 1, 2).to(dt)
        xt.requires_grad_(True)
        y = tm(xt)
        y.backward(torch.from_numpy(g).permute(0, 3, 1, 2).to(y.dtype))
        got[dt] = (y, xt.grad, {k: p.grad for k, p in tm.named_parameters()},
                   {k: b.clone() for k, b in tm.named_buffers()})
    assert str(got[BF16][0].dtype)[6:] == str(want[jnp.bfloat16][0].dtype) == "bfloat16"
    assert got[BF16][1].dtype == BF16
    nhwc = lambda t: np_of(t.permute(0, 2, 3, 1))  # noqa: E731
    bars(nhwc(got[BF16][0]), nhwc(got[F32][0]), want[jnp.bfloat16][0],
               want[jnp.float32][0], "bottleneck y")
    bars(nhwc(got[BF16][1]), nhwc(got[F32][1]), want[jnp.bfloat16][1],
               want[jnp.float32][1], "bottleneck dx")
    w16, w32 = (grads_from_flax(want[d][2]) for d in (jnp.bfloat16, jnp.float32))
    for k in w16:
        assert got[BF16][2][k].dtype == F32, k
        bars(np_of(got[BF16][2][k]), np_of(got[F32][2][k]), np_of(w16[k]), np_of(w32[k]),
                   f"bottleneck d {k}")
    s16, s32 = (state_dict_from_flax({"batch_stats": want[d][3]["batch_stats"]})
                for d in (jnp.bfloat16, jnp.float32))
    for k in s16:
        if not s16[k].is_floating_point():
            continue
        bars(np_of(got[BF16][3][k]), np_of(got[F32][3][k]), np_of(s16[k]), np_of(s32[k]),
                   f"bottleneck {k}")


def text_block_rows():
    """K1 forward and backward in a causal text block on the seeded init's
    bfloat16 leaves (q, k, v bfloat16, the float32 mask): the output and the
    gradients of x and of every parameter, each ``(port bf16, port f32, JAX
    bf16, JAX f32, name)``, the dtypes checked."""
    rng = np.random.default_rng(23)
    N, L, C, H = 3, 20, 32, 4
    x = np.asarray(jnp.asarray(rng.standard_normal((N, L, C)), jnp.bfloat16))
    mask = np.asarray(jlayers.causal_mask(L))
    j32 = jlayers.ResidualAttentionBlock(C, H)
    j16 = jlayers.ResidualAttentionBlock(C, H, dtype=jnp.bfloat16)
    init = jax.jit(lambda k: j16.init(k, x, mask))(jax.random.PRNGKey(23))
    keys = bf16_keys(init)
    v32 = randomize_norms(jax.tree_util.tree_map(np.asarray, init), 23)
    v16 = with_leaves(v32, keys)
    g = _cotangent((N, L, C), 24)
    want = {}
    for name, m, var, xin in (("bf16", j16, v16, x), ("f32", j32, v32, np.asarray(x, np.float32))):
        y, (dp, dx), _ = jax_fwd_bwd(lambda p, xx, m=m: m.apply({"params": p}, xx, mask),
                                     (var["params"], xin), g)
        want[name] = (y, dp, dx)
    got = {}
    for name, dt, var in (("bf16", BF16, v16), ("f32", F32, v32)):
        tm = tlayers.ResidualAttentionBlock(C, H, dt)
        load_state(tm, state_dict_from_flax(var))
        xt = torch.from_numpy(np.asarray(x, np.float32)).to(dt).requires_grad_(True)
        y = tm(xt, tlayers.causal_mask(L))
        y.backward(torch.from_numpy(g).to(y.dtype))
        got[name] = (y, xt.grad, {k: p.grad for k, p in tm.named_parameters()})
    assert str(got["bf16"][0].dtype)[6:] == str(want["bf16"][0].dtype) == "bfloat16"
    rows = [(np_of(got["bf16"][0]), np_of(got["f32"][0]), want["bf16"][0], want["f32"][0],
             "text block y"),
            (np_of(got["bf16"][1]), np_of(got["f32"][1]), want["bf16"][2], want["f32"][2],
             "text block dx")]
    w16, w32 = grads_from_flax(want["bf16"][1]), grads_from_flax(want["f32"][1])
    for k in w16:
        assert str(got["bf16"][2][k].dtype)[6:] == str(np_dtype(w16[k])), k
        rows.append((np_of(got["bf16"][2][k]), np_of(got["f32"][2][k]), np_of(w16[k]),
                     np_of(w32[k]), f"text block d {k}"))
    return rows


def test_text_block_train_matches_jax():
    for row in text_block_rows():
        bars(*row)


def np_dtype(t):
    return str(t.dtype)[6:]


def bilateral_prompt_rows(mix):
    """K2 forward and backward in BilateralPrompt at the training shape (T =
    B texts an image): on float32 leaves (``mix`` "f32_vision") the vision
    projections float32 and the text ones bfloat16, on bfloat16 leaves all
    six bfloat16; outputs and the gradients of vis, lan and every parameter,
    as :func:`text_block_rows`."""
    rng = np.random.default_rng(25)
    N, Hs, Ws, D, T = 4, 3, 4, 16, 4
    vis = np.asarray(jnp.asarray(rng.standard_normal((N, Hs, Ws, D)), jnp.bfloat16))
    lan = np.asarray(jnp.asarray(rng.standard_normal((N, T, D)), jnp.bfloat16))
    j32, j16 = JBilateral(D, D), JBilateral(D, D, dtype=jnp.bfloat16)
    init = jax.jit(lambda k: j16.init(k, vis, lan))(jax.random.PRNGKey(25))
    keys = bf16_keys(init)
    v32 = randomize_norms(jax.tree_util.tree_map(np.asarray, init), 25)
    v16 = v32 if mix == "f32_vision" else with_leaves(v32, keys)
    gv, gl = _cotangent((N, Hs, Ws, D), 26), _cotangent((N, T, D), 27)
    want = {}
    for name, m, var, a, b in (("bf16", j16, v16, vis, lan),
                               ("f32", j32, v32, np.asarray(vis, np.float32),
                                np.asarray(lan, np.float32))):
        outs, grads, _ = jax_fwd_bwd(lambda p, a, b, m=m: m.apply({"params": p}, a, b),
                                     (var["params"], a, b), (gv, gl))
        want[name] = (outs, grads)
    got = {}
    for name, dt, var in (("bf16", BF16, v16), ("f32", F32, v32)):
        tm = BilateralPrompt(D, D, dt)
        load_state(tm, state_dict_from_flax(var))
        vt = torch.from_numpy(np.asarray(vis, np.float32)).reshape(N, Hs * Ws, D).to(dt)
        lt = torch.from_numpy(np.asarray(lan, np.float32)).to(dt)
        vt.requires_grad_(True)
        lt.requires_grad_(True)
        nv, nl = tm(vt, lt)
        torch.autograd.backward((nv, nl), (torch.from_numpy(gv).reshape(nv.shape).to(nv.dtype),
                                           torch.from_numpy(gl).to(nl.dtype)))
        got[name] = ((nv, nl), (vt.grad, lt.grad), {k: p.grad for k, p in tm.named_parameters()})
    (j_out16, (jp16, jv16, jl16)), (j_out32, (jp32, jv32, jl32)) = want["bf16"], want["f32"]
    rows = []
    for i, name in enumerate(("new_vis", "new_lan")):
        assert np_dtype(got["bf16"][0][i]) == str(j_out16[i].dtype)
        rows.append((np_of(got["bf16"][0][i]).reshape(j_out16[i].shape),
                     np_of(got["f32"][0][i]).reshape(j_out16[i].shape), j_out16[i], j_out32[i],
                     f"{name} ({mix})"))
    for i, (name, w16, w32) in enumerate((("d vis", jv16, jv32), ("d lan", jl16, jl32))):
        rows.append((np_of(got["bf16"][1][i]).reshape(w16.shape),
                     np_of(got["f32"][1][i]).reshape(w16.shape), w16, w32, f"{name} ({mix})"))
    w16, w32 = grads_from_flax(jp16), grads_from_flax(jp32)
    for k in w16:
        assert np_dtype(got["bf16"][2][k]) == np_dtype(w16[k]), k
        if k.endswith("0.bias") and "v_" in k:  # a bias right before an InstanceNorm: noise
            continue
        rows.append((np_of(got["bf16"][2][k]), np_of(got["f32"][2][k]), np_of(w16[k]),
                     np_of(w32[k]), f"d {k} ({mix})"))
    return rows


@pytest.mark.parametrize("mix", ["f32_vision", "bf16"])
def test_bilateral_prompt_train_matches_jax(mix):
    for row in bilateral_prompt_rows(mix):
        bars(*row)


def jax_head(vis_p, lan_p, scale, hw, out_hw, fp, fc):
    """``tris_tpu/models/stage1.py``'s training head (lines 100-131) on
    [B, h*w, D] and [B, T, D] operands, with its dtypes."""
    B = vis_p.shape[0]
    (h_, w_), (H, W) = hw, out_hw
    score = scale * jnp.einsum("bpc,bqc->bpq", vis_p, lan_p)
    own = jnp.take_along_axis(score, jnp.arange(B)[:, None, None], axis=2)
    seg = own.reshape(B, h_, w_, 1).transpose(0, 3, 1, 2)
    seg = j_resize(seg, (H, W), align_corners=False).transpose(0, 2, 3, 1)
    score_t = score.transpose(0, 2, 1)
    feats = jnp.concatenate([jnp.ones_like(score_t[:, :1]), score_t], axis=1)
    masks = jax.nn.softmax(feats, axis=1)
    cls_out = (feats.mean(axis=-1) + feats.max(axis=-1)
               + focal_penalty(masks.mean(axis=-1), fp, fc))[:, 1:]
    return cls_out, jax.nn.relu(seg)[..., 0], jax.nn.sigmoid(seg)[..., 0]


def _head_case(rng, vis_dtype, tie: bool):
    B, h, w, D = 4, 3, 4, 16
    vis = rng.standard_normal((B, h * w, D)).astype(np.float32)
    lan = rng.standard_normal((B, B, D)).astype(np.float32)
    if tie:
        # pixels 2 and 7 of image 1 equal pixel 5: text 2's GMP ties over three pixels
        vis[1, 2] = vis[1, 7] = vis[1, 5] = vis[1, 5] * 3
    vis = np.asarray(jnp.asarray(vis, jnp.bfloat16).astype(vis_dtype))
    lan = np.asarray(jnp.asarray(lan, jnp.bfloat16))
    return vis, lan, (h, w), (10, 14)


@pytest.mark.parametrize("mix,tie", [("f32_vision", False), ("bf16", False), ("bf16", True)])
def test_stage1_head_train_matches_jax(mix, tie):
    # K3's training head on (vis_p, lan_p) = (float32, bfloat16) (--pretrain)
    # or (bfloat16, bfloat16), the float32 scale: cls_out and both maps, and
    # d vis_p and d lan_p, against JAX's head and its vjp. With a planted tie,
    # GMP's gradient is split evenly among the tied maxima, as JAX splits it
    rng = np.random.default_rng(29)
    vis, lan, hw, out_hw = _head_case(rng, np.float32 if mix == "f32_vision" else jnp.bfloat16,
                                      tie)
    scale = np.float32(14.285714)
    cts = [_cotangent((4, 4), 30), _cotangent((4,) + out_hw, 31), _cotangent((4,) + out_hw, 32)]
    want = {}
    for name, a, b in (("bf16", vis, lan), ("f32", np.asarray(vis, np.float32),
                                            np.asarray(lan, np.float32))):
        outs, grads, _ = jax_fwd_bwd(
            lambda a, b: jax_head(a, b, jnp.float32(scale), hw, out_hw, 3.0, 0.01), (a, b),
            tuple(cts))
        want[name] = (outs, grads)
    got = {}
    for name, a, b in (("bf16", vis, lan), ("f32", np.asarray(vis, np.float32),
                                            np.asarray(lan, np.float32))):
        at = torch.from_numpy(np.asarray(a, np.float32)).to(
            BF16 if str(a.dtype) == "bfloat16" else F32).requires_grad_(True)
        bt = torch.from_numpy(np.asarray(b, np.float32)).to(
            BF16 if str(b.dtype) == "bfloat16" else F32).requires_grad_(True)
        cls_out, _, relu_map, sig_map = stage1_head_plain(at, bt, torch.tensor(scale), hw, out_hw,
                                                          3.0, 0.01)
        torch.autograd.backward((cls_out, relu_map, sig_map),
                                tuple(torch.from_numpy(c) for c in cts))
        got[name] = ((cls_out, relu_map, sig_map), (at.grad, bt.grad))
    for i, name in enumerate(("cls_out", "relu_map", "sig_map")):
        assert got["bf16"][0][i].dtype == F32 and str(want["bf16"][0][i].dtype) == "float32"
        bars(np_of(got["bf16"][0][i]), np_of(got["f32"][0][i]), want["bf16"][0][i],
                   want["f32"][0][i], f"{name} ({mix}{', tie' if tie else ''})")
    for i, name in enumerate(("d vis_p", "d lan_p")):
        assert np_dtype(got["bf16"][1][i]) == str(want["bf16"][1][i].dtype)
        bars(np_of(got["bf16"][1][i]), np_of(got["f32"][1][i]), want["bf16"][1][i],
                   want["f32"][1][i], f"{name} ({mix}{', tie' if tie else ''})")
    if tie:
        # the tie is exact in bfloat16 (the dot rounded before the scale), and JAX gives each
        # of the three pixels a third of GMP's gradient; so does the port
        score = np.einsum("pc,qc->pq", np.asarray(vis[1], np.float32), np.asarray(lan[1],
                                                                                  np.float32))
        top = np.asarray(jnp.asarray(score, jnp.bfloat16), np.float32)
        q = int(np.argmax(top.max(axis=0)))
        assert (top[:, q] == top[:, q].max()).sum() == 3, "the planted tie is not exact"
        np.testing.assert_array_equal(np_of(got["bf16"][1][0]), np.asarray(want["bf16"][1][0],
                                                                           np.float32))


def test_train_residual_weak_scalar(stage1, monkeypatch):
    # the training forward's fusion residual multiplies by 0.1 as jnp does on
    # bfloat16: in bfloat16 (0.10009765625), then adds; bit for bit jnp's
    _, _, regimes, _ = stage1
    batch = make_batch(15, u8=True, negatives=False)
    seen = {}
    fusion = BilateralPrompt.forward

    def record_fusion(self, vis, lan, *a):
        out = fusion(self, vis, lan, *a)
        seen["fusion"] = (vis, lan, *out)
        return out

    def record_head(vis_p, lan_p, *a):
        seen["head"] = (vis_p, lan_p)
        return stage1_head_plain(vis_p, lan_p, *a)

    monkeypatch.setattr(BilateralPrompt, "forward", record_fusion)
    monkeypatch.setattr(kernels, "stage1_head", record_head)
    tm = port_stage1(regimes["seeded"])
    with torch.no_grad():
        tm(image_to_nchw(torch.from_numpy(batch["image"])), torch.from_numpy(batch["word_ids"]),
           train=True)
    vis, lan, new_vis, new_lan = (jnp.asarray(np_of(t), jnp.bfloat16) for t in seen["fusion"])
    for got, new, base in zip(seen["head"], (new_vis, new_lan), (vis, lan)):
        want = np.asarray(new.reshape(got.shape) * 0.1 + base.reshape(got.shape), np.float32)
        assert got.dtype == BF16
        np.testing.assert_array_equal(np_of(got), want)


# ---- the optimizer -----------------------------------------------------------------


def test_adamw_bf16_leaves_match_optax(stage1):
    # three AdamW steps fed identical gradients on the seeded regime's leaves:
    # the 15 bfloat16 leaves and their bfloat16 moments bit for bit optax's
    # make_optimizer (each op rounded to bfloat16); the float32 leaves as
    # tests/test_torch_train.py holds them (1e-6 of the leaf, 3e-5 of the lr)
    _, _, regimes, _ = stage1
    v = regimes["seeded"]
    lr, wd, total = 5e-5, 0.01, 10
    tm = port_stage1(v)
    flat = flatten_dict(v["params"])
    j_params = v["params"]
    tx = j_make_optimizer(j_params, base_lr=lr, weight_decay=wd, total_steps=total)
    opt_state = tx.init(j_params)
    update = jit_exact(tx.update)
    optimizer, scheduler = make_optimizer(tm, base_lr=lr, weight_decay=wd, total_steps=total)
    params = dict(tm.named_parameters())
    rng = np.random.default_rng(33)
    for step in range(3):
        # gradients of a leaf's own scale, some large: bfloat16 moments and updates that round
        j_grads = unflatten_dict({k: np.asarray(jnp.asarray(
            rng.standard_normal(a.shape) * (1e-3 if step else 1e2), a.dtype))
            for k, a in flat.items()})
        updates, opt_state = update(j_grads, opt_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, g in grads_from_flax(j_grads).items():
            params[k].grad = g
        apply_gradients(optimizer, scheduler)
        want = state_dict_from_flax({"params": j_params})
        n_low = 0
        for k, p in params.items():
            assert p.dtype == want[k].dtype, k
            if p.dtype == BF16:
                n_low += 1
                assert torch.equal(p.detach(), want[k]), (step, k)
            else:
                w = want[k].numpy()
                atol = max(1e-6 * np.abs(w).max(), 3e-5 * lr)
                np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-6, atol=atol,
                                           err_msg=k)
        assert n_low == 15
    # the moments: optax's mu and nu of each bfloat16 leaf, bit for bit
    checked = 0
    for label in ("backbone", "head"):
        adam = opt_state.inner_states[label].inner_state[0]
        for kind, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            for key, m in flatten_dict(tree).items():
                if getattr(m, "dtype", None) != jnp.bfloat16:
                    continue
                (name, want_m), = state_dict_from_flax(
                    {"params": unflatten_dict({key: np.asarray(m)})}).items()
                got_m = optimizer.state[params[name]][kind]
                assert got_m.dtype == BF16 and torch.equal(got_m, want_m), (name, kind)
                checked += 1
    assert checked == 30


def test_bf16_resume_and_keeper_keep_leaves(stage1, critic, tmp_path):
    # --resume and the best-checkpoint keeper with --bf16: the bfloat16
    # leaves and their bfloat16 moments survive a save and a load, and a
    # resumed step equals the unbroken one
    _, _, regimes, _ = stage1
    _, _, tc = critic
    batches = [batch_to_device(make_batch(s, u8=True, negatives=True), "cpu") for s in (16, 17)]

    def fresh():
        model = port_stage1(regimes["seeded"])
        return (model, *make_optimizer(model, total_steps=4))

    a = fresh()
    for b in batches:
        train_step(a[0], tc, a[1], a[2], b)
    first = fresh()
    train_step(first[0], tc, first[1], first[2], batches[0])
    keeper = BestCheckpointKeeper(str(tmp_path), rank=0)
    best = keeper.update(0, 10.0, 10.0, lambda path: save_train_checkpoint(
        path, *first, extra={"epoch": 0}))
    resumed = fresh()
    step, epoch = resume_train_state(best["path"], *resumed)
    assert (step, epoch) == (1, 1)
    low = [k for k, t in resumed[0].state_dict().items() if t.dtype == BF16]
    assert len(low) == 15
    moments = [t for st in resumed[1].state.values() for k, t in st.items() if k != "step"]
    assert sum(t.dtype == BF16 for t in moments) == 30
    for (k, x), (_, y) in zip(first[0].state_dict().items(), resumed[0].state_dict().items()):
        assert x.dtype == y.dtype and torch.equal(x, y), k
    train_step(resumed[0], tc, resumed[1], resumed[2], batches[1])
    for (k, x), (_, y) in zip(a[0].state_dict().items(), resumed[0].state_dict().items()):
        assert x.dtype == y.dtype and torch.equal(x, y), k


# ---- the entry points ------------------------------------------------------------


def _args(*extra):
    return get_parser().parse_args(["--bf16", "--device", "cpu", *extra])


def test_bf16_still_refused(monkeypatch, tmp_path):
    # stage-2 training and bfloat16 training over several ranks raise, naming what --bf16
    # covers; the demo, now covered, gets past its model to the image (tiny stage 2)
    args = _args("--hidden_dim", "32")
    with pytest.raises(NotImplementedError, match="stage-1 eval.*stage-2 training with --bf16"):
        common.build_stage2(args, train=True)
    monkeypatch.setattr(common, "Stage2Config", lambda **kw: dataclasses.replace(
        Stage2Config(clip_override=TINY), txt_length=kw["txt_length"]))
    with pytest.raises(FileNotFoundError):
        demo.main(_args("--img", str(tmp_path / "x.jpg"), "--text", "a"))
    monkeypatch.setattr(common, "rank_world", lambda: (0, 2))
    with pytest.raises(NotImplementedError, match="stage-1 training over 2 processes with "
                                                  "--bf16 is not ported"):
        common.build_stage1(args, train=True)


def test_cli_train_stage1_bf16(monkeypatch, tmp_path):
    # python -m tris_tpu_torch.cli.train_stage1 --bf16 --device cpu, one epoch
    # on the fake data with tiny backbones: the model and its checkpoint keep
    # the 15 bfloat16 leaves, with --clip_weights 8 (the backbone float32)
    from tests.fixtures import make_fake_refcoco
    from tests.test_torch_prms import TINY_VIT

    monkeypatch.setitem(tclip.CLIP_CONFIGS, "RN50", TINY)
    monkeypatch.setitem(tclip.CLIP_CONFIGS, "ViT-B-32", TINY_VIT)
    root, _ = make_fake_refcoco(str(tmp_path / "data"))
    clip_path = str(tmp_path / "rn50.pt")
    torch.save(tclip.CLIP(dataclasses.replace(TINY, txt_length=20)).state_dict(), clip_path)
    for extra, n_low in (((), 15), (("--clip_weights", clip_path), 8)):
        out = tmp_path / f"out{n_low}"
        res = cli_train.main(_args(
            "--dataset", "refcoco", "--splitBy", "unc", "--refer_data_root", root, "--size",
            "64", "--eval_batch", "2", "--hidden_dim", str(HIDDEN), "--host_threads", "1",
            "--batch_size", "4", "--negative_samples", "2", "--epoch", "1", "--test_split",
            "val", "--output", str(out), "--print-freq", "1", "--fast_eval", *extra))
        assert set(res) == {"val", "train"}
        payload = torch.load(str(out / "ckpt_320_epoch_0_best.pth"), weights_only=True)
        assert sum(t.dtype == BF16 for t in payload["model"].values()) == n_low
        moments = [t for st in payload["optimizer"]["state"].values() for k, t in st.items()
                   if k != "step"]
        assert sum(t.dtype == BF16 for t in moments) == 2 * n_low


# ---- ReferIt eval with --bf16 -------------------------------------------------------


@pytest.mark.parametrize("regime", EVAL_REGIMES)
def test_validate_referit_bf16_matches_jax(referit_multi, regime, monkeypatch):  # noqa: F811
    # --bf16 on ReferIt eval (K4 takes float32 maps): every metric of the
    # bfloat16 port within a quarter of JAX's bfloat16-float32 gap of JAX's
    # (or within the float32 paths' 1e-4), in the two eval regimes of tests/test_torch_bf16.py
    from tests.test_torch_bf16 import port_stage1 as eval_port

    cfg = JStage1Config(hidden_dim=HIDDEN, clip_override=TINY_RESNET_CLIP)
    j32, j16 = JStage1(cfg), JStage1(cfg, dtype=jnp.bfloat16)
    args = (jnp.zeros((1, 64, 64, 3)), jnp.ones((1, 20), jnp.int32))
    keys = bf16_keys(jax.eval_shape(lambda k: j16.init(k, *args, train=False),
                                    jax.random.PRNGKey(1)))
    init = jax.jit(lambda k: j32.init(k, *args, train=False))(jax.random.PRNGKey(1))
    v32 = randomize_norms(jax.tree_util.tree_map(np.asarray, init), 1)
    v = v32 if regime == "f32_leaves" else with_leaves(v32, keys)
    ds = lambda mod: mod.ReferItTestDataset(referit_multi, size=64, max_tokens=20)  # noqa: E731
    want16 = _jax_exact(monkeypatch, lambda: j_validate_referit(j16, v, ds(JR)))
    want32 = j_validate_referit(j32, v32, ds(JR))
    got16 = validate_referit(eval_port(v), ds(R))
    got32 = validate_referit(eval_port(v32, F32), ds(R))
    _metric_bars(got16, got32, want16, want32, f"ReferIt ({regime})")
    assert 0 < got16["mIoU"] < 100
