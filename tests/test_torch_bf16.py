"""``--bf16`` of the PyTorch port (stage-1 eval and PRMS) against the JAX
package's ``dtype=bfloat16`` modules, on the CPU (the kernel wrappers take
their plain versions there), at the tests' tiny RN50 config.

Two leaf regimes, as a user meets them: a checkpoint (``--pretrain``,
``--clip_weights``: every leaf float32) and the seeded ``dtype=bfloat16``
init (the 15 leaf kinds flax makes in the module's dtype bfloat16), which
send different dtypes to K1, K2 and K3.

The reference is the JAX module compiled with XLA's
``xla_allow_excess_precision`` off (:func:`jit_exact`), so that each
bfloat16 op rounds where the program writes it. XLA's CPU default keeps
some of a fusion's bfloat16 intermediates in float32 at its own choice: at
the slice's 64 px the JAX package's two compiles are themselves 0.2 to 0.3
of the bfloat16-float32 gap apart, which leaves no room for a bar at a
quarter of it.

Distances are ``max |a - b| / max |f32|``, the JAX float32 output being the
scale. Bars, on the same inputs and variables:

- the port's bfloat16 output lies within a quarter of the gap between the
  JAX package's bfloat16 and float32 outputs;
- it lies at least half the gap away from the port's float32 output (a
  route that silently computed in float32 would not);
- its dtype is JAX's.

Measured here (each test prints its numbers): the port at most 0.025 of
the gap from JAX (the text block on float32 leaves; below 1e-5 of it, most
of them the same bits, everywhere else), and at the full gap from its own
float32 route; gaps from 0.0045 (the text block) to 0.30 (new_vis, an
InstanceNorm over 12 pixels) and 0.028 to 0.039 for the maps and the CAMs.
The metrics equal JAX's bfloat16 ones (validate's mIoU 3.94 and 4.00
against 3.73 in float32).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from tests.fixtures import make_fake_refcoco
from tests.helpers import TINY_RESNET_CLIP
from tests.test_torch_models import HIDDEN, TINY, make_inputs, randomize_norms
from tests.test_torch_prms import make_critic_pair
from tris_tpu.data.dataset import Loader as JLoader, ReferSegDataset as JDataset
from tris_tpu.eval.validate import validate as j_validate, validate_prms as j_validate_prms
from tris_tpu.models import clip as jclip, layers as jlayers
from tris_tpu.models.fusion import BilateralPrompt as JBilateral
from tris_tpu.models.stage1 import Stage1Config as JStage1Config, TRISStage1 as JStage1
from tris_tpu_torch.ckpt.from_jax import stage1_state_dict_from_flax, state_dict_from_flax
from tris_tpu_torch.ckpt.io import load_state
from tris_tpu_torch.cli import common, demo
from tris_tpu_torch.config import get_parser
from tris_tpu_torch.data.dataset import Loader, ReferSegDataset
from tris_tpu_torch.eval.validate import validate, validate_prms
from tris_tpu_torch.models import clip as tclip, layers as tlayers
from tris_tpu_torch.models.fusion import BilateralPrompt
from tris_tpu_torch.models.stage1 import Stage1Config, TRISStage1

torch.set_num_threads(2)

BF16 = torch.bfloat16
REGIMES = ("f32_leaves", "bf16_leaves")
EXACT = {"xla_allow_excess_precision": False}
METRIC_FLOOR = 1e-4  # the port's float32 metrics against JAX's (tests/test_torch_eval.py)
_JIT = jax.jit  # jit_exact's, while _jax_exact stands in for jax.jit


def jit_exact(fn):
    """``jax.jit(fn)``, each argument signature compiled with XLA's excess
    precision off."""
    jitted = _JIT(fn)
    compiled = {}

    @functools.wraps(fn)
    def call(*args):
        leaves, tree = jax.tree_util.tree_flatten(args)
        key = (tree, tuple((np.shape(x), np.result_type(x)) for x in leaves))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(compiler_options=EXACT)
        return compiled[key](*args)

    return call


def _jit_exact_decorator(fn=None, **kw):
    """A stand-in for ``jax.jit`` while the JAX package's validate builds its
    forward: the same function, compiled by :func:`jit_exact`."""
    assert not kw, kw
    return jit_exact(fn)


def dist(a, b, scale) -> float:
    a, b, scale = (np.asarray(x, np.float64) for x in (a, b, scale))
    return float(np.abs(a - b).max() / np.abs(scale).max())


def check_bars(port16, port32, jax16, jax32, what):
    """The bars of the module docstring; returns (gap, share of it)."""
    gap = dist(jax16, jax32, jax32)
    got = dist(port16, jax16, jax32)
    away = dist(port16, port32, jax32)
    print(f"{what}: gap {gap:.4g}, the port at {got / max(gap, 1e-30):.3g} of it, "
          f"{away / max(gap, 1e-30):.3g} of it from its float32 route")
    assert gap > 0, f"{what}: bfloat16 and float32 agree, the test is vacuous"
    assert got <= gap / 4, f"{what}: port {got:.3g} from JAX, gap {gap:.3g}"
    assert away >= gap / 2, f"{what}: port bf16 only {away:.3g} from port f32, gap {gap:.3g}"
    return gap, got / gap


def np_of(t) -> np.ndarray:
    return t.detach().float().numpy()


def bf16_keys(variables):
    return {k for k, a in flatten_dict(variables).items() if a.dtype == jnp.bfloat16}


def with_leaves(variables, keys):
    """``variables`` with the leaves at ``keys`` in bfloat16 (the seeded init's)."""
    return unflatten_dict({k: (jnp.asarray(a).astype(jnp.bfloat16) if k in keys else a)
                           for k, a in flatten_dict(variables).items()})


@pytest.fixture(scope="module")
def stage1():
    """(JAX float32 model, JAX bfloat16 model, the bfloat16 init's leaf keys,
    float32 variables: tests/test_torch_models.py's, the float32 init with
    randomized norms, whose maps are not all zero at these inputs)."""
    cfg = JStage1Config(hidden_dim=HIDDEN, clip_override=TINY_RESNET_CLIP)
    j32, j16 = JStage1(cfg), JStage1(cfg, dtype=jnp.bfloat16)
    args = (jnp.zeros((1, 64, 64, 3)), jnp.ones((1, 20), jnp.int32))
    keys = bf16_keys(jax.eval_shape(lambda k: j16.init(k, *args, train=False),
                                    jax.random.PRNGKey(1)))
    init = jax.jit(lambda k: j32.init(k, *args, train=False))(jax.random.PRNGKey(1))
    v32 = randomize_norms(jax.tree_util.tree_map(np.asarray, init), 1)
    return j32, j16, keys, v32


def variables_of(stage1, regime):
    _, _, keys, v32 = stage1
    return v32 if regime == "f32_leaves" else with_leaves(v32, keys)


def port_stage1(variables, dtype=BF16) -> TRISStage1:
    tm = TRISStage1(Stage1Config(hidden_dim=HIDDEN, clip_override=TINY), dtype).eval()
    load_state(tm, stage1_state_dict_from_flax(variables))
    return tm


def test_bf16_leaf_set(stage1):
    # the port's dtype=bfloat16 init makes bfloat16 exactly the leaves JAX's
    # init makes bfloat16 (15 at this config), by name; from_jax keeps them
    # bfloat16; a float32 state dict loads as float32 (as the JAX package's
    # loaders replace the init's leaves), a bfloat16 one as bfloat16
    _, _, keys, v32 = stage1
    assert len(keys) == 15
    jax_bf16 = {k for k, t in stage1_state_dict_from_flax(
        with_leaves(v32, keys)).items() if t.dtype == BF16}
    tm = TRISStage1(Stage1Config(hidden_dim=HIDDEN, clip_override=TINY), BF16)
    port_bf16 = {k for k, t in tm.state_dict().items() if t.dtype == BF16}
    assert port_bf16 == jax_bf16 and len(port_bf16) == 15
    assert all(t.dtype == torch.float32 for k, t in tm.state_dict().items()
               if k not in port_bf16 and t.is_floating_point())
    params = dict(tm.named_parameters())
    load_state(tm, stage1_state_dict_from_flax(v32))
    assert all(t.dtype == torch.float32 for t in tm.state_dict().values() if t.is_floating_point())
    assert all(p is params[k] for k, p in tm.named_parameters())  # the same Parameters
    load_state(tm, stage1_state_dict_from_flax(with_leaves(v32, keys)))
    assert {k for k, t in tm.state_dict().items() if t.dtype == BF16} == jax_bf16


def test_bottleneck_fold_matches_jax():
    # K13's eval fold in a strided bottleneck (its downsample too) on a
    # bfloat16 input; a bottleneck's leaves are float32 in both regimes
    # (measured: gap 0.0050, the port at 0 of it)
    rng = np.random.default_rng(3)
    x = np.asarray(jnp.asarray(rng.standard_normal((2, 8, 8, 16)), jnp.bfloat16))
    j32, j16 = jclip.Bottleneck(planes=8, stride=2), jclip.Bottleneck(planes=8, stride=2,
                                                                       dtype=jnp.bfloat16)
    v = jax.jit(lambda k: j32.init(k, jnp.asarray(x, jnp.float32)))(jax.random.PRNGKey(3))
    v = randomize_norms(jax.tree_util.tree_map(np.asarray, v), 3)
    want16 = jit_exact(j16.apply)(v, x)
    want32 = jit_exact(j32.apply)(v, np.asarray(x, np.float32))
    xt = torch.from_numpy(np.asarray(x, np.float32)).permute(0, 3, 1, 2).to(BF16)
    got = {}
    for dt in (BF16, torch.float32):
        tm = tclip.Bottleneck(16, 8, 2, dtype=dt).eval()
        tm.load_state_dict(state_dict_from_flax(v), strict=True)
        with torch.no_grad():
            got[dt] = np_of(tm(xt.to(dt)).permute(0, 2, 3, 1))
    assert want16.dtype == jnp.bfloat16 and tm.conv1.compute_dtype == torch.float32
    check_bars(got[BF16], got[torch.float32], want16, want32, "bottleneck")


@pytest.mark.parametrize("regime", REGIMES)
def test_text_block_matches_jax(regime):
    # K1 in a causal text block: on float32 leaves the stream is float32
    # (K1 in float32, the MLP in bfloat16); on bfloat16 leaves it is bfloat16
    # and K1 takes bfloat16 q, k, v with the float32 mask
    # (measured: gaps 0.0045 and 0.0050, the port at 0.025 and 0 of them)
    rng = np.random.default_rng(4)
    N, L, C, H = 3, 20, 32, 4
    x = rng.standard_normal((N, L, C)).astype(np.float32)
    mask = np.asarray(jlayers.causal_mask(L))
    j32 = jlayers.ResidualAttentionBlock(C, H)
    j16 = jlayers.ResidualAttentionBlock(C, H, dtype=jnp.bfloat16)
    init = jax.jit(lambda k: j16.init(k, x, mask))(jax.random.PRNGKey(4))
    keys = bf16_keys(init)
    assert len(keys) == 2  # attn/in_proj_kernel and attn/in_proj_bias
    v32 = randomize_norms(jax.tree_util.tree_map(np.asarray, init), 4)
    v = v32 if regime == "f32_leaves" else with_leaves(v32, keys)
    xin = x if regime == "f32_leaves" else np.asarray(jnp.asarray(x, jnp.bfloat16))
    want16 = jit_exact(j16.apply)(v, xin, mask)
    want32 = jit_exact(j32.apply)(v32, np.asarray(xin, np.float32), mask)
    got = {}
    for dt, var in ((BF16, v), (torch.float32, v32)):
        tm = tlayers.ResidualAttentionBlock(C, H, dt).eval()
        load_state(tm, state_dict_from_flax(var))
        xt = torch.from_numpy(np.asarray(xin, np.float32))
        with torch.no_grad():
            out = tm(xt.to(BF16) if regime == "bf16_leaves" and dt == BF16 else xt,
                     tlayers.causal_mask(L))
        got[dt] = out
    assert str(got[BF16].dtype)[6:] == str(want16.dtype)
    check_bars(np_of(got[BF16]), np_of(got[torch.float32]), want16, want32,
               f"text block ({regime})")


@pytest.mark.parametrize("regime", REGIMES)
def test_bilateral_prompt_matches_jax(regime):
    # K2 at T = 2 texts (the vision softmax over two keys): on float32 leaves
    # the vision operands are float32 and the text ones bfloat16 (new_vis
    # float32); on bfloat16 leaves all bfloat16 (new_vis bfloat16); new_lan
    # is bfloat16 both ways (measured: gaps 0.0085 to 0.30, the port at 3e-7 of them)
    rng = np.random.default_rng(5)
    N, Hs, Ws, D, T = 2, 3, 4, 16, 2
    vis = np.asarray(jnp.asarray(rng.standard_normal((N, Hs, Ws, D)), jnp.bfloat16))
    lan = np.asarray(jnp.asarray(rng.standard_normal((N, T, D)), jnp.bfloat16))
    j32, j16 = JBilateral(D, D), JBilateral(D, D, dtype=jnp.bfloat16)
    init = jax.jit(lambda k: j16.init(k, vis, lan))(jax.random.PRNGKey(5))
    keys = bf16_keys(init)
    assert len(keys) == 8  # v_proj{1,2,3}_in and v_output_in, scale and bias
    v32 = randomize_norms(jax.tree_util.tree_map(np.asarray, init), 5)
    v = v32 if regime == "f32_leaves" else with_leaves(v32, keys)
    want16 = jit_exact(j16.apply)(v, vis, lan)
    want32 = jit_exact(j32.apply)(v32, np.asarray(vis, np.float32), np.asarray(lan, np.float32))
    vt = torch.from_numpy(np.asarray(vis, np.float32)).reshape(N, Hs * Ws, D)
    lt = torch.from_numpy(np.asarray(lan, np.float32))
    got = {}
    for dt, var in ((BF16, v), (torch.float32, v32)):
        tm = BilateralPrompt(D, D, dt).eval()
        load_state(tm, state_dict_from_flax(var))
        with torch.no_grad():
            got[dt] = tm(vt.to(dt), lt.to(dt))
    new_vis_dtype = "float32" if regime == "f32_leaves" else "bfloat16"
    for i, name in enumerate(("new_vis", "new_lan")):
        assert str(got[BF16][i].dtype)[6:] == str(want16[i].dtype)
        assert str(want16[i].dtype) == (new_vis_dtype if i == 0 else "bfloat16")
        check_bars(np_of(got[BF16][i]).reshape(want16[i].shape),
                   np_of(got[torch.float32][i]).reshape(want16[i].shape),
                   want16[i], want32[i], f"{name} ({regime})")


@pytest.mark.parametrize("regime", REGIMES)
def test_response_maps_matches_jax(stage1, regime):
    # K3's eval head in the whole stage-1 model (K13, K1, K2 and K3 on their
    # bfloat16 operands): 2 images x 3 sentences at 64 px; the maps are
    # float32 (measured: gaps 0.032 and 0.028, the port at 7e-6 and 5e-6 of them)
    j32, j16, _, v32 = stage1
    v = variables_of(stage1, regime)
    img, ids = make_inputs(2, 3, seed=6)
    run = lambda m: jit_exact(lambda v, i, t: m.apply(v, i, t, method="response_maps"))
    want16, want32 = run(j16)(v, img, ids), run(j32)(v32, img, ids)
    x = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        got16 = port_stage1(v).response_maps(x, torch.from_numpy(ids))
        got32 = port_stage1(v32, torch.float32).response_maps(x, torch.from_numpy(ids))
    assert got16.dtype == torch.float32 and want16.dtype == jnp.float32
    check_bars(np_of(got16), np_of(got32), want16, want32, f"response maps ({regime})")


@pytest.fixture(scope="module")
def refdata(tmp_path_factory):
    root, _ = make_fake_refcoco(str(tmp_path_factory.mktemp("refdata")))
    return root


def _metric_bars(got16, got32, want16, want32, what):
    assert set(got16) == set(want16) == set(want32)
    print(f"{what}: " + ", ".join(f"{k} {got16[k]:.4f} (JAX bf16 {want16[k]:.4f}, f32 "
                                  f"{want32[k]:.4f})" for k in ("mIoU", "oIoU", "hit")))
    for k in want16:
        gap = abs(want16[k] - want32[k])
        assert abs(got16[k] - want16[k]) <= max(gap / 4, METRIC_FLOOR), (what, k)
        assert abs(got32[k] - want32[k]) <= METRIC_FLOOR, (what, k)


def _jax_exact(monkeypatch, fn):
    """``fn()`` with the JAX package's forwards built by :func:`jit_exact`."""
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", _jit_exact_decorator)
        return fn()


@pytest.mark.parametrize("regime", REGIMES)
def test_validate_matches_jax(stage1, refdata, regime, monkeypatch):
    # the slice as a whole: 6 refs x 2 sentences at 64 px in batches of 4,
    # with the box metrics; every metric of the bfloat16 port within a
    # quarter of JAX's bfloat16-float32 gap of JAX's (or within the float32
    # paths' 1e-4), and the float32 port within 1e-4 of JAX's float32
    j32, j16, _, v32 = stage1
    v = variables_of(stage1, regime)
    kw = dict(with_boxes=True, device_resize=True, host_threads=1)
    jds = JDataset(refdata, split="train", size=64, eval_mode=True)
    tds = ReferSegDataset(refdata, split="train", size=64, eval_mode=True)
    jl = lambda: JLoader(jds, 4, shuffle=False, drop_last=False, num_threads=1)
    tl = lambda: Loader(tds, 4, shuffle=False, drop_last=False, num_threads=1)
    want16 = _jax_exact(monkeypatch, lambda: j_validate(j16, v, jl(), **kw))
    want32 = j_validate(j32, v32, jl(), **kw)
    got16 = validate(port_stage1(v), tl(), **kw)
    got32 = validate(port_stage1(v32, torch.float32), tl(), **kw)
    _metric_bars(got16, got32, want16, want32, f"validate ({regime})")
    assert 0 < got16["mIoU"] < 100


@pytest.fixture(scope="module")
def critic():
    return make_critic_pair()


@pytest.mark.parametrize("regime", REGIMES)
def test_validate_prms_matches_jax(stage1, critic, refdata, regime, tmp_path, monkeypatch):
    # PRMS with --bf16 (the ViT critic float32, as the JAX package builds
    # it): 6 refs at 96 px; the metrics as validate's, every ref's selection
    # JAX's, and each CAM file (the selected map at the original size) within
    # a quarter of the gap between JAX's bfloat16 and float32 files
    j32, j16, _, v32 = stage1
    jc, cv, tc = critic
    v = variables_of(stage1, regime)
    jds = JDataset(refdata, split="train", size=96, eval_mode=True)
    tds = ReferSegDataset(refdata, split="train", size=96, eval_mode=True)
    jl = lambda: JLoader(jds, 4, shuffle=False, drop_last=False, num_threads=1)
    tl = lambda: Loader(tds, 4, shuffle=False, drop_last=False, num_threads=1)
    dirs = {side: str(tmp_path / side) for side in ("j16", "j32", "p16", "p32")}
    kw = lambda side: dict(save_cam=True, cam_save_dir=dirs[side] + "/cam",
                           name_save_dir=dirs[side] + "/names", host_threads=1)
    want16 = _jax_exact(monkeypatch,
                        lambda: j_validate_prms(j16, jc, v, cv, jl(), **kw("j16")))
    want32 = j_validate_prms(j32, jc, v32, cv, jl(), **kw("j32"))
    got16 = validate_prms(port_stage1(v), tc, tl(), **kw("p16"))
    got32 = validate_prms(port_stage1(v32, torch.float32), tc, tl(), **kw("p32"))
    _metric_bars(got16, got32, want16, want32, f"PRMS ({regime})")
    import os

    names = sorted(os.listdir(dirs["j16"] + "/cam"))
    assert len(names) == 6 and sorted(os.listdir(dirs["p16"] + "/cam")) == names
    cams = {side: np.stack([np.load(f"{dirs[side]}/cam/{n}") for n in names]) for side in dirs}
    check_bars(cams["p16"], cams["p32"], cams["j16"], cams["j32"], f"PRMS CAMs ({regime})")


def _args(*extra):
    return get_parser().parse_args(["--bf16", "--device", "cpu", *extra])


def test_bf16_refused_outside_stage1_eval(tmp_path, monkeypatch):
    # --bf16 builds stage 1 for eval, ReferIt and training on one process;
    # stage 2, the demo and training over several processes raise, naming
    # what --bf16 covers
    args = _args("--hidden_dim", "32")
    args.clip_weights = None
    with pytest.raises(NotImplementedError, match="covers stage-1 eval, PRMS.*stage 2"):
        common.build_stage2(args)
    with pytest.raises(NotImplementedError, match="covers stage-1 eval, PRMS.*the demo"):
        demo.main(_args("--img", "x.jpg", "--text", "a"))
    monkeypatch.setattr(common, "rank_world", lambda: (0, 2))
    with pytest.raises(NotImplementedError, match="stage-1 training over 2 processes with --bf16"):
        common.build_stage1(args, train=True)
    assert "stage-1 eval, PRMS and ReferIt eval" in common.BF16_SCOPE
    assert "stage-1 training on one process" in common.BF16_SCOPE


def test_cli_builds_bf16_stage1(monkeypatch):
    # cli.validate's model under --bf16: the seeded init in bfloat16 with
    # JAX's 15 leaf kinds (at the tiny config), in eval mode
    cfg = Stage1Config(hidden_dim=HIDDEN, clip_override=TINY)
    monkeypatch.setattr(common, "Stage1Config",
                        lambda **kw: dataclasses.replace(cfg, **{k: kw[k] for k in (
                            "hidden_dim", "txt_length", "attn_multi")}))
    model = common.build_stage1(_args("--hidden_dim", str(HIDDEN)))
    assert not model.training
    assert sum(t.dtype == BF16 for t in model.state_dict().values()) == 15
    assert model.backbone.transformer.resblocks[0].attn.in_proj_weight.dtype == BF16
