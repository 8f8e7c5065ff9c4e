"""The PyTorch port stands alone and runs on the card by default: it imports
no JAX and nothing of the JAX package, its entry points refuse to drop to
the CPU silently, its kernel wrappers take their plain versions for CPU
tensors only, and ``chip_smoke.py`` fails without a card.
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from tris_tpu_torch import kernels
from tris_tpu_torch.cli import validate as cli_validate
from tris_tpu_torch.cli.common import build_stage1
from tris_tpu_torch.config import get_parser

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "tris_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|tris_tpu)(\.|\s|$)", re.M)


def test_import_loads_no_jax_and_nothing_of_the_jax_package():
    modules = sorted(
        "tris_tpu_torch." + ".".join(p.relative_to(ROOT / "tris_tpu_torch").with_suffix("").parts)
        for p in (ROOT / "tris_tpu_torch").rglob("*.py") if p.name != "__init__.py")
    code = ("import sys, importlib\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'tris_tpu'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_line_names_jax_or_the_jax_package(path):
    assert not FORBIDDEN.findall(path.read_text()), path


def test_build_stage1_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    args = get_parser().parse_args([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_stage1(args)


@pytest.mark.parametrize("entry", ["build_stage2", "train_stage2", "validate_stage2"])
def test_stage2_entry_points_default_to_cuda(entry):
    # stage 2's builder and both CLIs go to the card unless told --device cpu
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    from tris_tpu_torch.cli import train_stage2
    from tris_tpu_torch.cli.common import build_stage2

    args = get_parser().parse_args(["--stage", "2"])
    run = {"build_stage2": lambda: build_stage2(args),
           "train_stage2": lambda: train_stage2.main(args),
           "validate_stage2": lambda: cli_validate.main(args)}[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run()


def test_load_pretrained_reads_a_torch_save(tmp_path):
    # --pretrain: a torch.save of the port's state_dict (the reference's
    # keys, so a released TRIS .pth too) loads strictly; other formats exit
    from tests.test_torch_models import HIDDEN, TINY
    from tris_tpu_torch.cli.common import load_pretrained
    from tris_tpu_torch.models.stage1 import Stage1Config, TRISStage1

    def tiny(seed):
        with torch.random.fork_rng():
            torch.manual_seed(seed)
            return TRISStage1(Stage1Config(hidden_dim=HIDDEN, clip_override=TINY))

    src = tiny(0)
    path = tmp_path / "stage1.pth"
    torch.save({"model": src.state_dict()}, path)
    args = get_parser().parse_args(["--pretrain", str(path)])
    dst = load_pretrained(args, tiny(1))
    for k, t in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], t), k
    args = get_parser().parse_args(["--pretrain", str(tmp_path / "stage1.msgpack")])
    with pytest.raises(SystemExit, match="torch checkpoints"):
        load_pretrained(args, dst)


@pytest.mark.parametrize("flags", [["--dataset", "referit", "--stage", "2"],
                                   ["--dataset", "referit"]])
def test_cli_paths_not_yet_ported_exit(monkeypatch, flags):
    # --dataset referit exited "not ported" until ReferIt eval was ported: it now builds
    # the test split's ReferItTestDataset from the flags and runs validate_referit on the
    # stage the flags name (tests/test_torch_referit.py runs it end to end)
    from tris_tpu_torch.data import referit
    from tris_tpu_torch.eval import validate_referit

    seen = {}
    monkeypatch.setattr(cli_validate, "build_stage1", lambda args: "stage1")
    monkeypatch.setattr(cli_validate, "build_stage2", lambda args: "stage2")
    monkeypatch.setattr(cli_validate, "load_pretrained", lambda args, model: model)
    monkeypatch.setattr(referit, "ReferItTestDataset",
                        lambda root, split, size, max_tokens: (root, split, size, max_tokens))
    monkeypatch.setattr(validate_referit, "validate_referit",
                        lambda model, ds, **kw: seen.update(model=model, ds=ds, **kw) or {})
    args = get_parser().parse_args(flags + ["--device", "cpu", "--refer_data_root", "r",
                                            "--test_split", "test", "--size", "64"])
    assert cli_validate.main(args) == {}
    assert seen["model"] == ("stage2" if "2" in flags else "stage1")
    assert seen["ds"] == ("r", "test", 64, 20) and seen["device_resize"] is True


@pytest.mark.parametrize("flags", [["--prms"], ["--prms", "--critic_weights", "vit.pt"]])
def test_cli_prms_runs_and_critic_weights_parses(monkeypatch, flags):
    # --prms runs PRMS with the critic that --critic_weights names (random
    # weights without it); both exited or failed to parse before PRMS was
    # ported
    seen = {}
    monkeypatch.setattr(cli_validate, "build_stage1", lambda args: "model")
    monkeypatch.setattr(cli_validate, "load_pretrained", lambda args, model: model)
    monkeypatch.setattr(cli_validate, "build_critic",
                        lambda args: seen.setdefault("weights", args.critic_weights) or "critic")
    monkeypatch.setattr(cli_validate, "build_eval_loaders",
                        lambda args, splits: {s: "loader" for s in splits})
    monkeypatch.setattr(cli_validate, "validate_prms",
                        lambda model, critic, loader, **kw: seen.update(critic=critic, **kw) or {})
    cli_validate.main(get_parser().parse_args(flags + ["--device", "cpu"]))
    assert seen["critic"] == (seen["weights"] or "critic")
    assert seen["weights"] == (flags[-1] if len(flags) > 1 else None)
    assert seen["device_resize"] is True


@pytest.mark.parametrize("flags", [["--tp", "2"], ["--tp", "1"], ["--scales", "0.5"],
                                   ["--multihost", "--tp", "4"], ["--scales", "1.0"],
                                   ["--profile", "steps", "--tp", "1"]])
def test_parser_refuses_options_only_the_jax_package_has(flags, capsys):
    # accepted and ignored, they would promise what the port does not do; --multihost and
    # --profile are the port's own since data parallelism was ported
    with pytest.raises(SystemExit):
        get_parser().parse_args(flags)
    assert "unrecognized arguments" in capsys.readouterr().err


@pytest.mark.parametrize("fast_eval", [False, True])
def test_cli_fast_eval_drops_the_box_metrics(monkeypatch, fast_eval):
    # --fast_eval is how the CLI reaches K4's scalars-only path
    seen = {}
    monkeypatch.setattr(cli_validate, "build_stage1", lambda args: "model")
    monkeypatch.setattr(cli_validate, "load_pretrained", lambda args, model: model)
    monkeypatch.setattr(cli_validate, "build_eval_loaders",
                        lambda args, splits: {s: "loader" for s in splits})
    monkeypatch.setattr(cli_validate, "validate", lambda model, loader, **kw: seen.update(kw) or {})
    flags = ["--device", "cpu"] + (["--fast_eval"] if fast_eval else [])
    cli_validate.main(get_parser().parse_args(flags))
    assert seen["with_boxes"] is not fast_eval and seen["device_resize"] is True


def test_wrappers_take_no_plain_path_off_the_cpu():
    # a tensor that is neither on the CPU nor on a card: the wrapper must
    # go for its kernel (and refuse), never quietly to the plain version
    q = torch.empty(2, 20, 64, device="meta")
    with pytest.raises(ValueError, match="expected CUDA"):
        kernels.mha_short(q, q, q, 4)
    with pytest.raises(ValueError, match="expected CUDA"):
        kernels.cross_attn(q, q, q, q, q, q, 1, 8.0)
    with pytest.raises(ValueError, match="expected CUDA"):
        kernels.critic_input(q, q, 1, 32, 16)
    with pytest.raises(ValueError, match="expected CUDA"):
        kernels.stage1_head(q, q, torch.empty((), device="meta"), (4, 5), (8, 8), 3.0, 0.01)
    with pytest.raises(ValueError, match="expected a CUDA"):
        kernels.normalize_u8_nchw(torch.empty(2, 8, 8, 3, dtype=torch.uint8, device="meta"))
    e = torch.empty(12, 16, device="meta")
    with pytest.raises(ValueError, match="expected CUDA"):
        kernels.bilinear_resize(e, (24, 32))
    with pytest.raises(ValueError, match="expected CUDA"):
        kernels.path_max_affinity(e, [np.zeros((1, 1, 2), np.int64)], 1)
    with pytest.raises(ValueError, match="expected CUDA"):
        kernels.refine_centroids(torch.empty(2, 12, 16, device="meta"))
    with pytest.raises(ValueError, match="expected CUDA"):
        kernels.walk_transition(torch.empty(1, 13, 18, device="meta"), np.array([[0, 1]]), 12, 16,
                                1, 10.0)
    m = torch.empty(64, 64, device="meta")
    with pytest.raises(ValueError, match="expected CUDA"):
        kernels.walk_matmul(m, m, 4, 4)
    with pytest.raises(ValueError, match="expected CUDA"):
        kernels.walk_square(m, m, m.bool(), m.bool(), 4, 4)
    with pytest.raises(ValueError, match="expected CUDA"):
        kernels.walk_tile_occupancy(m)
    with pytest.raises(ValueError, match="expected CUDA"):
        kernels.irn_loss(torch.empty(1, 16, 16, dtype=torch.uint8, device="meta"),
                         torch.empty(1, 1, 12, 8, device="meta"),
                         torch.empty(1, 2, 16, 16, device="meta"), np.array([[0, 1]]), 4)
    with pytest.raises(ValueError, match="expected CUDA"):
        kernels.pixel_attn(q, q, q, 1)
    with pytest.raises(ValueError, match="expected CUDA"):
        kernels.ema_update([q], [q], 0.5)
    c = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="expected CUDA"):
        kernels.batch_norm_act(torch.empty(2, 3, 4, 4, device="meta"), c, c, c, c, training=True,
                               update_stats=True, momentum=0.1, eps=1e-5, act="relu")
    # nor does the walk's transition on a grid too small for K10's band build
    from tris_tpu_torch.pseudo.indexing import transition_matrix

    with pytest.raises(ValueError, match="CPU tensors only"):
        transition_matrix(torch.empty(6, 10, device="meta"))


def test_irn_host_mask_feed_refuses_tensors_off_the_cpu():
    # the IRN loss's host-mask feed is the plain version (no kernel reads
    # precomputed masks): off the CPU it raises before the model runs
    from tris_tpu_torch.pseudo.train_irn import irn_loss

    masks = {k: torch.empty(1, 1, 12, device="meta") for k in ("aff_bg_pos", "aff_fg_pos",
                                                               "aff_neg")}
    with pytest.raises(ValueError, match="host-mask feed has no kernel"):
        irn_loss(None, None, {"image": torch.empty(1, 3, 8, 8, device="meta"), **masks})


def test_irn_loss_table_refuses_directions_outside_the_window():
    # K8 reads each direction's destination window: a (dy, dx) table from a
    # larger radius than the one given would read out of bounds on the card,
    # so the wrapper checks the table once, when it caches it
    import importlib

    from tris_tpu_torch.pseudo.indexing import PathIndex

    table = importlib.import_module("tris_tpu_torch.kernels.irn_loss")._dirs_table
    small, large = PathIndex(5, (16, 16)), PathIndex(10, (32, 32))
    key = lambda pi: tuple(map(tuple, np.asarray(pi.search_dst).tolist()))  # noqa: E731
    cpu = torch.device("cpu")
    got = table(key(small), small.radius_floor, cpu)
    assert got.dtype == torch.int32 and got.tolist() == np.asarray(small.search_dst).tolist()
    assert table(key(small), large.radius_floor, cpu).shape == got.shape
    with pytest.raises(ValueError, match="outside the window of radius floor 4"):
        table(key(large), small.radius_floor, cpu)
    with pytest.raises(ValueError, match="outside the window"):
        table(((-1, 0),), 4, cpu)


def test_walk_defaults_to_cuda_for_host_arrays():
    # numpy maps and edge go to the card unless the caller asks for the CPU
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    from tris_tpu_torch.pseudo.indexing import bucket_pad, propagate_to_edge_bucketed

    x, edge = np.zeros((2, 12, 14), np.float32), np.zeros((12, 14), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        propagate_to_edge_bucketed(x, edge)
    xp, ep = bucket_pad(x, edge, device="cpu")
    assert xp.shape == (16, 32, 32) and ep.shape == (32, 32) and float(ep[-1, -1]) == 1.0


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("checks the failure on a machine without CUDA")
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# ---- names in csrc/: launchers.h's namespace tris against the files' own ------------------

CSRC = ROOT / "tris_tpu_torch" / "kernels" / "csrc"
_DECL_FUNC = re.compile(r"(?<![\w:])(\w+)\s*\((?:[^()]|\([^()]*\))*\)\s*(?:const\s*)?$")
_DECL_CONST = re.compile(r"\b(?:constexpr|const)\b[^=]*?(?<![\w:])(\w+)\s*(?:\[[^\]]*\]\s*)?=")
_DECL_TYPE = re.compile(r"\b(?:struct|class|union|enum|using)\s+(\w+)")
_NOT_NAMES = {"static_assert", "if", "for", "while", "switch", "return", "sizeof", "decltype"}


def namespace_scope_names(src: str) -> set:
    """``(name, namespaces)`` of each constant, type and function that C++ source ``src``
    declares at namespace scope (not inside a function or a type): ``namespaces`` the names
    of the namespaces around it, ``""`` for an anonymous one. Comments, strings and
    preprocessor lines are dropped first; each statement is the text since the last
    ``;``, ``{`` or ``}``."""
    src = re.sub(r"/\*.*?\*/", "", src, flags=re.S)
    src = re.sub(r"//[^\n]*", "", src)
    src = re.sub(r"^\s*#[^\n]*", "", src, flags=re.M)
    src = re.sub(r'"(?:\\.|[^"\\])*"', '""', src)
    found, stack, last = set(), [], 0
    for m in re.finditer(r"[{};]", src):
        stmt, last = src[last:m.start()].strip(), m.end()
        if stmt and all(kind == "ns" for kind, _ in stack):
            names = set(_DECL_TYPE.findall(stmt))
            const, func = _DECL_CONST.search(stmt), _DECL_FUNC.search(stmt)
            if const:
                names.add(const.group(1))
            elif func and not stmt.startswith("namespace"):
                names.add(func.group(1))
            found |= {(n, tuple(ns for _, ns in stack)) for n in names - _NOT_NAMES}
        if m.group() == "{":
            ns = re.search(r"\bnamespace\s*(\w*)$", stmt)
            stack.append(("ns", ns.group(1)) if ns else ("block", ""))
        elif m.group() == "}":
            stack.pop()
    return found


def shadowed_names(header: str, source: str) -> set:
    """The names ``header`` declares in namespace tris that ``source`` declares again at file
    scope, in the global or an anonymous namespace: inside ``namespace tris`` code of that
    file, the file's own declaration and tris's are two entities of one name."""
    ours = {n for n, ns in namespace_scope_names(header) if ns == ("tris",)}
    return ours & {n for n, ns in namespace_scope_names(source) if "tris" not in ns}


@pytest.mark.parametrize("path", sorted(CSRC.glob("*.cu*")), ids=lambda p: p.name)
def test_no_file_local_name_shadows_launchers_h(path):
    # a .cu (or the .cuh it includes) declares none of launchers.h's names for itself: a
    # file-local constant of the same name as one in namespace tris has compiled into the
    # wrong value where both were in sight
    header = (CSRC / "launchers.h").read_text()
    assert {"kStage1HeadThreads", "stage1_head_plan", "Stage1HeadPlan", "TapArrays",
            "stage1_head"} <= {n for n, ns in namespace_scope_names(header) if ns == ("tris",)}
    assert shadowed_names(header, path.read_text()) == set()


@pytest.mark.parametrize("planted,name", [
    ("constexpr int kStage1HeadThreads = 128;", "kStage1HeadThreads"),
    ("__device__ __forceinline__ int stage1_head_plan(int x) { return x; }", "stage1_head_plan"),
    ("struct TapArrays {\n  int n;\n};", "TapArrays"),
])
def test_shadowing_guard_catches_a_planted_collision(planted, name):
    # the guard's own check: the same name declared in stage1_head.cu's anonymous namespace
    header = (CSRC / "launchers.h").read_text()
    source = (CSRC / "stage1_head.cu").read_text()
    assert "namespace {\n" in source and shadowed_names(header, source) == set()
    planted_source = source.replace("namespace {\n", f"namespace {{\n\n{planted}\n", 1)
    assert shadowed_names(header, planted_source) == {name}


def test_parser_takes_multihost_and_profile():
    args = get_parser().parse_args(["--multihost", "--profile", "trace"])
    assert args.multihost is True and args.profile == "trace"
    assert get_parser().parse_args([]).multihost is False


def test_multihost_without_torchrun_raises(monkeypatch):
    # --multihost never falls back to one process: without torchrun's environment the
    # group cannot start, and the CLI says so
    from tris_tpu_torch.cli.common import start_distributed

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    args = get_parser().parse_args(["--multihost", "--device", "cpu"])
    with pytest.raises(ValueError):
        start_distributed(args)


def test_native_build_compiles_only_the_ports_sources_and_loads_no_jax_library():
    """The port's native library is built from its own copies under
    tris_tpu_torch/native/csrc into its git-ignored build directory; no
    source under native/ is compiled and no library of tris_tpu/ or native/
    is loaded (the process's own memory map, after a CRF, a decode and the
    codec ran)."""
    from tris_tpu_torch import native

    port = ROOT / "tris_tpu_torch"
    sources = [native.CSRC / n for n in native.SOURCES]
    assert all(s.exists() and s.resolve().is_relative_to(port) for s in sources)
    cmd = native.build_command(sources, str(native.BUILD_DIR / "x.so"))
    named = [a for a in cmd if a.endswith((".cpp", ".cc", ".c", ".so"))]
    assert named and all(pathlib.Path(a).resolve().is_relative_to(port) for a in named), cmd
    assert native.BUILD_DIR.resolve().is_relative_to(port)
    assert "tris_tpu_torch/native/build/" in (ROOT / ".gitignore").read_text().split()
    code = ("import numpy as np\n"
            "from tris_tpu_torch import native\n"
            "from tris_tpu_torch.data import mask_ops\n"
            "from tris_tpu_torch.pseudo.crf import crf_inference_label\n"
            "m = np.eye(8, dtype=np.uint8)\n"
            "mask_ops.rle_decode(mask_ops.rle_encode(m))\n"
            "crf_inference_label(np.zeros((8, 8, 3), np.uint8), m.astype(np.int32))\n"
            "native.jpeg_decode(b'not a jpeg') if native.jpeg_available() else None\n"
            "print(native.library_path())\n"
            "print(open('/proc/self/maps').read())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    lib, maps = out.stdout.split("\n", 1)
    assert pathlib.Path(lib).resolve().parent == native.BUILD_DIR.resolve()
    loaded = {line.split()[-1] for line in maps.splitlines() if "libtris_native" in line}
    assert loaded == {str(pathlib.Path(lib).resolve())}
    for bad in (ROOT / "tris_tpu", ROOT / "native"):
        assert not any(p.startswith(str(bad) + os.sep) for p in loaded), loaded


def test_step_profiler_writes_the_trace_of_steps_10_to_20(tmp_path):
    from tris_tpu_torch.cli.common import StepProfiler

    prof, seen = StepProfiler(str(tmp_path / "trace"), rank=1), []
    for it in range(25):
        prof.step(it, seen.append)
        torch.ones(8).sum()
    prof.close(seen.append)
    assert seen == [f"profiler trace written to {tmp_path / 'trace' / 'trace_rank1.json'}"]
    assert (tmp_path / "trace" / "trace_rank1.json").stat().st_size > 0
    StepProfiler(None).step(10)  # no directory: nothing
