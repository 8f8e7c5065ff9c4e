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


@pytest.mark.parametrize("flags", [["--stage", "2"], ["--dataset", "referit"]])
def test_cli_paths_not_yet_ported_exit(flags):
    args = get_parser().parse_args(flags + ["--device", "cpu"])
    with pytest.raises(SystemExit, match="not ported"):
        cli_validate.main(args)


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


@pytest.mark.parametrize("flags", [["--tp", "2"], ["--multihost"], ["--profile", "trace"],
                                   ["--ema_eval"], ["--scales", "1.0"],
                                   ["--clip_weights", "rn50.pt"]])
def test_parser_refuses_options_only_the_jax_package_has(flags, capsys):
    # accepted and ignored, they would promise what the port does not do
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
    with pytest.raises(ValueError, match="expected a CUDA"):
        kernels.normalize_u8_nchw(torch.empty(2, 8, 8, 3, dtype=torch.uint8, device="meta"))


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
