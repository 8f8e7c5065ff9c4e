"""Repairs of the port's faults against the reference, on the CPU:

- the threaded batch builders (``Loader.epoch``, ``irn_train_batches``)
  raise a failed batch's exception instead of hanging, and their workers
  end when the consumer stops early;
- ``--clip_weights`` loads OpenAI's released CLIP layout into the backbone
  of both stages, from a ``state_dict`` and from a TorchScript file;
- ``validate(save_cam=True)`` creates its CAM directory and writes one names
  json with every process's names, from rank 0;
- every rank's ``Loader.epoch`` yields ``len(loader)`` batches (the order
  padded with its head to a multiple of the process count), one process's
  order unchanged;
- the IRN pair labels take one validity threshold (``irn_loss.MAX_VALID``),
  which the loss honours when another is given.
"""

import json
import multiprocessing
import os
import threading
import time

import numpy as np
import pytest
import torch

from tests.fixtures import make_fake_refcoco
from tests.test_torch_models import TINY
from tris_tpu_torch.cli.common import build_stage1, build_stage2
from tris_tpu_torch.config import get_parser
from tris_tpu_torch.data.dataset import Loader, ReferSegDataset
from tris_tpu_torch.models import clip as clip_mod
from tris_tpu_torch.models.clip import CLIP
from tris_tpu_torch.pseudo import pipeline as PP
from tris_tpu_torch.pseudo.indexing import PathIndex

torch.set_num_threads(2)

TIMEOUT_S = 20   # each builder raises within a second; a hang would block for ever


def _within(fn, seconds=TIMEOUT_S):
    """``fn()`` on a daemon thread: its exception, or None; fails the test
    if it has not returned after ``seconds``."""
    out = {}

    def target():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - the caller inspects it
            out["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"still running after {seconds} s: the builder hangs"
    return out.get("error")


@pytest.fixture(scope="module")
def refdata(tmp_path_factory):
    root, _ = make_fake_refcoco(str(tmp_path_factory.mktemp("refdata")))
    return root


def test_loader_raises_a_missing_image_instead_of_hanging(refdata, tmp_path):
    # the third training image is gone: with 2 threads the epoch raises
    # FileNotFoundError (it blocked in q.get() for ever before)
    import shutil

    root = tmp_path / "data"
    shutil.copytree(refdata, root)
    os.remove(root / "train2014" / "COCO_train2014_000000000002.jpg")
    ds = ReferSegDataset(str(root), "refcoco", "unc", "train", size=32)
    loader = Loader(ds, 1, shuffle=False, num_threads=2)
    err = _within(lambda: list(loader.epoch(0)))
    assert isinstance(err, FileNotFoundError), err
    assert "COCO_train2014_000000000002.jpg" in str(err)


def test_loader_workers_end_when_the_consumer_stops_early(refdata, monkeypatch):
    # one batch taken, then the generator closed: every worker ends (none
    # stays blocked on the full queue). The loader's workers are the threads
    # started meanwhile under the name threaded_in_order gives them (a thread
    # that another library starts is not one), recorded as they start: a
    # worker may already have built its share and ended before the first
    # batch is out, and would be missing from threading.enumerate() then
    from tris_tpu_torch.utils.threads import WORKER_NAME

    started = []

    class Recorded(threading.Thread):
        def start(self):
            started.append(self)
            super().start()

    monkeypatch.setattr(threading, "Thread", Recorded)
    ds = ReferSegDataset(refdata, "refcoco", "unc", "train", size=32)
    it = Loader(ds, 1, shuffle=False, num_threads=2).epoch(0)
    assert next(it)["image"].shape == (1, 32, 32, 3)
    workers = [t for t in started if t.name.startswith(WORKER_NAME + "-")]
    assert len(workers) == 2
    it.close()
    deadline = time.time() + TIMEOUT_S
    while any(t.is_alive() for t in workers) and time.time() < deadline:
        time.sleep(0.02)
    assert not any(t.is_alive() for t in workers)


def test_irn_train_batches_raise_a_missing_ir_label_instead_of_hanging(refdata, tmp_path):
    # the ir labels of pass 1 are missing for one name: IRN training's
    # batches raise FileNotFoundError with 2 threads
    from PIL import Image

    names = [f"{i}_{i + 1}" for i in range(4)]
    ir = tmp_path / "ir_label"
    ir.mkdir()
    for name in names[:-1]:
        Image.fromarray(np.zeros((48, 64), np.uint8)).save(ir / f"{name}.png")
    cfg = PP.PseudoConfig(data_root=os.path.join(refdata, "train2014"), ir_label_dir=str(ir),
                          crop_size=64, radius=5)
    pi = PathIndex(5, (16, 16))
    err = _within(lambda: list(PP.irn_train_batches(cfg, names, pi, 1, 1, num_threads=2)))
    assert isinstance(err, FileNotFoundError), err
    assert f"{names[-1]}.png" in str(err)


# ---- --clip_weights ------------------------------------------------------------------------


def _released_clip(tmp_path, form: str) -> str:
    """OpenAI's release layout of a tiny RN CLIP (its state_dict keys and
    the three metadata entries), as a state_dict or a TorchScript file."""
    with torch.random.fork_rng():
        torch.manual_seed(21)
        clip = CLIP(TINY)
    for k, v in (("input_resolution", 224), ("context_length", 77), ("vocab_size", 49408)):
        clip.register_buffer(k, torch.tensor(v))
    path = str(tmp_path / f"RN50-{form}.pt")
    if form == "state_dict":
        torch.save(clip.state_dict(), path)
    else:
        ids = torch.zeros(1, 20, dtype=torch.long)
        ids[0, 0], ids[0, 3] = 49406, 49407
        torch.jit.save(torch.jit.trace_module(clip, {"encode_text": ids}, check_trace=False), path)
    return path


@pytest.mark.parametrize("form", ["state_dict", "torchscript"])
@pytest.mark.parametrize("stage", [1, 2])
def test_clip_weights_load_the_released_layout(monkeypatch, tmp_path, form, stage):
    # every backbone leaf is the file's (the positional embedding's rows
    # too: the file has the model's 77), the rest of the model is the seeded
    # init; the metadata entries are dropped
    monkeypatch.setitem(clip_mod.CLIP_CONFIGS, "RN50", TINY)
    path = _released_clip(tmp_path, form)
    build = build_stage1 if stage == 1 else build_stage2
    base = ["--device", "cpu", "--hidden_dim", "32"]
    plain = build(get_parser().parse_args(base))
    model = build(get_parser().parse_args(base + ["--clip_weights", path]))
    released = torch.load(path, weights_only=True) if form == "state_dict" else \
        torch.jit.load(path).state_dict()
    backbone = model.backbone.state_dict()
    assert set(released) - set(backbone) == {"input_resolution", "context_length", "vocab_size"}
    for k, t in backbone.items():
        assert torch.equal(t, released[k]), k
    for k, t in model.state_dict().items():
        if not k.startswith("backbone."):
            assert torch.equal(t, plain.state_dict()[k]), k
    assert not torch.equal(model.backbone.token_embedding.weight,
                           plain.backbone.token_embedding.weight)


def test_clip_weights_refuse_a_short_positional_embedding(monkeypatch, tmp_path):
    # a file whose text positions do not cover --max_query_len tokens
    monkeypatch.setitem(clip_mod.CLIP_CONFIGS, "RN50", TINY)
    sd = CLIP(TINY).state_dict()
    sd["positional_embedding"] = sd["positional_embedding"][:8]
    path = tmp_path / "short.pt"
    torch.save(sd, path)
    with pytest.raises(ValueError, match="does not cover 20 tokens"):
        build_stage2(get_parser().parse_args(["--device", "cpu", "--clip_weights", str(path)]))


# ---- validate(save_cam=True) ------------------------------------------------------------------


def _save_cam_worker(rank: int, init: str, root: str, out_dir: str):
    import torch.distributed as dist

    from tris_tpu_torch.eval.validate import validate
    from tris_tpu_torch.models.stage1 import Stage1Config, TRISStage1

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
    try:
        with torch.random.fork_rng():
            torch.manual_seed(0)
            model = TRISStage1(Stage1Config(hidden_dim=32, clip_override=TINY))
        ds = ReferSegDataset(root, "refcoco", "unc", "train", size=32, eval_mode=True)
        loader = Loader(ds, 2, shuffle=False, drop_last=False, process_index=rank,
                        process_count=2, num_threads=1)
        validate(model, loader, with_boxes=False, save_cam=True,
                 cam_save_dir=os.path.join(out_dir, "cam"),
                 name_save_dir=os.path.join(out_dir, "names"), log=lambda *a: None,
                 host_threads=1)
    finally:
        dist.destroy_process_group()


def test_validate_save_cam_makes_its_dir_and_gathers_every_process(refdata, tmp_path):
    # two gloo processes, each with half of the 6 train refs: the fresh CAM
    # directory is created, each map saved there, and rank 0 alone writes the
    # names json, listing both processes' names (each wrote its own before)
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{tmp_path / 'rendezvous'}"
    out = tmp_path / "out"
    procs = [ctx.Process(target=_save_cam_worker, args=(r, init, refdata, str(out)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
        assert not p.is_alive() and p.exitcode == 0
    cams = sorted(f[:-4] for f in os.listdir(out / "cam"))
    names = json.load(open(out / "names" / "refcoco_train_cam_name.json"))
    assert len(cams) > 3 and sorted(names) == cams and len(set(names)) == len(names)
    ranks = {int(n.split("_")[0]) % 2 for n in names}      # refs 0, 2, 4 and 1, 3, 5
    assert ranks == {0, 1}


class _StubRefs:
    """``n`` train refs; each example is its own index."""

    eval_mode = False

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def train_example(self, i: int, rng) -> dict:
        return {"index": np.int64(i)}


# the first three are the cases where the ranks' counts used to disagree with len(loader)
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("n_refs,world,batch", [(11, 2, 2), (9, 2, 2), (12, 5, 3), (10, 1, 3),
                                                (7, 3, 2), (2, 4, 1), (16, 4, 4), (5, 3, 8)])
def test_loader_ranks_yield_len_batches(n_refs, world, batch, drop_last):
    loaders = [Loader(_StubRefs(n_refs), batch, drop_last=drop_last, num_threads=1,
                      process_index=r, process_count=world) for r in range(world)]
    per_rank = [[b["index"] for b in ld.epoch(3)] for ld in loaders]
    assert [len(b) for b in per_rank] == [len(loaders[0])] * world
    assert all(len(x) == batch for b in per_rank for x in b[:-1])
    seen = np.concatenate([x for b in per_rank for x in b] or [np.zeros(0, np.int64)])
    if not drop_last:   # every ref on some rank; only the padding repeats one
        assert set(seen.tolist()) == set(range(n_refs))
        assert len(seen) == -(-n_refs // world) * world


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_one_process_keeps_its_order(drop_last):
    order = np.arange(11)
    np.random.default_rng(1234 + 2).shuffle(order)
    got = np.concatenate([b["index"] for b in Loader(_StubRefs(11), 4, drop_last=drop_last,
                                                      num_threads=1).epoch(2)])
    np.testing.assert_array_equal(got, order[:8] if drop_last else order)


def test_irn_pair_labels_take_one_threshold(monkeypatch):
    import importlib
    import inspect

    from tris_tpu_torch import kernels as K
    from tris_tpu_torch.pseudo import aug

    IL = importlib.import_module("tris_tpu_torch.kernels.irn_loss")

    assert inspect.signature(aug.affinity_labels_from_indices).parameters[
        "max_valid"].default == IL.MAX_VALID == 21
    # labels 0, 1, 2, 5 and 255: with the threshold at 3 the 5s are ignored as 255 is
    rng = np.random.default_rng(4)
    pi = PathIndex(5, (16, 16))
    rf = pi.radius_floor
    lab = rng.choice(np.array([0, 1, 2, 5, 255], np.uint8), (2, 16, 16))
    aff = torch.rand(2, len(pi.search_dst), 16 - rf, 16 - 2 * rf,
                     generator=torch.Generator().manual_seed(0))
    dp = torch.zeros(2, 2, 16, 16)
    for max_valid in (3, 21):
        monkeypatch.setattr(IL, "MAX_VALID", max_valid)
        _, counts = K.irn_loss(torch.from_numpy(lab), aff, dp, pi.search_dst, rf)
        want = np.zeros(3, np.int64)
        for dy, dx in np.asarray(pi.search_dst).tolist():
            a = lab[:, :16 - rf, rf:16 - rf]
            b = lab[:, dy:dy + 16 - rf, rf + dx:rf + dx + 16 - 2 * rf]
            valid = (a < max_valid) & (b < max_valid)
            want += [(valid & (a == b) & (a == 0)).sum(), (valid & (a == b) & (a > 0)).sum(),
                     (valid & (a != b)).sum()]
        np.testing.assert_array_equal(counts.numpy(), want)
        assert want.min() > 0
