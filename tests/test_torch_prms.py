"""Parity of the PyTorch port's PRMS slice with the JAX package, on the CPU in
float32 (the kernel wrappers take their plain versions there): the ViT
critic, its key layout, K5's and K6's plain versions, ``make_prms_forward``,
``validate_prms`` end to end on the fake RefCOCO fixture, and the CLI.

The stage-1 size (96) differs from the tiny critic's resolution (64), so K5
really resizes: at equal sizes the JAX resize returns its input unchanged.
"""

import dataclasses
import json
import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from tests.fixtures import make_fake_refcoco
from tests.helpers import TINY_VIT_CLIP
from tests.test_torch_models import TINY, make_inputs, make_stage1_pair, randomize_norms
from tris_tpu.ckpt.convert import convert_clip_state_dict
from tris_tpu.data.dataset import Loader as JLoader, ReferSegDataset as JDataset
from tris_tpu.eval.validate import make_prms_forward as j_make_prms_forward
from tris_tpu.eval.validate import validate_prms as j_validate_prms
from tris_tpu.models.clip import CLIP as JCLIP
from tris_tpu.ops.normalize import image_input_to_f32 as j_u8
from tris_tpu.ops.resize import bilinear_resize as j_resize
from tris_tpu_torch import kernels
from tris_tpu_torch.ckpt.from_jax import state_dict_from_flax
from tris_tpu_torch.cli import validate as cli_validate
from tris_tpu_torch.config import get_parser
from tris_tpu_torch.data.dataset import Loader, ReferSegDataset
from tris_tpu_torch.eval.validate import (
    _names_of_all_processes,
    image_to_nchw,
    make_prms_forward,
    validate_prms,
)
from tris_tpu_torch.models import clip as clip_mod
from tris_tpu_torch.models.clip import CLIP, CLIPConfig

torch.set_num_threads(2)

TINY_VIT = CLIPConfig(**dataclasses.asdict(TINY_VIT_CLIP))
SIZE = 96  # stage-1 input; the critic's is TINY_VIT_CLIP.image_resolution = 64


def make_critic_pair(seed: int = 5):
    """(JAX ViT CLIP, its variables, the port's CLIP with the same weights)."""
    jc = JCLIP(TINY_VIT_CLIP)
    res = TINY_VIT_CLIP.image_resolution
    v = jax.jit(lambda k: jc.init(k, jnp.zeros((1, res, res, 3)), jnp.ones((1, 20), jnp.int32)))(
        jax.random.PRNGKey(seed))
    v = randomize_norms(jax.tree_util.tree_map(np.asarray, v), seed)
    tc = CLIP(TINY_VIT).eval()
    tc.load_state_dict(state_dict_from_flax(v), strict=True)
    return jc, v, tc


@pytest.fixture(scope="module")
def critic():
    return make_critic_pair()


@pytest.fixture(scope="module")
def stage1():
    return make_stage1_pair()


def test_clip_vit_encoders(critic):
    # 1e-4: the bar of the ResNet towers' test (2 ViT and 2 text blocks, f32)
    jc, v, tc = critic
    img, ids = make_inputs(3, 1, size=TINY_VIT_CLIP.image_resolution, seed=2)
    want_img = jax.jit(lambda v, x: jc.apply(v, x, method="encode_image"))(v, img)
    want_seq, want_eot = jax.jit(lambda v, t: jc.apply(v, t, method="encode_text"))(v, ids[:, 0])
    x = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        got_img = tc.encode_image(x)
        got_seq, got_eot = tc.encode_text(torch.from_numpy(ids[:, 0]))
        # forward_patches is the same tower fed the patch matrix K5 writes
        assert torch.equal(tc.visual.forward_patches(tc.visual.conv1.patchify(x)), got_img)
    assert got_img.shape == (3, TINY_VIT_CLIP.embed_dim)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_seq.numpy(), np.asarray(want_seq), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_eot.numpy(), np.asarray(want_eot), rtol=1e-4, atol=1e-4)


def test_clip_vit_state_dict_round_trip(critic):
    # the port's ViT keys are the reference CLIP's (visual.conv1.weight OIHW,
    # class_embedding, positional_embedding, ln_pre/post, proj): the JAX
    # package's converter maps them back onto the flax variables exactly
    _, v, tc = critic
    sd = tc.state_dict()
    assert tuple(sd["visual.conv1.weight"].shape) == (64, 3, 16, 16)
    assert "visual.conv1.bias" not in sd
    back = convert_clip_state_dict({k: t.numpy() for k, t in sd.items()})
    a, b = flatten_dict(back), flatten_dict(v)
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


@pytest.mark.parametrize("size", [SIZE, 64])
def test_critic_input_plain_matches_jax(size):
    # K5's plain version against JAX's to224 + product + PatchEmbed's
    # space-to-depth (columns (py, px, c) there, (c, py, px) here), within
    # 1e-6 of the scale: taps against matrix products at HIGHEST. At 64 -> 64
    # the JAX resize is the identity, and so must the taps be.
    B, S, n, ps = 2, 3, TINY_VIT_CLIP.image_resolution, TINY_VIT_CLIP.vision_patch_size
    rng = np.random.default_rng(3)
    cams = np.maximum(rng.standard_normal((B * S, size, size)), 0).astype(np.float32)
    img = rng.standard_normal((B, 3, size, size)).astype(np.float32)
    got = kernels.critic_input(torch.from_numpy(cams), torch.from_numpy(img), S, n, ps).numpy()
    fg = (j_resize(jnp.asarray(cams)[:, None], (n, n), align_corners=True)
          * jnp.repeat(j_resize(jnp.asarray(img), (n, n), align_corners=True), S, axis=0))
    g = n // ps
    want = np.asarray(fg).reshape(B * S, 3, g, ps, g, ps).transpose(0, 2, 4, 1, 3, 5)
    want = want.reshape(B * S * g * g, 3 * ps * ps)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    if size == n:
        np.testing.assert_array_equal(got, want)


def test_normalize_u8_nchw_plain_matches_jax():
    # 1e-6 absolute: one multiply and one add per value, which XLA on the CPU
    # may fuse into one FMA (an ulp); the f32 feed only changes its layout
    rng = np.random.default_rng(4)
    u8 = rng.integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    got = image_to_nchw(torch.from_numpy(u8))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 5, 7)
    want = np.asarray(j_u8(jnp.asarray(u8))).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    f32 = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    assert torch.equal(image_to_nchw(torch.from_numpy(f32)),
                       torch.from_numpy(f32).permute(0, 3, 1, 2))


def test_make_prms_forward_matches_jax(stage1, critic):
    # 2 refs x 3 sentence slots, the second ref with one padded slot: scores
    # within 1e-4, the invalid slot at -inf, best equal wherever the top two
    # scores are more than 1e-3 apart, maps within 1e-4 of their scale
    jm, v, tm = stage1
    jc, cv, tc = critic
    img, ids = make_inputs(2, 3, size=SIZE, seed=6)
    valid = np.array([[True, True, True], [True, True, False]])
    j_best, j_cams, j_scores = (np.asarray(a) for a in j_make_prms_forward(jm, jc)(
        v, cv, jnp.asarray(img), jnp.asarray(ids), jnp.asarray(valid)))
    with torch.no_grad():
        best, cams, scores = (t.numpy() for t in make_prms_forward(tm, tc)(img, ids, valid))
    assert cams.shape == (2, 3, SIZE, SIZE) and scores.shape == (2, 3)
    assert np.isneginf(scores[1, 2]) and np.isneginf(j_scores[1, 2])
    np.testing.assert_allclose(scores[valid], j_scores[valid], rtol=1e-4, atol=1e-4)
    top2 = np.sort(np.where(valid, j_scores, -1e9), axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-3
    assert clear.any()
    np.testing.assert_array_equal(best[clear], j_best[clear])
    np.testing.assert_allclose(cams, j_cams, rtol=1e-4, atol=1e-4 * np.abs(j_cams).max())


@pytest.fixture(scope="module")
def refdata(tmp_path_factory):
    root, _ = make_fake_refcoco(str(tmp_path_factory.mktemp("refdata")))
    return root


@pytest.mark.parametrize("device_resize,u8", [(True, False), (False, False), (True, True)])
def test_validate_prms_matches_jax(refdata, stage1, critic, tmp_path, device_resize, u8):
    # the slice as a whole: 6 train refs x 2 sentences in batches of 4 (the
    # last one padded), shared weights, the f32 feed or the u8 feed (K6's
    # path). Metrics within 1e-4 absolute; the
    # same CAM files at the original size within 1e-5; in one process the
    # same names json as JAX's (over several processes the port gathers every
    # process's names and rank 0 alone writes them, where the JAX package
    # writes each process's own names from every process)
    jm, v, tm = stage1
    jc, cv, tc = critic
    jds = JDataset(refdata, split="train", size=SIZE, eval_mode=True, u8_images=u8)
    tds = ReferSegDataset(refdata, split="train", size=SIZE, eval_mode=True, u8_images=u8)
    dirs = {side: (str(tmp_path / side / "cam"), str(tmp_path / side / "names"))
            for side in ("jax", "port")}
    kw = dict(save_cam=True, device_resize=device_resize, host_threads=1)
    want = j_validate_prms(jm, jc, v, cv, JLoader(jds, 4, shuffle=False, drop_last=False,
                                                  num_threads=1),
                           cam_save_dir=dirs["jax"][0], name_save_dir=dirs["jax"][1], **kw)
    got = validate_prms(tm, tc, Loader(tds, 4, shuffle=False, drop_last=False, num_threads=1),
                        cam_save_dir=dirs["port"][0], name_save_dir=dirs["port"][1], **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    assert 0 < got["mIoU"] < 100

    def names(side):
        with open(os.path.join(dirs[side][1], "refcoco_train_names.json")) as f:
            return json.load(f)

    assert names("port") == names("jax") and len(names("port")) == 6
    assert sorted(os.listdir(dirs["port"][0])) == sorted(os.listdir(dirs["jax"][0]))
    for name in names("jax"):
        a = np.load(os.path.join(dirs["jax"][0], f"{name}.npy"))
        b = np.load(os.path.join(dirs["port"][0], f"{name}.npy"))
        assert b.shape == a.shape == (48, 64) and b.dtype == np.float32
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def _names_worker(rank: int, init: str, out_dir: str):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
    try:
        names, writer = _names_of_all_processes([f"{rank}_a", f"{rank}_b"])
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as f:
        json.dump({"names": names, "writer": writer}, f)


def test_names_json_gathers_every_process(tmp_path):
    # two gloo processes: each sees all four names, and rank 0 alone writes
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [ctx.Process(target=_names_worker, args=(r, init, str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
        assert not p.is_alive() and p.exitcode == 0
    out = [json.load(open(tmp_path / f"{r}.json")) for r in range(2)]
    for r in range(2):
        assert out[r]["names"] == ["0_a", "0_b", "1_a", "1_b"]
    assert [o["writer"] for o in out] == [True, False]
    assert _names_of_all_processes(["x"]) == (["x"], True)   # no group: as is


def test_cli_validate_prms_end_to_end(refdata, monkeypatch, tmp_path):
    # python -m tris_tpu_torch.cli.validate --prms --save_cam --device cpu on
    # tiny backbones, the critic read from a --critic_weights checkpoint that
    # the port saved itself (loaded strictly: the reference CLIP's keys)
    monkeypatch.setitem(clip_mod.CLIP_CONFIGS, "RN50", TINY)
    monkeypatch.setitem(clip_mod.CLIP_CONFIGS, "ViT-B-32", TINY_VIT)
    with torch.random.fork_rng():
        torch.manual_seed(11)
        saved = CLIP(TINY_VIT)
    weights = tmp_path / "ViT-B-32.pt"
    torch.save(saved.state_dict(), weights)
    built = {}
    build_critic = cli_validate.build_critic
    monkeypatch.setattr(cli_validate, "build_critic",
                        lambda args: built.setdefault("critic", build_critic(args)))
    cam_dir, name_dir = tmp_path / "cam", tmp_path / "names"
    args = get_parser().parse_args([
        "--dataset", "refcoco", "--splitBy", "unc", "--refer_data_root", refdata,
        "--size", str(SIZE), "--test_split", "train", "--prms", "--save_cam",
        "--cam_save_dir", str(cam_dir), "--name_save_dir", str(name_dir),
        "--eval_batch", "2", "--hidden_dim", "32", "--device", "cpu",
        "--critic_weights", str(weights), "--host_threads", "1",
    ])
    res = cli_validate.main(args)["train"]
    assert 0.0 <= res["mIoU"] <= 100.0
    for k, t in saved.state_dict().items():
        assert torch.equal(built["critic"].state_dict()[k], t), k
    names = json.load(open(name_dir / "refcoco_train_names.json"))
    assert len(names) == 6
    for n in names:
        assert np.load(cam_dir / f"{n}.npy").shape == (48, 64)
