"""Parity of the PyTorch port's IRNet passes 1 (CRF ir labels) and 2 (IRN
training) with the JAX package, on the CPU in float32, where the kernel
wrappers take their plain versions: the CRF, the augmentations, the
batches in both label feeds, the pair labels, the loss fields, the loss and
every head gradient (with a case of exact ties in the edge map), the
optimizer and its schedule over three steps, the mean-shift calibration,
and both passes end to end. Crop 64, radius 5, B=2; the JAX loss and its
gradient compile once for the module.

Bars: ir labels, augmentations, batches and pair labels exact (the same
draws, PIL calls and comparisons; the JAX package's own native CRF agrees
at >= 99.9 % of pixels); loss fields and losses within 1e-5 relative;
gradients within 1e-4 of each leaf's max (the port's GroupNorm eps patched
to flax's 1e-6, as tests/test_torch_irnet.py does); parameters after
optimizer steps within 1e-6 of each leaf's scale or 3e-5 of the lr
(optax rounds the poly schedule in float32, LambdaLR in float64); the
calibrated mean shift within 1e-5 of its scale.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict
from PIL import Image
from scipy import ndimage

from tests.fixtures import make_fake_refcoco
from tests.test_torch_irnet import _irnet_variables, _port_irnet
from tris_tpu.pseudo import aug as JA
from tris_tpu.pseudo import crf as JC
from tris_tpu.pseudo import labels as JL
from tris_tpu.pseudo import pipeline as JP
from tris_tpu.pseudo import train_irn as JT
from tris_tpu.pseudo.indexing import PathIndex as JPathIndex
from tris_tpu.pseudo.irnet import IRNet as JIRNet, affinity_displacement_losses as j_losses
from tris_tpu.pseudo.irnet import to_pair_displacement as j_pairs
from tris_tpu_torch import kernels
from tris_tpu_torch.ckpt.from_jax import irnet_grads_from_flax, irnet_state_dict_from_flax
from tris_tpu_torch.pseudo import aug as PA
from tris_tpu_torch.pseudo import labels as PL
from tris_tpu_torch.pseudo import pipeline as PP
from tris_tpu_torch.pseudo import train_irn as PT
from tris_tpu_torch.pseudo.indexing import PathIndex
from tris_tpu_torch.pseudo.irnet import affinity_displacement_losses, to_pair_displacement

torch.set_num_threads(2)

CROP, RADIUS, B = 64, 5, 2
IMG_HW = (56, 72)
N_NAMES = 3


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()
                 / max(float(np.abs(np.asarray(b)).max()), 1e-30))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Fake RefCOCO images (coloured rectangles on dim noise), CAMs peaking
    on a rectangle at the original size, the names json, and the port's ir
    labels (pass 1, one process)."""
    root = tmp_path_factory.mktemp("irn")
    make_fake_refcoco(str(root), n_images=N_NAMES, img_hw=IMG_HW, learnable=True)
    names = [f"{i}_{i + 1}" for i in range(N_NAMES)]
    (root / "cam").mkdir()
    yy, xx = np.mgrid[:IMG_HW[0], :IMG_HW[1]]
    for i, name in enumerate(names):
        cy, cx = 12 + 8 * (i % 2), 11 + 20 * (i % 2)
        cam = np.exp(-0.5 * (((yy - cy) / 9.0) ** 2 + ((xx - cx) / 11.0) ** 2))
        np.save(root / "cam" / f"{name}.npy", cam.astype(np.float32))
    (root / "names.json").write_text(json.dumps(names))
    common = dict(train_list=str(root / "names.json"), data_root=str(root / "train2014"),
                  cam_dir=str(root / "cam"), ir_label_dir=str(root / "ir_label"),
                  crop_size=CROP, radius=RADIUS, num_workers=2)
    PP.run_cam_to_ir_label(PP.PseudoConfig(**common), parallel=False)
    return root, names, common


@pytest.fixture(autouse=True)
def _pil_decode(monkeypatch):
    # both packages decode with PIL (the JAX one takes its native decoder where built)
    monkeypatch.setenv("TRIS_NATIVE_DECODE", "0")


@pytest.fixture(scope="module")
def jax_irn():
    """The JAX IRNet, its variables, the port's IRNet on the same weights
    (GroupNorm eps 1e-6), the path indices, and the JAX loss and gradient
    compiled once for the device-label feed."""
    jm, v = _irnet_variables(0, dp_scale=8.0)
    jpi = JPathIndex(RADIUS, (CROP // 4, CROP // 4))
    fn = jax.jit(jax.value_and_grad(
        lambda params, stats, batch: JT.irn_loss(params, stats, jm, jpi, batch), has_aux=True))
    return jm, v, jpi, PathIndex(RADIUS, (CROP // 4, CROP // 4)), fn


def _batches(data, labels="device", epochs=1, seed=3):
    root, names, common = data
    pi = PathIndex(RADIUS, (CROP // 4, CROP // 4))
    return list(PP.irn_train_batches(PP.PseudoConfig(**common), names, pi, B, epochs, seed=seed,
                                     num_threads=2, labels=labels))


def _port_loss_grads(model, pi, batch):
    model.zero_grad(set_to_none=True)
    metrics = PT.irn_loss(model, pi, PT.batch_to_device(batch, "cpu"))
    metrics["loss"].backward()
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {n: p.grad.clone() for n, p in model.named_parameters() if p.requires_grad})


def _trainable(model):
    PT.make_irn_optimizer(model, PT.IRNTrainConfig(crop_size=CROP, radius=RADIUS), 1)
    return model


# ---- pass 1: the CRF --------------------------------------------------------------------


def test_cam_to_ir_label_matches_jax(data, monkeypatch):
    # exact against the JAX package's numpy lattice; >= 99.9 % against its
    # native C++ lattice (the same algorithm, rounded in another order)
    root, names, common = data
    for name in names:
        img = np.asarray(Image.open(PP.image_path(PP.PseudoConfig(**common), name)))
        cam = np.load(root / "cam" / f"{name}.npy")
        got = PL.cam_to_ir_label(img, cam)
        native = JL.cam_to_ir_label(img, cam)
        with monkeypatch.context() as m:
            m.setattr(JC, "_native", lambda: None)
            want = JL.cam_to_ir_label(img, cam)
        assert got.dtype == np.uint8 and set(np.unique(got)) <= {0, 1, 255}
        np.testing.assert_array_equal(got, want)
        assert (got == native).mean() >= 0.999
        assert len(np.unique(got)) >= 2


def test_run_cam_to_ir_label_matches_jax(data, tmp_path, monkeypatch):
    # the pass in two worker processes against the JAX pass in one; PNGs equal
    root, names, common = data
    monkeypatch.setattr(JC, "_native", lambda: None)
    cfg = dict(common, ir_label_dir=str(tmp_path / "port"))
    PP.run_cam_to_ir_label(PP.PseudoConfig(**cfg))
    JP.run_cam_to_ir_label(JP.PseudoConfig(**dict(common, ir_label_dir=str(tmp_path / "jax"))),
                           parallel=False)
    for name in names:
        a = np.asarray(Image.open(tmp_path / "port" / f"{name}.png"))
        np.testing.assert_array_equal(a, np.asarray(Image.open(tmp_path / "jax" / f"{name}.png")))
        np.testing.assert_array_equal(a, np.asarray(Image.open(root / "ir_label" / f"{name}.png")))


# ---- the augmentations and the batches ---------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_augmentations_match_jax(seed):
    # the same draws from the same Generator: exact, crops larger and smaller
    # than the image
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (40 + 9 * seed, 70 - 11 * seed, 3), dtype=np.uint8)
    lab = rng.choice(np.array([0, 1, 255], np.uint8), img.shape[:2])
    outs = []
    for mod in (PA, JA):
        r = np.random.default_rng(100 + seed)
        i, l = mod.random_scale_pair(img, lab, (0.5, 1.5), r)
        i, l = mod.random_lr_flip_pair(i, l, r)
        i, l = mod.random_crop_pair(i, l, 48, r)
        outs.append((i, l, mod.top_left_crop(img, 48, 0), mod.pil_rescale(l, 0.25, 0)))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    pi = PathIndex(RADIUS, (12, 12))
    reduced = outs[0][3]
    for a, b in zip(PA.affinity_labels_from_indices(reduced, pi.src_indices, pi.dst_indices),
                    JA.affinity_labels_from_indices(reduced, pi.src_indices, pi.dst_indices)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("labels", ["device", "host"])
def test_irn_train_batches_match_jax(data, labels):
    # two epochs of 3 names at B=2 (the short batch wraps), two threads: exact
    root, names, common = data
    got = _batches(data, labels, epochs=2)
    jpi = JPathIndex(RADIUS, (CROP // 4, CROP // 4))
    want = list(JP.irn_train_batches(JP.PseudoConfig(**common), names, jpi, B, 2, seed=3,
                                     num_threads=1, labels=labels))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert got[0]["image"].shape == (B, CROP, CROP, 3)


def test_affinity_labels_on_device_match_host(data):
    # the port's static-window build against the host build and JAX's device build
    batch = _batches(data)[0]
    pi = PathIndex(RADIUS, (CROP // 4, CROP // 4))
    got = PT.affinity_labels_on_device(torch.from_numpy(batch["reduced_label"]), pi)
    jpi = JPathIndex(RADIUS, (CROP // 4, CROP // 4))
    want = JT.affinity_labels_on_device(jnp.asarray(batch["reduced_label"]), jpi)
    for b in range(B):
        host = PA.affinity_labels_from_indices(batch["reduced_label"][b], pi.src_indices,
                                               pi.dst_indices)
        for g, w, h in zip(got, want, host):
            np.testing.assert_array_equal(g[b].numpy(), h)
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w)[b])
    assert all(float(m.sum()) > 0 for m in got)


# ---- the losses and the gradients ---------------------------------------------------------


def test_affinity_displacement_losses_match_jax():
    # the four loss fields on random heads' outputs, within 1e-5 relative
    rng = np.random.default_rng(5)
    edge = rng.standard_normal((B, 1, 16, 16)).astype(np.float32)
    dp = (3 * rng.standard_normal((B, 2, 16, 16))).astype(np.float32)
    jpi, pi = JPathIndex(RADIUS, (16, 16)), PathIndex(RADIUS, (16, 16))
    want = jax.jit(lambda e, d: j_losses(e, d, jpi))(jnp.asarray(edge.transpose(0, 2, 3, 1)),
                                                     jnp.asarray(dp.transpose(0, 2, 3, 1)))
    got = affinity_displacement_losses(torch.from_numpy(edge), torch.from_numpy(dp), pi)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), np.asarray(w)) <= 1e-5
    # the pair displacement alone: a difference of the same two values, exact
    pair = to_pair_displacement(torch.from_numpy(dp), pi)
    np.testing.assert_array_equal(pair.numpy(), np.asarray(
        j_pairs(jnp.asarray(dp.transpose(0, 2, 3, 1)), jpi)))


def _tied(v):
    """The variables with fc_edge6's weights on the taps of x1-x3 zeroed: the
    edge map is then a function of the x4 taps of x4 and x5, whose first and
    last two rows and columns are copies (the upsample clamps there), so
    paths through them tie exactly."""
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    params = jax.tree_util.tree_map(np.array, params)
    params["fc_edge6"]["kernel"][..., :96, :] = 0.0
    return {**v, "params": params}


@pytest.mark.parametrize("ties", [False, True], ids=["random", "planted_ties"])
def test_irn_loss_and_gradients_match_jax(data, jax_irn, ties):
    # the loss terms within 1e-5 relative and every head gradient within
    # 1e-4 of its leaf's max, on the device-label feed; the host-mask feed
    # gives the port the same loss and gradients
    jm, v, jpi, pi, fn = jax_irn
    v = _tied(v) if ties else v
    batch = _batches(data)[0]
    (_, want_m), want_g = fn(v["params"], v["batch_stats"], batch)
    model = _trainable(_port_irnet(v, 1e-6))
    got_m, got_g = _port_loss_grads(model, pi, batch)
    for k in ("loss", "pos_aff", "neg_aff", "dp_fg", "dp_bg"):
        assert abs(got_m[k] - float(want_m[k])) <= 1e-5 * abs(float(want_m[k])), k
    want_g = irnet_grads_from_flax(want_g)
    assert set(got_g) == {k for k in want_g if not k.startswith("resnet50")}
    for k, g in got_g.items():
        w = want_g[k].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-30), k
        if not (ties and k.startswith(("fc_edge1", "fc_edge2", "fc_edge3"))):
            assert float(g.abs().max()) > 0, k
    if ties:  # the edge map really ties along paths, and the split was exercised
        with torch.no_grad():
            edge = torch.sigmoid(model(PT.batch_to_device(batch, "cpu")["image"])[0][:, 0])
        win = [torch.stack([edge[:, dy:dy + 12, 4 + dx:4 + dx + 8] for dy, dx in path])
               for path in kernels.path_max.path_steps(pi.paths_by_length)]
        n_tied = sum(int(((w == w.amax(0)).sum(0) > 1).sum()) for w in win)
        assert n_tied >= 100
    host = _batches(data, "host")[0]
    model.zero_grad(set_to_none=True)
    host_m, host_g = _port_loss_grads(model, pi, host)
    for k in got_m:
        assert abs(host_m[k] - got_m[k]) <= 1e-6 * abs(got_m[k]), k
    for k in got_g:
        assert torch.allclose(host_g[k], got_g[k], rtol=0, atol=1e-6 * float(got_g[k].abs().max()))


def _jax_tx(v, lr, max_step):
    cfg = JT.IRNTrainConfig(crop_size=CROP, radius=RADIUS, lr=lr)
    tx = JT.make_irn_optimizer(v["params"], cfg, max_step)
    return tx, jax.jit(lambda g, s, p: (lambda u: (optax.apply_updates(p, u[0]), u[1]))(
        tx.update(g, s, p)))


def _assert_params_close(model, params, lr, what):
    want = irnet_state_dict_from_flax({"params": params,
                                       "batch_stats": {"mean_shift": np.zeros(2)}})
    for k, p in model.named_parameters():
        if not p.requires_grad:
            continue
        w = want[k].numpy()
        bar = max(1e-6 * np.abs(w).max(), 3e-5 * lr * (10 if k.startswith("fc_dp") else 1))
        assert np.abs(p.detach().numpy() - w).max() <= bar, (what, k)


def test_sgd_steps_match_optax(data, jax_irn):
    # three steps at lr 0.1 with the schedule ending at the third, fed the
    # same gradients (JAX's, at JAX's parameters): torch's SGD groups and
    # LambdaLR move every head parameter as optax's multi_transform does,
    # and the trunk not at all. Real steps on each side's own gradients are
    # no bar beyond the first: sign() in the displacement loss and the path
    # max's argmax flip on rounding-level differences of near-flat fields
    # (measured here: step 2's gradients 4.8e-3 of a leaf's max apart after
    # step 1's 3.8e-6)
    jm, v, jpi, pi, fn = jax_irn
    lr, n_steps = 0.1, 3
    batches = _batches(data, epochs=2)[:n_steps]
    tx, update = _jax_tx(v, lr, n_steps)
    model = _port_irnet(v, 1e-6)
    opt, sched = PT.make_irn_optimizer(model, PT.IRNTrainConfig(crop_size=CROP, radius=RADIUS,
                                                                lr=lr), n_steps)
    params, state = v["params"], tx.init(v["params"])
    for i, batch in enumerate(batches):
        _, grads = fn(params, v["batch_stats"], batch)
        opt.zero_grad(set_to_none=True)
        tg = irnet_grads_from_flax(grads)
        for k, p in model.named_parameters():
            if p.requires_grad:
                p.grad = tg[k].clone()
        opt.step()
        sched.step()
        params, state = update(grads, state, params)
        _assert_params_close(model, params, lr, f"step {i + 1}")
    assert sched.get_last_lr() == [0.0, 0.0]
    trunk = flatten_dict(params["trunk"])
    np.testing.assert_array_equal(model.state_dict()["resnet50.conv1.weight"].numpy(),
                                  np.asarray(trunk[("conv1", "kernel")]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(np.asarray(trunk[("conv1", "kernel")]),
                                  flatten_dict(v["params"]["trunk"])[("conv1", "kernel")])


def test_calibrate_mean_shift_matches_jax(data, jax_irn):
    # the top-left-cropped images of each full batch: the mean shift within
    # 1e-5 of its scale; no full batch raises in both packages
    root, names, common = data
    jm, v, jpi, pi, fn = jax_irn
    cfg = PP.PseudoConfig(**common)
    images = list(PP.calibration_images(cfg, names, B))
    assert len(images) == N_NAMES // B and images[0].shape == (B, CROP, CROP, 3)
    model = PT.calibrate_mean_shift(_port_irnet(v, 1e-6),
                                    [torch.from_numpy(x).permute(0, 3, 1, 2) for x in images])
    want = JT.calibrate_mean_shift(jm, v, [{"image": jnp.asarray(x)} for x in images])
    w = np.asarray(want["batch_stats"]["mean_shift"])
    got = model.mean_shift.running_mean.numpy()
    assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max()
    with pytest.raises(ValueError):
        PT.calibrate_mean_shift(model, [])
    with pytest.raises(ValueError):
        JT.calibrate_mean_shift(jm, v, [])


# ---- pass 2 end to end --------------------------------------------------------------------


def test_run_train_irn_matches_jax(data, jax_irn, tmp_path, monkeypatch):
    # both passes from the same weights on the same batch (the JAX pass's
    # init and step patched to this module's compiled loss: its optimizer,
    # batches and calibration are its own): one step, as multi-step parity
    # is chaotic (test_sgd_steps_match_optax), then the calibration; the
    # saved .pth loads into the port's IRNet and equals the JAX pass's
    # variables within the bars above
    root, names, common = data
    names = names[:B]
    jm, v, jpi, pi, fn = jax_irn
    lr, epochs = 0.1, 1
    monkeypatch.setattr(JIRNet, "init", lambda self, *a, **k: v)

    def make_step(model, path_index, donate=True):
        def step(state, batch):
            host = jax.tree_util.tree_map(np.asarray, (state.params, state.batch_stats, batch))
            (_, metrics), grads = fn(*host)
            updates, opt_state = state.tx.update(grads, state.opt_state, state.params)
            return state.replace(step=state.step + 1, params=optax.apply_updates(state.params,
                                                                                updates),
                                 opt_state=opt_state), metrics
        return step

    monkeypatch.setattr(JT, "make_irn_train_step", make_step)
    jcfg = JP.PseudoConfig(**dict(common, irn_weights=str(tmp_path / "irn.msgpack")))
    want = JP.run_train_irn(jcfg, names, epochs=epochs, batch_size=B, lr=lr, log=lambda *a: None)
    cfg = PP.PseudoConfig(**dict(common, irn_weights=str(tmp_path / "irn.pth")))
    got = PP.run_train_irn(cfg, names, epochs=epochs, batch_size=B, lr=lr, log=lambda *a: None,
                           device="cpu", model=_port_irnet(v, 1e-6))
    loaded = _port_irnet(v, 1e-6)
    loaded.load_state_dict(torch.load(tmp_path / "irn.pth"), strict=True)
    for k, t in got.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], t), k
    _trainable(loaded)
    _assert_params_close(loaded, jax.tree_util.tree_map(np.asarray, want["params"]), lr, "pass")
    w = np.asarray(want["batch_stats"]["mean_shift"])
    assert np.abs(got.mean_shift.running_mean.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    assert float(np.abs(w).max()) > 0


def test_run_train_irn_needs_a_full_calibration_batch(data, tmp_path):
    # fewer names than the batch: the calibration has no batch and raises,
    # as the JAX pass's np.stack([]) does
    root, names, common = data
    cfg = PP.PseudoConfig(**dict(common, irn_weights=str(tmp_path / "irn.pth")))
    with pytest.raises(ValueError, match="need at least one array"):
        PP.run_train_irn(cfg, names[:1], epochs=1, batch_size=B, device="cpu",
                         log=lambda *a: None)
    assert not os.path.exists(tmp_path / "irn.pth")


def test_ir_labels_feed_the_trainer(data):
    # the pass-1 PNGs hold {0, 1, 255} and give the batches all three pair masks
    root, names, common = data
    for name in names:
        lab = np.asarray(Image.open(root / "ir_label" / f"{name}.png"))
        assert lab.shape == IMG_HW and set(np.unique(lab)) <= {0, 1, 255}
    host = _batches(data, "host")[0]
    assert all(host[k].sum() > 0 for k in ("aff_bg_pos", "aff_fg_pos", "aff_neg"))
    labels = ndimage.label(host["aff_fg_pos"][0].sum(0) > 0)[1]
    assert labels >= 1
