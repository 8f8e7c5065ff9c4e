"""Parity of the PyTorch port's instance pseudo-mask pass (IRNet's
``make_ins_seg``) with the JAX package, on the CPU in float32, where the
kernel wrappers take their plain versions: ``PathIndex``, K7's path max,
K9's centroid refinement, K6's bilinear resize, K10's transition build and
its products, the random walk, IRNet and its inference head, the weight
layouts, the host clustering, the input stage, the pipelined pass end to
end and the CLI.

Tolerances: K7, K9, ``PathIndex`` and the input stage are exact; K6 within
1e-6 of the output's scale (taps against the JAX matrix products, whose
sums may fuse a multiply-add); K10's T within 1e-6 of its scale (its column
sums add in another order than JAX's) and its products within 4e-6 (they
sum in float64, JAX's in float32);
the walk within 1e-4 of its max and its labels at >= 99.9 % (eight
squarings amplify the transition's rounding); IRNet within a bar measured
here and stated at its test.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from flax.traverse_util import flatten_dict, unflatten_dict
from scipy import ndimage

from tests.fixtures import make_fake_refcoco
from tris_tpu.ckpt.convert_tris import convert_irnet_state_dict
from tris_tpu.ops.resize import bilinear_resize as j_resize
from tris_tpu.pseudo import indexing as J
from tris_tpu.pseudo import labels as JL
from tris_tpu.pseudo import pipeline as J_pipeline
from tris_tpu.pseudo.irnet import IRNet as JIRNet, edge_displacement_infer as j_infer
from tris_tpu.pseudo.pipeline import PseudoConfig as JConfig, run_make_ins_seg as j_run
from tris_tpu_torch import kernels
from tris_tpu_torch.ckpt.from_jax import irnet_state_dict_from_flax
from tris_tpu_torch.cli import irnet as cli_irnet
from tris_tpu_torch.pseudo import indexing as P
from tris_tpu_torch.pseudo import irnet as irnet_mod
from tris_tpu_torch.pseudo import labels as PL
from tris_tpu_torch.pseudo import pipeline as PL_pipeline
from tris_tpu_torch.pseudo.irnet import IRNet, edge_displacement_infer
from tris_tpu_torch.pseudo.pipeline import PseudoConfig, run_make_ins_seg

torch.set_num_threads(2)

IMG_HW = (62, 66)   # IRNet's test image, and the fake RefCOCO images of the pass


def _walk_labels(rw, thres=0.25):
    """What the pass reads of a walk: max-normalised, bg-thresholded argmax."""
    m = rw / max(rw.max(), 1e-12)
    return np.argmax(np.concatenate([np.full((1,) + rw.shape[1:], thres, np.float32), m], 0), 0)


def _walk_fixture(rng, H=48, W=40, n_maps=5):
    """A smooth edge map with structure and instance-masked score maps (the
    JAX package's walk fixture)."""
    edge = ndimage.gaussian_filter(rng.random((H, W)).astype(np.float32), 4)
    edge = (edge - edge.min()) / (edge.max() - edge.min() + 1e-9)
    x = (rng.random((n_maps, H, W)) * (rng.random((n_maps, 1, 1)) > 0.3)).astype(np.float32)
    return x, edge


def _smooth_field(seed, H=40, W=52, amp=3.0):
    rng = np.random.default_rng(seed)
    f = np.stack([ndimage.gaussian_filter(rng.standard_normal((H, W)), 3) for _ in range(2)])
    return (f / np.abs(f).max() * amp).astype(np.float32)


def _sink_field(h=17, w=19):
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    return np.stack([np.clip(8 - yy, -1, 1), np.clip(9 - xx, -1, 1)])


# ---- PathIndex and K7 ---------------------------------------------------------


@pytest.mark.parametrize("radius,size", [(5, (20, 24)), (10, (40, 44))])
def test_path_index_matches_jax(radius, size):
    a, b = J.PathIndex(radius, size), P.PathIndex(radius, size)
    assert b.radius_floor == a.radius_floor
    np.testing.assert_array_equal(b.search_dst, a.search_dst)
    np.testing.assert_array_equal(b.src_indices, a.src_indices)
    np.testing.assert_array_equal(b.dst_indices, a.dst_indices)
    assert len(b.paths_by_length) == len(a.paths_by_length)
    for x, y in zip(b.paths_by_length, a.paths_by_length):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(b.path_indices, a.path_indices):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("radius,shape", [(5, (29, 30)), (10, (2, 32, 36))])
def test_path_max_affinity_plain_matches_jax(radius, shape):
    # exact: a max and 1 - m. Radius 5 at the walk's padded edge map, radius
    # 10 batched as IRN training will read it
    rng = np.random.default_rng(radius)
    pi = J.PathIndex(radius, shape[-2:])
    edge = rng.random(shape).astype(np.float32)
    groups = jax.jit(lambda e: J.path_max_affinity_slices(e, pi))(jnp.asarray(edge))
    want = np.concatenate([np.asarray(g) for g in groups], axis=-2)
    got = kernels.path_max_affinity(torch.from_numpy(edge), pi.paths_by_length, pi.radius_floor)
    ch, cw = shape[-2] - pi.radius_floor, shape[-1] - 2 * pi.radius_floor
    assert got.shape == (*shape[:-2], len(pi.search_dst), ch, cw)
    np.testing.assert_array_equal(got.reshape(want.shape).numpy(), want)


# ---- K9 -------------------------------------------------------------------------


@pytest.mark.parametrize("field", ["smooth", "sink"])
def test_refine_centroids_plain_matches_jax(field):
    # exact int32 centroids after 300 steps on a smooth field (a few pixels
    # of displacement, as IRNet's) and on the sink of test_pseudo.py
    disp = _smooth_field(0) if field == "smooth" else _sink_field()
    want = np.asarray(JL._refine_centroids(jnp.asarray(disp)))
    got = PL.find_centroids_with_refinement(disp, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if field == "sink":
        assert (got[0] == 8).all() and (got[1] == 9).all()


def _centroid_steps(disp, iterations, fma=None):
    """The JAX package's centroid loop in numpy float32, each operation
    rounded alone; with ``fma``, the three multiply-adds of the term sum
    fused as XLA's CPU backend fuses them (LLVM's FPOpFusion::Fast)."""
    H, W = disp.shape[1:]
    cy = np.broadcast_to(np.arange(H, dtype=np.float32)[:, None], (H, W)).copy()
    cx = np.broadcast_to(np.arange(W, dtype=np.float32)[None, :], (H, W)).copy()
    f = np.pad(disp.transpose(1, 2, 0), ((0, 1), (0, 1), (0, 0)), mode="edge")
    neigh = np.concatenate([f[:-1, :-1], f[:-1, 1:], f[1:, :-1], f[1:, 1:]], -1).reshape(H * W, 8)
    one = np.float32(1)
    for _ in range(iterations):
        iy, ix = np.floor(cy).astype(np.int32), np.floor(cx).astype(np.int32)
        yc = (cy - iy.astype(np.float32))[..., None]
        xc = (cx - ix.astype(np.float32))[..., None]
        n = neigh[(iy * W + ix).reshape(-1)].reshape(H, W, 8)
        m1, m2 = n[..., 6:8] * yc, n[..., 2:4] * (one - yc)
        m3, m4 = n[..., 4:6] * yc, n[..., 0:2] * (one - yc)
        if fma:
            v = fma(m4, one - xc, fma(m3, one - xc, fma(m1, xc, m2 * xc)))
        else:
            v = ((m1 * xc + m2 * xc) + m3 * (one - xc)) + m4 * (one - xc)
        cy = np.clip(cy + v[..., 0], np.float32(0), np.float32(H - 1))
        cx = np.clip(cx + v[..., 1], np.float32(0), np.float32(W - 1))
    return np.stack([np.round(cy), np.round(cx)]).astype(np.int32)


def test_refine_centroids_plain_is_the_reference_arithmetic_and_jax_fuses():
    # On a rough field the JAX package's CPU result departs from its own
    # term order: XLA's CPU backend fuses t1 + t2, + t3 and + t4 into FMAs.
    # The port (plain version and kernel) rounds each operation alone, as
    # the reference IRNet's numpy does; with the fusions emulated (float64
    # product and sum, rounded once), the same steps give JAX's centroids.
    disp = (np.random.default_rng(0).standard_normal((2, 30, 40)) * 2).astype(np.float32)
    got = kernels.refine_centroids(torch.from_numpy(disp)).numpy()
    np.testing.assert_array_equal(got, _centroid_steps(disp, 300))

    def fma(a, b, c):
        return (a.astype(np.float64) * b + c).astype(np.float32)

    np.testing.assert_array_equal(_centroid_steps(disp, 300, fma),
                                  np.asarray(JL._refine_centroids(jnp.asarray(disp))))


# ---- K6 and K10 -----------------------------------------------------------------


@pytest.mark.parametrize("size,align_corners", [((52, 68), False), ((7, 9), True),
                                                ((29, 31), False), ((30, 11), True),
                                                ((13, 40), False)])
def test_bilinear_resize_plain_matches_jax(size, align_corners):
    # x4 (the heads' and the walk's), shrinks to odd sizes (the CAM to the
    # grid), one axis unchanged; within 1e-6 of the output's scale
    x = np.random.default_rng(2).standard_normal((3, 2, 13, 17)).astype(np.float32)
    want = np.asarray(j_resize(jnp.asarray(x), size, align_corners))
    got = kernels.bilinear_resize(torch.from_numpy(x), size, align_corners).numpy()
    assert got.shape == want.shape == (3, 2, *size)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("H,W", [(32, 32), (12, 14), (12, 8)])
def test_walk_transition_plain_matches_jax_dense_prefix(H, W):
    # the JAX dense prefix (band -> dense -> pow -> column sums) within 1e-6
    # of T's scale; at W = 8 directions share a flat offset and add
    rng = np.random.default_rng(H + W)
    pi = J._padded_path_index(5, (H + 5, W + 10))
    rf = pi.radius_floor
    dirs = np.asarray(pi.search_dst, np.int64)
    grids = rng.random((len(dirs), H + 5 - rf, W + 10 - 2 * rf)).astype(np.float32)

    @jax.jit
    def prefix(g):
        scaled = jnp.power(J._banded_dense_affinity(g, dirs, H, W, 5 - rf), 10.0)
        return scaled / scaled.sum(axis=0, keepdims=True)

    want = np.asarray(prefix(jnp.asarray(grids)))
    got = kernels.walk_transition(torch.from_numpy(grids), dirs, H, W, 5 - rf, 10.0).numpy()
    assert got.shape == (H * W, H * W)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("squarings", [1, 4])
def test_walk_matmul_plain_matches_jax_products(squarings):
    # K10's products: T's square after ``squarings - 1`` squarings and the
    # thin step, against JAX's float32 dot at HIGHEST, within 4e-6 of the
    # output's max: the port sums in float64, JAX in float32 (its sums of
    # 1024 terms measured 1.1e-6 off after 3 squarings); ``square`` with
    # T's band equals the dense squaring
    H, W = 32, 32
    rng = np.random.default_rng(squarings)
    pi = J._padded_path_index(5, (H + 5, W + 10))
    rf = pi.radius_floor
    dirs = np.asarray(pi.search_dst, np.int64)
    grids = rng.random((len(dirs), H + 5 - rf, W + 10 - 2 * rf)).astype(np.float32)
    t = kernels.walk_transition(torch.from_numpy(grids), dirs, H, W, 5 - rf, 10.0)
    t_in, band = P.square(t, squarings - 1, P.transition_band(5, W))
    got, band = P.square(t_in, 1, band)
    want = np.asarray(jnp.dot(jnp.asarray(t_in.numpy()), jnp.asarray(t_in.numpy()),
                              precision=jax.lax.Precision.HIGHEST))
    assert np.abs(got.numpy() - want).max() <= 4e-6 * np.abs(want).max()
    assert torch.equal(got, P.square(t_in, 1)[0])
    x = rng.random((3, H, W)).astype(np.float32)
    edge = rng.random((H, W)).astype(np.float32)
    rw = P.thin_step(torch.from_numpy(x), torch.from_numpy(edge), got, band).numpy()
    want = np.asarray(jnp.dot(jnp.asarray((x * (1 - edge)).reshape(3, -1)), jnp.asarray(got.numpy()),
                              precision=jax.lax.Precision.HIGHEST)).reshape(3, H, W)
    assert np.abs(rw - want).max() <= 4e-6 * np.abs(want).max()


# ---- the walk ---------------------------------------------------------------------


@pytest.mark.parametrize("case", ["12x14", "fixture48x40", "narrow12x8", "tiny6x10"])
def test_propagate_to_edge_matches_jax(case):
    # the reference formulation on both sides (f32, all squarings): rw within
    # 1e-4 of its max, labels >= 99.9 %. 12x14 at exp_times 4 as
    # test_pseudo.py; the fixture at 8; 12x8 shares band offsets; 6x10 is
    # too small for the band and takes the scatter build
    rng = np.random.default_rng(7)
    if case == "fixture48x40":
        (x, edge), exp_times = _walk_fixture(rng), 8
    else:
        H, W = {"12x14": (12, 14), "narrow12x8": (12, 8), "tiny6x10": (6, 10)}[case]
        x = rng.random((3, H, W)).astype(np.float32)
        edge = (rng.random((H, W)) * 0.9).astype(np.float32)
        exp_times = 4
    want = np.asarray(J.propagate_to_edge(x, edge, radius=5, beta=10.0, exp_times=exp_times,
                                          k_sq=exp_times, dtype="float32"))
    got = P.propagate_to_edge(torch.from_numpy(x), torch.from_numpy(edge), 5, 10.0,
                              exp_times).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert (_walk_labels(got) == _walk_labels(want)).mean() >= 0.999


def test_propagate_to_edge_bucketed_matches_jax():
    # 12x14 padded to the 32x32 bucket and 3 maps to 16, exp_times 8
    rng = np.random.default_rng(8)
    x = rng.random((3, 12, 14)).astype(np.float32)
    edge = (rng.random((12, 14)) * 0.9).astype(np.float32)
    want = np.asarray(J.propagate_to_edge_bucketed(x, edge))
    got = P.propagate_to_edge_bucketed(x, edge, device="cpu").numpy()
    assert got.shape == (3, 12, 14)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert (_walk_labels(got) == _walk_labels(want)).mean() >= 0.999


# ---- IRNet ---------------------------------------------------------------------------


def _irnet_variables(seed=0, dp_scale=1.0):
    """JAX IRNet variables: the init's kernels, GN scales and biases and BN
    statistics redrawn, a mean shift, the last displacement conv scaled."""
    model = JIRNet()
    v = jax.jit(lambda k: model.init(k, jnp.zeros((1, 64, 64, 3))))(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    out = {}
    for k, a in flatten_dict(jax.tree_util.tree_map(np.asarray, v)).items():
        a = np.asarray(a, np.float32)
        n = rng.standard_normal(a.shape).astype(np.float32)
        if k[-1] == "mean_shift":
            a = 0.3 * n
        elif k[0] == "batch_stats":
            a = 0.1 * n if k[-1] == "mean" else 1 + 0.2 * np.abs(n)
        elif k[-1] == "scale":
            a = 1 + 0.1 * n
        elif k[-1] == "bias":
            a = 0.1 * n
        elif k[-2] == "fc_dp7_conv2":
            a = a * dp_scale
        out[k] = a
    return model, unflatten_dict(out)


def _port_irnet(variables, gn_eps):
    model = IRNet()
    model.load_state_dict(irnet_state_dict_from_flax(variables), strict=True)
    for m in model.modules():
        if isinstance(m, torch.nn.GroupNorm):
            m.eps = gn_eps
    return model.eval()


@pytest.fixture(scope="module")
def irnet_pair():
    model, v = _irnet_variables(0, dp_scale=8.0)
    return model, v, _port_irnet(v, 1e-6)


def test_irnet_and_inference_head_match_jax(irnet_pair):
    # with the port's GroupNorm eps patched to flax's 1e-6: the edge within
    # 1e-6 and the displacement within 1e-5 of its scale (measured 1.8e-7
    # and 1.9e-6: f32 convolutions through 16 bottlenecks in another order,
    # and flax's GroupNorm variance is E[x^2] - E[x]^2 where torch's is two
    # passes)
    jm, v, tm = irnet_pair
    img = np.random.default_rng(3).standard_normal((*IMG_HW, 3)).astype(np.float32)
    want_e, want_d = (np.asarray(a) for a in j_infer(jm, v, jnp.asarray(img)))
    got_e, got_d = edge_displacement_infer(tm, torch.from_numpy(img))
    assert got_e.shape == want_e.shape == (16, 17) and got_d.shape == want_d.shape == (2, 16, 17)
    assert np.abs(got_e.numpy() - want_e).max() <= 1e-6
    assert np.abs(got_d.numpy() - want_d).max() <= 1e-5 * np.abs(want_d).max()


def test_irnet_groupnorm_eps_is_the_reference_torch_default(irnet_pair):
    # the intended divergence: the reference's nn.GroupNorm(groups, ch) has
    # eps 1e-5; the JAX package's flax GroupNorm 1e-6. The port keeps 1e-5,
    # and the outputs move measurably against the 1e-6 model
    _, v, tm = irnet_pair
    port = _port_irnet(v, irnet_mod.GN_EPS)
    eps = {m.eps for m in IRNet().modules() if isinstance(m, torch.nn.GroupNorm)}
    assert eps == {1e-5} and irnet_mod.GN_EPS == 1e-5
    x = np.random.default_rng(4).standard_normal((1, 3, *IMG_HW)).astype(np.float32)
    x = torch.from_numpy(x)
    with torch.no_grad():
        a, b = port(x), tm(x)
    assert float((a[1] - b[1]).abs().max()) > 0.0


def test_irnet_state_dict_layouts(irnet_pair, tmp_path):
    # the port's keys are the reference IRNet's: the JAX package's converter
    # (which raises on an unknown key) maps them back onto the flax variables
    # exactly; a reference-layout .pth with its alias keys loads strictly
    _, v, tm = irnet_pair
    sd = tm.state_dict()
    assert "resnet50.layer1.0.downsample.0.weight" in sd and "fc_dp7.3.weight" in sd
    assert "mean_shift.running_mean" in sd and "fc_edge6.bias" in sd
    back = convert_irnet_state_dict({k: t.numpy() for k, t in sd.items()})
    a, b = flatten_dict(back), flatten_dict(v)
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))
    ref = dict(sd)
    ref["fc_dp7.4.running_mean"] = sd["mean_shift.running_mean"]
    ref["stage1.0.weight"] = sd["resnet50.conv1.weight"]
    ref["stage1.1.running_mean"] = sd["resnet50.bn1.running_mean"]
    ref["stage2.0.conv1.weight"] = sd["resnet50.layer1.0.conv1.weight"]
    ref["edge_layers.0.0.weight"] = sd["fc_edge1.0.weight"]
    ref["dp_layers.0.0.weight"] = sd["fc_dp1.0.weight"]
    ref["backbone.0.weight"] = sd["resnet50.conv1.weight"]
    path = str(tmp_path / "res50_irn.pth")
    torch.save(ref, path)
    loaded = irnet_mod.load_irnet_weights(IRNet(), path)
    for k, t in sd.items():
        assert torch.equal(loaded.state_dict()[k], t), k
    with pytest.raises(SystemExit, match="torch checkpoints"):
        irnet_mod.load_irnet_weights(IRNet(), str(tmp_path / "irn.msgpack"))


# ---- the host clustering and the device half of the walk ----------------------------------


def test_cluster_centroids_and_detect_instance_match_jax():
    disp = _smooth_field(5, 24, 28, amp=4.0)
    cents = PL.find_centroids_with_refinement(disp, device="cpu")
    got = PL.cluster_centroids(cents, disp)
    want = JL.cluster_centroids(cents, disp)
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] >= 2
    rng = np.random.default_rng(6)
    score = rng.random((3, 20, 22)).astype(np.float32)
    masks = rng.random((3, 20, 22)) > 0.6
    masks[1] = False
    for frag in (0, 5):
        a = PL.detect_instance(score, masks, np.zeros(3, np.int64), frag)
        b = JL.detect_instance(score, masks, np.zeros(3, np.int64), frag)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_walk_upsample_argmax_matches_jax():
    # the CAM at 62x66 -> the 16x17 grid, 3 instances walked on the 32x32
    # bucket, x4 and cropped: rw_up within 1e-4 of its max, the argmax at
    # >= 99.9 % of pixels, and the host half's dicts. exp_times 4: at 8 both
    # float32 walks are 6e-5 to 7e-5 of the max from a float64 walk here and
    # 1.05e-4 apart; the walk's 8 squarings are test_propagate_to_edge's
    rng = np.random.default_rng(9)
    oh, ow = IMG_HW
    inst = np.zeros((3, 16, 17), bool)
    inst[0, :8], inst[1, 8:, :9], inst[2, 8:, 9:] = True, True, True
    cam = ndimage.gaussian_filter(rng.random((oh, ow)), 5).astype(np.float32)
    edge = ndimage.gaussian_filter(rng.random((16, 17)), 2).astype(np.float32)
    want_rw, want_shape = (np.asarray(a) for a in
                           JL.walk_upsample_argmax(inst, cam, edge, (oh, ow), exp_times=4))
    got_rw, got_shape = PL.walk_upsample_argmax(inst, cam, edge, (oh, ow), exp_times=4,
                                                device="cpu")
    got_rw, got_shape = got_rw.numpy(), got_shape.numpy()
    assert got_rw.shape == want_rw.shape == (3, oh, ow)
    assert np.abs(got_rw - want_rw).max() <= 1e-4
    assert (got_shape == want_shape).mean() >= 0.999
    a = PL.detect_from_walk(got_rw, got_shape, (oh, ow))
    b = JL.detect_from_walk(want_rw, want_shape, (oh, ow))
    assert sorted(a) == sorted(b) == ["cam", "class", "mask", "score"]


def test_make_instance_masks_matches_jax():
    # the serial API end to end on a smooth field of a few pixels: K9, the
    # clustering, the walk (4 squarings, as above), the detection
    rng = np.random.default_rng(12)
    disp = _smooth_field(14, 16, 17, amp=4.0)   # 4 instances
    edge = ndimage.gaussian_filter(rng.random((16, 17)), 2).astype(np.float32)
    cam = ndimage.gaussian_filter(rng.random(IMG_HW), 5).astype(np.float32)
    a = PL.make_instance_masks(edge, disp, cam, IMG_HW, exp_times=4, device="cpu")
    b = JL.make_instance_masks(edge, disp, cam, IMG_HW, exp_times=4)
    assert sorted(a) == sorted(b) == ["cam", "class", "mask", "score"]
    assert a["mask"].shape == b["mask"].shape and a["mask"].shape[0] >= 2
    assert (a["mask"] == b["mask"]).mean() >= 0.999
    assert np.abs(a["cam"] - b["cam"]).max() <= 1e-4
    np.testing.assert_allclose(a["score"], b["score"], atol=1e-4)


# ---- the pass and the CLI --------------------------------------------------------------------


def _ins_seg_data(root, n=3):
    """Fake RefCOCO images at IMG_HW, a names json of ``n`` of them and
    smooth CAMs at the original size."""
    make_fake_refcoco(str(root), n_images=n, img_hw=IMG_HW)
    names = [f"{i}_{i + 1}" for i in range(n)]
    cam_dir = root / "cam"
    cam_dir.mkdir()
    rng = np.random.default_rng(11)
    for name in names:
        cam = ndimage.gaussian_filter(rng.random(IMG_HW), 6)
        np.save(cam_dir / f"{name}.npy", ((cam - cam.min()) / np.ptp(cam)).astype(np.float32))
    (root / "names.json").write_text(json.dumps(names))
    return names


def _compare_ins_seg(dir_a, dir_b, names):
    for name in names:
        a = np.load(os.path.join(dir_a, f"{name}.npy"), allow_pickle=True).item()
        b = np.load(os.path.join(dir_b, f"{name}.npy"), allow_pickle=True).item()
        assert sorted(a) == sorted(b) == ["cam", "class", "mask", "score"], name
        assert a["cam"].shape == b["cam"].shape == (b["cam"].shape[0], *IMG_HW), name
        assert np.abs(a["cam"] - b["cam"]).max() <= 1e-4 * np.abs(b["cam"]).max(), name
        assert a["mask"].shape == b["mask"].shape, name
        assert (a["mask"] == b["mask"]).mean() >= 0.999, name
        np.testing.assert_array_equal(a["class"], b["class"])
        np.testing.assert_allclose(a["score"], b["score"], atol=1e-4 * np.abs(b["cam"]).max())


@pytest.mark.parametrize("scales", [(1.0,), (0.5,), (0.75, 1.0)])
def test_ins_seg_load_matches_jax(tmp_path, monkeypatch, scales):
    # the input stage: PIL decode, the first scale's bicubic rescale of the
    # raw image (aug.py's copy), then the normalisation; exact
    monkeypatch.setenv("TRIS_NATIVE_DECODE", "0")
    names = _ins_seg_data(tmp_path, n=1)
    common = dict(data_root=str(tmp_path / "train2014"), cam_dir=str(tmp_path / "cam"),
                  scales=scales)
    got = PL_pipeline._ins_seg_load(PseudoConfig(**common), names[0])
    want = J_pipeline._ins_seg_load(JConfig(**common), names[0])
    assert got[0] == want[0] and got[1] == want[1] == IMG_HW
    h, w = (int(np.round(s * scales[0])) for s in IMG_HW)
    assert got[2].shape == want[2].shape == (h, w, 3)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


def test_run_make_ins_seg_matches_jax(irnet_pair, tmp_path, monkeypatch):
    # both sides decode with PIL (the JAX package would take its native JPEG
    # decoder where built); the JAX pass on one device, unpipelined. With
    # these weights the third image splits into 2 instances and 8 fragments
    monkeypatch.setenv("TRIS_NATIVE_DECODE", "0")
    jm, v, tm = irnet_pair
    names = _ins_seg_data(tmp_path)
    common = dict(train_list=str(tmp_path / "names.json"), data_root=str(tmp_path / "train2014"),
                  cam_dir=str(tmp_path / "cam"), exp_times=3)
    j_run(JConfig(ins_seg_dir=str(tmp_path / "jax"), **common), variables=v, log=lambda *a: None,
          devices=jax.devices()[:1], num_shards=1, shard_idx=0, depth=0)
    run_make_ins_seg(PseudoConfig(ins_seg_dir=str(tmp_path / "port"), **common), model=tm,
                     log=lambda *a: None, device="cpu")
    assert sorted(os.listdir(tmp_path / "port")) == sorted(f"{n}.npy" for n in names)
    _compare_ins_seg(tmp_path / "port", tmp_path / "jax", names)


def test_cli_make_ins_seg_pass(irnet_pair, tmp_path):
    # --make_ins_seg_pass --device cpu with a .pth writes one dict npy per name
    names = _ins_seg_data(tmp_path, n=2)
    weights = tmp_path / "res50_irn.pth"
    torch.save(irnet_pair[2].state_dict(), weights)
    args = cli_irnet.get_irn_parser().parse_args([
        "--train_list", str(tmp_path / "names.json"), "--data_root", str(tmp_path / "train2014"),
        "--cam_dir", str(tmp_path / "cam"), "--ins_seg_out_dir", str(tmp_path / "ins_seg"),
        "--irn_weights", str(weights), "--exp_times", "3", "--make_ins_seg_pass",
        "--device", "cpu"])
    cli_irnet.main(args)
    for name in names:
        d = np.load(tmp_path / "ins_seg" / f"{name}.npy", allow_pickle=True).item()
        assert sorted(d) == ["cam", "class", "mask", "score"]
        assert d["mask"].shape[1:] == IMG_HW and d["mask"].dtype == bool


@pytest.mark.parametrize("passes", [["--cam_to_ir_label_pass"], ["--train_irn_pass"],
                                    ["--cam_to_ir_label_pass", "--train_irn_pass",
                                     "--make_ins_seg_pass"]],
                         ids=["cam_to_ir_label", "train_irn", "chain"])
def test_cli_passes(tmp_path, passes):
    # --device cpu at crop 64, radius 5, B=2, one epoch: the CRF pass writes
    # one {0, 1, 255} PNG per name (in a worker process), the training pass
    # a .pth that loads strictly into IRNet, and the chain the ins-seg dicts
    names = _ins_seg_data(tmp_path, n=3)
    ir_dir, weights = tmp_path / "ir_label", tmp_path / "out" / "res50_irn.pth"
    common = dict(train_list=str(tmp_path / "names.json"), data_root=str(tmp_path / "train2014"),
                  cam_dir=str(tmp_path / "cam"), ir_label_dir=str(ir_dir))
    if passes == ["--train_irn_pass"]:
        PL_pipeline.run_cam_to_ir_label(PseudoConfig(**common), parallel=False)
    args = cli_irnet.get_irn_parser().parse_args([
        "--train_list", common["train_list"], "--data_root", common["data_root"],
        "--cam_dir", common["cam_dir"], "--ir_label_out_dir", str(ir_dir),
        "--ins_seg_out_dir", str(tmp_path / "ins_seg"), "--irn_weights", str(weights),
        "--irn_crop_size", "64", "--irn_radius", "5", "--irn_batch_size", "2",
        "--irn_num_epoches", "1", "--exp_times", "3", "--num_workers", "1", "--device", "cpu",
        *passes])
    cli_irnet.main(args)
    for name in names:
        lab = np.asarray(Image.open(ir_dir / f"{name}.png"))
        assert lab.shape == IMG_HW and set(np.unique(lab)) <= {0, 1, 255}
    assert weights.exists() == ("--train_irn_pass" in passes)
    if weights.exists():
        model = irnet_mod.load_irnet_weights(IRNet(), str(weights))
        assert float(model.mean_shift.running_mean.abs().max()) > 0
    if "--make_ins_seg_pass" in passes:
        for name in names:
            d = np.load(tmp_path / "ins_seg" / f"{name}.npy", allow_pickle=True).item()
            assert sorted(d) == ["cam", "class", "mask", "score"]
            assert d["mask"].shape[1:] == IMG_HW
