"""DISN, CameraNet and their shared pieces in the port against the JAX
package on the CPU (fp32): one weight set (every JAX leaf redrawn from a
seed) carried across by ``convert.disn_state_dict`` / ``camnet_state_dict``,
the same numpy inputs, outputs within 5e-4.  Then the DISN ``Reconstructor``
against the JAX one on the JAX init's weights (redrawn ones make a field so
rough that fp32 rounding flips lattice cells): the same points evaluated and
the same mesh."""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from jax_weights import redraw
from slice3d_tpu import camera as jax_camera
from slice3d_tpu.convert import torch_import
from slice3d_tpu.data import Slice3DDataset as JaxDataset
from slice3d_tpu.data.builders import create_synthetic_dataset
from slice3d_tpu.models.build import init_variables
from slice3d_tpu.models.camnet import CameraNet as JaxCameraNet
from slice3d_tpu.models.camnet import camera_pose_loss as jax_pose_loss
from slice3d_tpu.models.camnet import rotation_from_ortho6d as jax_ortho6d
from slice3d_tpu.models.disn import DISNModel as JaxDISN
from slice3d_tpu.models.layers import MLP as JaxMLP
from slice3d_tpu.models.sdf_head import sample_slice_pyramids as jax_sample_pyramids
from slice3d_tpu.models.vgg import VGG16BNBackbone as JaxVGG
from slice3d_tpu.ops.grid_sample import grid_sample_2d as jax_grid_sample
from slice3d_tpu.pipeline import Reconstructor as JaxReconstructor
from slice3d_tpu_torch import camera
from slice3d_tpu_torch.convert import camnet_state_dict, disn_state_dict
from slice3d_tpu_torch.data.dataset import Slice3DDataset
from slice3d_tpu_torch.models.camnet import CameraNet, camera_pose_loss, rotation_from_ortho6d
from slice3d_tpu_torch.models.disn import DISNModel, global_pool_side
from slice3d_tpu_torch.models.sdf_head import relu_mlp, sample_slice_pyramids
from slice3d_tpu_torch.models.vgg import REF_ENCODER_BLOCKS, VGG16BNBackbone
from slice3d_tpu_torch.ops.grid_sample import grid_sample_2d
from slice3d_tpu_torch.pipeline import Reconstructor

ATOL = 5e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny torch ops in one thread: the test workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy() if hasattr(got, "detach") else got,
                               np.asarray(want), atol=atol, rtol=0)


def cams(n, seed=0):
    """n (full projection, rotation) pairs of random views."""
    rng = np.random.default_rng(seed)
    full, rot = [], []
    for _ in range(n):
        az, el, d = rng.uniform(-np.pi, np.pi), rng.uniform(-0.4, 0.4), rng.uniform(1.0, 1.4)
        full.append(jax_camera.full_projection_matrix(az, el, d))
        rot.append(jax_camera.camera_matrices(az, el, d)[0])
    return np.stack(full).astype(np.float32), np.stack(rot).astype(np.float32)


def test_rotation_from_ortho6d_matches_jax():
    poses = np.random.default_rng(0).normal(size=(7, 6)).astype(np.float32)
    got = rotation_from_ortho6d(t(poses))
    close(got, jax_ortho6d(jnp.asarray(poses)), atol=1e-6)
    for r in got.numpy():
        np.testing.assert_allclose(r.T @ r, np.eye(3), atol=1e-5)
        assert np.linalg.det(r) > 0.99


@pytest.mark.parametrize("img", [32, 64])
def test_camnet_matches_jax(img):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, img, img, 3)).astype(np.float32)
    jmodel = JaxCameraNet()
    variables = redraw(jmodel.init(jax.random.PRNGKey(0), x), seed=2)
    want = jmodel.apply(variables, x)
    model = CameraNet(img).eval()
    model.load_state_dict(camnet_state_dict(variables))
    with torch.no_grad():
        got = model(t(x))
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k])
    assert ((got["distance_ratio"] >= 0.7) & (got["distance_ratio"] <= 1.05)).all()

    pcd = rng.uniform(-0.5, 0.5, (2, 64, 3)).astype(np.float32)
    regress = np.stack([jax_camera.camera_matrices(0.3 * i, 0.1, 1.2)[1]
                        for i in range(2)]).astype(np.float32)
    norm = np.stack([np.diag(rng.uniform(0.8, 1.2, 4)) for _ in range(2)]).astype(np.float32)
    k = np.stack([jax_camera.intrinsics()] * 2).astype(np.float32)
    loss, pred = camera_pose_loss(got["pred_RT_inv"], t(pcd), t(regress), t(norm), t(k))
    w_loss, w_pred = jax_pose_loss(want["pred_RT_inv"], pcd, regress, norm, k)
    assert float(loss) == pytest.approx(float(w_loss), rel=1e-5)
    close(pred, w_pred)


@pytest.mark.parametrize("img", [32, 96])
def test_disn_matches_jax(img):
    """img 96: a 3x3 global map, which the JAX rule leaves unpooled."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, img, img, 3)).astype(np.float32)
    qry = rng.uniform(-0.5, 0.5, (2, 40, 3)).astype(np.float32)
    full, rot = cams(2)
    jmodel = JaxDISN()
    variables = redraw(jmodel.init(jax.random.PRNGKey(0), x, qry, full, rot), seed=4)
    model = DISNModel(img_size=img).eval()
    model.load_state_dict(disn_state_dict(variables))
    with torch.no_grad():
        pyramids, feat_global = model.encode(t(x))
        got = model(t(x), t(qry), t(full), t(rot))
    w_pyr, w_global = jmodel.apply(variables, x, method=jmodel.encode)
    for p, w in zip(pyramids, w_pyr):
        close(p, w, atol=1e-3 * float(np.abs(w).max()))
    close(feat_global, w_global)
    want = jmodel.apply(variables, x, qry, full, rot)
    assert got.shape == (2, 40) and got.dtype == torch.float32
    close(got, want)
    assert float(np.abs(want).max()) > 10 * ATOL


def test_state_dicts_invert_the_torch_importer():
    x = np.zeros((1, 128, 128, 3), np.float32)
    qry = np.zeros((1, 4, 3), np.float32)
    full, rot = cams(1)
    for jmodel, args, to_sd, back in (
            (JaxDISN(), (x, qry, full, rot), disn_state_dict, torch_import.disn_model),
            (JaxCameraNet(), (x,), camnet_state_dict, torch_import.camnet_model)):
        variables = redraw(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *args)), 5)
        sd = to_sd(variables)
        model = DISNModel() if to_sd is disn_state_dict else CameraNet()
        assert set(sd) == set(model.state_dict())  # loads strictly
        for a, b in zip(jax.tree_util.tree_leaves(back(sd)), jax.tree_util.tree_leaves(variables)):
            np.testing.assert_array_equal(a, b)


def test_global_pool_side():
    for img, side in ((32, 1), (64, 2), (96, 3), (128, 4), (160, 5), (256, 4), (384, 4)):
        assert global_pool_side(img) == side, img
    assert DISNModel(img_size=256).img_encoder.classifier[0].in_features == 512 * 16


def test_grid_sample_matches_torch_and_jax():
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(3, 5, 7, 4)).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (3, 50, 2)).astype(np.float32)  # some out of range
    got = grid_sample_2d(t(feats), t(coords))
    lib = F.grid_sample(t(feats).permute(0, 3, 1, 2), t(coords)[:, None], mode="bilinear",
                        padding_mode="zeros", align_corners=True)[:, :, 0].permute(0, 2, 1)
    close(got, lib, atol=1e-6)
    close(got, jax_grid_sample(jnp.asarray(feats), jnp.asarray(coords)), atol=1e-6)
    # twice differentiable in the points (the mesh polish needs it)
    pts = torch.tensor(rng.uniform(-0.9, 0.9, (1, 6, 2)), dtype=torch.float64,
                       requires_grad=True)
    f64 = torch.tensor(feats[:1], dtype=torch.float64)
    assert torch.autograd.gradgradcheck(lambda p: grid_sample_2d(f64, p).pow(2).sum(), (pts,))


def test_sample_slice_pyramids_and_mlp_match_jax():
    rng = np.random.default_rng(7)
    pyr = [rng.normal(size=(2 * 3, s, s, c)).astype(np.float32) for s, c in ((8, 4), (4, 6))]
    uv = rng.uniform(-1, 1, (2, 9, 2)).astype(np.float32)
    got = sample_slice_pyramids([t(p) for p in pyr], t(uv), n_slices=3)
    assert got.shape == (2, 9, 3, 10)
    close(got, jax_sample_pyramids([jnp.asarray(p) for p in pyr], jnp.asarray(uv), 3), atol=1e-6)
    x = rng.normal(size=(5, 3)).astype(np.float32)
    for relu_last in (True, False):
        jm = JaxMLP((8, 6, 2), relu_last=relu_last)
        v = redraw(jm.init(jax.random.PRNGKey(0), x), 8)
        m = relu_mlp(3, (8, 6, 2), relu_last=relu_last)
        m.load_state_dict({f"{idx}.{n}": t(v["params"][f"fc{i}"][k].T if n == "weight"
                                           else v["params"][f"fc{i}"][k])
                           for i, idx in enumerate((0, 2, 4))
                           for n, k in (("weight", "kernel"), ("bias", "bias"))})
        close(m(t(x)), jm.apply(v, x), atol=1e-6)


def test_vgg_final_matches_jax():
    x = np.random.default_rng(9).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    jvgg = JaxVGG(with_final=True)
    v = redraw(jvgg.init(jax.random.PRNGKey(0), x), 10)
    model = DISNModel(img_size=64).eval()
    model.load_state_dict(disn_state_dict({
        "params": {"img_encoder": v["params"],
                   **{k: p for k, p in _disn_heads(64).items()}},
        "batch_stats": {"img_encoder": v["batch_stats"]}}))
    taps, final = model.img_encoder(t(x).permute(0, 3, 1, 2))
    w_taps, w_final = jvgg.apply(v, x)
    assert len(taps) == 5
    for a, b in zip(taps, w_taps):
        close(a.permute(0, 2, 3, 1), b, atol=1e-3 * float(np.abs(b).max()))
    close(final.permute(0, 2, 3, 1), w_final, atol=1e-3 * float(np.abs(w_final).max()))
    no_final = VGG16BNBackbone(REF_ENCODER_BLOCKS)(t(x).permute(0, 3, 1, 2))
    assert isinstance(no_final, list) and len(no_final) == 5


def _disn_heads(img):
    """Zero DISN heads (the VGG test loads only the trunk's weights)."""
    d = 512 * global_pool_side(img) ** 2

    def mlp(cin, widths):
        out = {}
        for i, w in enumerate(widths):
            out[f"fc{i}"] = {"kernel": np.zeros((cin, w), np.float32),
                             "bias": np.zeros(w, np.float32)}
            cin = w
        return out

    return {"global_head": mlp(d, (1024, 1024, 128)), "pts_feat_extractor": mlp(3, (64, 256, 512)),
            "fc_local": mlp(1472 + 512, (512, 256, 1)), "fc_global": mlp(640, (512, 256, 1))}


def test_full_projection_and_dataset_match_jax(tmp_path):
    for az, el, d in ((0.0, 0.0, 1.2), (0.8, -0.3, 1.1)):
        np.testing.assert_array_equal(camera.full_projection_matrix(az, el, d),
                                      jax_camera.full_projection_matrix(az, el, d))
    root = create_synthetic_dataset(str(tmp_path / "synth"), n_shapes=2, n_views=6,
                                    img_size=32, n_sdf=16, seed=4)
    kw = dict(split="test", img_size=32, n_views=6, load_slices=False, load_sdf=False,
              load_full_projection=True)
    port, jax_ds = Slice3DDataset(root, **kw), JaxDataset(root, **kw)
    for i in range(2):
        got, want = port[i], jax_ds[i]
        assert set(got) == set(want) and "trans_mat_right" in got
        for key, value in want.items():
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("batch", [1, 2])
def test_disn_reconstructor_matches_jax(batch):
    """img 32, res0 16, up 1, fp32: DISN's coarse level and refinement levels
    through the gather path, the full camera and the object rotation; two
    objects of different views in a batch of 2."""
    jmodel = JaxDISN()
    variables = init_variables(jmodel, types.SimpleNamespace(img_size=32), seed=0)
    model = DISNModel(img_size=32)
    model.load_state_dict(disn_state_dict(variables))
    rng = np.random.default_rng(12)
    full, rot = cams(2, seed=13)
    feeds = [{"img_input": rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32),
              "trans_mat_right": full[i], "obj_rot_mat": rot[i]} for i in range(2)]
    probe, _ = Reconstructor(model, resolution0=8, upsampling_steps=0,
                             device="cpu").build_grid(feeds[0])
    kw = dict(resolution0=16, upsampling_steps=1, chunk_size=2048, batch_size=batch,
              threshold=float(1.0 / (1.0 + np.exp(-np.median(probe)))))
    jrec = JaxReconstructor(jmodel, variables, transport_dtype="float32", **kw)
    rec = Reconstructor(model, device="cpu", **kw)
    if batch == 1:
        pairs = [(rec.reconstruct(f), jrec.reconstruct(f)) for f in feeds]
    else:
        pairs = list(zip(rec.reconstruct_batch(feeds), jrec.reconstruct_batch(feeds)))
    for (mesh, stats), (j_mesh, j_stats) in pairs:
        assert stats["n_points_evaluated"] == j_stats["n_points_evaluated"]
        assert stats["n_points_evaluated"] > 17 ** 3  # refinement ran
        assert not mesh.is_empty
        np.testing.assert_array_equal(mesh.faces, j_mesh.faces)
        np.testing.assert_allclose(mesh.vertices, j_mesh.vertices, atol=1e-3, rtol=0)
    assert len(pairs[0][0][0].faces) != len(pairs[1][0][0].faces)  # two objects
