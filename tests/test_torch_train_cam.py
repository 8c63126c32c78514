"""Camera-pose estimator training of the port against the JAX package's
``CamTrainer`` and ``CamEstDataset`` (CPU, fp32).

img 32 (CameraNet's ``fc`` then reads a 1x1 map), batch 2, 64 points.  The
JAX variables are redrawn from a seed and carried into the port by
``convert.camnet_state_dict``; one jitted JAX step returns the gradients
beside the update.  Tolerances as tests/test_torch_train_reg.py: the loss
and gradients at atol 5e-4 / rtol 1e-3, the updated parameters where |g| is
beyond 5e-4 within 1e-6 + 3e-3 lr and within 2 lr elsewhere (Adam's first
step moves each by lr times a sign), BatchNorm statistics at atol 1e-5.
"""

import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from jax_weights import redraw
from slice3d_tpu.data.builders import create_synthetic_dataset as jax_synthetic
from slice3d_tpu.models.camnet import camera_pose_loss as jax_pose_loss
from slice3d_tpu.train.train_cam import CamEstDataset as JaxCamEstDataset
from slice3d_tpu.train.train_cam import CamTrainer as JaxCamTrainer
from slice3d_tpu_torch.config import Options
from slice3d_tpu_torch.convert import camnet_state_dict
from slice3d_tpu_torch.models.build import load_camnet
from slice3d_tpu_torch.train.train_cam import CamEstDataset, CamTrainer

IMG, B, N_PCD, LR = 32, 2, 64, 1e-3
TOL = dict(atol=5e-4, rtol=1e-3)
_STATS = ("running_mean", "running_var", "num_batches_tracked")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The JAX builder's dataset (the port's writes the same pixels:
    tests/test_torch_train_reg.py)."""
    return jax_synthetic(str(tmp_path_factory.mktemp("cam") / "objaverse"), n_shapes=2,
                         n_views=6, img_size=IMG, n_sdf=512)


def _batch(root):
    """Both items of the val split (fixed view 4) from the JAX dataset."""
    ds = JaxCamEstDataset(root, split="val", img_size=IMG, n_views=6, n_pcd=N_PCD)
    items = [ds[i] for i in range(len(ds))]
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def test_dataset_items_match_jax(root):
    ours = CamEstDataset(root, split="val", img_size=IMG, n_views=6, n_pcd=N_PCD)
    theirs = JaxCamEstDataset(root, split="val", img_size=IMG, n_views=6, n_pcd=N_PCD)
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        a, b = ours[i], theirs[i]
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # a short SDF file is tiled up to n_pcd, as there
    long = CamEstDataset(root, split="val", img_size=IMG, n_views=6, n_pcd=700)[0]
    np.testing.assert_array_equal(long["pcd"], JaxCamEstDataset(
        root, split="val", img_size=IMG, n_views=6, n_pcd=700)[0]["pcd"])


@pytest.fixture(scope="module")
def jax_run(root):
    trainer = JaxCamTrainer(lr=LR)
    params, stats, _ = trainer.init_state(img_size=IMG)
    variables = redraw({"params": params, "batch_stats": stats}, 80)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    batch = _batch(root)

    @jax.jit
    def step(params, stats, opt_state, batch):
        def loss_fn(p):
            out, mut = trainer.model.apply({"params": p, "batch_stats": stats},
                                           batch["img_input"], mutable=["batch_stats"])
            loss, _ = jax_pose_loss(out["pred_RT_inv"], batch["pcd"], batch["regress_mat"],
                                    batch["norm_mat"], batch["K"])
            return loss, mut["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = trainer.tx.update(grads, opt_state, params)
        return loss, grads, new_stats, jax.tree_util.tree_map(lambda p, u: p + u, params,
                                                              updates)

    loss, grads, new_stats, new_params = step(params, stats, trainer.tx.init(params), batch)
    np_ = lambda t: jax.tree_util.tree_map(np.array, t)  # noqa: E731
    return {"variables": variables, "batch": batch, "loss": float(loss), "grads": np_(grads),
            "stats": np_(new_stats), "params": np_(new_params)}


def test_train_step_matches_jax(jax_run):
    trainer = CamTrainer(lr=LR, img_size=IMG, device="cpu")
    state = trainer.init_state()
    state.model.load_state_dict(camnet_state_dict(jax_run["variables"]))
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state, loss = trainer.train_step(state, jax_run["batch"])
    assert state.step == 1
    np.testing.assert_allclose(float(loss), jax_run["loss"], **TOL)
    stats = jax_run["variables"]["batch_stats"]
    grads = {k: v for k, v in camnet_state_dict({"params": jax_run["grads"],
                                                 "batch_stats": stats}).items()
             if not k.endswith(_STATS)}
    want = camnet_state_dict({"params": jax_run["params"], "batch_stats": jax_run["stats"]})
    params = dict(state.model.named_parameters())
    assert set(grads) == set(params)
    for n, p in params.items():
        g, w = p.grad.numpy(), grads[n].numpy()
        np.testing.assert_allclose(g, w, **TOL, err_msg=n)
        err = np.abs(p.detach().numpy() - want[n].numpy())
        firm = np.abs(w) >= TOL["atol"]
        assert err[firm].max(initial=0) <= 1e-6 + 3e-3 * LR, n
        assert err.max() <= 2 * LR + 1e-6, n
        assert not torch.equal(p, before[n]), n
    n_bn = 0
    for n, v in state.model.state_dict().items():
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want[n].numpy(), atol=1e-5, rtol=0, err_msg=n)
            n_bn += 1
    assert n_bn == 2 * 13  # every BatchNorm of the trunk feeds the pose


def test_train_cam_cli_and_load_camnet(root, tmp_path, capsys):
    """``python -m slice3d_tpu_torch.train_cam`` for one epoch: a metric-named
    checkpoint under <dir_experiments>/<name_exp_cam>/ckpt that
    ``load_camnet`` (``reconstruct --est_campose``) reads."""
    from slice3d_tpu_torch.train_cam import main

    main(["--name_exp_cam", "camtest", "--name_dataset", "objaverse",
          "--dir_data", os.path.dirname(root), "--img_size", str(IMG), "--n_bs", "2",
          "--n_epochs", "1", "--n_views", "6", "--n_wk", "1", "--freq_log", "1",
          "--dir_experiments", str(tmp_path), "--device", "cpu"])
    assert "[cam] epoch 0 step 1 loss" in capsys.readouterr().out
    (ckpt,) = glob.glob(str(tmp_path / "camtest" / "ckpt" / "*.ckpt"))
    epoch, step, loss = os.path.basename(ckpt)[:-5].split("_")
    assert (epoch, step) == ("0", "1") and np.isfinite(float(loss))
    opts = Options(img_size=IMG, dir_experiments=str(tmp_path), name_exp_cam="camtest",
                   name_ckpt_cam=os.path.basename(ckpt))
    model = load_camnet(opts)
    saved = torch.load(ckpt, weights_only=True)["model"]
    for n, t in model.state_dict().items():
        assert torch.equal(t, saved[n]), n


def test_cam_trainer_and_cli_run_on_cuda_unless_asked_otherwise(monkeypatch, root, tmp_path):
    from slice3d_tpu_torch.train_cam import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CamTrainer()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--dir_data", os.path.dirname(root), "--img_size", str(IMG),
              "--dir_experiments", str(tmp_path)])
