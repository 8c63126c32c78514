"""The port's projection self-check (``slice3d_tpu_torch/test_projection.py``)
against the root ``test_projection.py`` on a synthetic dataset (CPU, no
card)."""

import sys

import numpy as np
import pytest

import test_projection as root_script
from slice3d_tpu.data.dataset import Slice3DDataset as JaxDataset
from slice3d_tpu_torch import test_projection
from slice3d_tpu_torch.data.builders import create_synthetic_dataset
from slice3d_tpu_torch.data.dataset import Slice3DDataset
from slice3d_tpu_torch.data.image import load_image

IMG, N_PTS = 64, 300


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("proj")
    create_synthetic_dataset(str(root / "synth"), n_shapes=2, n_views=12, img_size=IMG,
                             n_sdf=1024)
    return root


def _jax_pixels(sample):
    """The root script's projection, line for line."""
    band = np.argsort(np.abs(sample["sdf"]))[:N_PTS]
    pts = sample["qry_norot"][band] @ sample["obj_rot_mat"]
    homo = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], axis=1)
    uvw = homo @ sample["trans_mat_wo_rot_tp"]
    return uvw[:, :2] / uvw[:, 2:3] * IMG


@pytest.mark.parametrize("shape_idx", [0, 1])
def test_projected_pixels_match_jax(data_dir, shape_idx):
    kw = dict(split="test", img_size=IMG, n_qry=8192)
    want = _jax_pixels(JaxDataset(str(data_dir / "synth"), **kw)[shape_idx])
    got = test_projection.project_surface_points(
        Slice3DDataset(str(data_dir / "synth"), **kw)[shape_idx], N_PTS, IMG)
    assert got.shape == (N_PTS, 2)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_png_matches_the_root_script(data_dir, tmp_path, monkeypatch):
    args = ["--dir_data", str(data_dir), "--name_dataset", "synth", "--img_size", str(IMG),
            "--shape_idx", "1"]
    monkeypatch.setattr(sys, "argv", ["test_projection.py", *args,
                                      "--out", str(tmp_path / "root.png")])
    root_script.main()
    test_projection.main(args + ["--out", str(tmp_path / "port.png")])
    want, got = load_image(str(tmp_path / "root.png")), load_image(str(tmp_path / "port.png"))
    assert got.shape == want.shape == (IMG, IMG, 3)

    sample = Slice3DDataset(str(data_dir / "synth"), split="test", img_size=IMG,
                            n_qry=8192)[1]
    px = test_projection.project_surface_points(sample, N_PTS, IMG)
    yy, xx = np.mgrid[:IMG, :IMG]
    dist = np.full((IMG, IMG), np.inf)
    for x, y in px:
        dist = np.minimum(dist, np.hypot(xx - x, yy - y))
    far = dist > 3.0
    assert far.any() and (~far).any()
    np.testing.assert_array_equal(got[far], want[far])
    red = np.all(got == test_projection.RED, axis=-1)
    inside = [(x, y) for x, y in px if 0 <= x < IMG and 0 <= y < IMG]
    assert inside
    for x, y in inside:
        assert red[np.hypot(xx - x, yy - y) <= 3.0].any(), (x, y)
