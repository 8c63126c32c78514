"""The raw dataset mode and the preprocessing on the card (run here on the
CPU) against the JAX package's ``device_preprocess`` path and the host path.

Tolerances: at the source size compositing and normalisation are the host
path's ops, so the port equals its own host path bit for bit and the JAX
device path within 1e-6 (XLA's fused divisions).  A resize is
``F.interpolate(bilinear, antialias=True)`` against JAX's
``jax.image.resize(linear, antialias=True)``: two implementations of one
triangle filter, held at 2e-5 on the [-1, 1] scale (readings 1.2e-7,
3.9e-7 and 2.4e-7 for 64 -> 16, 16 -> 24 and 40 -> 16 on noise images; both
are 6.5e-3 to 7.8e-3 from the host path's Pillow resize there).
"""

import glob
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from slice3d_tpu.data.dataset import Slice3DDataset as JaxDataset
from slice3d_tpu.data.device_transforms import DeviceTransformLoader as JaxLoader
from slice3d_tpu.data.device_transforms import preprocess_rgba_device as jax_preprocess
from slice3d_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from slice3d_tpu_torch.data.builders import create_synthetic_dataset
from slice3d_tpu_torch.data.dataset import Slice3DDataset, preprocess_image
from slice3d_tpu_torch.data.device_transforms import (DeviceTransformLoader,
                                                      preprocess_rgba_device)
from slice3d_tpu_torch.data.image import encode_png
from slice3d_tpu_torch.data.pipeline import BatchLoader

RESIZE_ATOL = 2e-5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return create_synthetic_dataset(str(tmp_path_factory.mktemp("dsdev") / "objaverse"),
                                    n_shapes=2, n_views=6, img_size=16, n_sdf=128)


def _raw(seed, h, w):
    raw = np.random.default_rng(seed).integers(0, 256, size=(h, w, 4), dtype=np.uint8)
    raw[:4, :4, 3] = 0  # fully transparent corner (white_bg fills it)
    return raw


@pytest.mark.parametrize("white_bg", [False, True])
def test_same_size_is_the_host_path(white_bg):
    raw = _raw(0, 16, 16)
    got = preprocess_rgba_device(torch.from_numpy(raw), 16, white_bg).numpy()
    np.testing.assert_array_equal(got, preprocess_image(raw, 16, white_bg))
    np.testing.assert_allclose(got, np.asarray(jax_preprocess(raw, 16, white_bg)), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("src,dst", [(64, 16), (16, 24), (40, 16)])
def test_resize_against_jax(src, dst):
    """Downscale and upscale, batched with leading axes, against JAX's."""
    raw = np.stack([_raw(s, src, src) for s in (1, 2, 3)]).reshape(3, 1, src, src, 4)
    got = preprocess_rgba_device(torch.from_numpy(raw), dst).numpy()
    want = np.asarray(jax_preprocess(jnp.asarray(raw), dst, False))
    assert got.shape == want.shape == (3, 1, dst, dst, 3)
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)


def test_raw_dataset_matches_jax(root):
    """The raw items (uint8 RGBA of the input view and the GT slices) equal the
    JAX package's, key for key."""
    ours = Slice3DDataset(root, split="val", img_size=16, n_qry=8, n_views=6,
                          device_preprocess=True)
    theirs = JaxDataset(root, split="val", img_size=16, n_qry=8, n_views=6,
                        device_preprocess=True)
    for i in range(2):
        a, b = ours[i], theirs[i]
        assert set(a) == set(b) and "img_input" not in a and "img_slices" not in a
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["img_input_raw"].shape == (16, 16, 4) and a["img_slices_raw"].shape == (12, 16,
                                                                                     16, 4)


def test_loader_matches_jax_and_the_host_path(root):
    kw = dict(split="val", img_size=16, n_qry=8, n_views=6, device_preprocess=True)
    ours = DeviceTransformLoader(BatchLoader(Slice3DDataset(root, **kw), 2, shuffle=False,
                                             num_workers=1), 16, device="cpu")
    theirs = JaxLoader(JaxBatchLoader(JaxDataset(root, **kw), 2, shuffle=False,
                                      num_workers=1), 16)
    (a,), (b,) = list(ours), list(theirs)
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]), atol=1e-6, rtol=0,
                                   err_msg=k)
    assert isinstance(a["img_input"], torch.Tensor) and a["img_input"].dtype == torch.float32
    host = Slice3DDataset(root, split="val", img_size=16, n_qry=8, n_views=6)
    for i in range(2):
        np.testing.assert_array_equal(a["img_input"][i].numpy(), host[i]["img_input"])
        np.testing.assert_array_equal(a["img_slices"][i].numpy(), host[i]["img_slices"])


def test_raw_mixed_resolution_rejected(tmp_path):
    """Raw feeds are stacked before the resize: an odd-sized PNG raises naming
    the file."""
    root = create_synthetic_dataset(str(tmp_path / "mix"), n_shapes=1, n_views=6,
                                    img_size=16, n_sdf=32)
    ds = Slice3DDataset(root, split="val", img_size=16, n_qry=8, n_views=6,
                        device_preprocess=True)
    ds[0]
    odd = sorted(glob.glob(os.path.join(root, "01_img_slices", "*", "004", "*.png")))[0]
    with open(odd, "wb") as f:
        f.write(encode_png(np.full((24, 24, 4), 255, np.uint8)))
    with pytest.raises(ValueError, match="uniform source resolutions") as err:
        ds[0]
    assert odd in str(err.value)


def test_grey_and_rgb_sources_gain_alpha(tmp_path):
    ds = Slice3DDataset.__new__(Slice3DDataset)
    ds._raw_hw = {}
    for i, img in enumerate((np.full((4, 4), 7, np.uint8), np.full((4, 4, 3), 9, np.uint8),
                             np.stack([np.full((4, 4), 5, np.uint8)] * 2, -1))):
        path = str(tmp_path / f"{i}.png")
        with open(path, "wb") as f:
            f.write(encode_png(img))
        out = ds.load_raw_rgba(path)
        assert out.shape == (4, 4, 4) and out.dtype == np.uint8
        assert (out[..., 3] == (5 if i == 2 else 255)).all()
        assert (out[..., :3] == img.reshape(4, 4, -1)[..., :1]).all()


def test_loader_runs_on_cuda_unless_asked_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceTransformLoader([], 16)
