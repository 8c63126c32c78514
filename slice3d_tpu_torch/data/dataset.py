"""Reader for the Slice3D on-disk dataset layout (the port's copy).

Layout:

    data/<dataset>/
      00_img_input/<shape_id>/{000..011}.png + meta.pkl
      01_img_slices/<shape_id>/<view>/{X,Y,Z}_{1..4}.png
      02_sdfs/<shape_id>.npy                      (N, 4) [xyz, sdf]
      03_splits/{train,val,test,trainval}.lst
      04_img_slices_gen/... / 05_img_slices_rec/...  (generated/recon slices)

``composite_rgba``, ``preprocess_image`` and ``Slice3DDataset`` follow the
JAX package's ``slice3d_tpu/data/dataset.py`` (itself the reference
``Slice3DDataset``): slice order X1-4, Z4-1, Y1-4; white-bg or alpha-masked
compositing; bilinear resize; [-1, 1] normalization; camera matrices from
meta.pkl; per-object SDF rescaling with the 0.003 level shift; view 4 and
seed 1234 for val/test.  Images are uint8 numpy arrays read by
``data/image.py`` (Pillow's decode and bilinear resize, without Pillow);
arrays out are NHWC float32.  ``load_full_projection`` adds DISN's full
projection (``trans_mat_right``).  ``device_preprocess`` emits the input
view and the GT slices as raw uint8 RGBA (``img_input_raw``,
``img_slices_raw``) for ``data/device_transforms.py`` to composite, resize
and normalise on the card (the JAX package's raw mode,
``slice3d_tpu/data/dataset.py:169-237``).
"""

from __future__ import annotations

import os
import pickle
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import camera
from .image import load_image, resize_bilinear

__all__ = ["Slice3DDataset", "SLICE_ORDER", "composite_rgba", "preprocess_image", "to_rgb"]

# Axis/part order of the 12 slices (reference datasets.py:106-111).
SLICE_ORDER: Tuple[Tuple[str, str], ...] = tuple(
    [("X", p) for p in "1234"]
    + [("Z", p) for p in "4321"]
    + [("Y", p) for p in "1234"]
)


def composite_rgba(arr: np.ndarray, white_bg: bool) -> np.ndarray:
    """uint8 image -> RGB uint8: RGBA alpha-masked onto black, or onto white
    where it is fully transparent; grey (with or without alpha) spread to
    three channels first."""
    if arr.ndim == 2:
        arr = np.stack([arr] * 3 + [np.full_like(arr, 255)], axis=-1)
    elif arr.shape[-1] == 2:
        arr = np.concatenate([arr[..., :1]] * 3 + [arr[..., 1:]], axis=-1)
    if arr.shape[-1] == 3:
        return arr
    rgb = arr[..., :3].astype(np.float32)
    alpha = arr[..., 3:4].astype(np.float32)
    if white_bg:
        # reference png_2_whitebg: fully transparent pixels -> white
        mask = (alpha == 0).astype(np.float32)
        out = 255.0 * mask + rgb * (1.0 - mask)
    else:
        out = rgb * (alpha / 255.0)
    return out.astype(np.uint8)


def preprocess_image(arr: np.ndarray, img_size: int, white_bg: bool) -> np.ndarray:
    """Composite, resize (bilinear), normalize to [-1, 1]. Returns (H, W, 3)."""
    rgb = composite_rgba(arr, white_bg)
    if rgb.shape[:2] != (img_size, img_size):
        rgb = resize_bilinear(rgb, (img_size, img_size))
    x = rgb.astype(np.float32) / 255.0
    return (x - 0.5) / 0.5


def to_rgb(arr: np.ndarray) -> np.ndarray:
    """Pillow's ``convert("RGB")`` of an 8-bit image: alpha dropped, grey
    spread to three channels."""
    if arr.ndim == 2:
        return np.stack([arr] * 3, axis=-1)
    if arr.shape[-1] in (1, 2):
        return np.concatenate([arr[..., :1]] * 3, axis=-1)
    return arr[..., :3]


@dataclass
class Slice3DDataset:
    root: str  # data/<dataset> directory
    split: str = "train"
    img_size: int = 128
    n_qry: int = 256
    n_views: int = 12
    n_slices: int = 12
    from_which_slices: str = "gt"  # gt | gt_rec | gen
    use_white_bg: bool = False
    load_slices: bool = True
    load_sdf: bool = True
    load_full_projection: bool = False  # 'trans_mat_right' for DISN
    categories: Sequence[str] = ("",)
    # raw uint8 RGBA under *_raw keys; composite, resize and normalise then
    # run on the card (data.device_transforms.DeviceTransformLoader)
    device_preprocess: bool = False

    def __post_init__(self):
        self.files: List[Tuple[str, str]] = []
        for category in self.categories:
            lst = os.path.join(self.root, "03_splits", category, f"{self.split}.lst")
            with open(lst) as f:
                ids = f.read().split()
            self.files.extend((category, sid) for sid in ids)
        self.dir_img_input = os.path.join(self.root, "00_img_input")
        slices_dir = {
            "gt": "01_img_slices",
            "gen": "04_img_slices_gen",
            "gt_rec": "05_img_slices_rec",
        }[self.from_which_slices]
        self.dir_img_slices = os.path.join(self.root, slices_dir)
        self.dir_sdf = os.path.join(self.root, "02_sdfs")
        self._raw_hw: Dict[str, Tuple[int, int]] = {}  # first raw size per feed

    def __len__(self) -> int:
        return len(self.files)

    # -- pieces -----------------------------------------------------------

    def view_index(self, rng: Optional[random.Random] = None) -> int:
        if self.split == "train":
            r = rng or random
            return r.randint(0, self.n_views - 1)
        return 4  # fixed eval view (reference datasets.py:95)

    def load_input_view(self, shape_id: str, view: int) -> np.ndarray:
        path = os.path.join(self.dir_img_input, shape_id, "%03d.png" % view)
        return preprocess_image(load_image(path), self.img_size, self.use_white_bg)

    def load_slice_images(self, shape_id: str, view: int) -> np.ndarray:
        """(n_slices, H, W, 3) in dataset slice order."""
        out = []
        vdir = os.path.join(self.dir_img_slices, shape_id, "%03d" % view)
        generated = self.from_which_slices in ("gen", "gt_rec")
        for axis, part in SLICE_ORDER:
            img = load_image(os.path.join(vdir, f"{axis}_{part}.png"))
            if generated:
                # generated slices are already composited RGB (resize if the
                # generation resolution differs from img_size)
                rgb = to_rgb(img)
                if rgb.shape[:2] != (self.img_size, self.img_size):
                    rgb = resize_bilinear(rgb, (self.img_size, self.img_size))
                x = rgb.astype(np.float32) / 255.0
                out.append((x - 0.5) / 0.5)
            else:
                out.append(preprocess_image(img, self.img_size, self.use_white_bg))
        return np.stack(out)

    def load_meta(self, shape_id: str):
        with open(os.path.join(self.dir_img_input, shape_id, "meta.pkl"), "rb") as f:
            return pickle.load(f)  # the dataset's own render metadata

    def load_camera(self, shape_id: str, view: int):
        meta = self.load_meta(shape_id)
        az, el, dist = meta[1][view], meta[2][view], meta[3][view]
        scale, offset = meta[5], meta[6]
        obj_rot, trans_tp = camera.camera_matrices(az, el, dist)
        return (
            obj_rot.astype(np.float32),
            trans_tp.astype(np.float32),
            float(scale),
            np.asarray(offset, dtype=np.float64),
        )

    def load_sdf_samples(self, shape_id: str, scale: float, offset) -> Tuple[np.ndarray, np.ndarray]:
        sdf_npy = np.load(os.path.join(self.dir_sdf, f"{shape_id}.npy"))
        pts, vals = camera.sdf_sample_transform(
            sdf_npy[:, :3], sdf_npy[:, 3], scale, offset
        )
        return pts.astype(np.float32), vals.astype(np.float32)

    def load_raw_rgba(self, path: str, group: str = "input") -> np.ndarray:
        """(H, W, 4) uint8 for the device-side preprocessing: grey and RGB
        gain an opaque alpha, grey is spread to three channels.

        Raw images are stacked per feed key before the resize on the card, so
        every source PNG of a ``group`` ("input" or "slices") must share one
        resolution; a mixed one raises naming the file (the host path resizes
        each image and takes mixed sizes)."""
        arr = load_image(path)
        if arr.ndim == 2:
            arr = arr[..., None]
        if arr.shape[-1] in (1, 2):
            arr = np.concatenate([arr[..., :1]] * 3 + [arr[..., 1:]], axis=-1)
        if arr.shape[-1] == 3:
            arr = np.concatenate([arr, np.full_like(arr[..., :1], 255)], axis=-1)
        first = self._raw_hw.setdefault(group, arr.shape[:2])
        if arr.shape[:2] != first:
            raise ValueError(
                f"device_preprocess needs uniform source resolutions per feed: {path} is "
                f"{arr.shape[:2]}, {group} images started with {first} (resize the renders "
                f"or disable device_preprocess)")
        return np.ascontiguousarray(arr, np.uint8)

    # -- sample assembly ---------------------------------------------------

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        category, shape_id = self.files[index]
        view = self.view_index()

        obj_rot, trans_tp, scale, offset = self.load_camera(shape_id, view)
        feed: Dict[str, np.ndarray] = {"obj_rot_mat": obj_rot, "trans_mat_wo_rot_tp": trans_tp}
        if self.device_preprocess:
            feed["img_input_raw"] = self.load_raw_rgba(
                os.path.join(self.dir_img_input, shape_id, "%03d.png" % view))
        else:
            feed["img_input"] = self.load_input_view(shape_id, view).astype(np.float32)
        if self.load_full_projection:
            meta = self.load_meta(shape_id)
            feed["trans_mat_right"] = camera.full_projection_matrix(
                meta[1][view], meta[2][view], meta[3][view]).astype(np.float32)
        if self.load_slices:
            if self.device_preprocess and self.from_which_slices == "gt":
                vdir = os.path.join(self.dir_img_slices, shape_id, "%03d" % view)
                feed["img_slices_raw"] = np.stack([
                    self.load_raw_rgba(os.path.join(vdir, f"{a}_{p}.png"), group="slices")
                    for a, p in SLICE_ORDER])
            else:
                feed["img_slices"] = self.load_slice_images(shape_id, view).astype(np.float32)
        if self.load_sdf:
            pts, vals = self.load_sdf_samples(shape_id, scale, offset)
            if self.split == "train":
                perm = np.random.permutation(len(pts))[: self.n_qry]
            else:
                perm = np.random.RandomState(1234).permutation(len(pts))[: self.n_qry]
            feed["qry_norot"] = pts[perm]
            feed["sdf"] = vals[perm]
            feed["occ"] = (vals[perm] <= 0).astype(np.float32)
        return feed
