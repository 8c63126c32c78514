"""Host-side data: the dataset reader and the Pillow-free image IO it uses."""

from .dataset import SLICE_ORDER, Slice3DDataset, composite_rgba, preprocess_image

__all__ = ["SLICE_ORDER", "Slice3DDataset", "composite_rgba", "preprocess_image"]
