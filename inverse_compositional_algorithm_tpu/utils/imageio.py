"""Image IO helpers.

Replaces the reference's imageio/skimage usage (reference: `save_image` at
src/keras-tf/tf_inverse_compositional_algorithm.py:40-48, notebook loaders).
Images are exchanged with the solvers as float arrays in the raw 0..255
range, which is what the reference and the IPOL C++ operate on.

`.npy` files need nothing beyond numpy; other formats (PNG, JPEG, ...) need
Pillow, the package's optional `io` extra.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_image", "save_image", "to_uint8"]


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "reading or writing image formats other than .npy needs Pillow: "
            "install the package's `io` extra (pip install "
            "'inverse-compositional-algorithm-tpu[io]') or use .npy files"
        ) from e
    return Image


def load_image(path: str, dtype=np.float32) -> np.ndarray:
    """Load an image as [H, W, C] float in 0..255: a `.npy` array ([H, W]
    or [H, W, C]) as stored, any other file as RGB through Pillow."""
    if str(path).endswith(".npy"):
        arr = np.load(path).astype(dtype)
        return arr[..., None] if arr.ndim == 2 else arr
    with _pil().open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=dtype)
    return arr


def to_uint8(img: np.ndarray) -> np.ndarray:
    """NaN-zero + min/max normalize to uint8, the reference's save path
    (src/keras-tf/tf_inverse_compositional_algorithm.py:41-47)."""
    arr = np.asarray(img, np.float64)
    arr = np.where(np.isfinite(arr), arr, 0.0)
    lo, hi = arr.min(), arr.max()
    if hi - lo < 1e-12:
        return np.zeros(arr.shape, np.uint8)
    return np.clip((arr - lo) / (hi - lo) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def save_image(img, path: str) -> None:
    """Save an image: `.npy` keeps the float array as is; any other format
    is a (possibly NaN-holed) float image normalized to uint8 (Pillow)."""
    if str(path).endswith(".npy"):
        np.save(path, np.asarray(img))
        return
    _pil().fromarray(to_uint8(np.asarray(img))).save(path)
