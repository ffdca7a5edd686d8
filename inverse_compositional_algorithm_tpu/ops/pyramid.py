"""Coarse-to-fine pyramid construction.

Gaussian presmoothing followed by bicubic resampling, with two selectable
smoothing conventions:

  * "ipol"     : sigma = ZOOM_SIGMA_ZERO * sqrt(1/nu^2 - 1), sampling at
                 input_coord = output_coord / nu — the faithful IPOL
                 downsample (reference: src/zoom.py:29-60), which is what the
                 stored C++ golden traces used.
  * "antialias": sigma = (1/nu - 1) / 2, the skimage `rescale`
                 anti_aliasing default that the reference's numpy pyramid
                 driver actually calls (src/inverse_compositional_algorithm.py:333-336).

Level sizes use round-half-up (C-style `int(n*nu + 0.5)`), matching the IPOL
C++ `zoom_size`; the reference numpy `zoom_size` (src/zoom.py:8-22) uses
numpy round-half-even, which differs only at deep levels of odd sizes.

All shapes are static per level: the pyramid is a Python list of arrays with
different (compile-time) shapes, which is the idiomatic JAX treatment of a
multi-resolution stack.
"""

from __future__ import annotations

import math
from functools import lru_cache as _lru_cache

import numpy as np
import jax.numpy as jnp
import jax

_cache = _lru_cache(maxsize=None)

from ..constants import ZOOM_SIGMA_ZERO
from .warp import bicubic_sample

__all__ = ["zoom_size", "pyramid_shapes", "gaussian_blur", "zoom_out", "build_pyramid"]


def zoom_size(nx: int, ny: int, factor: float) -> tuple[int, int]:
    """New (nx, ny) after scaling by `factor` (round half-up, IPOL style)."""
    return int(nx * factor + 0.5), int(ny * factor + 0.5)


def pyramid_shapes(height: int, width: int, nscales: int, nu: float):
    """[(H, W)] for each pyramid level, finest first."""
    shapes = [(height, width)]
    for _ in range(1, nscales):
        h, w = shapes[-1]
        nxx, nyy = zoom_size(w, h, nu)
        shapes.append((nyy, nxx))
    return shapes


def _gaussian_kernel(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """1-D normalized Gaussian taps, scipy.ndimage.gaussian_filter's layout
    (radius = int(truncate*sigma + 0.5); reference smoothing uses
    scipy.ndimage.gaussian_filter at src/zoom.py:50)."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(image, sigma: float):
    """Separable Gaussian blur of [B, H, W, C] with symmetric (edge-repeat)
    padding — scipy's default 'reflect' boundary mode."""
    if sigma <= 0:
        return image
    k = jnp.asarray(_gaussian_kernel(sigma), image.dtype)
    r = (k.shape[0] - 1) // 2

    # Depthwise separable conv: fold channels into the batch dim so a plain
    # 2-D convolution (which XLA hands to the convolution library) works
    # for any channel count.
    b, h, w, c = image.shape
    x = image.transpose(0, 3, 1, 2).reshape(b * c, 1, h, w)
    x = jnp.pad(x, ((0, 0), (0, 0), (r, r), (r, r)), mode="symmetric")
    kx = k.reshape(1, 1, 1, -1)
    ky = k.reshape(1, 1, -1, 1)
    dn = jax.lax.conv_dimension_numbers(x.shape, kx.shape, ("NCHW", "OIHW", "NCHW"))
    hi = jax.lax.Precision.HIGHEST  # true float32 (no TF32/bf16 passes)
    x = jax.lax.conv_general_dilated(x, ky, (1, 1), "VALID", dimension_numbers=dn,
                                     precision=hi)
    x = jax.lax.conv_general_dilated(x, kx, (1, 1), "VALID", dimension_numbers=dn,
                                     precision=hi)
    return x.reshape(b, c, h, w).transpose(0, 2, 3, 1)


def _aa_sigma(nu: float, method: str) -> float:
    if method == "ipol":
        return ZOOM_SIGMA_ZERO * math.sqrt(1.0 / (nu * nu) - 1.0)
    if method == "antialias":
        return max(0.0, (1.0 / nu - 1.0) / 2.0)
    raise ValueError(f"unknown pyramid method {method!r}")


def _resample_matrix(n_in: int, coords: np.ndarray) -> np.ndarray:
    """[n_in, n_out] Keys-bicubic sampling matrix for a static 1-D grid.

    S[s, o] accumulates the cubic tap weights of output sample o whose
    source coordinate is coords[o]; taps are clipped to the edges exactly
    like `bicubic_sample`, so S @ row == 1-D bicubic resampling of the row,
    value-identical up to float summation order.
    """
    coords = np.asarray(coords, np.float64)
    x0 = np.floor(coords).astype(np.int64)
    t = coords - x0
    t2 = t * t
    t3 = t2 * t
    ws = [
        -0.5 * t3 + t2 - 0.5 * t,
        1.5 * t3 - 2.5 * t2 + 1.0,
        -1.5 * t3 + 2.0 * t2 + 0.5 * t,
        0.5 * t3 - 0.5 * t2,
    ]
    s = np.zeros((n_in, coords.shape[0]))
    o = np.arange(coords.shape[0])
    for i, w in enumerate(ws):
        np.add.at(s, (np.clip(x0 + (i - 1), 0, n_in - 1), o), w)
    return s.astype(np.float32)


def _blur_matrix(n: int, sigma: float) -> np.ndarray:
    """[n, n] dense operator of the separable Gaussian blur with symmetric
    (edge-mirror) boundary — exactly `gaussian_blur`'s per-axis action as a
    matrix, so it can be fused with the resample matrix."""
    if sigma <= 0:
        return np.eye(n)
    k = _gaussian_kernel(sigma)
    r = (k.shape[0] - 1) // 2
    g = np.zeros((n, n))
    idx = np.arange(-r, n + r)
    # numpy/scipy 'symmetric'/'reflect' index folding: ... 1 0 | 0 1 ... n-1 | n-1 ...
    idx = np.where(idx < 0, -idx - 1, idx)
    idx = np.where(idx >= n, 2 * n - idx - 1, idx)
    for i in range(n):
        np.add.at(g[i], idx[i : i + 2 * r + 1], k)
    return g


@_cache
def _zoom_matrices(h: int, w: int, nu: float, method: str):
    """Per-axis fused blur+resample operators (M_y [H, nyy], M_x [W, nxx]).

    Presmoothing and Keys resampling are both linear and axis-separable, so
    the whole IPOL zoom-out is exactly TWO matmuls per level:
    out = M_y^T I M_x with M = G(sigma) @ S. Built in float64, applied in
    float32 — the same taps as conv-then-gather up to summation order, with
    no 1-channel depthwise convolutions on the hot path.
    """
    nxx, nyy = zoom_size(w, h, nu)
    sigma = _aa_sigma(nu, method)
    ox = np.arange(nxx, dtype=np.float64)
    oy = np.arange(nyy, dtype=np.float64)
    if method == "ipol":
        sx, sy = ox / nu, oy / nu
    else:
        sx, sy = (ox + 0.5) / nu - 0.5, (oy + 0.5) / nu - 0.5
    m_x = _blur_matrix(w, sigma) @ _resample_matrix(w, sx).astype(np.float64)
    m_y = _blur_matrix(h, sigma) @ _resample_matrix(h, sy).astype(np.float64)
    return m_y, m_x     # float64; cast to the image dtype at use


def zoom_out(image, nu: float, method: str = "ipol"):
    """Downsample [B, H, W, C] by factor nu (< 1): presmooth + bicubic resample.

    Sampling grid follows the chosen convention: "ipol" samples at
    out/nu (reference src/zoom.py:52-58); "antialias" samples at pixel
    centers (out + 0.5)/nu - 0.5 like skimage/tf resize.

    Blur and resample fold into one constant per-axis matrix each
    (`_zoom_matrices`), so a pyramid level costs exactly two matmuls —
    no convolutions, no gathers.
    """
    b, h, w, c = image.shape
    m_y, m_x = _zoom_matrices(h, w, nu, method)
    m_y = jnp.asarray(m_y, image.dtype)
    m_x = jnp.asarray(m_x, image.dtype)
    hi = jax.lax.Precision.HIGHEST  # true float32 (see gaussian_blur note)
    tmp = jnp.einsum("bhwc,hy->bywc", image, m_y, precision=hi)
    return jnp.einsum("bywc,wx->byxc", tmp, m_x, precision=hi)


def build_pyramid(image, nscales: int, nu: float, method: str = "ipol"):
    """List of [B, h_s, w_s, C], level 0 = input resolution (finest).

    Each level is produced from the previous one (recursive downsampling),
    as the reference pyramid driver does
    (src/inverse_compositional_algorithm.py:331-338).
    """
    levels = [image]
    for _ in range(1, nscales):
        levels.append(zoom_out(levels[-1], nu, method))
    return levels
