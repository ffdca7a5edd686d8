"""Batched bicubic sampling and parametric warping.

Keys cubic-convolution (a = -0.5, i.e. Catmull-Rom) resampling with
clip-to-edge boundary handling, the same interpolant as both the reference's
handwritten kernel (reference: src/bicubic_interpolation.py:26-41) and its TF
sampler (src/keras-tf/tf_bicubic_interpolation.py:5-29). The reference's
*production* numpy path delegates to skimage.transform.warp order-3 (a cubic
B-spline — src/bicubic_interpolation.py:199); the three reference variants
already disagree at the 1e-4 level near boundaries, so we standardize on the
IPOL/Keys kernel and validate end-to-end against the stored C++ traces.

Design notes:
  * no NaN sentinels — out-of-domain pixels are reported through an explicit
    validity mask, which downstream reductions multiply in. This is exactly
    equivalent to the reference's NaN-then-`where(isfinite, ., 0)` pattern
    (e.g. src/image_optimisation.py:102-103) but keeps every array NaN-free,
    which XLA and Pallas handle far better.
  * the 16 taps are accumulated from 16 batched gathers over a flattened
    [B, H*W, C] image, the same structure XLA compiles `tf.gather_nd` to
    (reference: src/keras-tf/tf_bicubic_interpolation.py:106-115).
"""

from __future__ import annotations

import jax.numpy as jnp

from .transforms import TransformType, transform_grid

__all__ = ["keys_cubic_weights", "bicubic_sample", "domain_mask", "warp_image"]


def keys_cubic_weights(t):
    """Four Keys (a=-0.5) weights for fractional offset t in [0, 1).

    Returns w_{-1}, w_0, w_1, w_2 for taps at floor-1 .. floor+2. Same basis
    as reference `cubic` (src/keras-tf/tf_bicubic_interpolation.py:21-29):
      |x| <= 1:  1.5|x|^3 - 2.5|x|^2 + 1
      1 < |x| < 2: -0.5|x|^3 + 2.5|x|^2 - 4|x| + 2
    evaluated at x = t+1, t, t-1, t-2 — expanded in Horner form per tap (all
    four |x| ranges are known statically, so no `where` ladders are needed).
    """
    t2 = t * t
    t3 = t2 * t
    w_m1 = -0.5 * t3 + t2 - 0.5 * t
    w_0 = 1.5 * t3 - 2.5 * t2 + 1.0
    w_p1 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w_p2 = 0.5 * t3 - 0.5 * t2
    return w_m1, w_0, w_p1, w_p2


def bicubic_sample(image, gx, gy):
    """Sample `image` at real-valued coordinates with Keys bicubic.

    Args:
      image: [B, H, W, C].
      gx, gy: [B, h, w] source x / y coordinates (output shape may differ
        from input shape, e.g. for pyramid downsampling).

    Returns:
      [B, h, w, C] interpolated values. Taps are clipped to the image edges
      (Neumann boundary), matching reference `neumann_bc`
      (src/bicubic_interpolation.py:8-23) and the TF sampler's
      `clip_by_value` (src/keras-tf/tf_bicubic_interpolation.py:111-112).
    """
    b, hh, ww, c = image.shape
    oh, ow = gx.shape[-2:]
    dt = image.dtype

    x0 = jnp.floor(gx)
    y0 = jnp.floor(gy)
    tx = (gx - x0).astype(dt)
    ty = (gy - y0).astype(dt)
    x0 = x0.astype(jnp.int32)
    y0 = y0.astype(jnp.int32)

    wx = keys_cubic_weights(tx)
    wy = keys_cubic_weights(ty)

    flat = image.reshape(b, hh * ww, c)
    out = jnp.zeros((b, oh, ow, c), dt)
    for j in range(4):
        yj = jnp.clip(y0 + (j - 1), 0, hh - 1)
        for i in range(4):
            xi = jnp.clip(x0 + (i - 1), 0, ww - 1)
            idx = (yj * ww + xi).reshape(b, oh * ow, 1)
            tap = jnp.take_along_axis(flat, idx, axis=1).reshape(b, oh, ow, c)
            out = out + tap * (wy[j] * wx[i])[..., None]
    return out


def domain_mask(gx, gy, height: int, width: int, delta: int):
    """Validity of each warped sample: True where the source point is inside
    the (delta-shrunk) image domain.

    out-of-domain test on the *real* coordinates, as in the IPOL kernel
    (reference: src/bicubic_interpolation.py:144):
      out = x < delta or x > nx-1-delta or y < delta or y > ny-1-delta.
    """
    d = float(delta)
    return (
        (gx >= d)
        & (gx <= (width - 1) - d)
        & (gy >= d)
        & (gy <= (height - 1) - d)
    )


def warp_image(image, p, ttype: TransformType, delta: int = 0):
    """Warp `image` by transform parameters p (the per-iteration hot op).

    I_w(x) = I(x'(x; p)), plus the validity mask of each output pixel.

    Args:
      image: [B, H, W, C].
      p: [B, 8] padded parameters.
      ttype: static transform type.
      delta: boundary margin for the domain mask.

    Returns:
      (warped [B, H, W, C], valid [B, H, W] bool).

    Combines reference `bicubic_interpolation_image`
    (src/bicubic_interpolation.py:120-152) / `tf_warp_image`
    (src/keras-tf/tf_transformation.py:159-211). The caller decides how to
    fill invalid pixels (the reference writes NaN or 0 depending on
    `nanifoutside`); solvers here consume the mask directly.
    """
    _, hh, ww, _ = image.shape
    gx, gy = transform_grid(p, ttype, hh, ww)
    warped = bicubic_sample(image, gx, gy)
    valid = domain_mask(gx, gy, hh, ww, delta)
    return warped, valid
