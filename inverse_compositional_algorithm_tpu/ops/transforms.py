"""Geometry core: parametric motion models and inverse-compositional algebra.

Five global motion models (translation, euclidean, similarity, affinity,
homography) over a single padded 8-parameter state. The reference keeps five
hand-expanded closed forms for every operation (reference:
src/transformation.py:36-263, src/keras-tf/tf_transformation.py:216-351); we
instead route everything through batched 3x3 homogeneous matrices, which is
both exactly equivalent algebra (the reference's formulas are the expanded
adjugate of the same matrix product) and compiler-friendly: one fixed-shape code
path for every model, no per-sample map_fn / switch_case.

Parameter layouts (identical to reference src/transformation.py:157-182):
  TRANSLATION  p = (tx, ty)
  EUCLIDEAN    p = (tx, ty, theta)
  SIMILARITY   p = (tx, ty, a, b)       -> [[1+a, -b], [b, 1+a]]
  AFFINITY     p = (tx, ty, a00, a01, a10, a11)
  HOMOGRAPHY   p = (h00, h01, h02, h10, h11, h12, h20, h21), H22 = 1

All public functions take/return padded parameters of shape [..., 8] with
unused slots zero, and are fully batched and jit/vmap-safe. The transform
type is a *static* Python value: each model compiles to its own tiny
specialized program (idiomatic XLA; no traced switch needed).
"""

from __future__ import annotations

import enum

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import NPARAMS_MAX

__all__ = [
    "TransformType",
    "nparams",
    "pad_params",
    "params_to_matrix",
    "matrix_to_params",
    "compose_inverse",
    "invert_params",
    "transform_grid",
    "transform_points",
    "jacobian_fields",
    "param_preconditioner",
    "zoom_in_params",
]


class TransformType(enum.Enum):
    """Motion model (reference: src/transformation.py:8-13)."""

    TRANSLATION = 1
    EUCLIDEAN = 2
    SIMILARITY = 3
    AFFINITY = 4
    HOMOGRAPHY = 5

    @property
    def n(self) -> int:
        return _NPARAMS[self]


_NPARAMS = {
    TransformType.TRANSLATION: 2,
    TransformType.EUCLIDEAN: 3,
    TransformType.SIMILARITY: 4,
    TransformType.AFFINITY: 6,
    TransformType.HOMOGRAPHY: 8,
}


def nparams(ttype: TransformType) -> int:
    """Number of live parameters of the model (reference: src/transformation.py:16-32)."""
    return _NPARAMS[ttype]


def pad_params(p, ttype: TransformType | None = None):
    """Pad a [..., k] parameter array with zeros up to [..., 8]."""
    p = jnp.asarray(p)
    k = p.shape[-1]
    if k == NPARAMS_MAX:
        return p
    if k > NPARAMS_MAX:
        raise ValueError(f"parameter vector has {k} > {NPARAMS_MAX} entries")
    pad = [(0, 0)] * (p.ndim - 1) + [(0, NPARAMS_MAX - k)]
    return jnp.pad(p, pad)


def params_to_matrix(p, ttype: TransformType):
    """Batched params -> homogeneous 3x3 matrices, shape [..., 3, 3].

    Semantics of reference src/transformation.py:188-236 (params2matrix),
    vectorized over any leading batch dims.
    """
    p = pad_params(p, ttype)
    dt = p.dtype
    one = jnp.ones(p.shape[:-1], dt)
    zero = jnp.zeros(p.shape[:-1], dt)
    tx, ty = p[..., 0], p[..., 1]

    if ttype is TransformType.TRANSLATION:
        rows = [one, zero, tx, zero, one, ty, zero, zero, one]
    elif ttype is TransformType.EUCLIDEAN:
        c, s = jnp.cos(p[..., 2]), jnp.sin(p[..., 2])
        rows = [c, -s, tx, s, c, ty, zero, zero, one]
    elif ttype is TransformType.SIMILARITY:
        a, b = p[..., 2], p[..., 3]
        rows = [one + a, -b, tx, b, one + a, ty, zero, zero, one]
    elif ttype is TransformType.AFFINITY:
        a00, a01, a10, a11 = p[..., 2], p[..., 3], p[..., 4], p[..., 5]
        rows = [one + a00, a01, tx, a10, one + a11, ty, zero, zero, one]
    elif ttype is TransformType.HOMOGRAPHY:
        rows = [
            one + p[..., 0], p[..., 1], p[..., 2],
            p[..., 3], one + p[..., 4], p[..., 5],
            p[..., 6], p[..., 7], one,
        ]
    else:  # pragma: no cover
        raise ValueError(f"unknown transform type {ttype}")

    m = jnp.stack(rows, axis=-1)
    return m.reshape(*p.shape[:-1], 3, 3)


def matrix_to_params(m, ttype: TransformType):
    """Homogeneous 3x3 matrices -> padded [..., 8] params.

    The matrix is assumed normalized (m[2,2] == 1 for homography; callers
    normalize first). Semantics of reference src/transformation.py:238-263.
    """
    m = jnp.asarray(m)
    zero = jnp.zeros(m.shape[:-2], m.dtype)
    tx, ty = m[..., 0, 2], m[..., 1, 2]

    if ttype is TransformType.TRANSLATION:
        cols = [tx, ty]
    elif ttype is TransformType.EUCLIDEAN:
        cols = [tx, ty, jnp.arctan2(m[..., 1, 0], m[..., 0, 0])]
    elif ttype is TransformType.SIMILARITY:
        cols = [tx, ty, m[..., 0, 0] - 1, m[..., 1, 0]]
    elif ttype is TransformType.AFFINITY:
        cols = [tx, ty, m[..., 0, 0] - 1, m[..., 0, 1], m[..., 1, 0], m[..., 1, 1] - 1]
    elif ttype is TransformType.HOMOGRAPHY:
        cols = [
            m[..., 0, 0] - 1, m[..., 0, 1], m[..., 0, 2],
            m[..., 1, 0], m[..., 1, 1] - 1, m[..., 1, 2],
            m[..., 2, 0], m[..., 2, 1],
        ]
    else:  # pragma: no cover
        raise ValueError(f"unknown transform type {ttype}")

    k = len(cols)
    out = jnp.stack(cols, axis=-1)
    if k < NPARAMS_MAX:
        out = jnp.concatenate(
            [out, jnp.zeros((*out.shape[:-1], NPARAMS_MAX - k), out.dtype)], axis=-1
        )
    return out


def _adjugate3(m):
    """Vectorized adjugate of [..., 3, 3] (transpose of the cofactor matrix).

    adj(M) = det(M) * inv(M); using the adjugate avoids the division so the
    degenerate-composition guard can be applied before any divide.
    """
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    adj = jnp.stack(
        [
            e * i - f * h, c * h - b * i, b * f - c * e,
            f * g - d * i, a * i - c * g, c * d - a * f,
            d * h - e * g, b * g - a * h, a * e - b * d,
        ],
        axis=-1,
    )
    return adj.reshape(*m.shape[:-2], 3, 3)


def compose_inverse(p, dp, ttype: TransformType, guard: float = 1e-10):
    """Inverse-compositional parameter update: p <- p o dp^{-1}.

    The defining step of the IC algorithm (reference: src/transformation.py:36-141
    `update_transform`; TF twin src/keras-tf/tf_transformation.py:216-351). The
    reference hand-expands M(p) @ adj(M(dp)) / norm per model; we compute the
    same product in matrix form, normalize by the homogeneous scale, and
    re-extract parameters. Degenerate updates (normalizer^2 <= guard) leave p
    unchanged, matching the reference's `det*det > 1E-10` guards
    (src/transformation.py:79,98,131).

    For TRANSLATION this reduces exactly to p - dp (reference
    src/transformation.py:52-54) and is special-cased for speed.
    """
    p = pad_params(p, ttype)
    dp = pad_params(dp, ttype)

    if ttype is TransformType.TRANSLATION:
        new = p.at[..., :2].set(p[..., :2] - dp[..., :2])
        return new

    mp = params_to_matrix(p, ttype)
    adj = _adjugate3(params_to_matrix(dp, ttype))
    # HIGHEST: tiny 3x3 product, but a reduced-precision matmul (TF32 or
    # bf16 passes) would inject ~1e-3 relative error into every composition step.
    u = jnp.matmul(mp, adj, precision=jax.lax.Precision.HIGHEST)
    # Homogeneous normalizer. For euclidean/similarity/affine updates this is
    # the 2x2 determinant of M(dp) (the reference's guard quantity); for
    # homography it is the full denominator of the expanded formulas.
    w = u[..., 2, 2]
    ok = (w * w) > guard
    safe_w = jnp.where(ok, w, jnp.ones_like(w))
    un = u / safe_w[..., None, None]
    new = matrix_to_params(un, ttype)
    return jnp.where(ok[..., None], new, p)


def invert_params(p, ttype: TransformType, guard: float = 1e-10):
    """Parameters of the inverse transform: params(M(p)^{-1}).

    The reference computes this in notebooks as
    matrix2params(inv(params2matrix(gt))) when building ground truth
    (reference: test/ica_keras_unit_tests.ipynb cell 9); provided here as a
    first-class op for dataset generation and evaluation.
    """
    p = pad_params(p, ttype)
    adj = _adjugate3(params_to_matrix(p, ttype))
    w = adj[..., 2, 2]
    ok = (w * w) > guard
    safe_w = jnp.where(ok, w, jnp.ones_like(w))
    inv = adj / safe_w[..., None, None]
    new = matrix_to_params(inv, ttype)
    return jnp.where(ok[..., None], new, p)


def transform_grid(p, ttype: TransformType, height: int, width: int,
                   y_offset=0):
    """Warped sampling coordinates x'(x; p) for every pixel.

    Args:
      p: [..., 8] padded parameters (batch leading dims).
      height, width: static image dims.
      y_offset: global row index of the first row (may be a traced scalar);
        lets a row-sharded caller compute its tile's absolute coordinates.

    Returns:
      (gx, gy): each [..., height, width], the source coordinates that the
      warped image samples from, matching reference `project`
      (src/transformation.py:144-186) / `tf_transformed_grid`
      (src/keras-tf/tf_transformation.py:122-152). The homography's
      homogeneous divide is a no-op for the affine family (denominator 1),
      so one code path serves all models.
    """
    p = pad_params(p, ttype)
    dt = p.dtype
    m = params_to_matrix(p, ttype)
    x = jnp.arange(width, dtype=dt)
    y = jnp.arange(height, dtype=dt) + jnp.asarray(y_offset, dt)
    # x' = m00 x + m01 y + m02 etc., broadcast as outer sums: keeps the grid
    # implicit (no [3, H, W] materialization before the contraction).
    gx = (
        m[..., 0, 0, None, None] * x[None, :]
        + m[..., 0, 1, None, None] * y[:, None]
        + m[..., 0, 2, None, None]
    )
    gy = (
        m[..., 1, 0, None, None] * x[None, :]
        + m[..., 1, 1, None, None] * y[:, None]
        + m[..., 1, 2, None, None]
    )
    if ttype is TransformType.HOMOGRAPHY:
        d = (
            m[..., 2, 0, None, None] * x[None, :]
            + m[..., 2, 1, None, None] * y[:, None]
            + m[..., 2, 2, None, None]
        )
        gx = gx / d
        gy = gy / d
    return gx, gy


def transform_points(p, ttype: TransformType, xs, ys):
    """Map a small set of points through the warp: x'(x; p) at (xs, ys).

    Args:
      p: [..., 8] padded parameters.
      xs, ys: [K] point coordinates (shared across the batch).

    Returns:
      (gx, gy): each [..., K]. Same math as `transform_grid` (reference
      `project`, src/transformation.py:144-186) on scattered probe points
      instead of the dense pixel grid — used e.g. by the divergence guard
      to test whether the image corners still overlap the frame.
    """
    p = pad_params(p, ttype)
    dt = p.dtype
    m = params_to_matrix(p, ttype)
    xs = jnp.asarray(xs, dt)
    ys = jnp.asarray(ys, dt)
    gx = (m[..., 0, 0, None] * xs + m[..., 0, 1, None] * ys
          + m[..., 0, 2, None])
    gy = (m[..., 1, 0, None] * xs + m[..., 1, 1, None] * ys
          + m[..., 1, 2, None])
    if ttype is TransformType.HOMOGRAPHY:
        d = (m[..., 2, 0, None] * xs + m[..., 2, 1, None] * ys
             + m[..., 2, 2, None])
        gx = gx / d
        gy = gy / d
    return gx, gy


def jacobian_fields(ttype: TransformType, height: int, width: int, dtype=jnp.float32,
                    scale=None, y_offset: int = 0):
    """Analytic warp Jacobian dW/dp at every pixel, padded to 8 columns.

    Returns (jx, jy), each [height, width, 8]:
      jx[..., n] = d x'(x; p) / d p_n |_{p=0},   jy likewise for y'.

    Column layout per model matches reference `jacobian`
    (src/derivatives.py:7-70) / `tf_jacobian` (src/keras-tf/tf_derivatives.py:35-88),
    e.g. homography rows [x, y, 1, 0, 0, 0, -x^2, -xy | 0, 0, 0, x, y, 1, -xy, -y^2].

    Args:
      scale: optional [8] per-column preconditioner; columns are *divided* by
        it (see `param_preconditioner`). Solving the preconditioned normal
        equations keeps the 8x8 Hessian well-conditioned in float32 even for
        homographies on large images (J columns span 1 .. L^2 otherwise).
      y_offset: global row index of this block's first row — lets sharded /
        tiled callers generate the correct absolute coordinates per tile.
    """
    x = jnp.broadcast_to(jnp.arange(width, dtype=dtype)[None, :], (height, width))
    y = jnp.broadcast_to(
        (jnp.arange(height, dtype=dtype) + jnp.asarray(y_offset, dtype))[:, None],
        (height, width),
    )
    one = jnp.ones((height, width), dtype)
    zero = jnp.zeros((height, width), dtype)

    if ttype is TransformType.TRANSLATION:
        jx = [one, zero]
        jy = [zero, one]
    elif ttype is TransformType.EUCLIDEAN:
        jx = [one, zero, -y]
        jy = [zero, one, x]
    elif ttype is TransformType.SIMILARITY:
        jx = [one, zero, x, -y]
        jy = [zero, one, y, x]
    elif ttype is TransformType.AFFINITY:
        jx = [one, zero, x, y, zero, zero]
        jy = [zero, one, zero, zero, x, y]
    elif ttype is TransformType.HOMOGRAPHY:
        jx = [x, y, one, zero, zero, zero, -x * x, -x * y]
        jy = [zero, zero, zero, x, y, one, -x * y, -y * y]
    else:  # pragma: no cover
        raise ValueError(f"unknown transform type {ttype}")

    k = len(jx)
    pad = [zero] * (NPARAMS_MAX - k)
    jxs = jnp.stack(jx + pad, axis=-1)
    jys = jnp.stack(jy + pad, axis=-1)
    if scale is not None:
        s = jnp.asarray(scale, dtype)
        jxs = jxs / s
        jys = jys / s
    return jxs, jys


def param_preconditioner(ttype: TransformType, height: int, width: int):
    """Per-column scales s ([8] numpy array) for Jacobian preconditioning.

    Solving (S^-1 H S^-1)(S dp) = S^-1 b with S = diag(s) equalizes the
    magnitude of the Jacobian columns (translation ~1, linear terms ~L,
    homography projective terms ~L^2, L = max(H, W)), the classic Hartley
    normalization. This is an accuracy improvement over the reference (which
    solves the raw, badly scaled system in float64 — src/derivatives.py:110-130);
    it is what makes a float32 device solve match the float64 CPU result.
    """
    L = float(max(height, width))
    ones = np.ones(NPARAMS_MAX, np.float64)
    if ttype is TransformType.TRANSLATION:
        pass
    elif ttype is TransformType.EUCLIDEAN:
        ones[2] = L
    elif ttype is TransformType.SIMILARITY:
        ones[2:4] = L
    elif ttype is TransformType.AFFINITY:
        ones[2:6] = L
    elif ttype is TransformType.HOMOGRAPHY:
        ones[[0, 1, 3, 4]] = L
        ones[[6, 7]] = L * L
    return ones


def zoom_in_params(p, ttype: TransformType, nx: int, ny: int, nxx: int, nyy: int):
    """Rescale parameters from a coarse pyramid level to the next finer one.

    nu = max(nxx/nx, nyy/ny); translation-like params scale by nu, the
    homography's projective row by 1/nu. Semantics of reference
    `zoom_in_parameters` (src/zoom.py:62-125) / `tf_zoom_in_parameters`
    (src/keras-tf/tf_zoom.py:5-84), batched over leading dims.
    """
    p = pad_params(p, ttype)
    nu = max(nxx / nx, nyy / ny)
    s = np.ones(NPARAMS_MAX, np.float64)
    if ttype is TransformType.HOMOGRAPHY:
        s[[2, 5]] = nu
        s[[6, 7]] = 1.0 / nu
    else:
        s[[0, 1]] = nu
    return p * jnp.asarray(s, p.dtype)
