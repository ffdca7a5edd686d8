"""Gauss-Newton normal equations, channel-reduced.

The reference materializes the steepest-descent images DIJ[B,H,W,C,8] and
einsum-contracts them every iteration (reference: src/derivatives.py:73-107,
src/image_optimisation.py:82-143, TF twins at
src/keras-tf/tf_inverse_compositional_algorithm.py:186-201,408-417). That
costs 8x the image bandwidth. Because the per-pixel steepest-descent vector
factorizes as

    d_n(p,c) = Ix(p,c) * Jx_n(p) + Iy(p,c) * Jy_n(p),

all channel sums can be taken *first*, reducing the whole problem to six
scalar maps per pair:

    gxx = sum_c Ix^2, gxy = sum_c Ix*Iy, gyy = sum_c Iy^2   (precomputed)
    u   = sum_c Ix*DI, v = sum_c Iy*DI                       (per iteration)

with which

    b_n    = sum_p w_p (u_p Jx_n + v_p Jy_n)
    H_{nm} = sum_p w_p (gxx JxJx + gxy (JxJy + JyJx) + gyy JyJy)_{nm}

— plain tall [B, P] @ [P, 8] contractions, with memory traffic equal to
reading the scalar maps once. The Hessian is accumulated over row chunks
with lax.scan so no [B, P, 8] intermediate ever exists. w is the IRLS
weight rho' (1 for the quadratic algorithm).

Moment form. Every Jacobian column is a polynomial of degree <= 2 in the
pixel coordinates, so every entry of H and b is a fixed linear combination
of the weighted coordinate moments

    M_k[j, i] = sum_p w_k(p) (x/L)^i (y/L)^j,     i, j in 0..4,  L = max(H, W)

of the five maps (w gxx, w gxy, w gyy, w u, w v). `coordinate_moments` is
the plain form of these moments (the reference of the fused iteration
kernel, ops/pallas/fused_iter.py), and `assemble_hessian` /
`assemble_rhs` turn them into H and b with static per-transform tensors.
Normalizing by L is exactly the Hartley preconditioning of
ops.transforms.param_preconditioner, so the assembled system is the
preconditioned one.
"""

from __future__ import annotations

import enum
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import NPARAMS_MAX
from .transforms import TransformType

__all__ = [
    "RobustLoss",
    "grad_moments",
    "residual_moments",
    "robust_weights",
    "hessian",
    "rhs",
    "coordinate_moments",
    "assemble_hessian",
    "assemble_rhs",
    "cholesky_solve8",
    "solve_normal",
]

NPOW = 5   # coordinate powers 0..4 of the moment form


class RobustLoss(enum.Enum):
    """Robust error function rho (reference: src/image_optimisation.py:10-15)."""

    QUADRATIC = 0
    TRUNCATED_QUADRATIC = 1
    GERMAN_MCCLURE = 2
    LORENTZIAN = 3
    CHARBONNIER = 4


def rhop(t2, lam, loss: RobustLoss):
    """Derivative rho'(t^2) of the robust error function.

    Vectorized over t2; matches `tf_rhop`
    (src/keras-tf/tf_image_optimisation.py:7-43). (The reference numpy
    `rhop` has a scalar-comparison bug in its TRUNCATED_QUADRATIC branch —
    src/image_optimisation.py:40-43; we implement the TF/C++ vectorized
    semantics.)
    """
    lam2 = lam * lam
    if loss is RobustLoss.QUADRATIC:
        return jnp.ones_like(t2)
    if loss is RobustLoss.TRUNCATED_QUADRATIC:
        return jnp.where(t2 < lam2, jnp.ones_like(t2), jnp.zeros_like(t2))
    if loss is RobustLoss.GERMAN_MCCLURE:
        return lam2 / jnp.square(lam2 + t2)
    if loss is RobustLoss.LORENTZIAN:
        return 1.0 / (lam2 + t2)
    if loss is RobustLoss.CHARBONNIER:
        return jax.lax.rsqrt(t2 + lam2)
    raise ValueError(f"unknown robust loss {loss}")


def grad_moments(ix, iy):
    """Channel-reduced gradient second moments.

    Args:
      ix, iy: [B, H, W, C] gradients, already multiplied by the boundary
        band mask (ops.gradients.boundary_band_mask).

    Returns:
      (gxx, gxy, gyy): [B, H, W] each.
    """
    gxx = jnp.sum(ix * ix, axis=-1)
    gxy = jnp.sum(ix * iy, axis=-1)
    gyy = jnp.sum(iy * iy, axis=-1)
    return gxx, gxy, gyy


def residual_moments(ix, iy, di):
    """Channel-reduced gradient-residual moments u = sum_c Ix*DI, v = sum_c Iy*DI.

    `di` must already be masked (invalid warp pixels zeroed), mirroring the
    reference's DI_filled (src/image_optimisation.py:103).
    """
    u = jnp.sum(ix * di, axis=-1)
    v = jnp.sum(iy * di, axis=-1)
    return u, v


def robust_weights(di, lam, loss: RobustLoss):
    """Per-pixel IRLS weight rho'(sum_c DI^2; lambda).

    `di` is the masked residual [B, H, W, C]; invalid pixels therefore
    contribute t2 = 0, which reproduces the reference's fill-then-weight
    order exactly (src/image_optimisation.py:74-77).
    """
    t2 = jnp.sum(di * di, axis=-1)
    return rhop(t2, lam, loss)


def _flatten_chunks(arr, chunk: int):
    """[..., P] -> [..., nchunks, chunk], zero-padded."""
    p = arr.shape[-1]
    nchunks = -(-p // chunk)
    pad = nchunks * chunk - p
    if pad:
        widths = [(0, 0)] * (arr.ndim - 1) + [(0, pad)]
        arr = jnp.pad(arr, widths)
    return arr.reshape(*arr.shape[:-1], nchunks, chunk)


def hessian(gxx, gxy, gyy, jx, jy, weights=None, chunk: int = 16384):
    """H[b] = sum_p w (gxx JxJx^T + gxy (JxJy^T + JyJx^T) + gyy JyJy^T).

    Args:
      gxx, gxy, gyy: [B, H, W] gradient moments.
      jx, jy: [H, W, 8] (preconditioned) Jacobian fields.
      weights: optional [B, H, W] IRLS weights (None = quadratic).
      chunk: pixels per accumulation step; bounds the transient to
        [B, chunk, 8] regardless of image size.

    Returns: [B, 8, 8].

    Equivalent to reference `hessian` / `hessian_robust`
    (src/derivatives.py:73-107) after the channel reduction described in the
    module docstring.
    """
    b = gxx.shape[0]
    acc_dt = jnp.promote_types(gxx.dtype, jnp.float32)

    def prep(m):
        m = m.reshape(b, -1)
        return _flatten_chunks(m.astype(acc_dt), chunk)

    if weights is not None:
        w = weights.reshape(b, -1)
        w1 = _flatten_chunks((gxx.reshape(b, -1) * w).astype(acc_dt), chunk)
        w2 = _flatten_chunks((gxy.reshape(b, -1) * w).astype(acc_dt), chunk)
        w3 = _flatten_chunks((gyy.reshape(b, -1) * w).astype(acc_dt), chunk)
    else:
        w1, w2, w3 = prep(gxx), prep(gxy), prep(gyy)

    jxc = _flatten_chunks(jx.reshape(-1, NPARAMS_MAX).astype(acc_dt).T, chunk)
    jyc = _flatten_chunks(jy.reshape(-1, NPARAMS_MAX).astype(acc_dt).T, chunk)
    # -> [nchunks, chunk, 8]
    jxc = jxc.transpose(1, 2, 0)
    jyc = jyc.transpose(1, 2, 0)

    def step(acc, args):
        w1c, w2c, w3c, jxk, jyk = args
        # [B, chunk, 8] transient per term; contraction over the chunk axis
        # is a matmul with K = chunk. Precision.HIGHEST keeps it in true
        # float32: a reduced-precision product (TF32 or bf16 inputs)
        # destroys the normal equations' 7 significant digits and stalls
        # convergence.
        kw = dict(preferred_element_type=acc_dt, precision=jax.lax.Precision.HIGHEST)
        xx = jnp.einsum("bp,pn,pm->bnm", w1c, jxk, jxk, **kw)
        xy = jnp.einsum("bp,pn,pm->bnm", w2c, jxk, jyk, **kw)
        yy = jnp.einsum("bp,pn,pm->bnm", w3c, jyk, jyk, **kw)
        return acc + xx + xy + xy.transpose(0, 2, 1) + yy, None

    init = jnp.zeros((b, NPARAMS_MAX, NPARAMS_MAX), acc_dt)
    # Under shard_map with variance checking, the carry must start with the
    # same varying-manual-axes type the body produces (the inputs are
    # device-varying); a no-op everywhere else.
    vma = tuple(getattr(jax.typeof(w1), "vma", ()) or ())
    if vma:
        init = jax.lax.pcast(init, vma, to="varying")
    h, _ = jax.lax.scan(
        step,
        init,
        (
            w1.transpose(1, 0, 2), w2.transpose(1, 0, 2), w3.transpose(1, 0, 2),
            jxc, jyc,
        ),
    )
    return h


def rhs(u, v, jx, jy, weights=None):
    """b[b] = sum_p w (u_p Jx + v_p Jy): two [B, P] @ [P, 8] matmuls.

    Equivalent to reference `independent_vector[_robust]`
    (src/image_optimisation.py:82-143) after channel reduction.
    """
    b = u.shape[0]
    acc_dt = jnp.promote_types(u.dtype, jnp.float32)
    uf = u.reshape(b, -1).astype(acc_dt)
    vf = v.reshape(b, -1).astype(acc_dt)
    if weights is not None:
        wf = weights.reshape(b, -1).astype(acc_dt)
        uf = uf * wf
        vf = vf * wf
    jxf = jx.reshape(-1, NPARAMS_MAX).astype(acc_dt)
    jyf = jy.reshape(-1, NPARAMS_MAX).astype(acc_dt)
    hi = jax.lax.Precision.HIGHEST  # true float32; see hessian() note
    return (jnp.matmul(uf, jxf, precision=hi)
            + jnp.matmul(vf, jyf, precision=hi))


def coordinate_moments(maps, norm_len: float, y_offset=0):
    """Plain weighted coordinate moments of the module docstring.

    Args:
      maps: [B, K, H, W] weight maps.
      norm_len: L, the full frame's max(height, width).
      y_offset: global row of row 0 (row-split callers), may be traced.

    Returns:
      [B, K, 5, 5] with M[b, k, j, i] = sum_p maps (x/L)^i (y/L)^j.
    """
    _, _, h, w = maps.shape
    acc = jnp.promote_types(maps.dtype, jnp.float32)
    xn = jnp.arange(w, dtype=acc) / norm_len
    yn = (jnp.arange(h, dtype=acc) + jnp.asarray(y_offset, acc)) / norm_len
    xp = jnp.stack([xn ** i for i in range(NPOW)], axis=-1)     # [W, 5]
    yp = jnp.stack([yn ** j for j in range(NPOW)], axis=-1)     # [H, 5]
    return jnp.einsum("bkhw,wi,hj->bkji", maps.astype(acc), xp, yp,
                      precision=jax.lax.Precision.HIGHEST)


def _column_polys(ttype: TransformType):
    """Per parameter column n: 3x3 coefficient grids [y-pow, x-pow] of the
    *preconditioned* Jacobian columns in normalized coordinates (x/L, y/L).
    Preconditioning divides each column by L^deg, so the normalized
    coefficients are exactly the raw integer ones."""
    def g(**terms):
        c = np.zeros((3, 3))
        for key, v in terms.items():
            a, b = int(key[1]), int(key[2])   # key like "p10" = x^1 y^0
            c[b, a] = v
        return c

    zero = g()
    one = g(p00=1.0)
    x = g(p10=1.0)
    y = g(p01=1.0)
    if ttype is TransformType.TRANSLATION:
        jx, jy = [one, zero], [zero, one]
    elif ttype is TransformType.EUCLIDEAN:
        jx, jy = [one, zero, -y], [zero, one, x]
    elif ttype is TransformType.SIMILARITY:
        jx, jy = [one, zero, x, -y], [zero, one, y, x]
    elif ttype is TransformType.AFFINITY:
        jx = [one, zero, x, y, zero, zero]
        jy = [zero, one, zero, zero, x, y]
    elif ttype is TransformType.HOMOGRAPHY:
        x2, xy, y2 = g(p20=-1.0), g(p11=-1.0), g(p02=-1.0)
        jx = [x, y, one, zero, zero, zero, x2, xy]
        jy = [zero, zero, zero, x, y, one, xy, y2]
    else:  # pragma: no cover
        raise ValueError(f"unknown transform type {ttype}")
    pad = [zero] * (NPARAMS_MAX - len(jx))
    return jx + pad, jy + pad


@functools.lru_cache(maxsize=None)
def _assembly(ttype: TransformType):
    """(T_h [8,8,3,5,5], T_b [8,2,5,5]) constant contraction tensors:
    H[n,m] = sum_{k,j,i} T_h[n,m,k,j,i] M[k,j,i], k over (w gxx, w gxy, w gyy);
    b[n]   = sum_{k,j,i} T_b[n,k,j,i] M[k,j,i],   k over (w u, w v)."""
    jx, jy = _column_polys(ttype)

    def polymul(a, b):
        out = np.zeros((NPOW, NPOW))
        for (i, j), va in np.ndenumerate(a):
            for (k, m), vb in np.ndenumerate(b):
                out[i + k, j + m] += va * vb
        return out

    t_h = np.zeros((NPARAMS_MAX, NPARAMS_MAX, 3, NPOW, NPOW))
    for n in range(NPARAMS_MAX):
        for m in range(NPARAMS_MAX):
            t_h[n, m, 0] = polymul(jx[n], jx[m])
            t_h[n, m, 1] = polymul(jx[n], jy[m]) + polymul(jy[n], jx[m])
            t_h[n, m, 2] = polymul(jy[n], jy[m])
    t_b = np.zeros((NPARAMS_MAX, 2, NPOW, NPOW))
    for n in range(NPARAMS_MAX):
        t_b[n, 0, :3, :3] = jx[n]
        t_b[n, 1, :3, :3] = jy[n]
    # Cached as numpy: a cached jnp array made under a jit trace would leak
    # the tracer into later traces.
    return t_h.astype(np.float32), t_b.astype(np.float32)


def assemble_hessian(m, ttype: TransformType):
    """Preconditioned H [B, 8, 8] from the moments [B, 3, >=5, >=5] of
    (w gxx, w gxy, w gyy)."""
    t_h, _ = _assembly(ttype)
    return jnp.einsum("bkji,nmkji->bnm", m[:, :, :NPOW, :NPOW],
                      jnp.asarray(t_h, m.dtype),
                      precision=jax.lax.Precision.HIGHEST)


def assemble_rhs(m, ttype: TransformType):
    """Preconditioned b [B, 8] from the moments [B, 2, >=5, >=5] of
    (w u, w v)."""
    _, t_b = _assembly(ttype)
    return jnp.einsum("bkji,nkji->bn", m[:, :, :NPOW, :NPOW],
                      jnp.asarray(t_b, m.dtype),
                      precision=jax.lax.Precision.HIGHEST)


def cholesky_solve8(h, b):
    """Batched 8x8 SPD solve via a fully unrolled Cholesky factorization.

    dp = H^-1 b for h: [B, 8, 8], b: [B, 8]. Unrolling the n=8 factorization
    into straight-line jnp ops keeps the solve inside the fused XLA program
    (no library call and no kernel boundary per iteration). Non-SPD input
    yields NaNs which the caller maps to dp = 0.
    """
    n = h.shape[-1]
    # lower-triangular factor, built column by column
    l = [[None] * n for _ in range(n)]
    for j in range(n):
        s = h[..., j, j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        ljj = jnp.sqrt(s)
        l[j][j] = ljj
        inv = 1.0 / ljj
        for i in range(j + 1, n):
            s = h[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s * inv
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return jnp.stack(x, axis=-1)


def solve_normal(h, b, live, precond=None):
    """Solve H dp = b for each pair; returns (dp [B, 8], error [B]).

    Args:
      h: [B, 8, 8] (preconditioned) normal matrix.
      b: [B, 8] (preconditioned) right-hand side.
      live: [8] 0/1 mask of the model's real parameters; padded slots get an
        identity diagonal so the padded system stays non-singular (their rhs
        is 0 so their solution is 0).
      precond: optional [8] column scales used to build jx/jy; the returned
        dp is de-preconditioned (dp = dp_tilde / s) so callers always see
        true parameter increments.

    error = ||dp||_2, the reference's convergence quantity
    (src/image_optimisation.py:146-155). A non-finite solve (singular H)
    yields dp = 0, matching the reference's singular-Hessian fallback
    (src/derivatives.py:126-129).
    """
    live = jnp.asarray(live, h.dtype)
    hp = h + jnp.diag(1.0 - live)[None, :, :]
    dp = cholesky_solve8(hp, b)
    if precond is not None:
        dp = dp / jnp.asarray(precond, dp.dtype)
    dp = jnp.where(jnp.all(jnp.isfinite(dp), axis=-1, keepdims=True), dp, 0.0)
    dp = dp * live
    error = jnp.linalg.norm(dp, axis=-1)
    return dp, error
