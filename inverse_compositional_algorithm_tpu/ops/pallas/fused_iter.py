"""Fused Gauss-Newton iteration kernel (Pallas, Triton route).

One kernel computes everything one solver trip needs except the 8x8 solve:
the warp x'(x; p), the 16-tap bicubic sample of the moving image, the masked
residual DI, the robust weight rho'(sum_c DI^2), the channel-reduced
moments u = sum_c Ix DI and v = sum_c Iy DI, and the weighted coordinate
moments of ops.normal_equations (module docstring) of the 5 (robust) or
2 (quadratic) maps. The plain pipeline it replaces (models/ic.py, "xla"
path) writes and re-reads iw, valid, DI, rho', u and v through device
memory; here no per-pixel intermediate leaves registers.

Layout, one program per (pair, block of BH x BW output pixels):

  * warp coordinates are computed in the kernel from the pair's 3x3 warp
    matrix (no coordinate planes are read);
  * each tap is a load from the NHWC moving image at an index clipped to
    the frame edge, as in ops.warp.bicubic_sample; the caches serve the
    overlapping taps of neighbouring pixels;
  * the template operands (i1, ix, iy and, robust, gxx/gxy/gyy) are one
    planar [B, P, H_out, W] array read with masked block loads, so the
    kernel masks its own edges and any frame size runs;
  * each program writes its partial moments [K, 8, 8] (the [0:5, 0:5]
    corner is meaningful) and one XLA sum finishes the reduction: blocks
    run in no order, and partial sums keep the result deterministic.

Row split (parallel/tiled.py): `y_offset` is the global row of output row
0; warp coordinates and moment powers use global rows, so the partial
moments of the row shards sum to the full-frame moments.

Everything is float32 and there is no matrix product, so no TF32 enters.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..normal_equations import NPOW, RobustLoss, rhop
from ..transforms import TransformType, params_to_matrix
from ..warp import keys_cubic_weights

__all__ = ["iteration_moments", "pack_template", "BLOCK", "NUM_WARPS"]

BLOCK = (8, 64)     # output pixels per program (rows, columns); tuned on H100
NUM_WARPS = 8
_NCOEF = 16         # per-pair scalars: 3x3 warp matrix, lambda, y_offset


def _kernel(coef_ref, img_ref, tpl_ref, out_ref, *, height, width, chans,
            out_h, bh, bw, inv_l, robust, nanifoutside, delta, projective):
    f32 = jnp.float32
    r0 = pl.program_id(1) * bh
    c0 = pl.program_id(2) * bw
    rows = r0 + jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 0)
    cols = c0 + jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 1)
    ok = (rows < out_h) & (cols < width)

    m = [coef_ref[k] for k in range(9)]
    lam = coef_ref[9]
    x = cols.astype(f32)
    y = rows.astype(f32) + coef_ref[10]        # global row

    # x'(x; p), the arithmetic of ops.transforms.transform_grid.
    gx = m[0] * x + m[1] * y + m[2]
    gy = m[3] * x + m[4] * y + m[5]
    if projective:
        den = m[6] * x + m[7] * y + m[8]
        gx = gx / den
        gy = gy / den
    d = float(delta)
    valid = ((gx >= d) & (gx <= (width - 1) - d)
             & (gy >= d) & (gy <= (height - 1) - d))

    # Bicubic sample (ops.warp.bicubic_sample). Coordinates are clamped to
    # a finite range first so that the integer taps are always defined;
    # this changes no in-domain sample.
    sx = jnp.clip(jnp.where(jnp.isfinite(gx), gx, -4.0), -4.0, width + 3.0)
    sy = jnp.clip(jnp.where(jnp.isfinite(gy), gy, -4.0), -4.0, height + 3.0)
    fx = jnp.floor(sx)
    fy = jnp.floor(sy)
    wx = keys_cubic_weights(sx - fx)
    wy = keys_cubic_weights(sy - fy)
    x0 = fx.astype(jnp.int32)
    y0 = fy.astype(jnp.int32)
    iw = [jnp.zeros((bh, bw), f32) for _ in range(chans)]
    for j in range(4):
        row = jnp.clip(y0 + (j - 1), 0, height - 1) * width
        for i in range(4):
            base = (row + jnp.clip(x0 + (i - 1), 0, width - 1)) * chans
            wgt = wy[j] * wx[i]
            for c in range(chans):
                iw[c] = iw[c] + img_ref[base + c] * wgt

    def plane(k):
        return plgpu.load(
            tpl_ref.at[k, pl.ds(r0, bh), pl.ds(c0, bw)], mask=ok, other=0.0)

    # Residual, robust weight and channel-reduced moments
    # (models.ic._masked_residual, ops.normal_equations.robust_weights /
    # residual_moments).
    u = jnp.zeros((bh, bw), f32)
    v = jnp.zeros((bh, bw), f32)
    t2 = jnp.zeros((bh, bw), f32)
    for c in range(chans):
        i1c = plane(c)
        if nanifoutside:
            di = jnp.where(valid, iw[c] - i1c, 0.0)
        else:
            di = jnp.where(valid, iw[c], 0.0) - i1c
        u = u + plane(chans + c) * di
        v = v + plane(2 * chans + c) * di
        t2 = t2 + di * di
    if robust is not None:
        rho = rhop(t2, lam, robust)
        maps = [rho * plane(3 * chans + k) for k in range(3)]
        maps += [rho * u, rho * v]
    else:
        maps = [u, v]

    # Moments: reduce each map against (x/L)^i over the block's columns,
    # then against (y/L)^j over its rows.
    xn = x * inv_l
    xpow = [jnp.ones((bh, bw), f32)]
    for _ in range(1, NPOW):
        xpow.append(xpow[-1] * xn)
    yn = ((r0 + jax.lax.broadcasted_iota(jnp.int32, (1, bh), 1)).astype(f32)
          + coef_ref[10]) * inv_l                             # [1, bh]
    pj = jax.lax.broadcasted_iota(jnp.int32, (8, bh), 0)
    ypow = jnp.where(pj == 0, 1.0, 0.0).astype(f32)           # [8, bh]
    cur = jnp.ones((1, bh), f32)
    for j in range(1, NPOW):
        cur = cur * yn
        ypow = jnp.where(pj == j, cur, ypow)
    col = jax.lax.broadcasted_iota(jnp.int32, (8, 8), 1)
    for k, w in enumerate(maps):
        w = jnp.where(ok, w, 0.0)
        acc = jnp.zeros((8, 8), f32)
        for i in range(NPOW):
            s = jnp.sum(w * xpow[i], axis=1)                  # [bh]
            mj = jnp.sum(ypow * s[None, :], axis=1, keepdims=True)  # [8, 1]
            acc = acc + jnp.where(col == i, mj, 0.0)
        out_ref[k] = acc


def pack_template(i1, ix, iy, gmom=None):
    """[B, P, H, W] planar template operands: i1, ix, iy (C planes each)
    and, for the robust kernel, the gradient moments (gxx, gxy, gyy).
    Loop-invariant: built once per solve."""
    parts = [i1, ix, iy]
    if gmom is not None:
        parts.append(jnp.stack(gmom, axis=-1))
    return jnp.concatenate(parts, axis=-1).transpose(0, 3, 1, 2)


@functools.partial(jax.jit, static_argnames=(
    "ttype", "robust", "nanifoutside", "delta", "interpret"))
def iteration_moments(i2, tpl, p, lam, *, ttype: TransformType,
                      robust: RobustLoss | None, nanifoutside: bool,
                      delta: int, y_offset=0, interpret: bool = False):
    """[B, K, 5, 5] weighted coordinate moments of one solver trip.

    Args:
      i2: [B, H, W, C] moving image, always the full frame.
      tpl: [B, P, H_out, W] from `pack_template` (P = 3C + 3 robust, 3C
        quadratic); H_out = H, or a row shard's height.
      p: [B, 8] padded warp parameters.
      lam: [B] per-pair robust threshold (unused when robust is None).
      robust: RobustLoss, or None for the quadratic kernel (K = 2: u, v).
        Otherwise K = 5: w gxx, w gxy, w gyy, w u, w v with w = rho'.
      y_offset: global row of output row 0 (traced scalar, row split).
      interpret: run in the Pallas interpreter (CPU tests).

    Returns moments in the layout of ops.normal_equations.coordinate_moments;
    assemble H and b with assemble_hessian / assemble_rhs.
    """
    return _moments(i2, tpl, p, lam, ttype=ttype, robust=robust,
                    nanifoutside=nanifoutside, delta=delta, y_offset=y_offset,
                    interpret=interpret, block=BLOCK)


def _moments(i2, tpl, p, lam, *, ttype, robust, nanifoutside, delta,
             y_offset, interpret, block):
    """iteration_moments at a given (rows, columns) block size."""
    b, h, w, c = i2.shape
    npl, h_out = tpl.shape[1], tpl.shape[2]
    nk = 2 if robust is None else 5
    if npl < (3 * c if robust is None else 3 * c + 3):
        raise ValueError(f"template has {npl} planes for C={c}, robust={robust}")
    bh, bw = block
    f32 = jnp.float32
    mat = params_to_matrix(p.astype(f32), ttype).reshape(b, 9)
    coef = jnp.concatenate([
        mat,
        jnp.broadcast_to(jnp.asarray(lam, f32), (b,))[:, None],
        jnp.broadcast_to(jnp.asarray(y_offset, f32), (b,))[:, None],
        jnp.zeros((b, _NCOEF - 11), f32)], axis=1)
    grid = (b, pl.cdiv(h_out, bh), pl.cdiv(w, bw))
    kernel = functools.partial(
        _kernel, height=h, width=w, chans=c, out_h=h_out, bh=bh, bw=bw,
        inv_l=1.0 / float(max(h, w)), robust=robust,
        nanifoutside=nanifoutside, delta=delta,
        projective=ttype is TransformType.HOMOGRAPHY)
    parts = pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=[
            pl.BlockSpec((None, _NCOEF), lambda n, i, j: (n, 0)),
            pl.BlockSpec((None, h * w * c), lambda n, i, j: (n, 0)),
            pl.BlockSpec((None, npl, h_out, w), lambda n, i, j: (n, 0, 0, 0)),
        ],
        out_specs=pl.BlockSpec((None, None, None, nk, 8, 8),
                               lambda n, i, j: (n, i, j, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, *grid[1:], nk, 8, 8), f32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="ica_iteration_moments",
    )(coef, i2.astype(f32).reshape(b, h * w * c), tpl.astype(f32))
    return parts.sum(axis=(1, 2))[:, :, :NPOW, :NPOW]
