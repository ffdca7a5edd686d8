"""User-facing alignment API.

`align(I1, I2, config)` is the one entry point that covers all three
reference algorithms (quadratic / robust / pyramidal — reference L5 at
src/inverse_compositional_algorithm.py:17,135,264): nscales=1 gives the
single-scale solvers, the `robust` field switches quadratic vs IRLS.

Accepts single images [H, W, C] or batches [B, H, W, C] of numpy/JAX
arrays; compiles one program per (config, shape, dtype) and caches it.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..config import AlignConfig
from ..ops.transforms import (
    TransformType,
    invert_params,
    nparams,
    pad_params,
    transform_grid,
)
from ..ops.warp import bicubic_sample, warp_image
from .pyramidal import pyramidal_solve

__all__ = ["AlignResult", "align", "solver_path", "warp", "transform_image"]


@jax.tree_util.register_dataclass
@dataclass
class AlignResult:
    """Outputs mirroring the reference's (p, error, DI, Iw) return tuple
    (src/inverse_compositional_algorithm.py:133), plus per-pair iteration
    counts and the validity mask of the final warp."""

    p: Any        # [B, 8] padded final parameters (or [8] for single input)
    error: Any    # [B] final ||dp||
    niters: Any   # [B] iterations applied at the finest scale
    di: Any       # [B, H, W, C] final error image Iw - I1
    iw: Any       # [B, H, W, C] final warped I2
    valid: Any    # [B, H, W] bool, warp in-domain mask
    diverged: Any  # [B] bool, finest-scale divergence guard tripped
    #   (p reverted to that scale's warm start; see models.ic._lost_overlap)
    level_niters: Any  # [B, nscales] trips applied per level, coarsest first

    def params(self, config: AlignConfig):
        """Un-padded parameter vector(s) for the configured model."""
        return self.p[..., : nparams(config.transform)]


def solver_path(dtype=jnp.float32, interpret: bool = False,
                platform: str | None = None) -> str:
    """The one rule that picks how each solver trip runs (models.ic.PATHS).

      * interpret=True: "interpret", the fused kernel in the Pallas
        interpreter. Only when asked, and only for tests.
      * a GPU and float32: "kernel", the fused kernel compiled for the
        card (ops/pallas/fused_iter.py). No shape, motion or option makes
        it give way to the plain iteration: the kernel masks its own edges
        and serves every transform, loss and preconditioning setting.
      * everything else: "xla", the plain op chain. On the CPU this is the
        only path, since the CPU is the device there; on a GPU it serves the
        dtypes the float32 kernel does not compute in (float64, bfloat16).

    platform defaults to jax.default_backend().
    """
    if interpret:
        return "interpret"
    platform = platform or jax.default_backend()
    if platform == "gpu" and jnp.dtype(dtype) == jnp.float32:
        return "kernel"
    return "xla"


def _align_impl(i1, i2, p0, config: AlignConfig, path: str):
    """Unjitted batched pipeline — the jit target (parallel.sharded maps
    it over the pairs axis of a mesh)."""
    state, per_scale = pyramidal_solve(
        i1, i2, p0, config.transform,
        nscales=config.nscales, nu=config.nu, tol=config.tol,
        max_iter=config.max_iter, robust=config.robust, lam=config.lam,
        nanifoutside=config.nanifoutside, delta=config.delta,
        pyramid_method=config.pyramid_method,
        precondition=config.precondition,
        hessian_chunk=config.hessian_chunk, path=path,
        verbose=config.verbose,
        divergence_guard=config.divergence_guard,
        delta_cap=config.delta_cap,
    )
    return _finish(i1, i2, state, per_scale, config)


def _finish(i1, i2, state, per_scale, config: AlignConfig) -> AlignResult:
    """Final warp at the solved p (plain XLA; it runs once per call)."""
    iw, valid = warp_image(i2, state.p, config.transform, config.delta)
    fill = jnp.asarray(jnp.nan if config.nanifoutside else 0.0, iw.dtype)
    iw = jnp.where(valid[..., None], iw, fill)
    return AlignResult(p=state.p, error=state.error, niters=state.niters,
                       di=iw - i1, iw=iw, valid=valid,
                       diverged=state.diverged,
                       level_niters=jnp.stack([s.niters for s in per_scale],
                                              axis=-1))


_align_batched = partial(jax.jit, static_argnames=("config", "path"))(
    _align_impl)


def align(i1, i2, config: AlignConfig = AlignConfig(), p0=None,
          dtype=jnp.float32) -> AlignResult:
    """Estimate the parametric motion warping I2 onto I1.

    Args:
      i1, i2: [H, W, C] or [B, H, W, C] images (any float/integer dtype;
        cast to `dtype`). Pixel range is the caller's business — the
        reference operates on raw 0..255 values.
      config: static algorithm configuration.
      p0: optional warm-start parameters, [k], [8], [B, k] or [B, 8].

    The per-trip path follows `solver_path(dtype, config.interpret)`.

    Returns:
      AlignResult (batch dims match the input rank).
    """
    config.validate()
    i1 = jnp.asarray(i1)
    i2 = jnp.asarray(i2)
    if i1.shape != i2.shape:
        raise ValueError("I1 and I2 must have the same shape")
    single = i1.ndim == 3
    if single:
        i1, i2 = i1[None], i2[None]
    if i1.ndim != 4:
        raise ValueError("images must be [H, W, C] or [B, H, W, C]")
    i1 = i1.astype(dtype)
    i2 = i2.astype(dtype)

    b = i1.shape[0]
    if p0 is None:
        p0 = jnp.zeros((b, 8), dtype)
    else:
        p0 = jnp.asarray(p0, dtype)
        if p0.ndim == 1:
            p0 = jnp.broadcast_to(pad_params(p0), (b, 8))
        else:
            p0 = pad_params(p0)

    res = _align_batched(i1, i2, p0, config,
                         solver_path(dtype, config.interpret))
    if single:
        res = jax.tree_util.tree_map(lambda x: x[0], res)
    return res


def warp(image, p, config: AlignConfig = AlignConfig()):
    """Warp an image (or batch) by parameters p; NaN/0-fills out-of-domain
    pixels per config.nanifoutside. Convenience mirror of the reference's
    `bicubic_interpolation_skimage` / `tf_warp_image` public surface."""
    image = jnp.asarray(image)
    single = image.ndim == 3
    if single:
        image = image[None]
    p = jnp.asarray(p, image.dtype)
    if p.ndim == 1:
        p = p[None]
    iw, valid = warp_image(image, pad_params(p), config.transform, config.delta)
    fill = jnp.nan if config.nanifoutside else 0.0
    iw = jnp.where(valid[..., None], iw, jnp.asarray(fill, iw.dtype))
    return (iw[0] if single else iw)


def transform_image(image, ttype: TransformType, gt):
    """Apply the *forward* motion `gt` to an image: out(x) = I(M(gt)^-1 x).

    Ground-truth pair generator, mirror of reference `transform_image`
    (src/transformation.py:266-318), which warps with skimage
    `transform.warp(tform.inverse)` — i.e. the output samples the input at
    the inverse-transformed coordinates, so aligning (out, I) recovers
    exactly p = params(M(gt)^-1) (what the reference notebooks compute as
    matrix2params(inv(params2matrix(gt))) — test/ica_keras_unit_tests.ipynb
    cell 9). Bicubic (Keys) sampling with clip-to-edge boundaries; unlike
    the reference there is no float64 upcast requirement.

    Intentional divergence: for EUCLIDEAN the reference negates the
    rotation angle (EuclideanTransform(rotation=-gt[2]),
    src/transformation.py:287) while its SIMILARITY path does not — the
    reference is internally inconsistent. Here every model uses
    params_to_matrix(gt) unmodified, so euclidean gt-generation rotates in
    the *opposite* direction from reference-generated datasets (see
    PARITY.md C23 note).
    """
    image = jnp.asarray(image)
    single = image.ndim == 3
    if single:
        image = image[None]
    b, hh, ww, _ = image.shape
    p_inv = invert_params(pad_params(jnp.asarray(gt, image.dtype), ttype), ttype)
    if p_inv.ndim == 1:
        p_inv = jnp.broadcast_to(p_inv, (b, 8))
    gx, gy = transform_grid(p_inv, ttype, hh, ww)
    out = bicubic_sample(image, gx, gy)
    return (out[0] if single else out)
