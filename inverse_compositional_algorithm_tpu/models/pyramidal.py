"""Coarse-to-fine pyramidal driver.

Builds the image pyramid, runs the (robust) IC solver per scale from
coarsest to finest, and rescales the parameters between levels — the
semantics of reference `pyramidal_inverse_compositional_algorithm`
(src/inverse_compositional_algorithm.py:264-374) / the
`PyramidalInverseCompositional` layer
(src/keras-tf/tf_inverse_compositional_algorithm.py:467-583).

Every level has static shapes, so the whole pyramid — downsampling, all
per-scale while_loops, parameter rescaling — compiles into ONE XLA program
with no host round-trips (the reference re-enters Python/TF per scale).

Warm-start note: the reference zeroes the coarsest level's parameters and
overwrites p0's level-0 slot from below (src/inverse_compositional_algorithm.py:337,
:371-372), i.e. a user-supplied initial p is silently ignored when
nscales > 1. Here p0 is propagated *down* to the coarsest level instead
(identical behavior for the default p0 = 0).
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import constants as cts
from ..ops.normal_equations import RobustLoss
from ..ops.pyramid import build_pyramid, pyramid_shapes
from ..ops.transforms import TransformType, pad_params, zoom_in_params
from .ic import ic_solve

__all__ = ["pyramidal_solve"]


def pyramidal_solve(
    i1,
    i2,
    p0,
    ttype: TransformType,
    *,
    nscales: int = 5,
    nu: float = 0.5,
    tol: float = 1e-3,
    max_iter: int = cts.MAX_ITER,
    robust: RobustLoss = RobustLoss.QUADRATIC,
    lam: float = 0.0,
    nanifoutside: bool = True,
    delta: int = 10,
    pyramid_method: str = "ipol",
    precondition: bool = True,
    hessian_chunk: int = 16384,
    path: str = "xla",
    verbose: bool = False,
    collect_trace: bool = False,
    divergence_guard: bool = True,
    delta_cap: bool = True,
):
    """Full multi-scale alignment of batched pairs.

    Args:
      i1, i2: [B, H, W, C]; p0: [B, k<=8] initial parameters at the finest
      scale. Remaining args as in `ic_solve` / the reference driver.
      collect_trace: also gather each scale's per-iteration
        (error, p, lam) history (see ic_solve) — the per-scale |Dp| traces
        of the reference's verbose pyramid (golden-comparable against
        reference docs/Algortihm Report.md:133-433).

    Returns:
      (state, per_scale): final-scale ICState (p at level 0), plus the list
      of per-scale ICStates coarsest-first for diagnostics. With
      collect_trace, (state, per_scale, traces) with traces coarsest-first.
    """
    _, hh, ww, _ = i1.shape
    shapes = pyramid_shapes(hh, ww, nscales, nu)
    p1 = build_pyramid(i1, nscales, nu, pyramid_method)
    p2 = build_pyramid(i2, nscales, nu, pyramid_method)

    # Propagate the warm start down to the coarsest level.
    p = pad_params(jnp.asarray(p0, i1.dtype))
    for s in range(1, nscales):
        (fh, fw), (ch, cw) = shapes[s - 1], shapes[s]
        p = zoom_in_params(p, ttype, fw, fh, cw, ch)

    per_scale = []
    traces = []
    state = None
    for s in range(nscales - 1, -1, -1):
        state = ic_solve(
            p1[s], p2[s], p, ttype,
            tol=tol, max_iter=max_iter, robust=robust, lam=lam,
            nanifoutside=nanifoutside, delta=delta,
            precondition=precondition, hessian_chunk=hessian_chunk,
            path=path, verbose=verbose,
            collect_trace=collect_trace, divergence_guard=divergence_guard,
            delta_cap=delta_cap,
        )
        if collect_trace:
            state, trace = state
            traces.append(trace)
        per_scale.append(state)
        if s > 0:
            (fh, fw), (ch, cw) = shapes[s - 1], shapes[s]
            p = zoom_in_params(state.p, ttype, cw, ch, fw, fh)
    if collect_trace:
        return state, per_scale, traces
    return state, per_scale
