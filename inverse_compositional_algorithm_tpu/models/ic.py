"""Single-scale inverse-compositional Gauss-Newton solvers.

One device-resident loop serves both algorithm variants of the reference:

  * quadratic IC  — Hessian precomputed once outside the loop (the defining
    IC property; reference: src/inverse_compositional_algorithm.py:17-133,
    H hoist at :102-103 / tf at
    src/keras-tf/tf_inverse_compositional_algorithm.py:186-189).
  * robust IRLS   — per-iteration rho' weights and lambda annealing
    (reference: src/inverse_compositional_algorithm.py:135-261, tf at :339-465).

Deviations from the reference (documented, all strict upgrades):
  * the whole iteration runs inside `lax.while_loop` with **per-pair**
    convergence masking. The reference's TF batch shares one convergence
    criterion (src/keras-tf/tf_inverse_compositional_algorithm.py:225-232 —
    its own comment admits the approximation), which forced its eval harness
    to run batch-of-1. Here each pair freezes independently; the loop exits
    when every pair has converged. No host syncs anywhere in the loop.
  * Jacobian columns are Hartley-preconditioned so the 8x8 solve is
    well-conditioned in float32 (see ops.transforms.param_preconditioner).
  * the returned error/warped images are recomputed at the *final* p (the
    reference returns the ones from the second-to-last iterate).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as cts
from ..ops.gradients import boundary_band_mask, central_gradients
from ..ops.normal_equations import (
    RobustLoss,
    assemble_hessian,
    assemble_rhs,
    coordinate_moments,
    grad_moments,
    hessian,
    residual_moments,
    rhs,
    robust_weights,
    solve_normal,
)
from ..ops.transforms import (
    TransformType,
    compose_inverse,
    jacobian_fields,
    nparams,
    pad_params,
    param_preconditioner,
    transform_grid,
    transform_points,
)
from ..ops.warp import bicubic_sample, domain_mask

__all__ = ["ICState", "ic_solve", "effective_delta", "normal_system", "PATHS"]

# Per-trip implementations of the normal equations (models.api.solver_path
# chooses one): "kernel" is the fused Pallas kernel compiled for the GPU
# (ops/pallas/fused_iter.py), "interpret" the same kernel in the Pallas
# interpreter (tests), "xla" the plain op chain.
PATHS = ("kernel", "interpret", "xla")


@jax.tree_util.register_dataclass
@dataclass
class ICState:
    """Per-pair solver state carried through the while_loop."""

    p: Any         # [B, 8] padded parameters
    error: Any     # [B] last applied ||dp||
    lam: Any       # [B] per-pair annealed lambda (robust only)
    it: Any        # scalar loop iteration
    niters: Any    # [B] iterations actually applied per pair
    active: Any    # [B] bool, pair still iterating
    diverged: Any  # [B] bool, divergence guard tripped (p reverted to p0)


def effective_delta(delta: int, height: int, width: int) -> int:
    """Cap the boundary-band margin so the interior never vanishes.

    The reference applies the same `delta` at every pyramid level
    (src/inverse_compositional_algorithm.py:340-372 passes it unchanged),
    so at small coarse levels (e.g. 16x16 at 256^2 with 5 scales) the
    delta=10 band masks EVERY gradient pixel: H is all-zero, the singular
    fallback yields dp=0, and the level silently contributes nothing —
    the root cause of the round-3 large-motion homography divergence
    (the next level then starts from scratch with the full motion).
    Capping delta at a quarter of the short side keeps >= half of each
    dimension usable at every level; full-resolution behavior (and all
    golden-trace shapes) are unaffected since their cap >> 10.
    """
    return min(int(delta), max(0, (min(height, width) - 1) // 4))


def _lost_overlap(p, ttype: TransformType, height: int, width: int,
                  margin: float = 0.5):
    """[B] bool: the warp has catastrophically left the frame.

    Probes the four image corners and the center through x'(x; p): a pair
    is declared diverged when every probe lands outside the frame inflated
    by `margin` (or is non-finite), i.e. template/moving overlap is
    essentially gone and no further Gauss-Newton step can be informative.
    Any legitimate alignment keeps probes far inside this bound, so the
    guard can only fire on genuinely lost solutions.
    """
    xs = jnp.array([0.0, width - 1.0, 0.0, width - 1.0, (width - 1) / 2.0])
    ys = jnp.array([0.0, 0.0, height - 1.0, height - 1.0, (height - 1) / 2.0])
    gx, gy = transform_points(p, ttype, xs, ys)
    mx, my = margin * width, margin * height
    ok = (
        (gx >= -mx) & (gx <= (width - 1) + mx)
        & (gy >= -my) & (gy <= (height - 1) + my)
        & jnp.isfinite(gx) & jnp.isfinite(gy)
    )
    return ~jnp.any(ok, axis=-1) | ~jnp.all(jnp.isfinite(p), axis=-1)


def _masked_residual(iw, valid, i1, nanifoutside: bool):
    """DI = Iw - I1 with out-of-domain handling.

    nanifoutside=True: invalid pixels contribute nothing (the reference's
    NaN-then-fill-zero). False: invalid pixels take value 0.0 in Iw, so
    DI = -I1 there and they *do* pull on the solution (reference:
    src/bicubic_interpolation.py:134-147).
    """
    if nanifoutside:
        return (iw - i1) * valid[..., None].astype(iw.dtype)
    return jnp.where(valid[..., None], iw, jnp.zeros_like(iw)) - i1


def _system_builder(i1, i2, ix, iy, ttype: TransformType, *,
                    robust: RobustLoss, nanifoutside: bool, delta: int,
                    precondition: bool, hessian_chunk: int, path: str,
                    y_offset=0, reduce=lambda x: x):
    """Loop-invariant set-up of one level's normal equations.

    Args:
      i1, ix, iy: [B, h, W, C] template and its (band-masked) gradients;
        h is the full height, or a row shard's height.
      i2: [B, H, W, C] full moving image.
      y_offset: global row of template row 0 (row split).
      reduce: sum of per-shard partials (lax.psum over the row axis under
        row split; identity otherwise).

    Returns:
      (scale, system): the [8] column preconditioner (None when
      precondition is False) and system(p, lam) -> (h [B,8,8], b [B,8]),
      the Gauss-Newton system at p in that metric.
    """
    if path not in PATHS:
        raise ValueError(f"unknown path {path!r}; expected one of {PATHS}")
    dt = i1.dtype
    _, hl, ww, _ = i1.shape
    height = i2.shape[1]
    is_robust = robust is not RobustLoss.QUADRATIC
    gmom = grad_moments(ix, iy)
    scale = param_preconditioner(ttype, height, ww) if precondition else None

    if path == "xla":
        jx, jy = jacobian_fields(ttype, hl, ww, dtype=dt, scale=scale,
                                 y_offset=y_offset)
        h_quad = None
        if not is_robust:
            h_quad = reduce(hessian(*gmom, jx, jy, chunk=hessian_chunk))

        def system(p, lam):
            gx, gy = transform_grid(p, ttype, hl, ww, y_offset=y_offset)
            iw = bicubic_sample(i2, gx, gy)
            valid = domain_mask(gx, gy, height, ww, delta)
            di = _masked_residual(iw, valid, i1, nanifoutside)
            if is_robust:
                rho = robust_weights(di, lam[:, None, None], robust)
                h = reduce(hessian(*gmom, jx, jy, weights=rho,
                                   chunk=hessian_chunk))
            else:
                rho, h = None, h_quad
            u, v = residual_moments(ix, iy, di)
            return h, reduce(rhs(u, v, jx, jy, weights=rho))

        return scale, system

    from ..ops.pallas.fused_iter import iteration_moments, pack_template

    # The kernel's moments give the system preconditioned by L = max(H, W)
    # (ops.normal_equations docstring); unscale it when asked for the raw
    # system: H = S H~ S, b = S b~.
    s_l = jnp.asarray(param_preconditioner(ttype, height, ww), jnp.float32)
    if precondition:
        unscale = lambda h, b: (h, b)   # noqa: E731
    else:
        unscale = lambda h, b: (h * s_l[:, None] * s_l[None, :], b * s_l)  # noqa: E731
    h_quad = None
    if not is_robust:
        m = coordinate_moments(jnp.stack(gmom, axis=1), float(max(height, ww)),
                               y_offset)
        h_quad = assemble_hessian(reduce(m), ttype)
    tpl = pack_template(i1, ix, iy, gmom if is_robust else None)

    def system(p, lam):
        m = reduce(iteration_moments(
            i2, tpl, p, lam, ttype=ttype,
            robust=robust if is_robust else None,
            nanifoutside=nanifoutside, delta=delta, y_offset=y_offset,
            interpret=(path == "interpret")))
        if is_robust:
            h, b = assemble_hessian(m[:, :3], ttype), assemble_rhs(m[:, 3:], ttype)
        else:
            h, b = h_quad, assemble_rhs(m, ttype)
        h, b = unscale(h, b)
        return h.astype(dt), b.astype(dt)

    return scale, system


def _template_gradients(i1, delta: int, nanifoutside: bool):
    ix, iy = central_gradients(i1)
    if nanifoutside and delta > 0:
        _, hh, ww, _ = i1.shape
        band = boundary_band_mask(hh, ww, delta).astype(i1.dtype)
        ix = ix * band[None, :, :, None]
        iy = iy * band[None, :, :, None]
    return ix, iy


def normal_system(i1, i2, p, lam, ttype: TransformType, *,
                  robust: RobustLoss = RobustLoss.QUADRATIC,
                  nanifoutside: bool = True, delta: int = 10,
                  precondition: bool = True, hessian_chunk: int = 16384,
                  path: str = "xla", delta_cap: bool = True):
    """(h, b) of one solver trip at parameters p, as ic_solve forms it.

    The entry point for comparing the paths with each other: the same
    gradients, band and preconditioning as ic_solve, then one evaluation
    of the chosen path's per-trip system. lam: [B] robust thresholds.
    """
    _, hh, ww, _ = i1.shape
    if delta_cap:
        delta = effective_delta(delta, hh, ww)
    ix, iy = _template_gradients(i1, delta, nanifoutside)
    _, system = _system_builder(
        i1, i2, ix, iy, ttype, robust=robust, nanifoutside=nanifoutside,
        delta=delta, precondition=precondition, hessian_chunk=hessian_chunk,
        path=path)
    return system(pad_params(jnp.asarray(p, i1.dtype)),
                  jnp.asarray(lam, i1.dtype))


def _anneal(lam_cur, act, annealing: bool):
    """Continuation: shrink lambda each trip toward LAMBDA_N (applied after
    rho, like the reference) — per pair, and only while that pair is still
    stepping, so frozen/diverged pairs keep a well-defined lambda."""
    if not annealing:
        return lam_cur
    nxt = jnp.where(
        lam_cur > cts.LAMBDA_N,
        jnp.maximum(lam_cur * cts.LAMBDA_RATIO, cts.LAMBDA_N),
        lam_cur,
    )
    return jnp.where(act, nxt, lam_cur)


def _trip(s: ICState, h, b, p0p, *, ttype: TransformType, height: int,
          width: int, scale, tol: float, max_iter: int, annealing: bool,
          divergence_guard: bool) -> ICState:
    """Solve, compose and convergence bookkeeping of one Gauss-Newton trip
    (shared by ic_solve and the row-split solver of parallel/tiled.py)."""
    live = np.zeros(cts.NPARAMS_MAX, np.float32)
    live[: nparams(ttype)] = 1.0
    act = s.active
    lam_next = _anneal(s.lam, act, annealing)
    dp, err = solve_normal(h, b, live, precond=scale)

    p_new = compose_inverse(s.p, pad_params(dp), ttype)
    if divergence_guard:
        bad = act & _lost_overlap(p_new, ttype, height, width)
        # A lost pair reverts to its warm start — the honest "this level
        # failed, pass the coarser estimate through" result — and stops
        # iterating (the flag reports it).
        p_new = jnp.where(bad[:, None], p0p, p_new)
    else:
        bad = jnp.zeros_like(act)
    err_new = jnp.where(act, err, s.error)
    still = act & (err > tol) & ~bad & (s.it + 1 < max_iter)
    return ICState(p=jnp.where(act[:, None], p_new, s.p), error=err_new,
                   lam=lam_next, it=s.it + 1,
                   niters=s.niters + act.astype(s.niters.dtype),
                   active=still, diverged=s.diverged | bad)


def ic_solve(
    i1,
    i2,
    p0,
    ttype: TransformType,
    *,
    tol: float = 1e-3,
    max_iter: int = cts.MAX_ITER,
    robust: RobustLoss = RobustLoss.QUADRATIC,
    lam: float = 0.0,
    nanifoutside: bool = True,
    delta: int = 10,
    precondition: bool = True,
    hessian_chunk: int = 16384,
    path: str = "xla",
    verbose: bool = False,
    collect_trace: bool = False,
    divergence_guard: bool = True,
    delta_cap: bool = True,
):
    """Estimate p aligning I2 to I1 at a single scale.

    Args:
      i1, i2: [B, H, W, C] float images (any channel count; the reference
        requires RGB — src/inverse_compositional_algorithm.py:47-49 — we
        relax that).
      p0: [B, 8] padded initial parameters (warm start).
      ttype: static motion model.
      robust: QUADRATIC selects the pure IC algorithm; anything else runs
        IRLS with that rho'.
      lam: robust threshold; <= 0 enables the LAMBDA_0 -> LAMBDA_N annealing
        schedule (reference: src/inverse_compositional_algorithm.py:223,235-238).
      path: how each trip forms the normal equations, one of PATHS
        (models.api.solver_path picks it for align).
      collect_trace: when True, iterate a fixed max_iter-step lax.scan
        instead of the early-exiting while_loop and ALSO return the
        per-iteration history (error [max_iter, B], p [max_iter, B, 8],
        lam [max_iter]) — the |Dp|/p traces of the reference's verbose
        mode (src/inverse_compositional_algorithm.py:125-129), for golden
        comparison against the stored IPOL C++ console traces
        (reference docs/Algortihm Report.md:38-433). The recorded lambda is
        the POST-anneal value — the C++ print convention (its first robust
        line shows 72 = 80*0.9, docs/Algortihm Report.md:351), asserted
        exactly by tests/test_golden_traces.py. Converged pairs hold
        their final values for the remaining steps.

      divergence_guard: detect catastrophically lost pairs (all corner/
        center probes outside the frame inflated by margin=0.5 of its
        size on each side — a 2x span, see _lost_overlap — or
        non-finite p),
        revert them to their warm start p0 and stop iterating them, with
        the per-pair `diverged` flag set. The reference has no such guard
        (src/inverse_compositional_algorithm.py:220-259 applies every step
        unconditionally) — one lost pair there both poisons its own result
        AND, in a batched setting, would drag the whole batch through
        max_iter. The guard freezes that pair's lambda annealing too.

      delta_cap: cap the boundary band via `effective_delta` so small
        coarse levels keep an interior (True, default). False keeps the
        reference's exact behavior — delta passed unchanged at every size
        (src/inverse_compositional_algorithm.py:340-372) — so A/B
        validation against the reference remains reachable.

    Returns:
      ICState with final parameters, per-pair error / iteration counts /
      diverged flags; with collect_trace, the tuple
      (ICState, (error_hist [T,B], p_hist [T,B,8], lam_hist [T,B])).
    """
    bsz, hh, ww, _ = i1.shape
    dt = i1.dtype
    is_robust = robust is not RobustLoss.QUADRATIC
    if delta_cap:
        delta = effective_delta(delta, hh, ww)

    ix, iy = _template_gradients(i1, delta, nanifoutside)
    scale, system = _system_builder(
        i1, i2, ix, iy, ttype, robust=robust, nanifoutside=nanifoutside,
        delta=delta, precondition=precondition, hessian_chunk=hessian_chunk,
        path=path)
    p0p = pad_params(jnp.asarray(p0, dt))
    trip = partial(_trip, p0p=p0p, ttype=ttype, height=hh, width=ww,
                   scale=scale, tol=tol, max_iter=max_iter,
                   annealing=is_robust and lam <= 0,
                   divergence_guard=divergence_guard)

    def body(s: ICState) -> ICState:
        h, b = system(s.p, s.lam)
        s2 = trip(s, h, b)
        if verbose:
            # lambda printed post-anneal, the C++ verbose convention
            # (docs/Algortihm Report.md:351: first line shows 72 = 80*0.9).
            jax.debug.print(
                "iter {i}: |Dp|={e} p={p} lambda={l}",
                i=s.it, e=s2.error, p=s2.p, l=s2.lam, ordered=True,
            )
        return s2

    init = ICState(
        p=p0p,
        error=jnp.full((bsz,), 1e10, dt),
        lam=jnp.full((bsz,), lam if lam > 0 else cts.LAMBDA_0, dt),
        it=jnp.asarray(0, jnp.int32),
        niters=jnp.zeros((bsz,), jnp.int32),
        active=jnp.ones((bsz,), bool),
        diverged=jnp.zeros((bsz,), bool),
    )
    if collect_trace:
        def scan_body(s, _):
            s2 = body(s)
            return s2, (s2.error, s2.p, s2.lam)

        state, trace = jax.lax.scan(scan_body, init, None, length=max_iter)
        return state, trace
    return jax.lax.while_loop(lambda s: jnp.any(s.active), body, init)
