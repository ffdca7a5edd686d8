"""Spatial-domain parallelism with explicit collectives (shard_map).

The SP-analogue for image alignment (SURVEY §2.2): row-tiles of the
template image are sharded over the mesh's "tile" axis, each device
computes its partial normal equations, and only the tiny 8x8 system + 8
vector cross the interconnect (`lax.psum`) per iteration — the
Schur-style layout where images are big but the reduced system is tiny.

Communication pattern per solve:
  * gradient halo — the y central difference needs one neighbor row from
    the adjacent shard; exchanged once with two `lax.ppermute` shifts
    (bicubic's 4x4 stencil never crosses tiles because warping samples the
    *replicated* moving image, see below).
  * per iteration — ONE psum of partial sums: [B, 8, 8] + [B, 8] on the
    plain path, the [B, K, 5, 5] coordinate moments on the kernel path.
    Nothing else moves.

The moving image I2 is replicated across the tile axis: a parametric warp
can fetch pixels from anywhere in the frame (a 10-px translation already
crosses any fixed halo), so tile-locality only exists for the *output*
(template) domain. Replicating I2 (a few MB) buys completely local gathers;
all per-iteration bandwidth — the warp's 16 taps, residual, moments — is
spread over the tile axis.

`parallel.sharded.align_sharded(tile_rows=True)` runs every path through
this solver (the fused kernel is opaque to XLA's SPMD partitioner, so the
rows are split here, by hand, for the plain path too); use it directly
when you want the solver state without the final warp.

The delta-band/boundary semantics use *global* row indices
(ops.gradients docstring; reference boundary logic at
src/keras-tf/tf_inverse_compositional_algorithm.py:19-37 is global too).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

try:  # JAX >= 0.4.35 exports it at top level
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from .. import constants as cts
from ..models.ic import ICState, _system_builder, _trip
from ..ops.normal_equations import RobustLoss
from ..ops.transforms import TransformType, pad_params
from .mesh import PAIRS_AXIS, TILE_AXIS, Mesh

__all__ = ["tiled_ic_solve", "tiled_pyramidal_solve"]


def _halo_gradients(i1_loc, nt: int, y0, height: int, delta: int,
                    nanifoutside: bool):
    """Central-difference gradients of a row shard with ppermute halos.

    x-gradients are width-local (no communication); the y central
    difference needs the last row of the shard above and the first row of
    the shard below — one ppermute each way. Rows at the *global* border
    are zeroed (matching ops.gradients.central_gradients), and the
    delta-band mask is applied with global coordinates.
    """
    dt = i1_loc.dtype
    b, h_loc, w, c = i1_loc.shape

    ix = 0.5 * (i1_loc[:, :, 2:, :] - i1_loc[:, :, :-2, :])
    ix = jnp.pad(ix, ((0, 0), (0, 0), (1, 1), (0, 0)))

    if nt > 1:
        down = [(i, i + 1) for i in range(nt - 1)]   # send last row downward
        up = [(i + 1, i) for i in range(nt - 1)]     # send first row upward
        top = lax.ppermute(i1_loc[:, -1:, :, :], TILE_AXIS, down)
        bot = lax.ppermute(i1_loc[:, :1, :, :], TILE_AXIS, up)
    else:
        top = jnp.zeros_like(i1_loc[:, :1])
        bot = jnp.zeros_like(i1_loc[:, :1])
    above = jnp.concatenate([top, i1_loc[:, :-1]], axis=1)
    below = jnp.concatenate([i1_loc[:, 1:], bot], axis=1)
    iy = 0.5 * (below - above)

    rows = jnp.arange(h_loc) + y0                    # global row indices
    interior = ((rows >= 1) & (rows <= height - 2)).astype(dt)
    iy = iy * interior[None, :, None, None]

    if nanifoutside and delta > 0:
        cols = np.arange(w)
        cok = jnp.asarray(((cols >= delta) & (cols < w - delta))
                          .astype(np.float32), dt)
        rok = ((rows >= delta) & (rows < height - delta)).astype(dt)
        band = rok[:, None] * cok[None, :]
        ix = ix * band[None, :, :, None]
        iy = iy * band[None, :, :, None]
    return ix, iy


@lru_cache(maxsize=128)
def _build_tiled_fn(
    ttype: TransformType,
    mesh: Mesh,
    tol: float,
    max_iter: int,
    robust: RobustLoss,
    lam: float,
    nanifoutside: bool,
    delta: int,
    precondition: bool,
    hessian_chunk: int,
    shape: tuple,
    dtype_name: str,
    path: str = "xla",
    divergence_guard: bool = True,
    delta_cap: bool = True,
):
    """Build + jit the shard_map program for one static configuration.

    Cached on every static argument (jit keys on function identity, so a
    fresh closure per call would retrace/recompile each solve)."""
    from ..models.ic import effective_delta

    bsz, hh, ww, _ = shape
    dt = jnp.dtype(dtype_name)
    nt = mesh.shape[TILE_AXIS]
    h_loc = hh // nt
    if delta_cap:
        delta = effective_delta(delta, hh, ww)   # same cap as models.ic
    is_robust = robust is not RobustLoss.QUADRATIC
    lam0 = lam if lam > 0 else cts.LAMBDA_0

    def shard_fn(i1_loc, i2_full, p0_loc):
        y0 = lax.axis_index(TILE_AXIS) * h_loc
        b_loc = i1_loc.shape[0]
        ix, iy = _halo_gradients(i1_loc, nt, y0, hh, delta, nanifoutside)
        # Each device forms only its local rows' partial system (the
        # replicated full moving image is sampled at global coordinates);
        # one psum per trip makes it the full-frame system. On the kernel
        # path only the [B, K, 5, 5] moment partials cross the interconnect.
        scale, system = _system_builder(
            i1_loc, i2_full, ix, iy, ttype, robust=robust,
            nanifoutside=nanifoutside, delta=delta,
            precondition=precondition, hessian_chunk=hessian_chunk,
            path=path, y_offset=y0,
            reduce=lambda x: lax.psum(x, TILE_AXIS))
        p0p = pad_params(jnp.asarray(p0_loc, dt))

        def body(s):
            h, b = system(s.p, s.lam)
            return _trip(s, h, b, p0p, ttype=ttype, height=hh, width=ww,
                         scale=scale, tol=tol, max_iter=max_iter,
                         annealing=is_robust and lam <= 0,
                         divergence_guard=divergence_guard)

        # Variance-checked shard_map: per-pair carries start with the
        # pairs-varying type the loop body produces. (The kernel paths run
        # check_vma=False — pallas_call outputs carry no vma type — so the
        # pcast is skipped there.)
        if path == "xla":
            vary = lambda x: jax.lax.pcast(x, PAIRS_AXIS, to="varying")  # noqa: E731
        else:
            vary = lambda x: x  # noqa: E731
        init = ICState(
            p=p0p,
            error=vary(jnp.full((b_loc,), 1e10, dt)),
            lam=vary(jnp.full((b_loc,), lam0, dt)),
            it=jnp.asarray(0, jnp.int32),
            niters=vary(jnp.zeros((b_loc,), jnp.int32)),
            active=vary(jnp.ones((b_loc,), bool)),
            diverged=vary(jnp.zeros((b_loc,), bool)),
        )
        s = lax.while_loop(lambda s: jnp.any(s.active), body, init)
        # Each pairs-shard runs its own while_loop trip count, so the
        # scalar `it` diverges across the pairs axis; reduce it to a
        # well-defined replicated diagnostic (max trip count). lam is
        # per-pair state like the flagship solver.
        return ICState(p=s.p, error=s.error, lam=s.lam,
                       it=lax.pmax(s.it, PAIRS_AXIS),
                       niters=s.niters, active=s.active, diverged=s.diverged)

    pp = P(PAIRS_AXIS)
    state_specs = ICState(p=pp, error=pp, lam=pp, it=P(), niters=pp,
                          active=pp, diverged=pp)
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(PAIRS_AXIS, TILE_AXIS), P(PAIRS_AXIS), pp),
        out_specs=state_specs,
        check_vma=(path == "xla"),
    )
    return jax.jit(fn)


def tiled_ic_solve(
    i1,
    i2,
    p0,
    ttype: TransformType,
    *,
    mesh: Mesh,
    tol: float = 1e-3,
    max_iter: int = cts.MAX_ITER,
    robust: RobustLoss = RobustLoss.QUADRATIC,
    lam: float = 0.0,
    nanifoutside: bool = True,
    delta: int = 10,
    precondition: bool = True,
    hessian_chunk: int = 16384,
    path: str = "xla",
    divergence_guard: bool = True,
    delta_cap: bool = True,
):
    """Single-scale IC/IRLS solve, row-tiled over mesh axis "tile" and
    batch-sharded over "pairs". Numerically equivalent to models.ic.ic_solve
    up to float summation order — INCLUDING per-pair lambda annealing and
    the divergence guard (lost pairs revert to the warm start with
    `diverged` set, exactly like the flagship solver). The compiled
    program is cached per (config, mesh, shape, dtype) — repeated solves
    pay compile cost once.

    Args:
      i1, i2: [B, H, W, C]; B divisible by the pairs axis, H by the tile
        axis. p0: [B, 8].
      path: per-trip path (models.ic.PATHS); "kernel" and "interpret" run
        the fused iteration kernel on each device's rows, with one
        [B, K, 5, 5] moment psum per trip.

    Returns:
      ICState (p/error/lam/niters/diverged sharded over pairs; `it` is the
      replicated max trip count across pair shards).
    """
    bsz, hh, ww, _ = i1.shape
    dt = i1.dtype
    nt = mesh.shape[TILE_AXIS]
    npair = mesh.shape[PAIRS_AXIS]
    if hh % nt:
        raise ValueError(f"H={hh} not divisible by tile axis size {nt}")
    if bsz % npair:
        raise ValueError(f"B={bsz} not divisible by pairs axis size {npair}")
    fn = _build_tiled_fn(ttype, mesh, float(tol), int(max_iter), robust,
                         float(lam), bool(nanifoutside), int(delta),
                         bool(precondition), int(hessian_chunk),
                         tuple(i1.shape), jnp.dtype(dt).name,
                         path, bool(divergence_guard), bool(delta_cap))
    return fn(i1, i2, pad_params(jnp.asarray(p0, dt)))


def tiled_pyramidal_solve(
    i1,
    i2,
    p0,
    ttype: TransformType,
    *,
    mesh: Mesh,
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
    divergence_guard: bool = True,
    delta_cap: bool = True,
):
    """Coarse-to-fine pyramid over the explicitly-tiled SP solver.

    Semantics of models.pyramidal.pyramidal_solve, with each level solved
    by `tiled_ic_solve` when its height divides the tile axis — the big,
    expensive levels, which is where spatial sharding pays — and by the
    single-device-semantics `models.ic.ic_solve` otherwise (tiny coarse
    levels whose odd heights don't split; their cost is negligible and
    XLA's SPMD partitioner still shards them over pairs). Parameters are
    rescaled between levels exactly like the reference driver
    (src/inverse_compositional_algorithm.py:340-372). The whole pyramid
    is one jitted program, cached per static setting, so a warm call
    reuses it.

    Returns (state, per_scale) like pyramidal_solve.
    """
    fn = _build_pyramid_fn(
        ttype, mesh, int(nscales), float(nu), pyramid_method,
        tol=float(tol), max_iter=int(max_iter), robust=robust,
        lam=float(lam), nanifoutside=bool(nanifoutside), delta=int(delta),
        precondition=bool(precondition), hessian_chunk=int(hessian_chunk),
        path=path, divergence_guard=bool(divergence_guard),
        delta_cap=bool(delta_cap))
    return fn(i1, i2, p0)


@lru_cache(maxsize=64)
def _build_pyramid_fn(ttype: TransformType, mesh: Mesh, nscales: int,
                      nu: float, pyramid_method: str, **kw):
    """Jit the tiled pyramid for one static configuration (cached for the
    same reason as _build_tiled_fn)."""
    from ..models.ic import ic_solve
    from ..ops.pyramid import build_pyramid, pyramid_shapes
    from ..ops.transforms import zoom_in_params

    nt = mesh.shape[TILE_AXIS]

    def run(i1, i2, p0):
        _, hh, ww, _ = i1.shape
        shapes = pyramid_shapes(hh, ww, nscales, nu)
        pyr1 = build_pyramid(i1, nscales, nu, pyramid_method)
        pyr2 = build_pyramid(i2, nscales, nu, pyramid_method)

        p = pad_params(jnp.asarray(p0, i1.dtype))
        for s in range(1, nscales):
            (fh, fw), (ch, cw) = shapes[s - 1], shapes[s]
            p = zoom_in_params(p, ttype, fw, fh, cw, ch)

        per_scale = []
        state = None
        for s in range(nscales - 1, -1, -1):
            if shapes[s][0] % nt == 0:
                state = tiled_ic_solve(pyr1[s], pyr2[s], p, ttype, mesh=mesh,
                                       **kw)
            else:
                state = ic_solve(pyr1[s], pyr2[s], p, ttype, **kw)
            per_scale.append(state)
            if s > 0:
                (fh, fw), (ch, cw) = shapes[s - 1], shapes[s]
                p = zoom_in_params(state.p, ttype, cw, ch, fw, fh)
        return state, per_scale

    return jax.jit(run)
