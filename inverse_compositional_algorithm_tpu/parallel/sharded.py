"""Mesh-sharded alignment: data parallelism over pairs (+ optional row tiling).

`align_sharded` is the scale-out twin of models.api.align: the same
pipeline over a ("pairs", "tile") mesh. Every per-pair quantity
(images, parameters, errors, convergence flags) shards over the pairs axis,
so the per-pair convergence masking from models/ic.py carries over unchanged
— thousands of keyframe registrations run concurrently, each stopping on its
own criterion. With tile > 1 the template's rows are also split over the
tile axis (parallel.tiled), which spreads the bandwidth-bound moment
computations; only the per-trip moments are reduced across the devices.

Multi-host: call `init_distributed()` first (jax.distributed), then build
the mesh over `jax.devices()` as usual — the global mesh spans hosts and
each host feeds its addressable shard of the pair batch.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp

from ..config import AlignConfig
from ..models.api import AlignResult, _align_impl, _finish, solver_path
from ..ops.transforms import pad_params
from .mesh import (
    PAIRS_AXIS,
    Mesh,
    P,
    image_sharding,
    make_mesh,
    pair_sharding,
)
from .tiled import shard_map, tiled_pyramidal_solve

__all__ = ["align_sharded", "init_distributed"]


def init_distributed(**kwargs) -> None:
    """Multi-host bring-up (jax.distributed.initialize passthrough)."""
    jax.distributed.initialize(**kwargs)


def align_sharded(i1, i2, config: AlignConfig = AlignConfig(), p0=None,
                  mesh: Mesh | None = None, tile_rows: bool = False,
                  dtype=jnp.float32) -> AlignResult:
    """Align a batch of pairs sharded across the mesh.

    Args:
      i1, i2: [B, H, W, C]; B must divide by the mesh's pairs axis.
        Single-process: B is the global batch. Multi-process
        (jax.process_count() > 1): i1/i2/p0 are THIS PROCESS's shard of
        the batch (each host feeds different pairs; the global batch is
        B * process_count, assembled with
        jax.make_array_from_process_local_data).
      mesh: a ("pairs", "tile") mesh (default: all devices on pairs).
      tile_rows: also shard image rows over the tile axis.

    Pairs data parallelism maps `align`'s pipeline over the pairs axis
    with shard_map, so each device runs the per-trip path of
    `solver_path` on its own pairs. With tile_rows, every path solves
    through the explicit row-split solver
    (parallel.tiled.tiled_pyramidal_solve): the fused kernel is opaque to
    XLA's SPMD pass, so the rows are split by hand. Either way the whole
    call is one jitted program, cached per (config, path, mesh, tile_rows).

    Returns:
      AlignResult with mesh-sharded leaves (use jax.device_get to fetch;
      multi-process callers see their addressable shards).
    """
    config.validate()
    path = solver_path(dtype, config.interpret)
    if mesh is None:
        mesh = make_mesh()
    i1 = jnp.asarray(i1, dtype)
    i2 = jnp.asarray(i2, dtype)
    b = i1.shape[0]
    if p0 is None:
        p0 = jnp.zeros((b, 8), dtype)
    else:
        p0 = pad_params(jnp.asarray(p0, dtype))

    img_s = image_sharding(mesh, tile_rows=tile_rows)
    vec_s = pair_sharding(mesh)
    nproc = jax.process_count()
    if nproc > 1:
        import numpy as np

        def glob(x, sh):
            gshape = (x.shape[0] * nproc,) + tuple(x.shape[1:])
            return jax.make_array_from_process_local_data(
                sh, np.asarray(x), gshape)

        i1, i2 = glob(i1, img_s), glob(i2, img_s)
        p0 = glob(p0, vec_s)
    else:
        i1, i2 = jax.device_put(i1, img_s), jax.device_put(i2, img_s)
        p0 = jax.device_put(p0, vec_s)

    return _sharded_fn(config, path, mesh, tile_rows)(i1, i2, p0)


def _tiled_align_impl(i1, i2, p0, config: AlignConfig, path: str,
                      mesh: Mesh) -> AlignResult:
    """`_align_impl` with the pyramid solved by the explicit row split."""
    state, per_scale = tiled_pyramidal_solve(
        i1, i2, p0, config.transform, mesh=mesh, nscales=config.nscales,
        nu=config.nu, tol=config.tol, max_iter=config.max_iter,
        robust=config.robust, lam=config.lam,
        nanifoutside=config.nanifoutside, delta=config.delta,
        pyramid_method=config.pyramid_method,
        precondition=config.precondition,
        hessian_chunk=config.hessian_chunk, path=path,
        divergence_guard=config.divergence_guard,
        delta_cap=config.delta_cap)
    return _finish(i1, i2, state, per_scale, config)


@lru_cache(maxsize=64)
def _sharded_fn(config: AlignConfig, path: str, mesh: Mesh, tile_rows: bool):
    """The jitted program for one static setting (cached: jit keys on the
    function object, so a fresh closure per call would recompile)."""
    if tile_rows:
        return jax.jit(partial(_tiled_align_impl, config=config, path=path,
                               mesh=mesh))
    return jax.jit(shard_map(
        partial(_align_impl, config=config, path=path),
        mesh=mesh, in_specs=P(PAIRS_AXIS), out_specs=P(PAIRS_AXIS),
        check_vma=False))
