"""Device-mesh helpers.

The reference has no multi-device support at all (SURVEY §2.2); scale-out
here follows the standard JAX recipe: build a named mesh, annotate array
shardings, let XLA insert the collectives between the devices.

Axes:
  * "pairs" — data parallelism over frame pairs (the primary scale-out:
    thousands of concurrent registrations).
  * "tile"  — spatial parallelism over image rows (for frames too large
    for one device; the normal equations reduce with psum, see
    parallel.tiled).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "pair_sharding", "image_sharding", "P", "NamedSharding"]

PAIRS_AXIS = "pairs"
TILE_AXIS = "tile"


def make_mesh(pairs: int | None = None, tile: int = 1, devices=None) -> Mesh:
    """Mesh over ("pairs", "tile"). Defaults to all devices on the pairs
    axis. Works identically for GPUs and the CPU fake-device test
    environment."""
    devices = list(devices if devices is not None else jax.devices())
    if pairs is None:
        pairs = len(devices) // tile
    n = pairs * tile
    if n > len(devices):
        raise ValueError(f"mesh {pairs}x{tile} needs {n} devices, "
                         f"have {len(devices)}")
    arr = np.array(devices[:n]).reshape(pairs, tile)
    return Mesh(arr, (PAIRS_AXIS, TILE_AXIS))


def pair_sharding(mesh: Mesh) -> NamedSharding:
    """[B, ...] arrays sharded over the pairs axis only."""
    return NamedSharding(mesh, P(PAIRS_AXIS))


def image_sharding(mesh: Mesh, tile_rows: bool = True) -> NamedSharding:
    """[B, H, W, C] images: batch over pairs, optionally rows over tile."""
    if tile_rows:
        return NamedSharding(mesh, P(PAIRS_AXIS, TILE_AXIS))
    return NamedSharding(mesh, P(PAIRS_AXIS))
