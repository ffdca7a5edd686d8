"""Sharded execution must reproduce single-device results exactly.

Runs on the 8-fake-CPU-device mesh from conftest (the standard JAX pattern
for validating pjit/psum logic without a pod — SURVEY §4)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import inverse_compositional_algorithm_tpu as ica
from inverse_compositional_algorithm_tpu.parallel.mesh import (
    make_mesh, pair_sharding,
)
from inverse_compositional_algorithm_tpu.parallel.sharded import align_sharded
from inverse_compositional_algorithm_tpu.ops.transforms import TransformType


requires_mesh = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (fake) devices")


@pytest.fixture(scope="module")
def batch8(request):
    make_pair = None
    # build 8 pairs with distinct translations from the session image
    import tests.conftest as c  # noqa
    rng = np.random.default_rng(7)
    from inverse_compositional_algorithm_tpu.ops.pyramid import gaussian_blur
    noise = rng.uniform(0, 255, (64, 80, 3)).astype(np.float32)
    img = np.array(gaussian_blur(jnp.asarray(noise[None]), 3.0))[0]
    from tests.conftest import synth_pair
    gts = rng.uniform(-2.0, 2.0, (8, 2)).astype(np.float32)
    i1 = np.stack([synth_pair(img, g, TransformType.TRANSLATION)[0] for g in gts])
    i2 = np.broadcast_to(img[None], i1.shape).copy()
    return i1, i2, gts


@requires_mesh
def test_pairs_dp_matches_single_device(batch8):
    i1, i2, gts = batch8
    cfg = ica.AlignConfig(transform=TransformType.TRANSLATION, nscales=1, delta=6)
    ref = ica.align(i1, i2, cfg)
    mesh = make_mesh(pairs=8, tile=1)
    got = align_sharded(i1, i2, cfg, mesh=mesh)
    np.testing.assert_allclose(np.asarray(got.p), np.asarray(ref.p), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.niters), np.asarray(ref.niters))
    # each pair actually found its own motion
    np.testing.assert_allclose(np.asarray(got.p)[:, :2], gts, atol=5e-3)


@requires_mesh
def test_pairs_dp_is_actually_sharded(batch8):
    i1, i2, _ = batch8
    cfg = ica.AlignConfig(transform=TransformType.TRANSLATION, nscales=1, delta=6)
    mesh = make_mesh(pairs=8, tile=1)
    got = align_sharded(i1, i2, cfg, mesh=mesh)
    # result parameters stay sharded over the pairs axis
    assert got.p.sharding.is_equivalent_to(pair_sharding(mesh), got.p.ndim)


@requires_mesh
def test_tile_sharding_matches(batch8):
    i1, i2, _ = batch8
    cfg = ica.AlignConfig(transform=TransformType.TRANSLATION, nscales=1, delta=6)
    ref = ica.align(i1, i2, cfg)
    mesh = make_mesh(pairs=4, tile=2)
    got = align_sharded(i1, i2, cfg, mesh=mesh, tile_rows=True)
    np.testing.assert_allclose(np.asarray(got.p), np.asarray(ref.p), atol=1e-5)


@requires_mesh
def test_tile_rows_is_one_cached_program(batch8, monkeypatch):
    """A warm align_sharded(tile_rows=True) call reuses the compiled program:
    the row-split pyramid is traced once, not on every call. 60 rows over 4
    tiles leave the coarse level (30 rows) to the unsplit solver, inside
    the same program."""
    from inverse_compositional_algorithm_tpu.parallel import sharded

    i1, i2, gts = batch8
    i1, i2 = i1[:2, :60], i2[:2, :60]
    traces = []
    real = sharded.tiled_pyramidal_solve

    def counting(*args, **kwargs):
        traces.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(sharded, "tiled_pyramidal_solve", counting)
    sharded._sharded_fn.cache_clear()
    try:
        cfg = ica.AlignConfig(transform=TransformType.TRANSLATION, nscales=2,
                              delta=6)
        mesh = make_mesh(pairs=2, tile=4)
        first = align_sharded(i1, i2, cfg, mesh=mesh, tile_rows=True)
        second = align_sharded(i1, i2, cfg, mesh=mesh, tile_rows=True)
    finally:
        sharded._sharded_fn.cache_clear()
    assert len(traces) == 1
    np.testing.assert_array_equal(np.asarray(first.p), np.asarray(second.p))
    np.testing.assert_allclose(np.asarray(first.p)[:, :2], gts[:2], atol=5e-3)


@requires_mesh
def test_pyramid_sharded(batch8):
    i1, i2, gts = batch8
    cfg = ica.AlignConfig(transform=TransformType.TRANSLATION, nscales=2, delta=6)
    mesh = make_mesh(pairs=8, tile=1)
    got = align_sharded(i1, i2, cfg, mesh=mesh)
    np.testing.assert_allclose(np.asarray(got.p)[:, :2], gts, atol=5e-3)
