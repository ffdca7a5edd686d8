"""shard_map tiled solver: parity with the single-device solver.

Runs on the 8-fake-device CPU mesh (conftest). The tiled path must agree
with models.ic.ic_solve up to float summation order.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from inverse_compositional_algorithm_tpu.models.ic import ic_solve
from inverse_compositional_algorithm_tpu.ops.normal_equations import RobustLoss
from inverse_compositional_algorithm_tpu.ops.transforms import TransformType
from inverse_compositional_algorithm_tpu.parallel.mesh import make_mesh
from inverse_compositional_algorithm_tpu.parallel.tiled import tiled_ic_solve


def _pair_batch(make_pair, p_gt, ttype, b=2, h=64, w=80):
    i1, i2 = make_pair(p_gt, ttype)
    i1 = np.broadcast_to(i1[None, :h, :w], (b, h, w, 3)).astype(np.float32)
    i2 = np.broadcast_to(i2[None, :h, :w], (b, h, w, 3)).astype(np.float32)
    return jnp.asarray(i1), jnp.asarray(i2), jnp.zeros((b, 8), jnp.float32)


@pytest.mark.parametrize("ttype,p_gt", [
    (TransformType.TRANSLATION, [1.5, -1.0]),
    (TransformType.HOMOGRAPHY, [0.01, 0.002, 1.0, -0.001, 0.005, 0.5,
                                2e-5, -3e-5]),
], ids=["translation", "homography"])
def test_tiled_matches_single_device(make_pair, ttype, p_gt):
    i1, i2, p0 = _pair_batch(make_pair, p_gt, ttype)
    mesh = make_mesh(pairs=2, tile=4)
    st_t = tiled_ic_solve(i1, i2, p0, ttype, mesh=mesh, delta=8)
    st_s = ic_solve(i1, i2, p0, ttype, delta=8)
    np.testing.assert_allclose(np.asarray(st_t.p), np.asarray(st_s.p),
                               atol=2e-4)
    est = np.asarray(st_t.p)[0, :len(p_gt)]
    np.testing.assert_allclose(est, p_gt, atol=2e-3)


def test_tiled_robust_matches(make_pair):
    p_gt = [1.5, -1.0, 0.01]
    i1, i2, p0 = _pair_batch(make_pair, p_gt, TransformType.EUCLIDEAN)
    mesh = make_mesh(pairs=1, tile=8)
    st_t = tiled_ic_solve(i1, i2, p0, TransformType.EUCLIDEAN, mesh=mesh,
                          delta=8, robust=RobustLoss.CHARBONNIER)
    st_s = ic_solve(i1, i2, p0, TransformType.EUCLIDEAN, delta=8,
                    robust=RobustLoss.CHARBONNIER)
    np.testing.assert_allclose(np.asarray(st_t.p), np.asarray(st_s.p),
                               atol=5e-4)
    np.testing.assert_allclose(np.asarray(st_t.p)[0, :3], p_gt, atol=5e-3)


def test_tiled_validates_divisibility(make_pair):
    i1, i2, p0 = _pair_batch(make_pair, [1.0, 0.0],
                             TransformType.TRANSLATION, h=60)
    mesh = make_mesh(pairs=1, tile=8)
    with pytest.raises(ValueError, match="not divisible"):
        tiled_ic_solve(i1, i2, p0, TransformType.TRANSLATION, mesh=mesh)


def test_tiled_pallas_warp_matches(make_pair):
    """The kernel path (interpreter) runs the fused iteration kernel on
    each row shard under shard_map; results must match the plain tiled
    solve to summation-order tolerance."""
    p_gt = [1.5, -1.0]
    i1, i2, p0 = _pair_batch(make_pair, p_gt, TransformType.TRANSLATION)
    mesh = make_mesh(pairs=2, tile=4)
    st_x = tiled_ic_solve(i1, i2, p0, TransformType.TRANSLATION, mesh=mesh,
                          delta=8)
    st_p = tiled_ic_solve(i1, i2, p0, TransformType.TRANSLATION, mesh=mesh,
                          delta=8, path="interpret")
    np.testing.assert_allclose(np.asarray(st_p.p), np.asarray(st_x.p),
                               atol=2e-4)
    np.testing.assert_allclose(np.asarray(st_p.p)[0, :2], p_gt, atol=2e-3)


def test_tiled_pyramidal_matches_pyramidal_solve(make_pair):
    """The SP pyramid driver must agree with models.pyramidal.pyramidal_solve
    (both warm-start propagation and per-level solves), mixing tiled levels
    (height divisible by the tile axis) with single-device coarse levels."""
    from inverse_compositional_algorithm_tpu.models.pyramidal import (
        pyramidal_solve,
    )
    from inverse_compositional_algorithm_tpu.parallel.tiled import (
        tiled_pyramidal_solve,
    )

    p_gt = [3.0, -2.0]
    i1, i2, p0 = _pair_batch(make_pair, p_gt, TransformType.TRANSLATION,
                             b=2, h=64, w=80)
    mesh = make_mesh(pairs=2, tile=4)
    st_t, per_t = tiled_pyramidal_solve(
        i1, i2, p0, TransformType.TRANSLATION, mesh=mesh, nscales=3,
        delta=6, robust=RobustLoss.CHARBONNIER)
    st_s, per_s = pyramidal_solve(
        i1, i2, p0, TransformType.TRANSLATION, nscales=3, delta=6,
        robust=RobustLoss.CHARBONNIER)
    assert len(per_t) == len(per_s) == 3
    np.testing.assert_allclose(np.asarray(st_t.p), np.asarray(st_s.p),
                               atol=5e-4)
    np.testing.assert_allclose(np.asarray(st_t.p)[0, :2], p_gt, atol=5e-3)


def _smooth(h, w, seed=0):
    from inverse_compositional_algorithm_tpu.ops.pyramid import gaussian_blur

    rng = np.random.default_rng(seed)
    noise = jnp.asarray(rng.uniform(0, 255, (1, h, w, 3)), jnp.float32)
    return gaussian_blur(noise, 2.0)


def test_tiled_fused_robust_matches(make_pair):
    """Robust IRLS through the fused iteration kernel under shard_map (a
    per-shard y_offset); must match the single-device kernel-path solver."""
    p_gt = [1.5, -1.0, 0.01]
    i1, i2, p0 = _pair_batch(make_pair, p_gt, TransformType.EUCLIDEAN)
    mesh = make_mesh(pairs=2, tile=4)
    st_t = tiled_ic_solve(i1, i2, p0, TransformType.EUCLIDEAN, mesh=mesh,
                          delta=8, robust=RobustLoss.CHARBONNIER,
                          path="interpret")
    st_s = ic_solve(i1, i2, p0, TransformType.EUCLIDEAN, delta=8,
                    robust=RobustLoss.CHARBONNIER, path="interpret")
    np.testing.assert_allclose(np.asarray(st_t.p), np.asarray(st_s.p),
                               atol=5e-4)
    np.testing.assert_allclose(np.asarray(st_t.lam), np.asarray(st_s.lam),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(st_t.p)[0, :3], p_gt, atol=5e-3)


def test_tiled_diverged_flag_parity():
    """A lost pair must revert + flag EXACTLY like models.ic.ic_solve:
    same diverged flags, same reverted p, same early exit (round-4 VERDICT:
    the tiled diverged flag was dead)."""
    h, w = 48, 64
    img = _smooth(h, w)
    from inverse_compositional_algorithm_tpu.ops.transforms import (
        pad_params,
        transform_grid,
    )
    from inverse_compositional_algorithm_tpu.ops.warp import bicubic_sample

    p_gt = pad_params(jnp.asarray([[1.5, -1.0]], jnp.float32),
                      TransformType.TRANSLATION)
    gx, gy = transform_grid(p_gt, TransformType.TRANSLATION, h, w)
    i1 = jnp.concatenate([bicubic_sample(img, gx, gy), img])
    i2 = jnp.concatenate([img, img])
    p0 = jnp.zeros((2, 8), jnp.float32).at[1, 0].set(5.0 * w)

    mesh = make_mesh(pairs=2, tile=4)
    st_t = tiled_ic_solve(i1, i2, p0, TransformType.TRANSLATION, mesh=mesh,
                          delta=3)
    st_s = ic_solve(i1, i2, p0, TransformType.TRANSLATION, delta=3)
    np.testing.assert_array_equal(np.asarray(st_t.diverged),
                                  np.asarray(st_s.diverged))
    assert not bool(st_t.diverged[0]) and bool(st_t.diverged[1])
    np.testing.assert_allclose(np.asarray(st_t.p[0, :2]), [1.5, -1.0],
                               atol=1e-2)
    np.testing.assert_allclose(np.asarray(st_t.p[1]), np.asarray(p0[1]))
    np.testing.assert_array_equal(np.asarray(st_t.niters),
                                  np.asarray(st_s.niters))
    assert int(st_t.niters[1]) <= 2


def test_tiled_per_pair_lambda():
    """lambda anneals per pair in the tiled solver (was a shared scalar):
    a converged pair's lambda freezes while the active pair keeps the
    80 * 0.9^k schedule."""
    from inverse_compositional_algorithm_tpu import constants as cts
    from inverse_compositional_algorithm_tpu.ops.transforms import (
        pad_params,
        transform_grid,
    )
    from inverse_compositional_algorithm_tpu.ops.warp import bicubic_sample

    h, w = 48, 64
    img = _smooth(h, w)
    p_gt = pad_params(jnp.asarray([[2.5, -2.0]], jnp.float32),
                      TransformType.TRANSLATION)
    gx, gy = transform_grid(p_gt, TransformType.TRANSLATION, h, w)
    i1 = jnp.concatenate([img, bicubic_sample(img, gx, gy)])
    i2 = jnp.concatenate([img, img])
    p0 = jnp.zeros((2, 8), jnp.float32)

    mesh = make_mesh(pairs=1, tile=8)
    st_t = tiled_ic_solve(i1, i2, p0, TransformType.TRANSLATION, mesh=mesh,
                          delta=3, robust=RobustLoss.CHARBONNIER)
    st_s = ic_solve(i1, i2, p0, TransformType.TRANSLATION, delta=3,
                    robust=RobustLoss.CHARBONNIER)
    lam_t = np.asarray(st_t.lam)
    assert lam_t.shape == (2,)
    np.testing.assert_allclose(lam_t, np.asarray(st_s.lam), rtol=1e-6)
    n0, n1 = int(st_t.niters[0]), int(st_t.niters[1])
    assert n0 < n1
    # each pair's lambda is its OWN k-step annealed value
    for i, n in ((0, n0), (1, n1)):
        np.testing.assert_allclose(
            lam_t[i],
            max(cts.LAMBDA_0 * cts.LAMBDA_RATIO ** n, cts.LAMBDA_N),
            rtol=1e-6)
