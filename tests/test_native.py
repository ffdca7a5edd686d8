"""Native C++ engine vs the JAX path (independent implementations must agree)."""

import numpy as np
import pytest

import jax.numpy as jnp

from inverse_compositional_algorithm_tpu import native_bridge as nb
from inverse_compositional_algorithm_tpu.ops.gradients import central_gradients
from inverse_compositional_algorithm_tpu.ops.normal_equations import hessian, rhs
from inverse_compositional_algorithm_tpu.ops.transforms import (
    TransformType, jacobian_fields, pad_params,
)
from inverse_compositional_algorithm_tpu.ops.warp import warp_image


@pytest.fixture(autouse=True)
def _native_library():
    """Build (first use) or load the library inside the test, never at
    import, so every test worker collects the same tests."""
    if not nb.available():
        pytest.skip("native library could not be built")


@pytest.mark.parametrize("ttype,p", [
    (TransformType.TRANSLATION, [1.7, -0.8]),
    (TransformType.EUCLIDEAN, [1.0, 0.5, 0.03]),
    (TransformType.HOMOGRAPHY, [0.01, 0.002, 1.5, -0.001, 0.004, 0.7,
                                1e-5, -2e-5]),
])
def test_warp_matches_jax(ttype, p):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (33, 47, 3)).astype(np.float32)
    p8 = np.zeros(8); p8[:len(p)] = p
    native = nb.warp_bicubic(img, p8, ttype.value, nanifoutside=True, delta=3)
    jw, valid = warp_image(jnp.asarray(img)[None],
                           pad_params(jnp.asarray(p8, jnp.float32))[None],
                           ttype, delta=3)
    jaxw = np.where(np.asarray(valid)[0][..., None], np.asarray(jw)[0], np.nan)
    mask = np.isfinite(native)
    assert (mask == np.isfinite(jaxw)).all()
    np.testing.assert_allclose(native[mask], jaxw[mask], atol=2e-3)


def test_gradients_match_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (21, 17, 3)).astype(np.float32)
    nix, niy = nb.gradients(img)
    jix, jiy = central_gradients(jnp.asarray(img)[None])
    np.testing.assert_allclose(nix, np.asarray(jix)[0], atol=1e-4)
    np.testing.assert_allclose(niy, np.asarray(jiy)[0], atol=1e-4)


@pytest.mark.parametrize("ttype", [TransformType.EUCLIDEAN,
                                   TransformType.HOMOGRAPHY])
def test_normal_eq_matches_jax(ttype):
    rng = np.random.default_rng(2)
    h, w = 19, 23
    gx = rng.normal(size=(h, w)).astype(np.float32)
    gy = rng.normal(size=(h, w)).astype(np.float32)
    r = rng.normal(size=(h, w)).astype(np.float32)
    w1, w2, w3, wu, wv = gx * gx, gx * gy, gy * gy, gx * r, gy * r
    hn, bn = nb.normal_eq(w1, w2, w3, wu, wv, ttype.value)
    jx, jy = jacobian_fields(ttype, h, w, dtype=jnp.float64)
    hj = hessian(jnp.asarray(w1, jnp.float64)[None],
                 jnp.asarray(w2, jnp.float64)[None],
                 jnp.asarray(w3, jnp.float64)[None], jx, jy)
    bj = rhs(jnp.asarray(wu, jnp.float64)[None],
             jnp.asarray(wv, jnp.float64)[None], jx, jy)
    np.testing.assert_allclose(hn, np.asarray(hj)[0], rtol=1e-5)
    np.testing.assert_allclose(bn, np.asarray(bj)[0], rtol=1e-5)


def test_native_full_solve_matches_jax(make_pair):
    """The native engine's complete single-pair solve converges to the same
    parameters as ic_solve (f64 native vs preconditioned-f32 JAX)."""
    import jax.numpy as jnp

    from inverse_compositional_algorithm_tpu import native_bridge as nb
    from inverse_compositional_algorithm_tpu.models.ic import ic_solve
    from inverse_compositional_algorithm_tpu.ops.normal_equations import RobustLoss
    from inverse_compositional_algorithm_tpu.ops.transforms import TransformType

    if not nb.available():
        pytest.skip("native library unavailable")
    for ttype, gt, robust in (
        (TransformType.TRANSLATION, [2.5, -1.75], 0),
        (TransformType.EUCLIDEAN, [1.0, -0.5, 0.02], 4),   # charbonnier
        (TransformType.SIMILARITY, [0.5, -1.0, 0.01, -0.008], 0),
        (TransformType.AFFINITY, [1.0, 0.5, 0.01, -0.005, 0.004, -0.01], 0),
        (TransformType.HOMOGRAPHY,
         [0.008, -0.004, 1.0, 0.005, -0.006, -0.75, 1e-6, -5e-7], 3),
    ):
        i1, i2 = make_pair(gt, ttype)
        p_nat, err, nit = nb.solve(i1, i2, np.zeros(8), ttype.value,
                                   robust_value=robust, delta=5)
        s = ic_solve(jnp.asarray(i1, jnp.float32)[None],
                     jnp.asarray(i2, jnp.float32)[None],
                     jnp.zeros((1, 8), jnp.float32), ttype, delta=5,
                     robust=RobustLoss(robust))
        k = len(gt)
        assert nit >= 2 and err < 1e-3
        np.testing.assert_allclose(p_nat[:k], gt, atol=5e-3)
        np.testing.assert_allclose(p_nat[:k], np.asarray(s.p[0, :k]),
                                   atol=5e-3)
