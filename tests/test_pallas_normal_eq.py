"""Moment form of the normal equations (the fused kernel's reference) vs
numpy and the plain Hessian / right-hand side."""

import numpy as np
import pytest

import jax.numpy as jnp

from inverse_compositional_algorithm_tpu.ops import normal_equations as ne
from inverse_compositional_algorithm_tpu.ops.transforms import (
    TransformType, jacobian_fields, param_preconditioner,
)


@pytest.fixture(scope="module")
def maps():
    rng = np.random.default_rng(0)
    b, h, w = 2, 21, 37
    gx = rng.normal(size=(b, h, w))
    gy = rng.normal(size=(b, h, w))
    r = rng.normal(size=(b, h, w))
    return [jnp.asarray(m, jnp.float32)
            for m in (gx * gx, gx * gy, gy * gy, gx * r, gy * r)]


def _moments(maps, **kw):
    b, h, w = maps[0].shape
    return ne.coordinate_moments(jnp.stack(maps, axis=1), float(max(h, w)),
                                 **kw)


def test_moments_match_numpy(maps):
    stack = jnp.stack(maps, axis=1)
    got = np.asarray(_moments(maps))
    b, k, h, w = stack.shape
    l = float(max(h, w))
    xs = np.arange(w) / l
    ys = np.arange(h) / l
    xp = np.stack([xs ** a for a in range(5)], -1)
    yp = np.stack([ys ** c for c in range(5)], -1)
    exp = np.einsum("qkhw,wa,hc->qkca", np.asarray(stack, np.float64), xp, yp)
    assert got.shape == (b, k, 5, 5)
    np.testing.assert_allclose(got, exp, rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("ttype", list(TransformType),
                         ids=[t.name for t in TransformType])
def test_fused_matches_xla(maps, ttype):
    """The assembly turns the moments into the preconditioned H and b of
    hessian() / rhs() for every transform."""
    b, h, w = maps[0].shape
    s = param_preconditioner(ttype, h, w)
    jx, jy = jacobian_fields(ttype, h, w, dtype=jnp.float64, scale=s)
    m64 = [jnp.asarray(np.asarray(m), jnp.float64) for m in maps]
    h_ref = np.asarray(ne.hessian(*m64[:3], jx, jy))
    b_ref = np.asarray(ne.rhs(m64[3], m64[4], jx, jy))
    m = _moments(maps)
    hh = ne.assemble_hessian(m[:, :3], ttype)
    bb = ne.assemble_rhs(m[:, 3:], ttype)
    np.testing.assert_allclose(np.asarray(hh), h_ref,
                               atol=2e-4 * np.abs(h_ref).max())
    np.testing.assert_allclose(np.asarray(bb), b_ref,
                               atol=2e-4 * np.abs(b_ref).max())


def test_split_entry_points(maps):
    """Moments of the Hessian maps alone and of the rhs maps alone assemble
    to the same system as one stack of all five."""
    ttype = TransformType.HOMOGRAPHY
    m_all = _moments(maps)
    h_only = ne.assemble_hessian(_moments(maps[:3]), ttype)
    b_only = ne.assemble_rhs(_moments(maps[3:]), ttype)
    np.testing.assert_allclose(np.asarray(h_only),
                               np.asarray(ne.assemble_hessian(m_all[:, :3], ttype)),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(b_only),
                               np.asarray(ne.assemble_rhs(m_all[:, 3:], ttype)),
                               rtol=1e-6)


def test_uneven_tiling(maps):
    """Row blocks with their global y_offset sum to the full-frame moments,
    whatever the (uneven) split."""
    b, h, w = maps[0].shape
    stack = jnp.stack(maps, axis=1)
    full = np.asarray(_moments(maps))
    for cuts in ((0, 8, 16, h), (0, 5, h)):
        parts = sum(
            np.asarray(ne.coordinate_moments(stack[:, :, r0:r1],
                                              float(max(h, w)), y_offset=r0))
            for r0, r1 in zip(cuts[:-1], cuts[1:]))
        np.testing.assert_allclose(parts, full, rtol=1e-5, atol=1e-5)
