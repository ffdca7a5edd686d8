"""Fused iteration kernel vs the plain pipeline (its reference).

The CPU tests run the kernel in the Pallas interpreter; the `gpu` tests run
it as compiled for the card. The reference is the plain op chain of
models.ic (path "xla"): warp -> masked residual -> robust weights ->
channel-reduced moments -> preconditioned normal equations.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from inverse_compositional_algorithm_tpu.models.ic import (
    _masked_residual,
    normal_system,
)
from inverse_compositional_algorithm_tpu.ops.gradients import (
    boundary_band_mask,
    central_gradients,
)
from inverse_compositional_algorithm_tpu.ops.normal_equations import (
    RobustLoss,
    assemble_hessian,
    assemble_rhs,
    grad_moments,
    hessian,
    residual_moments,
    rhs,
    robust_weights,
)
from inverse_compositional_algorithm_tpu.ops.pallas import fused_iter
from inverse_compositional_algorithm_tpu.ops.pallas.fused_iter import (
    iteration_moments,
    pack_template,
)
from inverse_compositional_algorithm_tpu.ops.transforms import (
    TransformType,
    jacobian_fields,
    pad_params,
    param_preconditioner,
    transform_grid,
)
from inverse_compositional_algorithm_tpu.ops.warp import (
    bicubic_sample,
    domain_mask,
)


def _setup(ttype, p, b=2, h=37, w=53, c=3, delta=4, seed=0):
    rng = np.random.default_rng(seed)
    i2 = jnp.asarray(rng.uniform(0, 255, (b, h, w, c)), jnp.float32)
    i1 = jnp.asarray(rng.uniform(0, 255, (b, h, w, c)), jnp.float32)
    pp = jnp.broadcast_to(pad_params(jnp.asarray(p, jnp.float32), ttype),
                          (b, 8))
    ix, iy = central_gradients(i1)
    band = boundary_band_mask(h, w, delta).astype(jnp.float32)[None, ..., None]
    ix = ix * band
    iy = iy * band
    gmom = grad_moments(ix, iy)
    gx, gy = transform_grid(pp, ttype, h, w)
    return dict(i1=i1, i2=i2, ix=ix, iy=iy, gmom=gmom, p=pp, gx=gx, gy=gy,
                h=h, w=w, delta=delta, ttype=ttype)


def _oracle(e, robust, lam, nanifoutside=True):
    iw = bicubic_sample(e["i2"], e["gx"], e["gy"])
    valid = domain_mask(e["gx"], e["gy"], e["h"], e["w"], e["delta"])
    di = _masked_residual(iw, valid, e["i1"], nanifoutside)
    scale = param_preconditioner(e["ttype"], e["h"], e["w"])
    jx, jy = jacobian_fields(e["ttype"], e["h"], e["w"], dtype=jnp.float32,
                             scale=scale)
    rho = (robust_weights(di, lam, robust) if robust is not None else None)
    u, v = residual_moments(e["ix"], e["iy"], di)
    hm = hessian(*e["gmom"], jx, jy, weights=rho)
    bv = rhs(u, v, jx, jy, weights=rho)
    return hm, bv


def _fused(e, robust, lam, nanifoutside=True, interpret=True, block=None):
    b = e["i1"].shape[0]
    # A robust-packed template (P = 3C+3) also serves the quadratic kernel
    # (the 3 moment planes are unread).
    tpl = pack_template(e["i1"], e["ix"], e["iy"], e["gmom"])
    args = (e["i2"], tpl, e["p"], jnp.full((b,), lam, jnp.float32))
    kw = dict(ttype=e["ttype"], robust=robust, nanifoutside=nanifoutside,
              delta=e["delta"], interpret=interpret)
    if block is None:
        m = iteration_moments(*args, **kw)
    else:
        m = fused_iter._moments(*args, y_offset=0, block=block, **kw)
    if robust is not None:
        return (assemble_hessian(m[:, :3], e["ttype"]),
                assemble_rhs(m[:, 3:], e["ttype"]))
    return None, assemble_rhs(m, e["ttype"])


def _close(got, ref, tol=2e-4):
    """Agreement relative to the largest entry of each pair's system."""
    got, ref = np.asarray(got), np.asarray(ref)
    axes = tuple(range(1, ref.ndim))
    norm = np.maximum(np.abs(ref).max(axis=axes, keepdims=True), 1.0)
    np.testing.assert_allclose(got / norm, ref / norm, atol=tol)


CASES = [
    (TransformType.TRANSLATION, [3.25, -2.5]),
    (TransformType.EUCLIDEAN, [1.5, -0.5, 0.05]),
    (TransformType.AFFINITY, [1.0, -1.0, 0.05, -0.02, 0.03, -0.04]),
    (TransformType.HOMOGRAPHY,
     [0.02, -0.01, 2.0, 0.015, -0.02, -1.5, 1e-4, -5e-5]),
]

ALL_TRANSFORMS = CASES[:2] + [
    (TransformType.SIMILARITY, [0.5, 1.0, 0.03, -0.02])] + CASES[2:]


@pytest.mark.parametrize("ttype,p", CASES)
def test_robust_matches_pipeline(ttype, p):
    e = _setup(ttype, p)
    h_ref, b_ref = _oracle(e, RobustLoss.CHARBONNIER, 5.0)
    h_got, b_got = _fused(e, RobustLoss.CHARBONNIER, 5.0)
    _close(h_got, h_ref)
    _close(b_got, b_ref)


@pytest.mark.parametrize("loss", [RobustLoss.TRUNCATED_QUADRATIC,
                                  RobustLoss.GERMAN_MCCLURE,
                                  RobustLoss.LORENTZIAN])
def test_other_losses(loss):
    e = _setup(TransformType.EUCLIDEAN, [1.5, -0.5, 0.05], seed=3)
    h_ref, b_ref = _oracle(e, loss, 17.0)
    h_got, b_got = _fused(e, loss, 17.0)
    _close(h_got, h_ref)
    _close(b_got, b_ref)


def test_quadratic_rhs_matches():
    e = _setup(TransformType.HOMOGRAPHY,
               [0.02, -0.01, 2.0, 0.015, -0.02, -1.5, 1e-4, -5e-5], seed=1)
    _, b_ref = _oracle(e, None, 0.0)
    _, b_got = _fused(e, None, 0.0)
    _close(b_got, b_ref)


def test_nanifoutside_false():
    e = _setup(TransformType.TRANSLATION, [9.0, -7.0], seed=2)
    h_ref, b_ref = _oracle(e, RobustLoss.CHARBONNIER, 5.0, nanifoutside=False)
    h_got, b_got = _fused(e, RobustLoss.CHARBONNIER, 5.0, nanifoutside=False)
    _close(h_got, h_ref)
    _close(b_got, b_ref)


def test_extreme_rotation_moments_match():
    """A ~69-degree rotation (taps far from each output pixel's own row)
    must still produce the exact normal equations."""
    e = _setup(TransformType.EUCLIDEAN, [0.0, 0.0, 1.2], h=64, w=200)
    h_ref, b_ref = _oracle(e, RobustLoss.CHARBONNIER, 5.0)
    h_got, b_got = _fused(e, RobustLoss.CHARBONNIER, 5.0)
    _close(h_got, h_ref)
    _close(b_got, b_ref)


@pytest.mark.parametrize("ttype,p", ALL_TRANSFORMS,
                         ids=[t.name for t, _ in ALL_TRANSFORMS])
@pytest.mark.parametrize("robust", [None, RobustLoss.CHARBONNIER],
                         ids=["quadratic", "robust"])
def test_kernel_matches_plain_system(ttype, p, robust):
    """Every transform, both kernels (K = 2 quadratic, K = 5 robust)."""
    e = _setup(ttype, p, seed=5)
    h_ref, b_ref = _oracle(e, robust, 7.0)
    h_got, b_got = _fused(e, robust, 7.0)
    _close(b_got, b_ref)
    if robust is not None:
        _close(h_got, h_ref)


@pytest.mark.parametrize("robust", [None, RobustLoss.LORENTZIAN],
                         ids=["quadratic", "robust"])
def test_odd_frame_masks_its_edges(robust):
    """97x131 covers neither block dimension evenly; nanifoutside=False
    makes every out-of-domain pixel pull on the system."""
    e = _setup(TransformType.AFFINITY, [1.0, -1.0, 0.05, -0.02, 0.03, -0.04],
               h=97, w=131, seed=6)
    h_ref, b_ref = _oracle(e, robust, 9.0, nanifoutside=False)
    h_got, b_got = _fused(e, robust, 9.0, nanifoutside=False)
    _close(b_got, b_ref)
    if robust is not None:
        _close(h_got, h_ref)


@pytest.mark.parametrize("nanifoutside", [True, False])
def test_large_motion_out_of_domain_taps(nanifoutside):
    """A 30-px shift plus projective terms: a large share of the taps lands
    outside the frame and is clipped to its edge."""
    e = _setup(TransformType.HOMOGRAPHY,
               [0.1, -0.05, 30.0, 0.04, -0.08, -25.0, 2e-3, -1e-3], seed=7)
    h_ref, b_ref = _oracle(e, RobustLoss.CHARBONNIER, 5.0, nanifoutside)
    h_got, b_got = _fused(e, RobustLoss.CHARBONNIER, 5.0, nanifoutside)
    _close(h_got, h_ref)
    _close(b_got, b_ref)


@pytest.mark.parametrize("block", [(8, 32), (16, 64), (32, 128)],
                         ids=lambda b: f"{b[0]}x{b[1]}")
def test_block_shape_does_not_change_moments(block):
    e = _setup(TransformType.SIMILARITY, [0.5, 1.0, 0.03, -0.02], seed=8)
    h_ref, b_ref = _fused(e, RobustLoss.CHARBONNIER, 5.0)
    h_got, b_got = _fused(e, RobustLoss.CHARBONNIER, 5.0, block=block)
    _close(h_got, h_ref, tol=1e-5)
    _close(b_got, b_ref, tol=1e-5)


@pytest.mark.parametrize("robust", [None, RobustLoss.CHARBONNIER],
                         ids=["quadratic", "robust"])
def test_row_split_partials_sum_to_full_frame(robust):
    """Row shards with y_offset (parallel/tiled.py) sum to the full-frame
    moments: warp coordinates and moment powers use global rows."""
    e = _setup(TransformType.HOMOGRAPHY,
               [0.02, -0.01, 2.0, 0.015, -0.02, -1.5, 1e-4, -5e-5],
               h=40, w=53, seed=9)
    b = e["i1"].shape[0]
    lam = jnp.full((b,), 5.0, jnp.float32)
    tpl = pack_template(e["i1"], e["ix"], e["iy"], e["gmom"])
    kw = dict(ttype=e["ttype"], robust=robust, nanifoutside=True,
              delta=e["delta"], interpret=True)
    full = iteration_moments(e["i2"], tpl, e["p"], lam, **kw)
    parts = sum(iteration_moments(e["i2"], tpl[:, :, r:r + 10], e["p"], lam,
                                  y_offset=r, **kw)
                for r in range(0, 40, 10))
    _close(parts, full, tol=1e-5)


@pytest.mark.parametrize("robust", [RobustLoss.QUADRATIC,
                                    RobustLoss.CHARBONNIER])
def test_unpreconditioned_system_matches(robust):
    """precondition=False: the kernel path unscales its system to the raw
    Jacobian metric of the plain path."""
    e = _setup(TransformType.AFFINITY, [1.0, -1.0, 0.05, -0.02, 0.03, -0.04],
               seed=10)
    lam = jnp.full((2,), 6.0, jnp.float32)
    kw = dict(robust=robust, delta=4, precondition=False)
    h_ref, b_ref = normal_system(e["i1"], e["i2"], e["p"], lam, e["ttype"],
                                 path="xla", **kw)
    h_got, b_got = normal_system(e["i1"], e["i2"], e["p"], lam, e["ttype"],
                                 path="interpret", **kw)
    _close(h_got, h_ref)
    _close(b_got, b_ref)


def test_template_plane_count_checked():
    e = _setup(TransformType.TRANSLATION, [1.0, 1.0])
    tpl = pack_template(e["i1"], e["ix"], e["iy"])          # 3C planes
    with pytest.raises(ValueError, match="planes"):
        iteration_moments(e["i2"], tpl, e["p"], jnp.ones((2,)),
                          ttype=e["ttype"], robust=RobustLoss.CHARBONNIER,
                          nanifoutside=True, delta=4, interpret=True)


def _synthetic_pair(b=1, h=48, w=64, gt=(1.5, -1.0)):
    from inverse_compositional_algorithm_tpu.ops.pyramid import gaussian_blur

    rng = np.random.default_rng(0)
    img = gaussian_blur(jnp.asarray(
        rng.uniform(0, 255, (b, h, w, 3)), jnp.float32), 2.0)
    p = pad_params(jnp.broadcast_to(jnp.asarray(gt, jnp.float32), (b, 2)))
    gx, gy = transform_grid(p, TransformType.TRANSLATION, h, w)
    i1 = bicubic_sample(img, gx, gy)
    return i1, img


@pytest.mark.parametrize("robust", [RobustLoss.QUADRATIC,
                                    RobustLoss.CHARBONNIER])
def test_solver_fused_branch_matches_xla(robust):
    """ic_solve on the kernel path (interpreter) converges to the same
    parameters, in the same number of trips, as the plain path."""
    from inverse_compositional_algorithm_tpu.models.ic import ic_solve

    i1, i2 = _synthetic_pair()
    p0 = jnp.zeros((1, 8), jnp.float32)
    s_xla = ic_solve(i1, i2, p0, TransformType.TRANSLATION, delta=3,
                     robust=robust, path="xla")
    s_pal = ic_solve(i1, i2, p0, TransformType.TRANSLATION, delta=3,
                     robust=robust, path="interpret")
    np.testing.assert_allclose(np.asarray(s_pal.p[0, :2]), [1.5, -1.0],
                               atol=1e-2)
    np.testing.assert_allclose(np.asarray(s_pal.p), np.asarray(s_xla.p),
                               atol=1e-4)
    assert int(s_pal.niters[0]) == int(s_xla.niters[0])


def test_align_interpret_pallas_end_to_end():
    """Full align() with interpret=True runs the kernel path through the
    pyramid on the CPU."""
    import inverse_compositional_algorithm_tpu as ica

    i1, i2 = _synthetic_pair(h=64, w=96, gt=(2.5, -1.5))
    cfg = ica.AlignConfig(transform=TransformType.TRANSLATION, nscales=2,
                          robust=RobustLoss.CHARBONNIER, delta=3,
                          interpret=True)
    res = ica.align(i1, i2, cfg)
    np.testing.assert_allclose(np.asarray(res.p[0, :2]), [2.5, -1.5],
                               atol=1e-2)


# ---- compiled for the GPU ------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("ttype,p", ALL_TRANSFORMS,
                         ids=[t.name for t, _ in ALL_TRANSFORMS])
@pytest.mark.parametrize("robust", [None, RobustLoss.CHARBONNIER],
                         ids=["quadratic", "robust"])
def test_compiled_kernel_matches_plain(ttype, p, robust):
    e = _setup(ttype, p, h=97, w=131, seed=11)
    h_ref, b_ref = _oracle(e, robust, 7.0)
    h_got, b_got = _fused(e, robust, 7.0, interpret=False)
    _close(b_got, b_ref, tol=1e-4)
    if robust is not None:
        _close(h_got, h_ref, tol=1e-4)


@pytest.mark.gpu
def test_compiled_align_takes_kernel_path():
    import inverse_compositional_algorithm_tpu as ica
    from inverse_compositional_algorithm_tpu.models.api import solver_path

    assert solver_path(jnp.float32) == "kernel"
    i1, i2 = _synthetic_pair(b=2, h=96, w=128, gt=(2.5, -1.5))
    cfg = ica.AlignConfig(transform=TransformType.TRANSLATION, nscales=2,
                          robust=RobustLoss.CHARBONNIER, delta=3)
    res = ica.align(i1, i2, cfg)
    np.testing.assert_allclose(np.asarray(res.p[:, :2]),
                               [[2.5, -1.5]] * 2, atol=1e-2)
