"""Robust IRLS must actually beat quadratic under occlusion.

The entire point of the robust tier is predominant-motion estimation when
part of the frame violates the global motion model (reference README.md:28,
src/image_optimisation.py:56-79; IPOL 2018.222). On clean synthetic warps
every loss is indistinguishable — the reference's own notebooks only ever
re-run clean pairs (test/inverse_compositional_algorithm_robust.ipynb) —
so this is evidence the reference never produced: with a ~25%-area patch
of the moving image replaced by unrelated content, the quadratic estimate
is measurably biased while the redescending losses hold
(round-4 VERDICT "missing" item 1 / task 2).
"""

import numpy as np

import jax.numpy as jnp

from inverse_compositional_algorithm_tpu.config import AlignConfig
from inverse_compositional_algorithm_tpu.eval.harness import (
    make_occluded_pairs,
)
from inverse_compositional_algorithm_tpu.models.api import align
from inverse_compositional_algorithm_tpu.ops.normal_equations import RobustLoss
from inverse_compositional_algorithm_tpu.ops.pyramid import gaussian_blur
from inverse_compositional_algorithm_tpu.ops.transforms import TransformType


def _mae(i1, i2, gt, robust, lam=0.0):
    cfg = AlignConfig(transform=TransformType.TRANSLATION, nscales=2,
                      robust=robust, lam=lam)
    res = align(i1, i2, cfg)
    assert not np.asarray(res.diverged).any()
    return float(np.abs(np.asarray(res.p)[:, :2] - gt[:, :2]).mean())


def test_robust_beats_quadratic_under_occlusion():
    rng = np.random.default_rng(0)
    b, s = 8, 128
    tex = np.asarray(gaussian_blur(
        jnp.asarray(rng.uniform(0, 255, (b, s, s, 3)), jnp.float32), 2.5))
    i1, i2, gt, mask = make_occluded_pairs(
        tex, TransformType.TRANSLATION, magnitude=2.0, occl_frac=0.25,
        seed=0)
    assert 0.2 < mask.mean() < 0.3       # the patch really covers ~25%

    quad = _mae(i1, i2, gt, RobustLoss.QUADRATIC)
    tq = _mae(i1, i2, gt, RobustLoss.TRUNCATED_QUADRATIC, lam=5.0)
    gm = _mae(i1, i2, gt, RobustLoss.GERMAN_MCCLURE)
    lo = _mae(i1, i2, gt, RobustLoss.LORENTZIAN)
    ch = _mae(i1, i2, gt, RobustLoss.CHARBONNIER)

    # quadratic is measurably biased by the occluded patch...
    assert quad > 0.02, f"occlusion failed to bias quadratic (mae {quad})"
    # ...the hard redescenders reject it almost entirely...
    assert tq < 0.25 * quad, (tq, quad)
    assert gm < 0.5 * quad, (gm, quad)
    # ...and the soft losses still clearly improve on quadratic.
    assert lo < 0.8 * quad, (lo, quad)
    assert ch < 0.85 * quad, (ch, quad)


def test_truncated_quadratic_needs_annealed_lambda_on_clipped_content():
    """Round-5 hostile-bank find (PERF.md 'truncated-quadratic threshold
    sensitivity'): a FIXED small truncation threshold zeroes every
    informative edge pixel's weight on saturation-clipped high-contrast
    content — the solver reports |Dp| ~ 0 while sitting far from the
    optimum — whereas the reference's annealed 80->5 schedule (lam=0)
    solves the same pairs. Pins both halves of that measurement."""
    rng = np.random.default_rng(3)
    b, s = 4, 128
    tex = np.asarray(gaussian_blur(
        jnp.asarray(rng.uniform(0, 1, (b, s, s, 3)), jnp.float32), 2.0))
    # crush ~40% of pixels into 0/255 plateaus (run_eval's hostile class)
    tex = np.clip((tex - 0.5) * 3.5 + 0.5, 0.0, 1.0) * 255.0
    from inverse_compositional_algorithm_tpu.eval.harness import make_pairs

    i1, i2, gt = make_pairs(tex.astype(np.float32),
                            TransformType.TRANSLATION, magnitude=2.0,
                            seed=0)
    fixed = _mae(i1, i2, gt, RobustLoss.TRUNCATED_QUADRATIC, lam=5.0)
    annealed = _mae(i1, i2, gt, RobustLoss.TRUNCATED_QUADRATIC, lam=0.0)
    assert annealed < 2e-3, annealed
    assert fixed > 10 * annealed, (fixed, annealed)


def test_clean_pairs_all_losses_equivalent():
    """Control: without occlusion the losses are indistinguishable (the
    regime every round-4 eval lived in) — pins that the separation above
    is really caused by the occlusion."""
    from inverse_compositional_algorithm_tpu.eval.harness import make_pairs

    rng = np.random.default_rng(0)
    b, s = 8, 128
    tex = np.asarray(gaussian_blur(
        jnp.asarray(rng.uniform(0, 255, (b, s, s, 3)), jnp.float32), 2.5))
    i1, i2, gt = make_pairs(tex, TransformType.TRANSLATION, magnitude=2.0,
                            seed=0)
    maes = [_mae(i1, i2, gt, r,
                 lam=5.0 if r is RobustLoss.TRUNCATED_QUADRATIC else 0.0)
            for r in RobustLoss]
    assert max(maes) < 2e-3, maes
