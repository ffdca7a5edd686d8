"""Random-transform evaluation harness.

Counterpart of the reference's `TFDSEvaluator`
(reference: test/ica_keras_performance_tests_colab.ipynb cell 13): generate
random ground-truth motions per model class, warp a base image set, run the
aligner, and report parameter-space MSE / MAE plus wall time, with sweeps
over transform type, robust loss, and pyramid depth (cells 18/24/29).

Differences from the reference (all deliberate):
  * no TFDS dependency — any [N, H, W, C] image stack works (local files,
    synthetic textures); imagenette can be fed in by the caller.
  * the whole batch is evaluated in ONE device-resident call with per-pair
    convergence, instead of the reference's batch-of-1 python loop.
  * metrics are computed against the *inverted* ground truth exactly as the
    reference's notebooks do (estimate p of I2->I1 where I1 = warp(I2, gt)
    means p* = gt itself in our pair convention; see eval/benchmarks.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

from ..config import AlignConfig
from ..models.api import _align_batched, solver_path
from ..ops.normal_equations import RobustLoss
from ..ops.transforms import TransformType, nparams, pad_params, transform_grid
from ..ops.warp import bicubic_sample

__all__ = ["EvalResult", "random_params", "make_pairs",
           "make_occluded_pairs", "evaluate", "evaluate_transforms",
           "evaluate_robust_losses", "evaluate_pyramid_levels",
           "evaluate_occlusion"]


@dataclass
class EvalResult:
    transform: str
    robust: str
    nscales: int
    batch: int
    mse: float           # parameter-space MSE vs ground truth
    mae: float           # parameter-space MAE
    max_err: float
    pairs_per_sec: float
    seconds: float
    mean_iters: float
    converged_frac: float
    diverged_frac: float  # pairs the finest-scale divergence guard tripped


def random_params(batch: int, ttype: TransformType, height: int, width: int,
                  magnitude: float = 3.0, seed: int = 0) -> np.ndarray:
    """[B, 8] random motions with ~`magnitude` pixels of border displacement
    (the reference draws uniform random transforms per class — colab cell 13)."""
    rng = np.random.default_rng(seed)
    l = max(height, width)
    p = np.zeros((batch, 8), np.float32)
    if ttype is TransformType.HOMOGRAPHY:
        p[:, [2, 5]] = rng.uniform(-magnitude, magnitude, (batch, 2))
        p[:, [0, 1, 3, 4]] = rng.uniform(-magnitude / l, magnitude / l,
                                         (batch, 4))
        p[:, 6:8] = rng.uniform(-magnitude / (l * l), magnitude / (l * l),
                                (batch, 2))
    else:
        p[:, :2] = rng.uniform(-magnitude, magnitude, (batch, 2))
        k = nparams(ttype) - 2
        if k:
            p[:, 2:2 + k] = rng.uniform(-magnitude / l, magnitude / l,
                                        (batch, k))
    return p


def make_pairs(images: np.ndarray, ttype: TransformType,
               magnitude: float = 3.0, seed: int = 0):
    """images [B, H, W, C] -> (I1, I2, gt) where I1 = images sampled at
    x'(x; gt): the solver's exact fixed point is gt."""
    imgs = jnp.asarray(images, jnp.float32)
    b, h, w, _ = imgs.shape
    gt = random_params(b, ttype, h, w, magnitude, seed)
    gx, gy = transform_grid(pad_params(jnp.asarray(gt)), ttype, h, w)
    i1 = bicubic_sample(imgs, gx, gy)
    return i1, imgs, gt


def make_occluded_pairs(images: np.ndarray, ttype: TransformType,
                        magnitude: float = 3.0, occl_frac: float = 0.2,
                        seed: int = 0):
    """Pairs where a patch of the moving image belongs to a DIFFERENT
    motion layer — the predominant-motion workload IRLS exists for.

    I1 = warp(images, gt) as in `make_pairs`; then a random square patch
    covering `occl_frac` of I2's area is replaced with unrelated content
    (the next image in the bank, contrast-matched). Those pixels violate
    the global motion model: a quadratic loss lets their large residuals
    pull the estimate away from gt, a redescending rho' down-weights them
    (reference IPOL 2018.222; robust notebook
    test/inverse_compositional_algorithm_robust.ipynb exercises the losses
    but only ever on un-occluded pairs).

    Returns (i1, i2_occluded, gt, occl_mask [B, H, W] bool).
    """
    imgs = jnp.asarray(images, jnp.float32)
    b, h, w, _ = imgs.shape
    rng = np.random.default_rng(seed + 1)
    gt = random_params(b, ttype, h, w, magnitude, seed)
    gx, gy = transform_grid(pad_params(jnp.asarray(gt)), ttype, h, w)
    i1 = bicubic_sample(imgs, gx, gy)

    side = int(round(np.sqrt(occl_frac * h * w)))
    side = max(4, min(side, min(h, w) - 1))
    other = np.roll(np.asarray(imgs), 1, axis=0)
    i2 = np.asarray(imgs).copy()
    mask = np.zeros((b, h, w), bool)
    for k in range(b):
        y0 = int(rng.integers(0, h - side + 1))
        x0 = int(rng.integers(0, w - side + 1))
        patch = other[k, :side, :side]
        i2[k, y0:y0 + side, x0:x0 + side] = patch
        mask[k, y0:y0 + side, x0:x0 + side] = True
    return i1, jnp.asarray(i2), gt, mask


def evaluate_occlusion(images, base: AlignConfig = AlignConfig(),
                       magnitude: float = 3.0, occl_frac: float = 0.2,
                       seed: int = 0):
    """QUADRATIC vs every robust loss on occluded pairs (the separation
    the clean sweeps cannot show: on clean synthetic warps all losses are
    indistinguishable — VERDICT r4 'missing' item 1)."""
    from .benchmarks import _measure

    i1, i2, gt, _ = make_occluded_pairs(images, base.transform, magnitude,
                                        occl_frac, seed)
    b = i1.shape[0]
    p0 = jnp.zeros((b, 8), jnp.float32)
    out = []
    for r in RobustLoss:
        cfg = base.replace(robust=r)
        res = _align_batched(i1, i2, p0, cfg,
                             solver_path(i1.dtype, cfg.interpret))
        jax.block_until_ready(res.p)
        pps, dt, _, _ = _measure(i1, i2, cfg, b, repeats=4,
                                 repeats0=1, nsamples=1)
        k = nparams(cfg.transform)
        err = np.asarray(res.p)[:, :k] - gt[:, :k]
        out.append(EvalResult(
            transform=cfg.transform.name, robust=r.name, nscales=cfg.nscales,
            batch=b, mse=float((err ** 2).mean()),
            mae=float(np.abs(err).mean()),
            max_err=float(np.abs(err).max()),
            pairs_per_sec=pps, seconds=dt,
            mean_iters=float(np.asarray(res.niters).mean()),
            converged_frac=float(((np.asarray(res.error) <= cfg.tol)
                                  & ~np.asarray(res.diverged)).mean()),
            diverged_frac=float(np.asarray(res.diverged).mean()),
        ))
    return out


def evaluate(images: np.ndarray, config: AlignConfig,
             magnitude: float = 3.0, seed: int = 0) -> EvalResult:
    """Align a randomly-warped copy of every image; report accuracy + speed.

    Timing uses the same two-point on-device scan as eval/benchmarks.py,
    which cancels the constant dispatch cost of a call. The times are
    those of whatever backend runs the harness; only a run on the GPU
    gives device numbers.

    Note the two measurements differ in initialization: accuracy fields
    (mse/mae/max_err/mean_iters/converged_frac) come from ONE align run
    with p0 = 0 (the reference evaluator's setting), while
    `pairs_per_sec`/`seconds` come from `_measure`'s multi-step scan whose
    steps use tiny random warm-start perturbations (so no scan step is
    loop-invariant). `seconds` is therefore scan-derived per-batch time,
    not the wall time of the accuracy run.
    """
    from .benchmarks import _measure

    i1, i2, gt = make_pairs(images, config.transform, magnitude, seed)
    b = i1.shape[0]
    p0 = jnp.zeros((b, 8), jnp.float32)
    res = _align_batched(i1, i2, p0, config,
                         solver_path(i1.dtype, config.interpret))
    jax.block_until_ready(res.p)
    pps, dt, _, _ = _measure(i1, i2, config, b, repeats=4,
                             repeats0=1, nsamples=1)

    k = nparams(config.transform)
    err = np.asarray(res.p)[:, :k] - gt[:, :k]
    return EvalResult(
        transform=config.transform.name,
        robust=config.robust.name,
        nscales=config.nscales,
        batch=b,
        mse=float((err ** 2).mean()),
        mae=float(np.abs(err).mean()),
        max_err=float(np.abs(err).max()),
        pairs_per_sec=pps,
        seconds=dt,
        mean_iters=float(np.asarray(res.niters).mean()),
        converged_frac=float(((np.asarray(res.error) <= config.tol)
                              & ~np.asarray(res.diverged)).mean()),
        diverged_frac=float(np.asarray(res.diverged).mean()),
    )


def evaluate_transforms(images, base: AlignConfig = AlignConfig(),
                        magnitude: float = 3.0):
    """Sweep over all five motion models (reference colab cell 18)."""
    return [evaluate(images, base.replace(transform=t), magnitude)
            for t in TransformType]


def evaluate_robust_losses(images, base: AlignConfig = AlignConfig(),
                           magnitude: float = 3.0):
    """Sweep over robust error functions (reference colab cell 24).

    Every loss runs the reference's annealed-lambda schedule (lam=0 ->
    LAMBDA_0 80 shrinking x0.9 to LAMBDA_N 5). Round 5 measured WHY that
    matters for TRUNCATED_QUADRATIC specifically: a FIXED lam=5 hard
    truncation discards every informative edge pixel on saturation-
    clipped high-contrast content (3 of the 64-bank's hostile contents
    fail at mae up to 19.8 px), while the graduated schedule — weights
    ~quadratic early, truncating only once near convergence — solves the
    same pairs to mae 7.6e-5 (PERF.md round-5 'truncated-quadratic
    threshold sensitivity')."""
    return [evaluate(images, base.replace(robust=r), magnitude)
            for r in RobustLoss]


def evaluate_pyramid_levels(images, base: AlignConfig = AlignConfig(),
                            levels=(3, 4, 5), magnitude: float = 3.0):
    """Sweep over pyramid depth (reference colab cell 29)."""
    return [evaluate(images, base.replace(nscales=n), magnitude)
            for n in levels]
