"""Throughput benchmark: batched pairs/second through the full pipeline.

Flagship configuration: homography model, robust (Charbonnier) IRLS,
5-scale pyramid, 584x388 RGB — the hardest config the reference supports.
The baseline anchor is the reference's own stored measurement: its numpy L5
entry point needs 10.13 s for ONE pair at this image size on the
*cheapest* config (quadratic, translation, single scale — reference
test/inverse_compositional_algorithm.ipynb cell 14, a CPU run), i.e.
0.0987 pairs/s; the robust+homography+5-scale config it is compared against
here is strictly more work, so vs_baseline is a conservative lower bound.

Timing: K complete alignments run on the device inside one jitted
`lax.scan` (each step gets a fresh warm-start perturbation and a per-step
image scaling so no step is loop-invariant and nothing can be hoisted or
deduplicated); one scalar checksum is fetched, and the record reports the
two-point difference (t(K) - t(K0)) / (K - K0), which cancels the constant
dispatch and transfer cost of a call.

Every record names the device it ran on; the benchmark needs a device in
`DEVICE_PEAKS` and fails on any other (a CPU time is no device metric).
"""

from __future__ import annotations

import time
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..config import AlignConfig
from ..models.api import _align_impl, solver_path
from ..ops.normal_equations import RobustLoss
from ..ops.pyramid import gaussian_blur
from ..ops.transforms import TransformType, pad_params, transform_grid
from ..ops.warp import bicubic_sample

# Reference numpy throughput anchor (pairs/s), see module docstring.
NUMPY_BASELINE_PAIRS_PER_SEC = 1.0 / 10.13

__all__ = ["make_bench_batch", "run_benchmark", "device_record",
           "DEVICE_PEAKS", "NUMPY_BASELINE_PAIRS_PER_SEC"]


def _base_image(height: int, width: int, dtype=jnp.float32):
    """Deterministic smooth test content in 0..255, made from a seed."""
    rng = np.random.default_rng(0)
    noise = rng.uniform(0.0, 255.0, (height, width, 3)).astype(np.float32)
    return gaussian_blur(jnp.asarray(noise, dtype)[None], 2.0)[0]


def make_bench_batch(batch: int, height: int, width: int,
                     transform: TransformType, seed: int = 0,
                     hard: bool = False):
    """[B,H,W,C] pair batch with per-pair random ground-truth motions.

    hard=False: realistic small motions (a few pixels at the borders) —
    the steady-state video-alignment regime. hard=True: large mixed
    motions (tens of pixels of translation, rotation-scale linear parts up
    to ~0.06, i.e. tens of pixels of border displacement) that stress the
    coarse pyramid levels and the solvers' full iteration budget."""
    img = _base_image(height, width)
    rng = np.random.default_rng(seed)
    l = max(height, width)
    tr, lin = (15.0, 35.0 / l) if hard else (3.0, 2.0 / l)
    p = np.zeros((batch, 8), np.float32)
    p[:, :2] = rng.uniform(-tr, tr, (batch, 2))
    if transform is TransformType.HOMOGRAPHY:
        p[:, [0, 1, 3, 4]] = rng.uniform(-lin, lin, (batch, 4))
        p[:, 2] = rng.uniform(-tr, tr, batch)
        p[:, 5] = rng.uniform(-tr, tr, batch)
        p[:, 6:8] = rng.uniform(-2.0 / (l * l), 2.0 / (l * l), (batch, 2))
    elif transform is not TransformType.TRANSLATION:
        k = {TransformType.EUCLIDEAN: 1, TransformType.SIMILARITY: 2,
             TransformType.AFFINITY: 4}[transform]
        p[:, 2:2 + k] = rng.uniform(-lin, lin, (batch, k))

    gx, gy = transform_grid(pad_params(jnp.asarray(p)), transform, height, width)
    i1 = bicubic_sample(jnp.broadcast_to(img[None], (batch, *img.shape)), gx, gy)
    i2 = jnp.broadcast_to(img[None], (batch, *img.shape))
    return i1, i2, p


@partial(jax.jit, static_argnames=("cfg", "path", "k"))
def _bench_scan(i1, i2, p0s, scales, cfg, path: str, k: int):
    """Run k full alignments on device; returns (checksum, niters[k, B]).

    Each step perturbs the warm start (p0s[j]) and scales the images by
    scales[j] (= 1 +/- 1e-6), so no step's computation is loop-invariant:
    the pyramid build, every solver iteration, and the final warp all
    execute k times on device.
    """
    def step(acc, xs):
        p0, s = xs
        r = _align_impl(i1 * s, i2 * s, p0, cfg, path)
        return acc + r.p.sum() + r.error.sum(), r.niters

    acc, nit = jax.lax.scan(step, jnp.float32(0.0),
                            (p0s[:k], scales[:k]))
    return acc, nit


def _measure(i1, i2, cfg, batch, repeats, repeats0, nsamples: int = 3,
             path: str | None = None):
    """(pairs_per_sec, seconds_per_batch, mean_finest_iters, samples) of
    the full alignment via the two-point on-device scan.

    `nsamples` independent two-point measurements run back-to-back in the
    same process; the headline value is their median, with min/median/max
    returned for the record.
    """
    path = path or solver_path(i1.dtype, cfg.interpret)
    rng = np.random.default_rng(1)
    # Perturb ONLY the translation slots: +-1e-4 px is physically
    # negligible at any frame size, which is all the perturbation is for
    # (defeating scan-step deduplication). A uniform +-1e-4 across all 8
    # params is NOT negligible for homography — p6/p7 have natural
    # magnitude ~1/L^2 (~1e-6), so +-1e-4 there warps borders by ~100 px
    # at 720p and the "warm start" becomes a large-motion solve.
    p0s = np.zeros((repeats, batch, 8), np.float32)
    p0s[:, :, :2] = rng.uniform(-1e-4, 1e-4, (repeats, batch, 2))
    p0s = jnp.asarray(p0s)
    scales = jnp.asarray(1.0 + rng.uniform(-1e-6, 1e-6, repeats), jnp.float32)
    i1, i2, p0s, scales = jax.device_put((i1, i2, p0s, scales))

    def run(k):
        return _bench_scan(i1, i2, p0s, scales, cfg, path, k)

    # Compile + warm up both program sizes.
    float(run(repeats0)[0])
    acc, nit = run(repeats)
    float(acc)

    per_batch_samples = []
    for _ in range(max(1, nsamples)):
        t0 = time.perf_counter()
        float(run(repeats0)[0])
        t1 = time.perf_counter()
        acc, nit = run(repeats)
        float(acc)
        t2 = time.perf_counter()
        per_batch_samples.append(((t2 - t1) - (t1 - t0))
                                 / (repeats - repeats0))

    per_batch = float(np.median(per_batch_samples))
    samples = {
        "pairs_per_sec_min": batch / max(per_batch_samples),
        "pairs_per_sec_median": batch / per_batch,
        "pairs_per_sec_max": batch / min(per_batch_samples),
        "n": len(per_batch_samples),
    }
    return (batch / per_batch, per_batch,
            float(np.asarray(nit, np.float64).mean()), samples)


# Published peaks per device kind (NVIDIA H100 SXM data sheet: HBM3
# bandwidth, float32 rate outside the tensor cores). A kind not listed is
# an error, not a default.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbs": 3350.0, "f32_tflops": 67.0,
                              "source": "NVIDIA H100 SXM data sheet"},
}


def device_record() -> dict:
    """platform / kind / count of the devices the record was taken on."""
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def device_peaks() -> dict:
    kind = jax.devices()[0].device_kind
    if kind not in DEVICE_PEAKS:
        raise RuntimeError(f"no published peaks for device kind {kind!r}; "
                           "add them to DEVICE_PEAKS")
    return DEVICE_PEAKS[kind]


def kernel_roofline(batch: int, height: int, width: int,
                    transform: TransformType, robust: RobustLoss) -> dict:
    """Achieved bandwidth of the fused iteration kernel at the bench shape.

    Times one robust kernel call per scan step (two-point on-device scan)
    and divides the bytes it must move by that time: the moving image and
    the packed template planes read once, plus the partial moments written.
    The peak is the published HBM bandwidth of the device kind.
    """
    from ..ops.gradients import boundary_band_mask, central_gradients
    from ..ops.normal_equations import grad_moments
    from ..ops.pallas.fused_iter import BLOCK, iteration_moments, pack_template

    peaks = device_peaks()
    i1, i2, p_gt = make_bench_batch(batch, height, width, transform)
    ix, iy = central_gradients(i1)
    band = boundary_band_mask(height, width, 10).astype(jnp.float32)
    ix = ix * band[None, :, :, None]
    iy = iy * band[None, :, :, None]
    gmom = grad_moments(ix, iy)
    tpl = pack_template(i1, ix, iy, gmom)
    lam = jnp.full((batch,), 5.0, jnp.float32)
    p = pad_params(jnp.asarray(p_gt))

    @partial(jax.jit, static_argnames=("k",))
    def scan_k(p, k: int):
        def step(acc, _):
            m = iteration_moments(i2, tpl, p.at[:, 2].add(acc * 1e-12), lam,
                                  ttype=transform, robust=robust,
                                  nanifoutside=True, delta=10)
            return acc + m.sum(), None

        return jax.lax.scan(step, jnp.float32(0.0), None, length=k)[0]

    k, k0 = 12, 3
    run = lambda n: float(scan_k(p, n))   # noqa: E731
    run(k0)
    run(k)
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(k0)
        t1 = time.perf_counter()
        run(k)
        t2 = time.perf_counter()
        ms.append(((t2 - t1) - (t1 - t0)) / (k - k0) * 1e3)
    med = float(np.median(ms))
    c = i2.shape[-1]
    nblk = -(-height // BLOCK[0]) * -(-width // BLOCK[1])
    bytes_per_pair = ((c + tpl.shape[1]) * height * width
                      + nblk * 5 * 64) * 4
    gbs = bytes_per_pair * batch / (med * 1e-3) / 1e9
    return {
        "kernel_ms_per_batch": med,
        "kernel_ms_samples": ms,
        "kernel_gbs": gbs,
        "hbm_peak_gbs": peaks["hbm_gbs"],
        "peak_source": peaks["source"],
        "pct_hbm_peak": 100.0 * gbs / peaks["hbm_gbs"],
    }


def run_benchmark(batch: int = 8, height: int = 388, width: int = 584,
                  transform: TransformType = TransformType.HOMOGRAPHY,
                  robust: RobustLoss = RobustLoss.CHARBONNIER,
                  nscales: int = 5, repeats: int = 4, repeats0: int = 1,
                  config: AlignConfig | None = None,
                  full: bool = True) -> dict:
    """Measure device throughput of `repeats` full alignments of the batch.

    Returns the bench.py JSON record. Throughput is computed from the
    two-point difference between a `repeats`-step and a `repeats0`-step
    on-device scan (see module docstring); every pair runs its full
    per-pair convergence in every counted step.

    With full=True the record also carries:
      * a hard-motion line (large mixed motions incl. rotations) so
        pairs/s is not flattered by near-instant convergence;
      * a fixed-iteration line (tol ~ 0 -> every pair runs MAX_ITER at
        every scale) pinning the pure per-iteration cost;
      * the fused kernel's achieved bandwidth against the device's peak;
      * large-frame lines (1080p and 4K RGB) through the same pipeline.
    """
    assert repeats > repeats0 >= 1
    device = device_record()
    device_peaks()          # fails on a device without published peaks
    cfg = config or AlignConfig(transform=transform, robust=robust,
                                nscales=nscales)
    cfg.validate()
    i1, i2, _ = make_bench_batch(batch, height, width, transform)
    path = solver_path(i1.dtype, cfg.interpret)
    pps, per_batch, mean_iters, samp = _measure(i1, i2, cfg, batch, repeats,
                                                repeats0)
    rec = {
        "metric": f"pairs/sec/device ({transform.name.lower()}, "
                  f"{robust.name.lower()}, {nscales}-scale, {height}x{width})",
        "value": pps,
        "unit": "pairs/s",
        "vs_baseline": pps / NUMPY_BASELINE_PAIRS_PER_SEC,
        "batch": batch,
        "seconds_per_batch": per_batch,
        "mean_finest_iters": mean_iters,
        "samples": samp,
        "device": device,
        "path": path,
        "timing": "on-device scan, two-point, median of in-run samples",
    }
    if not full:
        return rec

    i1h, i2h, _ = make_bench_batch(batch, height, width, transform,
                                   seed=7, hard=True)
    pps_h, _, it_h, samp_h = _measure(i1h, i2h, cfg, batch, repeats, repeats0)
    rec["hard_motion"] = {"pairs_per_sec": pps_h,
                          "vs_baseline": pps_h / NUMPY_BASELINE_PAIRS_PER_SEC,
                          "mean_finest_iters": it_h, "samples": samp_h}

    cfg_fix = cfg.replace(tol=1e-9)
    pps_f, sec_f, it_f, samp_f = _measure(i1, i2, cfg_fix, batch, repeats,
                                          repeats0)
    rec["fixed_30_iters"] = {"pairs_per_sec": pps_f,
                             "seconds_per_batch": sec_f,
                             "mean_finest_iters": it_f, "samples": samp_f}

    if path == "kernel":
        rec["roofline"] = kernel_roofline(batch, height, width, transform,
                                          robust)

    base_px_rate = pps * (height * width) / 1e6
    rec["large_frame"] = {}
    for (lh, lw, lb) in ((1080, 1920, 2), (2160, 3840, 1)):
        i1l, i2l, _ = make_bench_batch(lb, lh, lw, transform, seed=3)
        pps_l, sec_l, it_l, samp_l = _measure(i1l, i2l, cfg, lb, repeats,
                                              repeats0)
        px = lh * lw / 1e6
        rec["large_frame"][f"{lw}x{lh}"] = {
            "pairs_per_sec": pps_l,
            "seconds_per_batch": sec_l,
            "batch": lb,
            "mean_finest_iters": it_l,
            "mpix_pairs_per_sec": pps_l * px,
            "vs_headline_px_rate": pps_l * px / base_px_rate,
            "samples": samp_l,
        }
    return rec
