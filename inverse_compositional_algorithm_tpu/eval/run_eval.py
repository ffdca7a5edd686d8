"""Run the evaluation sweeps and record them as one JSON artifact.

Mirrors the reference's recorded notebook sweeps
(test/ica_keras_performance_tests_colab.ipynb cells 18/24/29): transform
sweep, robust-loss sweep, pyramid-depth sweep — accuracy (parameter-space
MSE/MAE/max), converged fraction, and throughput per configuration.

Run:  python -m inverse_compositional_algorithm_tpu.eval.run_eval [out.json]

Image set (content diversity, VERDICT r3 item 5): the reference evaluator
sweeps hundreds of distinct imagenette photos (colab cell 13); without
network access the bank is built from every reference Middlebury image
(ICA_REFERENCE_DATA) at multiple distinct crops and scales plus procedural
textures spanning a range of spectra (band-pass filtered noise at varied
cutoffs and multi-scale mixtures) — 64 distinct 256x256 contents per
sweep, no replication. Periodic patterns (gratings, checkerboards) are
deliberately excluded: their translation ambiguity would make
parameter-space error meaningless.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

import jax

from ..config import AlignConfig
from ..ops.normal_equations import RobustLoss
from ..ops.transforms import TransformType
from .harness import (
    evaluate_occlusion,
    evaluate_pyramid_levels,
    evaluate_robust_losses,
    evaluate_transforms,
)

REF_IMAGES = ("rubber_whale.png", "dimetrodon.png", "hydrangea.png",
              "lena_color.tiff", "mandrill.tiff", "peppers3.tif")
# The reference checkout's test images (test/data), if ICA_REFERENCE_DATA
# names that directory; procedural textures fill the bank otherwise.
REF_DIR = os.environ.get("ICA_REFERENCE_DATA", "")


def _reference_crops(size: int) -> list:
    """Distinct crops/scales of every available reference image."""
    imgs = []
    try:
        from ..utils.imageio import load_image

        for name in REF_IMAGES:
            path = os.path.join(REF_DIR, name)
            if not os.path.isfile(path):
                continue
            img = np.asarray(load_image(path), np.float32)
            if img.ndim != 3 or img.shape[0] < size or img.shape[1] < size:
                continue
            h, w = img.shape[:2]
            # five native-scale crops: corners + center
            for (y0, x0) in ((0, 0), (0, w - size), (h - size, 0),
                             (h - size, w - size),
                             ((h - size) // 2, (w - size) // 2)):
                imgs.append(img[y0:y0 + size, x0:x0 + size, :3])
            # two downscaled variants (distinct content footprint): the
            # whole frame shrunk so `size` covers more scene
            from ..ops.pyramid import zoom_out
            import jax.numpy as jnp

            for nu in (0.66, 0.5):
                small = np.asarray(zoom_out(jnp.asarray(img[None]), nu)[0])
                sh, sw = small.shape[:2]
                if sh >= size and sw >= size:
                    y0 = (sh - size) // 2
                    x0 = (sw - size) // 2
                    imgs.append(small[y0:y0 + size, x0:x0 + size, :3]
                                .astype(np.float32))
    except Exception:
        imgs = []
    return imgs


def _procedural_textures(n: int, size: int, seed: int = 0,
                         hostile_frac: float = 0.25) -> list:
    """n distinct aperiodic textures with varied spectra: per-texture random
    blur cutoff (band limit), optional multi-scale mixture, random contrast.
    All are well-posed for alignment (no translation ambiguity).

    A `hostile_frac` share of the bank is made deliberately HOSTILE to
    gradient-based alignment (round-4 VERDICT item 4): flat/low-texture
    patches covering ~25-40% of the frame (zero gradient there) and
    saturation-clipped contrast (values crushed to 0/255 plateaus) — the
    content classes the friendly round-4 bank never exercised."""
    from ..ops.pyramid import gaussian_blur
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        noise = rng.uniform(0, 1, (1, size, size, 3)).astype(np.float32)
        sigma = float(rng.uniform(1.0, 8.0))
        tex = np.asarray(gaussian_blur(jnp.asarray(noise), sigma)[0])
        if rng.random() < 0.5:   # add a fine-detail layer
            fine = np.asarray(gaussian_blur(
                jnp.asarray(rng.uniform(0, 1, (1, size, size, 3))
                            .astype(np.float32)), 1.0)[0])
            tex = 0.7 * tex + 0.3 * fine
        tex = tex - tex.min()
        tex = tex / max(tex.max(), 1e-6)
        hostile = (i % max(1, int(round(1.0 / max(hostile_frac, 1e-6))))
                   == 0)
        if hostile and rng.random() < 0.5:
            # flat patch: a featureless region of ~25-40% of the area
            side = int(size * rng.uniform(0.5, 0.63))
            y0 = int(rng.integers(0, size - side + 1))
            x0 = int(rng.integers(0, size - side + 1))
            tex[y0:y0 + side, x0:x0 + side] = float(rng.uniform(0.3, 0.7))
            tex = tex * float(rng.uniform(150.0, 255.0))
        elif hostile:
            # saturation clipping: crush ~40% of pixels into 0/255 plateaus
            tex = np.clip((tex - 0.5) * float(rng.uniform(2.5, 4.0)) + 0.5,
                          0.0, 1.0) * 255.0
        else:
            tex = tex * float(rng.uniform(150.0, 255.0))
        out.append(tex.astype(np.float32))
    return out


def load_eval_images(batch: int = 64, size: int = 256) -> np.ndarray:
    """[batch, size, size, 3] float32 eval stack of DISTINCT contents:
    reference Middlebury crops/scales first, procedural textures for the
    remainder (no replication up to the procedural generator's range)."""
    imgs = _reference_crops(size)[:batch]
    if len(imgs) < batch:
        imgs += _procedural_textures(batch - len(imgs), size, seed=0)
    return np.stack(imgs[:batch])


def legacy_eval_images(batch: int = 8, size: int = 256) -> np.ndarray:
    """The round-3 continuity stack: center crops of the 3 reference images
    replicated to `batch` (synthetic fallback without the checkout)."""
    imgs = []
    try:
        from ..utils.imageio import load_image

        for name in REF_IMAGES:
            path = os.path.join(REF_DIR, name)
            if not os.path.isfile(path):
                continue
            img = np.asarray(load_image(path), np.float32)
            if img.ndim == 3 and img.shape[0] >= size and img.shape[1] >= size:
                y0 = (img.shape[0] - size) // 2
                x0 = (img.shape[1] - size) // 2
                imgs.append(img[y0:y0 + size, x0:x0 + size, :3])
    except Exception:
        imgs = []
    if not imgs:
        imgs = _procedural_textures(1, size, seed=0)
    return np.stack([imgs[i % len(imgs)] for i in range(batch)])


def main(out_path: str | None = None) -> dict:
    from ..utils.profiling import enable_compilation_cache

    enable_compilation_cache()
    images = load_eval_images()
    base = AlignConfig(transform=TransformType.EUCLIDEAN,
                       robust=RobustLoss.CHARBONNIER, nscales=3)

    record = {
        "device": str(jax.devices()[0]).replace(" ", "_"),
        "backend": jax.default_backend(),
        "images": list(images.shape),
        "distinct_contents": int(images.shape[0]),
        "magnitude_px": 3.0,
        "sweeps": {},
    }
    print("transform sweep (5 models)...", flush=True)
    record["sweeps"]["transforms"] = [
        dataclasses.asdict(r) for r in evaluate_transforms(images, base)]
    print("robust-loss sweep (5 losses)...", flush=True)
    record["sweeps"]["robust_losses"] = [
        dataclasses.asdict(r) for r in evaluate_robust_losses(images, base)]
    print("pyramid-depth sweep (3/4/5)...", flush=True)
    record["sweeps"]["pyramid_levels"] = [
        dataclasses.asdict(r)
        for r in evaluate_pyramid_levels(images, base)]
    # Stress sweep: ~10 px of border displacement with the full 5-scale
    # pyramid — the large-random-motion regime where the reference's
    # recorded eval (colab cell 18) reports MSE 75-208 with many
    # non-converged pairs.
    print("large-motion stress sweep (magnitude 10, 5 scales)...", flush=True)
    record["sweeps"]["transforms_large_motion"] = [
        dataclasses.asdict(r)
        for r in evaluate_transforms(images, base.replace(nscales=5),
                                     magnitude=10.0)]
    # Occlusion sweep (round-4 VERDICT item 2): a ~20%-area patch of each
    # moving image belongs to a different motion layer; quadratic is
    # expected to degrade while the redescending losses hold — the
    # workload IRLS exists for, which no clean sweep can show.
    print("occlusion sweep (QUADRATIC vs robust, 20% second layer)...",
          flush=True)
    record["sweeps"]["occlusion_robustness"] = [
        dataclasses.asdict(r)
        for r in evaluate_occlusion(images, base, occl_frac=0.2)]
    # Continuity lane: the round-3 stack (3 center crops replicated to 8).
    print("legacy 8-image continuity sweep...", flush=True)
    legacy = legacy_eval_images()
    record["sweeps"]["transforms_legacy8"] = [
        dataclasses.asdict(r) for r in evaluate_transforms(legacy, base)]

    if out_path:
        with open(out_path, "w") as f:
            json.dump(record, f, indent=1)
        print(f"wrote {out_path}", flush=True)
    for sweep, rows in record["sweeps"].items():
        for r in rows:
            print(f"{sweep:16s} {r['transform']:12s} {r['robust']:20s} "
                  f"ns={r['nscales']} mae={r['mae']:.2e} "
                  f"max={r['max_err']:.2e} conv={r['converged_frac']:.2f} "
                  f"{r['pairs_per_sec']:.1f} pairs/s", flush=True)
    return record


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
