"""Video-stabilization-style demo: batched frame-to-keyframe registration.

The reference documents its API through notebooks
(test/inverse_compositional_algorithm.ipynb); this script is the
equivalent runnable walkthrough, driving a mosaicking / video
stabilization style workload: a jittered sequence is registered to its
first frame in ONE batched `align` call (every pair converges
independently on device), then re-rendered through the estimated warps.

Run:  python examples/stabilize.py [outdir]      (CPU or GPU)
"""

from __future__ import annotations

import sys

import numpy as np

import jax
import jax.numpy as jnp

import inverse_compositional_algorithm_tpu as ica
from inverse_compositional_algorithm_tpu.ops.pyramid import gaussian_blur
from inverse_compositional_algorithm_tpu.ops.transforms import (
    pad_params,
    transform_grid,
)
from inverse_compositional_algorithm_tpu.ops.warp import bicubic_sample


def load_scene(h: int, w: int):
    """A REAL Middlebury frame from the reference's test data (the same
    fixture its notebooks drive — docs/rawData.md) when ICA_REFERENCE_DATA
    names that directory, else a synthetic smooth texture."""
    import os

    try:
        from inverse_compositional_algorithm_tpu.utils.imageio import (
            load_image,
        )

        img = np.asarray(load_image(os.path.join(
            os.environ["ICA_REFERENCE_DATA"], "rubber_whale.png")),
            np.float32)
        y0 = (img.shape[0] - h) // 2
        x0 = (img.shape[1] - w) // 2
        if y0 >= 0 and x0 >= 0:
            print("scene: Middlebury rubber_whale (real image)")
            return jnp.asarray(img[None, y0:y0 + h, x0:x0 + w, :3])
    except Exception:
        pass
    rng = np.random.default_rng(42)
    print("scene: synthetic texture (reference data not found)")
    return gaussian_blur(
        jnp.asarray(rng.uniform(0, 255, (1, h, w, 3)), jnp.float32), 2.0)


def make_sequence(n_frames: int = 8, h: int = 288, w: int = 384,
                  seed: int = 0):
    """A real scene observed through a jittering euclidean camera."""
    rng = np.random.default_rng(seed)
    scene = load_scene(h, w)
    # random per-frame jitter: a few px of translation + ~0.5 deg of roll
    jitter = np.zeros((n_frames, 8), np.float32)
    jitter[1:, 0] = rng.uniform(-4, 4, n_frames - 1)
    jitter[1:, 1] = rng.uniform(-4, 4, n_frames - 1)
    jitter[1:, 2] = rng.uniform(-0.01, 0.01, n_frames - 1)
    gx, gy = transform_grid(
        pad_params(jnp.asarray(jitter), ica.TransformType.EUCLIDEAN),
        ica.TransformType.EUCLIDEAN, h, w)
    frames = bicubic_sample(jnp.broadcast_to(scene, (n_frames, h, w, 3)),
                            gx, gy)
    return frames, jitter


def main(outdir: str | None = None) -> None:
    frames, gt = make_sequence()
    n = frames.shape[0]
    print(f"backend: {jax.default_backend()}, frames: {frames.shape}")

    # Register every frame to the keyframe (frame 0) in one batched call.
    cfg = ica.AlignConfig(transform=ica.TransformType.EUCLIDEAN, nscales=3)
    key = jnp.broadcast_to(frames[:1], frames.shape)
    res = ica.align(frames, key, cfg)   # warp(frame_k) onto keyframe

    est = np.asarray(res.params(cfg))
    print("per-frame estimated [tx ty theta] vs ground-truth jitter:")
    for k in range(n):
        print(f"  frame {k}: est {np.round(est[k], 4)}  gt {gt[k, :3]}"
              f"  iters={int(res.niters[k])}"
              f"  diverged={bool(res.diverged[k])}")
    err = np.abs(est - gt[:, :3]).max()
    print(f"max parameter error: {err:.2e}")

    # Stabilized sequence = each frame warped back onto the keyframe grid.
    stabilized = np.asarray(res.iw)
    residual = np.nanmean(np.abs(np.asarray(res.di)), axis=(1, 2, 3))
    print("mean |frame - keyframe| after stabilization (0..255 scale):",
          [f"{v:.2e}" for v in residual])

    if outdir:
        import os

        from inverse_compositional_algorithm_tpu.utils.imageio import (
            save_image,
        )

        os.makedirs(outdir, exist_ok=True)
        for k in range(n):
            save_image(stabilized[k], os.path.join(outdir, f"stab_{k:03d}.png"))
        # side-by-side evidence strip: jittered input row over stabilized row
        raw = np.asarray(frames)
        strip = np.concatenate([
            np.concatenate(list(raw[: min(4, n)]), axis=1),
            np.concatenate(list(np.nan_to_num(stabilized[: min(4, n)])),
                           axis=1),
        ], axis=0)
        save_image(strip, os.path.join(outdir, "strip.png"))
        print(f"wrote {n} stabilized frames + strip.png to {outdir}/")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
