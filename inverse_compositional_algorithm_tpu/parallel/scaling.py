"""Virtual weak-scaling measurement on the fake CPU device mesh.

A rehearsal of multi-device scaling without the cards: fix the
per-device pair count, grow the device count on a CPU fake-device mesh
(XLA_FLAGS=--xla_force_host_platform_device_count), and check that (a) the
program partitions and runs at every mesh size, and (b) per-device
throughput stays flat (weak-scaling efficiency). On shared host cores this
measures partitioning overhead, not device speed — a collapsing efficiency
would indicate hidden serialization (e.g. an unsharded intermediate or a
host sync), which is exactly what it guards against.

Run (fresh process so device count can be forced):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python -m inverse_compositional_algorithm_tpu.parallel.scaling
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def force_cpu_fake_devices(n: int = 8) -> None:
    """Force the CPU platform with n fake devices BEFORE backend init.

    jax.config.update takes precedence over a JAX_PLATFORMS value set
    elsewhere. Must run before the first jax.devices()/computation.
    """
    import os

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n}").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


def measure_weak_scaling(device_counts=(1, 2, 4, 8), pairs_per_device=4,
                         height=96, width=128, nscales=2,
                         repeats=10) -> dict:
    import jax
    import jax.numpy as jnp

    from ..config import AlignConfig
    from ..eval.benchmarks import make_bench_batch
    from ..ops.normal_equations import RobustLoss
    from ..ops.transforms import TransformType
    from .mesh import make_mesh
    from .sharded import align_sharded

    cfg = AlignConfig(transform=TransformType.HOMOGRAPHY,
                      robust=RobustLoss.CHARBONNIER, nscales=nscales,
                      delta=5)
    rows = []
    for nd in device_counts:
        if nd > len(jax.devices()):
            continue
        mesh = make_mesh(pairs=nd, tile=1, devices=jax.devices()[:nd])
        b = pairs_per_device * nd
        i1, i2, _ = make_bench_batch(b, height, width, cfg.transform)
        res = align_sharded(i1, i2, cfg, mesh=mesh)
        jax.block_until_ready(res.p)          # compile + warm
        t0 = time.perf_counter()
        for _ in range(repeats):
            res = align_sharded(i1, i2, cfg, mesh=mesh)
            jax.block_until_ready(res.p)
        dt = (time.perf_counter() - t0) / repeats
        rows.append({
            "devices": nd,
            "batch": b,
            "pairs_per_sec": round(b / dt, 2),
            "pairs_per_sec_per_device": round(b / dt / nd, 2),
            "errors_finite": bool(np.isfinite(np.asarray(res.error)).all()),
        })
        print(rows[-1], flush=True)
    eff = (rows[-1]["pairs_per_sec_per_device"]
           / rows[0]["pairs_per_sec_per_device"]) if len(rows) > 1 else 1.0
    return {
        "mode": "virtual CPU fake-device mesh (weak scaling proxy)",
        "config": "homography+charbonnier, %dx%d, %d scales, %d pairs/dev"
                  % (height, width, nscales, pairs_per_device),
        "rows": rows,
        "weak_scaling_efficiency": round(eff, 3),
    }


if __name__ == "__main__":
    force_cpu_fake_devices(8)
    rec = measure_weak_scaling()
    out = sys.argv[1] if len(sys.argv) > 1 else None
    if out:
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"wrote {out}")
    else:
        print(json.dumps(rec))
