"""Multi-host launcher for sharded alignment.

The reference is strictly single-process (SURVEY §2.2); this is the
scale-out entry point. One process per host drives all of that host's
GPUs: standard jax.distributed bring-up, a global ("pairs", "tile") mesh
over every card of every host; each host feeds its addressable shard of
the pair batch and the program runs with XLA collectives (NCCL) between
the cards.

One command per host, run by your cluster runner:

    python -m inverse_compositional_algorithm_tpu.parallel.launch \
        --coordinator <host0-ip>:8476 --num-processes <H> --process-id <i> \
        --batch-per-host 64 [--tile 1] [--height 388 --width 584]

Nothing tells JAX of the cluster unless the runner does, so pass the three
flags. Prints per-host and global pairs/s; process 0 also prints the JSON
summary line.

Single-host smoke (8 fake CPU devices):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python -m inverse_compositional_algorithm_tpu.parallel.launch \
        --no-distributed --batch-per-host 16
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (omit to auto-detect)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--no-distributed", action="store_true",
                    help="skip jax.distributed (single-host / fake devices)")
    ap.add_argument("--platform", default=None,
                    help="force a JAX platform (e.g. cpu); jax.config "
                         "takes precedence over JAX_PLATFORMS")
    ap.add_argument("--batch-per-host", type=int, default=64)
    ap.add_argument("--height", type=int, default=388)
    ap.add_argument("--width", type=int, default=584)
    ap.add_argument("--tile", type=int, default=1,
                    help="row-tile axis size (spatial sharding)")
    ap.add_argument("--nscales", type=int, default=5)
    ap.add_argument("--transform", default="homography")
    ap.add_argument("--robust", default="charbonnier")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)

    if args.no_distributed:
        # Single-host smoke on CPU fake devices: the platform pin is
        # applied through jax.config before backend init.
        from .scaling import force_cpu_fake_devices

        force_cpu_fake_devices(8)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if not args.no_distributed:
        # Multi-process CPU backends only federate with an explicit
        # cross-process collectives implementation; GPUs use NCCL.
        if (args.platform or os.environ.get("JAX_PLATFORMS", "")) == "cpu":
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        from .sharded import init_distributed

        kw = {}
        if args.coordinator:
            kw = dict(coordinator_address=args.coordinator,
                      num_processes=args.num_processes,
                      process_id=args.process_id)
        init_distributed(**kw)

    from ..config import AlignConfig
    from ..eval.benchmarks import NUMPY_BASELINE_PAIRS_PER_SEC, make_bench_batch
    from ..ops.normal_equations import RobustLoss
    from ..ops.transforms import TransformType
    from .mesh import make_mesh
    from .sharded import align_sharded

    ndev = len(jax.devices())
    nproc = jax.process_count()
    pid = jax.process_index()
    mesh = make_mesh(pairs=ndev // args.tile, tile=args.tile)
    cfg = AlignConfig(transform=TransformType[args.transform.upper()],
                      robust=RobustLoss[args.robust.upper()],
                      nscales=args.nscales)

    pairs = ndev // args.tile
    # Each host builds only ITS shard of the pair batch (different content
    # per host — that's the point of scale-out); align_sharded assembles
    # the global array from the per-process shards. Round the per-host
    # batch UP so the global batch b_local * nproc is always a multiple of
    # the pairs axis — including when nproc does not divide pairs (e.g.
    # 3 hosts feeding a 4-way pairs axis needs b_local % 4 == 0).
    import math

    step = pairs // math.gcd(pairs, nproc)
    b_local = max(step, -(-args.batch_per_host // step) * step)
    b_global = b_local * nproc
    i1, i2, _ = make_bench_batch(b_local, args.height, args.width,
                                 cfg.transform, seed=pid)

    res = align_sharded(i1, i2, cfg, mesh=mesh, tile_rows=args.tile > 1)
    jax.block_until_ready(res.p)              # compile + warm
    t0 = time.perf_counter()
    for _ in range(args.repeats):
        res = align_sharded(i1, i2, cfg, mesh=mesh, tile_rows=args.tile > 1)
        jax.block_until_ready(res.p)
    dt = (time.perf_counter() - t0) / args.repeats

    pps = b_global / dt
    # A multi-process global array can only be read shard-by-shard.
    err_local = np.concatenate(
        [np.asarray(s.data) for s in res.error.addressable_shards])
    rec = {
        "hosts": nproc,
        "devices": ndev,
        "mesh": f"{ndev // args.tile}x{args.tile} pairs x tile",
        "batch_global": b_global,
        "pairs_per_sec_global": round(pps, 2),
        "pairs_per_sec_per_device": round(pps / ndev, 2),
        "vs_numpy_baseline": round(pps / NUMPY_BASELINE_PAIRS_PER_SEC, 1),
        "errors_finite": bool(np.isfinite(err_local).all()),
    }
    if pid == 0:
        print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
