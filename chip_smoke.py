#!/usr/bin/env python
"""Bring-up check of the alignment engine on the GPU.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the multi-card paths only

Phases (one card):
  1. device: the card's name and power limit (nvidia-smi, no JAX);
  2. the `gpu`-marked tests, in a child process, before this process
     touches the card;
  3. flagship `align`: homography + Charbonnier, 5 scales, 584x388 RGB,
     batch 8, seeded content;
  4. quadratic path: affinity, 3 scales;
  5. large frames: 1920x1080 batch 2 and 3840x2160 batch 1;
  6. kernel against plain: per-trip (H, b), final p, timing of both paths,
     and a float64 plain run on the CPU (child process) on 2 pairs;
  7. the CLI, in-process, on .npy frames.

Every phase prints its numbers; a phase that fails makes the exit code
nonzero and suppresses the final line. The last line of a passing run is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# Limits of the comparisons (float32 on the card).
SYSTEM_REL_TOL = 1e-4      # per-trip (H, b), relative to each pair's largest entry
KERNEL_VS_PLAIN_PX = 1e-3  # final p of the two paths, corner displacement
GROUND_TRUTH_PX = 2e-2     # against the seeded ground truth
F64_ORACLE_PX = 1e-3       # against a float64 plain run on the CPU
MULTI_CARD_PX = 1e-2       # multi-card result against single-card align


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit of the card(s); raises without a GPU."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi lists no GPU")
    return lines[0]


def run_gpu_tests() -> None:
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    cmd = [sys.executable, "-m", "pytest", "tests/", "-m", "gpu", "-q",
           "-p", "no:cacheprovider", "-p", "no:xdist"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                       text=True, timeout=600)
    tail = "\n".join(r.stdout.strip().splitlines()[-3:])
    log(f"[tests] pytest -m gpu: rc={r.returncode} "
        f"({time.perf_counter() - t0:.1f} s)\n{tail}")
    if r.returncode != 0:
        log(r.stdout[-4000:] + r.stderr[-4000:])
        raise RuntimeError("gpu-marked tests failed")


class Smoke:
    """Phase bodies; each raises on failure."""

    def __init__(self):
        import jax
        import jax.numpy as jnp
        import numpy as np

        import inverse_compositional_algorithm_tpu as ica
        from inverse_compositional_algorithm_tpu.eval import benchmarks
        from inverse_compositional_algorithm_tpu.models import api
        from inverse_compositional_algorithm_tpu.ops import transforms

        self.jax, self.jnp, self.np, self.ica = jax, jnp, np, ica
        self.bench, self.api, self.tf = benchmarks, api, transforms
        self.flagship = ica.AlignConfig(
            transform=ica.TransformType.HOMOGRAPHY,
            robust=ica.RobustLoss.CHARBONNIER, nscales=5)

    # -- helpers ---------------------------------------------------------
    def corner_err(self, p, q, ttype, h, w):
        """Max over pairs and frame corners of |x'(x; p) - x'(x; q)| (px)."""
        np, jnp = self.np, self.jnp
        xs = jnp.array([0.0, w - 1.0, 0.0, w - 1.0])
        ys = jnp.array([0.0, 0.0, h - 1.0, h - 1.0])
        p = jnp.asarray(np.asarray(p, np.float64), jnp.float32)
        q = jnp.asarray(np.asarray(q, np.float64), jnp.float32)
        ax, ay = self.tf.transform_points(p, ttype, xs, ys)
        bx, by = self.tf.transform_points(q, ttype, xs, ys)
        return float(np.max(np.hypot(np.asarray(ax) - np.asarray(bx),
                                     np.asarray(ay) - np.asarray(by))))

    def peak_bytes(self, dev=None):
        dev = dev or self.jax.devices()[0]
        return (dev.memory_stats() or {}).get("peak_bytes_in_use", -1)

    def timed(self, fn, n=5):
        """(first-call seconds, median warm seconds, result)."""
        jax = self.jax
        t0 = time.perf_counter()
        res = jax.block_until_ready(fn())
        first = time.perf_counter() - t0
        warm = []
        for _ in range(n):
            t0 = time.perf_counter()
            res = jax.block_until_ready(fn())
            warm.append(time.perf_counter() - t0)
        return first, float(self.np.median(warm)), res

    def run_align(self, name, cfg, batch, h, w, seed=0, limit=GROUND_TRUTH_PX):
        np = self.np
        i1, i2, gt = self.bench.make_bench_batch(batch, h, w, cfg.transform,
                                                 seed=seed)
        first, warm, res = self.timed(lambda: self.ica.align(i1, i2, cfg))
        conv = float(np.mean((np.asarray(res.error) <= cfg.tol)
                             & ~np.asarray(res.diverged)))
        err = self.corner_err(res.p, gt, cfg.transform, h, w)
        trips = np.asarray(res.level_niters).max(axis=0).tolist()
        log(f"[{name}] {w}x{h} b{batch} {cfg.transform.name.lower()}/"
            f"{cfg.robust.name.lower()} {cfg.nscales} scales: "
            f"compile+first {first:.2f} s, warm {warm * 1e3:.3f} ms, "
            f"converged {conv:.3f}, corner err vs gt {err:.3e} px "
            f"(limit {limit}), max trips per level coarse->fine {trips}, "
            f"peak_bytes_in_use {self.peak_bytes()}")
        if conv < 1.0 or not err <= limit:
            raise AssertionError(f"{name}: converged {conv}, corner err {err}")
        return i1, i2, gt, res

    # -- phases ----------------------------------------------------------
    def flagship_align(self):
        self.flag_inputs = self.run_align("flagship", self.flagship, 8, 388,
                                          584)

    def quadratic(self):
        cfg = self.flagship.replace(transform=self.ica.TransformType.AFFINITY,
                                    robust=self.ica.RobustLoss.QUADRATIC,
                                    nscales=3)
        self.run_align("quadratic", cfg, 8, 388, 584, seed=1)

    def large_frames(self):
        self.hd_inputs = self.run_align("large", self.flagship, 2, 1080, 1920,
                                        seed=3)
        self.run_align("large", self.flagship, 1, 2160, 3840, seed=4)

    def kernel_vs_plain(self):
        np, jnp, ica = self.np, self.jnp, self.ica
        from inverse_compositional_algorithm_tpu import constants as cts
        from inverse_compositional_algorithm_tpu.models.ic import normal_system

        cfg = self.flagship
        for (i1, i2, gt, res), (h, w) in ((self.flag_inputs, (388, 584)),
                                          (self.hd_inputs, (1080, 1920))):
            b = i1.shape[0]
            # (H, b) of the first trip (p = 0) on both paths.
            lam = jnp.full((b,), cts.LAMBDA_0, jnp.float32)
            kw = dict(robust=cfg.robust, delta=cfg.delta)
            hk, bk = normal_system(i1, i2, jnp.zeros((b, 8)), lam,
                                   cfg.transform, path="kernel", **kw)
            hx, bx = normal_system(i1, i2, jnp.zeros((b, 8)), lam,
                                   cfg.transform, path="xla", **kw)
            rel = max(
                float(np.max(np.abs(np.asarray(a) - np.asarray(r)).reshape(b, -1).max(1)
                             / np.abs(np.asarray(r)).reshape(b, -1).max(1)))
                for a, r in ((hk, hx), (bk, bx)))
            # Both paths end to end, in turns, same inputs.
            p0 = jnp.zeros((b, 8), jnp.float32)
            run_k = lambda: self.api._align_batched(i1, i2, p0, cfg, "kernel")  # noqa: E731
            run_x = lambda: self.api._align_batched(i1, i2, p0, cfg, "xla")  # noqa: E731
            fk, _, rk = self.timed(run_k, n=1)
            fx, _, rx = self.timed(run_x, n=1)
            tk, tx = [], []
            for _ in range(7):
                tk.append(self.timed(run_k, n=1)[1])
                tx.append(self.timed(run_x, n=1)[1])
            dp = self.corner_err(rk.p, rx.p, cfg.transform, h, w)
            log(f"[kernel-vs-plain] {w}x{h} b{b}: per-trip (H, b) max rel err "
                f"{rel:.3e} (limit {SYSTEM_REL_TOL}); final p corner diff "
                f"{dp:.3e} px (limit {KERNEL_VS_PLAIN_PX}); align warm "
                f"median kernel {np.median(tk) * 1e3:.3f} ms vs plain XLA "
                f"{np.median(tx) * 1e3:.3f} ms (first call {fk:.2f} s vs "
                f"{fx:.2f} s; samples kernel {[round(t * 1e3, 3) for t in tk]}"
                f" plain {[round(t * 1e3, 3) for t in tx]})")
            if not (rel <= SYSTEM_REL_TOL and dp <= KERNEL_VS_PLAIN_PX):
                raise AssertionError(f"kernel vs plain at {w}x{h}: rel {rel}, "
                                     f"dp {dp}")
        self.f64_oracle()

    def f64_oracle(self):
        """The first 2 flagship pairs in float64 on the CPU (child process,
        so this process keeps x64 off) against the card's float32 result."""
        np = self.np
        i1, i2, gt, res = self.flag_inputs
        with tempfile.TemporaryDirectory() as d:
            np.save(os.path.join(d, "i1.npy"), np.asarray(i1[:2]))
            np.save(os.path.join(d, "i2.npy"), np.asarray(i2[:2]))
            code = (
                "import json, sys, numpy as np, jax, jax.numpy as jnp\n"
                "jax.config.update('jax_enable_x64', True)\n"
                "import inverse_compositional_algorithm_tpu as ica\n"
                "d = sys.argv[1]\n"
                "cfg = ica.AlignConfig(transform=ica.TransformType.HOMOGRAPHY,"
                " robust=ica.RobustLoss.CHARBONNIER, nscales=5)\n"
                "r = ica.align(np.load(d + '/i1.npy'), np.load(d + '/i2.npy'),"
                " cfg, dtype=jnp.float64)\n"
                "print(json.dumps({'p': np.asarray(r.p).tolist(),"
                " 'backend': jax.default_backend()}))\n")
            env = dict(os.environ, JAX_PLATFORMS="cpu")
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-c", code, d], cwd=HERE,
                               env=env, capture_output=True, text=True,
                               timeout=900)
        if r.returncode != 0:
            raise RuntimeError("float64 CPU run failed:\n" + r.stderr[-3000:])
        out = json.loads(r.stdout.strip().splitlines()[-1])
        assert out["backend"] == "cpu"
        err = self.corner_err(res.p[:2], np.asarray(out["p"]),
                              self.flagship.transform, 388, 584)
        log(f"[kernel-vs-plain] float64 CPU oracle, 2 pairs 584x388: corner "
            f"diff {err:.3e} px (limit {F64_ORACLE_PX}; CPU run "
            f"{time.perf_counter() - t0:.1f} s)")
        if not err <= F64_ORACLE_PX:
            raise AssertionError(f"float64 oracle: {err}")

    def cli(self):
        np = self.np
        from inverse_compositional_algorithm_tpu import cli

        i1, i2, gt, _ = self.flag_inputs
        with tempfile.TemporaryDirectory() as d:
            f1, f2 = os.path.join(d, "i1.npy"), os.path.join(d, "i2.npy")
            out = os.path.join(d, "out.json")
            np.save(f1, np.asarray(i1[0]))
            np.save(f2, np.asarray(i2[0]))
            rc = cli.main(["align", f1, f2, "--transform", "homography",
                           "--robust", "charbonnier", "--nscales", "5",
                           "--output", out,
                           "--save-warped", os.path.join(d, "w.npy")])
            with open(out) as f:
                rec = json.load(f)
            warped = np.load(os.path.join(d, "w.npy"))
        err = self.corner_err(np.asarray(rec["p"])[None], gt[:1],
                              self.flagship.transform, 388, 584)
        log(f"[cli] align on .npy frames: rc={rc}, {rec['iterations']} finest "
            f"trips, corner err vs gt {err:.3e} px, warped {warped.shape}")
        if rc != 0 or not err <= GROUND_TRUTH_PX or warped.shape != (388, 584, 3):
            raise AssertionError("cli")

    # -- four cards --------------------------------------------------------
    def four_cards(self):
        np, jnp, jax, ica = self.np, self.jnp, self.jax, self.ica
        from inverse_compositional_algorithm_tpu.parallel.mesh import make_mesh
        from inverse_compositional_algorithm_tpu.parallel.sharded import (
            align_sharded,
        )
        from inverse_compositional_algorithm_tpu.parallel.tiled import (
            tiled_pyramidal_solve,
        )

        devs = jax.devices()
        if len(devs) < 4:
            raise RuntimeError(f"--four-cards needs 4 GPUs, found {len(devs)}")
        cfg = self.flagship

        def report(name, res_p, ref_p, h, w, first, warm):
            ds = sorted(d.id for d in res_p.sharding.device_set)
            err = self.corner_err(np.asarray(res_p), ref_p, cfg.transform, h, w)
            peaks = {d.id: self.peak_bytes(d) for d in devs[:4]}
            log(f"[four-cards] {name}: device set {ds}, corner diff vs "
                f"single-card align {err:.3e} px (limit {MULTI_CARD_PX}), "
                f"compile+first {first:.2f} s, warm {warm * 1e3:.3f} ms, "
                f"peak_bytes_in_use per device {peaks}")
            if len(ds) != 4 or not err <= MULTI_CARD_PX:
                raise AssertionError(name)

        def single_card(name, i1, i2):
            _, warm, ref = self.timed(lambda: ica.align(i1, i2, cfg))
            log(f"[four-cards] single-card align {name}: warm "
                f"{warm * 1e3:.3f} ms")
            return ref

        i1, i2, gt = self.bench.make_bench_batch(32, 388, 584, cfg.transform)
        ref = single_card("584x388 b32", i1, i2)
        mesh = make_mesh(pairs=4, tile=1, devices=devs[:4])
        first, warm, res = self.timed(
            lambda: align_sharded(i1, i2, cfg, mesh=mesh))
        report("pairs data parallelism 584x388 b32 over make_mesh(pairs=4)",
               res.p, ref.p, 388, 584, first, warm)

        i1, i2, gt = self.bench.make_bench_batch(1, 2160, 3840, cfg.transform,
                                                 seed=4)
        ref = single_card("3840x2160 b1", i1, i2)
        mesh = make_mesh(pairs=1, tile=4, devices=devs[:4])
        first, warm, res = self.timed(
            lambda: align_sharded(i1, i2, cfg, mesh=mesh, tile_rows=True))
        report("row split align_sharded(tile_rows=True) 3840x2160 b1 over 1x4",
               res.p, ref.p, 2160, 3840, first, warm)
        path = self.api.solver_path(jnp.float32)
        first, warm, st = self.timed(lambda: tiled_pyramidal_solve(
            i1, i2, jnp.zeros((1, 8), jnp.float32), cfg.transform, mesh=mesh,
            nscales=cfg.nscales, robust=cfg.robust, delta=cfg.delta,
            path=path)[0])
        report(f"row split tiled_pyramidal_solve (path {path}) 3840x2160 b1 "
               "over 1x4", st.p, ref.p, 2160, 3840, first, warm)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths, on 4 GPUs")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "inverse_compositional_algorithm_tpu")):
        log("chip_smoke: the package is not beside this script")
        return 2
    sys.path.insert(0, HERE)
    try:
        card = card_line()
    except Exception as e:  # noqa: BLE001
        log(f"chip_smoke: no GPU ({e})")
        return 2
    log(f"[device] nvidia-smi: {card}")

    failures = []

    def phase(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001
            failures.append(name)
            log(f"[{name}] FAILED\n{traceback.format_exc()}")
        log(f"[{name}] {time.perf_counter() - t0:.1f} s")

    if not args.four_cards:
        phase("tests", run_gpu_tests)

    import jax

    from inverse_compositional_algorithm_tpu.utils.profiling import (
        enable_compilation_cache,
    )

    log(f"[device] compile cache: {enable_compilation_cache()}")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"chip_smoke: JAX found no GPU (platform {dev.platform})")
        return 2
    from inverse_compositional_algorithm_tpu.models.api import solver_path

    import jax.numpy as jnp

    path = solver_path(jnp.float32)
    log(f"[device] {dev.device_kind} x{len(jax.devices())}; float32 align "
        f"runs path {path!r}")
    if path != "kernel":
        failures.append("path")

    smoke = Smoke()
    if args.four_cards:
        phase("four-cards", smoke.four_cards)
    else:
        phase("flagship", smoke.flagship_align)
        phase("quadratic", smoke.quadratic)
        phase("large", smoke.large_frames)
        if {"flagship", "large"} & set(failures):
            failures.append("kernel-vs-plain")
            failures.append("cli")
        else:
            phase("kernel-vs-plain", smoke.kernel_vs_plain)
            phase("cli", smoke.cli)

    log(f"[device] nvidia-smi: {card_line()}")
    if failures:
        log(f"chip_smoke: FAILED phases {failures}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
