"""Profiling and tracing utilities.

The reference's observability is ad-hoc timeit cells
(reference: test/time_profiling.ipynb) and verbose prints; here:
per-stage wall timers that block on device completion, plus a thin wrapper
over jax.profiler for capturing device traces viewable in Perfetto/XProf.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import jax

__all__ = ["StageTimer", "trace", "enable_compilation_cache",
           "compilation_cache_dir"]


REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compilation_cache_dir(platform: str | None = None) -> str | None:
    """Where compiled executables persist, or None for no cache.

      * JAX_COMPILATION_CACHE_DIR, when set, on any platform: the user's
        choice, and no other path is set in code;
      * otherwise `<repo>/.jax_cache` on the GPU;
      * otherwise none. On the CPU the cache stays off: XLA:CPU executables
        are compiled for the exact host CPU features, and reloading one on
        a host with other features crashes the process. CPU compiles take
        seconds anyway.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    platform = platform or jax.default_backend()
    return REPO_CACHE_DIR if platform == "gpu" else None


def enable_compilation_cache() -> str | None:
    """Persist compiled executables across processes (see
    compilation_cache_dir); the 5-level pyramid program takes long to
    compile, and the cache makes reruns of bench.py, chip_smoke.py and the
    CLI for an already-seen (shape, config) start at once. Returns the
    directory in use."""
    path = compilation_cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


class StageTimer:
    """Accumulating wall-clock timer keyed by stage name.

    Blocks on device work (jax.block_until_ready on the value returned by
    the stage) so times are real, not dispatch latencies::

        timer = StageTimer()
        with timer("warp"):
            iw = warp_fn(...)           # timer blocks at scope exit
        print(timer.report())
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._live = []

    @contextlib.contextmanager
    def __call__(self, name: str, value=None):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            if self._live:
                jax.block_until_ready(self._live.pop())
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def observe(self, value):
        """Register the stage's output so the timer can block on it."""
        self._live.append(value)
        return value

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        width = max((len(k) for k in self.totals), default=4)
        lines = [f"{k:<{width}}  {v * 1e3:10.3f} ms  x{self.counts[k]}"
                 for k, v in rows]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler device trace around the enclosed block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
