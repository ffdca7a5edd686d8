"""Test environment: virtual 8-device CPU mesh, x64 available.

The suite runs on the CPU unless JAX_PLATFORMS says otherwise (set before
jax imports). Sharding / multi-device logic is validated on a fake CPU
device mesh (the standard JAX pattern, see SURVEY.md §4), and the fused
iteration kernel runs in the Pallas interpreter.

Tests of the kernel as compiled for the GPU carry the `gpu` marker and skip
elsewhere; on a machine with a card they run with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q

(chip_smoke.py runs exactly that as its second phase).
"""

import os

PLATFORM = os.environ.setdefault("JAX_PLATFORMS", "cpu")

if PLATFORM == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import jax  # noqa: E402

if PLATFORM == "cpu":
    # Unit-test oracles compare in float64; package code is dtype-explicit
    # so enabling x64 does not change the float32 production paths.
    jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip `gpu`-marked tests where JAX has no GPU (decided per test, so
    every test worker collects the same tests)."""
    if (request.node.get_closest_marker("gpu")
            and jax.default_backend() != "gpu"):
        pytest.skip("needs the GPU: compiled kernel (run with -m gpu on "
                    "the card, or python chip_smoke.py)")


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """Drop compiled executables at module boundaries.

    XLA:CPU's compiler segfaults deterministically when the ~150th-plus
    executable of the suite is a large shard_map program (observed at
    tests/test_tiled.py's pyramidal compiles, 73% into the suite, across
    multiple runs and cache configurations; the same compiles succeed in
    a fresh process). Freeing the accumulated executables between
    modules keeps the process under whatever compiler-state limit is
    being hit. Costs a few re-compiles for shapes shared across modules.
    """
    yield
    jax.clear_caches()
    try:
        from inverse_compositional_algorithm_tpu.parallel.tiled import (
            _build_tiled_fn,
        )

        _build_tiled_fn.cache_clear()
    except Exception:
        pass


@pytest.fixture(scope="session")
def smooth_image():
    """Deterministic smooth RGB test image [140, 180, 3] in 0..255."""
    import jax.numpy as jnp
    from inverse_compositional_algorithm_tpu.ops.pyramid import gaussian_blur

    rng = np.random.default_rng(0)
    noise = rng.uniform(0.0, 255.0, (140, 180, 3)).astype(np.float32)
    return np.array(gaussian_blur(jnp.asarray(noise[None]), 3.0))[0]


def synth_pair(img, p, ttype):
    """(I1, I2) with exact ground truth p: I1 = img sampled at x'(x; p),
    I2 = img. The solver's fixed point is then exactly p (no boundary
    zero-fill artifacts; only edge-clipped taps within ~2 px of the border,
    which the delta band excludes)."""
    import jax.numpy as jnp
    from inverse_compositional_algorithm_tpu.ops.transforms import (
        pad_params, transform_grid,
    )
    from inverse_compositional_algorithm_tpu.ops.warp import bicubic_sample

    img = jnp.asarray(img, jnp.float32)
    h, w, _ = img.shape
    gx, gy = transform_grid(pad_params(jnp.asarray(p, jnp.float32))[None], ttype, h, w)
    i1 = bicubic_sample(img[None], gx, gy)[0]
    return np.array(i1), np.array(img)


@pytest.fixture(scope="session")
def make_pair(smooth_image):
    def _make(p, ttype):
        return synth_pair(smooth_image, p, ttype)

    return _make
