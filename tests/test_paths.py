"""The path rule, the compile-cache placement, the device guards of the
benchmark and chip_smoke.py, and the .npy frame IO."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from inverse_compositional_algorithm_tpu.models.api import solver_path
from inverse_compositional_algorithm_tpu.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,dtype,interpret,expected", [
    ("gpu", jnp.float32, False, "kernel"),
    ("gpu", jnp.float64, False, "xla"),
    ("gpu", jnp.bfloat16, False, "xla"),
    ("cpu", jnp.float32, False, "xla"),
    ("cpu", jnp.float32, True, "interpret"),
    ("gpu", jnp.float32, True, "interpret"),
])
def test_solver_path_rule(platform, dtype, interpret, expected):
    assert solver_path(dtype, interpret, platform=platform) == expected


def test_cpu_default_is_plain_path():
    assert jax.default_backend() == "cpu"
    assert solver_path(jnp.float32) == "xla"


def test_unknown_path_rejected():
    from inverse_compositional_algorithm_tpu.models.ic import ic_solve
    from inverse_compositional_algorithm_tpu.ops.transforms import TransformType

    x = jnp.zeros((1, 16, 16, 1), jnp.float32)
    with pytest.raises(ValueError, match="unknown path"):
        ic_solve(x, x, jnp.zeros((1, 8), jnp.float32),
                 TransformType.TRANSLATION, path="mosaic")


@pytest.mark.parametrize("env,platform,expected", [
    ("/some/cache", "gpu", "/some/cache"),
    ("/some/cache", "cpu", "/some/cache"),
    (None, "gpu", profiling.REPO_CACHE_DIR),
    (None, "cpu", None),
])
def test_compile_cache_placement(monkeypatch, env, platform, expected):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    assert profiling.compilation_cache_dir(platform) == expected


def test_repo_cache_dir_is_gitignored():
    assert profiling.REPO_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_stays_off_on_cpu(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert profiling.enable_compilation_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PATH="/usr/bin:/bin")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_benchmark_refuses_unknown_device():
    from inverse_compositional_algorithm_tpu.eval import benchmarks

    with pytest.raises(RuntimeError, match="no published peaks"):
        benchmarks.device_peaks()
    with pytest.raises(RuntimeError, match="no published peaks"):
        benchmarks.run_benchmark(batch=1, height=32, width=32, full=False)


def test_device_record_names_the_device():
    from inverse_compositional_algorithm_tpu.eval import benchmarks

    rec = benchmarks.device_record()
    assert rec == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}


def test_npy_frames_roundtrip(tmp_path):
    from inverse_compositional_algorithm_tpu.utils.imageio import (
        load_image,
        save_image,
    )

    img = np.random.default_rng(0).uniform(0, 255, (9, 11, 3))
    save_image(img, str(tmp_path / "a.npy"))
    np.testing.assert_array_equal(load_image(str(tmp_path / "a.npy")),
                                  img.astype(np.float32))
    np.save(tmp_path / "g.npy", img[..., 0])
    assert load_image(str(tmp_path / "g.npy")).shape == (9, 11, 1)


def test_cli_aligns_npy_frames(tmp_path, make_pair, capsys):
    from inverse_compositional_algorithm_tpu import cli
    from inverse_compositional_algorithm_tpu.ops.transforms import TransformType

    i1, i2 = make_pair([1.5, -1.0], TransformType.TRANSLATION)
    np.save(tmp_path / "i1.npy", i1)
    np.save(tmp_path / "i2.npy", i2)
    rc = cli.main(["align", str(tmp_path / "i1.npy"), str(tmp_path / "i2.npy"),
                   "--transform", "translation", "--nscales", "2",
                   "--save-warped", str(tmp_path / "w.npy")])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    np.testing.assert_allclose(out["p"], [1.5, -1.0], atol=1e-2)
    assert np.load(tmp_path / "w.npy").shape == i1.shape


def test_sharded_tile_rows_kernel_path_uses_row_split(make_pair):
    """align_sharded(tile_rows=True) on the kernel path (interpreter) solves
    through the explicit row-split solver and matches align."""
    import inverse_compositional_algorithm_tpu as ica
    from inverse_compositional_algorithm_tpu.ops.transforms import TransformType
    from inverse_compositional_algorithm_tpu.parallel.mesh import make_mesh
    from inverse_compositional_algorithm_tpu.parallel.sharded import (
        align_sharded,
    )

    i1, i2 = make_pair([1.5, -1.0], TransformType.TRANSLATION)
    i1 = np.broadcast_to(i1[None, :64, :80], (2, 64, 80, 3)).copy()
    i2 = np.broadcast_to(i2[None, :64, :80], (2, 64, 80, 3)).copy()
    cfg = ica.AlignConfig(transform=TransformType.TRANSLATION, nscales=2,
                          delta=6, interpret=True)
    ref = ica.align(i1, i2, cfg)
    got = align_sharded(i1, i2, cfg, mesh=make_mesh(pairs=2, tile=2),
                        tile_rows=True)
    assert len(got.p.sharding.device_set) >= 2
    np.testing.assert_allclose(np.asarray(got.p), np.asarray(ref.p),
                               atol=2e-4)
    np.testing.assert_array_equal(np.asarray(got.level_niters).shape, (2, 2))
