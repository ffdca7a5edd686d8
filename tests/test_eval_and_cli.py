"""Eval harness, image IO, and CLI surface tests (CPU, small shapes)."""

import json
import os

import numpy as np
import pytest

from inverse_compositional_algorithm_tpu.config import AlignConfig
from inverse_compositional_algorithm_tpu.eval.harness import (
    evaluate, evaluate_pyramid_levels, make_pairs, random_params,
)
from inverse_compositional_algorithm_tpu.ops.normal_equations import RobustLoss
from inverse_compositional_algorithm_tpu.ops.transforms import TransformType
from inverse_compositional_algorithm_tpu.utils.imageio import (
    load_image, save_image, to_uint8,
)


@pytest.fixture(scope="module")
def image_stack(request):
    smooth = request.getfixturevalue("smooth_image")
    img = np.asarray(smooth)[:96, :112]
    rng = np.random.default_rng(3)
    stack = np.stack([np.roll(img, rng.integers(0, 40), axis=1)
                      for _ in range(3)])
    return stack.astype(np.float32)


def test_random_params_shapes():
    for t in TransformType:
        p = random_params(4, t, 100, 120, magnitude=2.0)
        assert p.shape == (4, 8)
        # padded slots stay zero
        from inverse_compositional_algorithm_tpu.ops.transforms import nparams
        assert np.all(p[:, nparams(t):] == 0)


def test_evaluate_recovers_random_motions(image_stack):
    cfg = AlignConfig(transform=TransformType.EUCLIDEAN, nscales=2, delta=6)
    r = evaluate(image_stack, cfg, magnitude=1.5)
    assert r.batch == 3
    assert r.mae < 0.05, f"param MAE too high: {r}"
    assert r.pairs_per_sec > 0
    assert 0.0 <= r.converged_frac <= 1.0


def test_evaluate_pyramid_sweep(image_stack):
    cfg = AlignConfig(transform=TransformType.TRANSLATION, delta=6)
    rs = evaluate_pyramid_levels(image_stack, cfg, levels=(2, 3),
                                 magnitude=1.0)
    assert [r.nscales for r in rs] == [2, 3]
    assert all(r.mae < 0.1 for r in rs)


def test_make_pairs_fixed_point(image_stack):
    i1, i2, gt = make_pairs(image_stack, TransformType.TRANSLATION,
                            magnitude=1.0, seed=1)
    assert i1.shape == i2.shape == image_stack.shape
    assert gt.shape == (3, 8)


def test_to_uint8_nan_and_range():
    img = np.array([[0.0, np.nan], [127.5, 255.0]])
    u = to_uint8(img)
    assert u.dtype == np.uint8
    assert u[0, 1] == 0          # NaN zeroed before normalize
    assert u[1, 1] == 255
    assert to_uint8(np.full((4, 4), 7.0)).max() == 0   # constant image


def test_save_load_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (16, 20, 3)).astype(np.float32)
    path = str(tmp_path / "x.png")
    save_image(img, path)
    back = load_image(path)
    assert back.shape == (16, 20, 3)
    assert back.dtype == np.float32


def test_cli_align_and_make_config(tmp_path, make_pair):
    from inverse_compositional_algorithm_tpu.cli import main

    i1, i2 = make_pair([2.0, -1.0], TransformType.TRANSLATION)
    p1, p2 = str(tmp_path / "i1.png"), str(tmp_path / "i2.png")
    # save RAW pixel values (cli loads 0..255; to_uint8 normalizes, which is
    # fine for alignment since the transform is intensity-invariant)
    save_image(i1[:64, :80], p1)
    save_image(i2[:64, :80], p2)
    out = str(tmp_path / "res.json")

    rc = main(["align", p1, p2, "--transform", "translation",
               "--nscales", "2", "--delta", "6", "--output", out,
               "--save-warped", str(tmp_path / "w.png")])
    assert rc == 0
    with open(out) as f:
        res = json.load(f)
    np.testing.assert_allclose(res["p"], [2.0, -1.0], atol=0.05)
    assert os.path.exists(tmp_path / "w.png")

    cfgp = str(tmp_path / "c.ini")
    assert main(["make-config", cfgp]) == 0
    from inverse_compositional_algorithm_tpu.config import read_config_file
    cfgs = read_config_file(cfgp)
    assert "pyramidal_inverse_compositional_algorithm" in cfgs


def test_eval_plots(tmp_path):
    """plots.py renders the three sweep charts from a recorded EVAL json
    (reference plot_results parity)."""
    import json

    from inverse_compositional_algorithm_tpu.eval.plots import plot_record

    row = dict(transform="EUCLIDEAN", robust="CHARBONNIER", nscales=3,
               batch=2, mse=1e-8, mae=1e-4, max_err=3e-4, pairs_per_sec=10.0,
               seconds=0.2, mean_iters=3.0, converged_frac=1.0)
    rec = {"device": "test", "sweeps": {
        "transforms": [row, {**row, "transform": "AFFINITY"}],
        "robust_losses": [row],
        "pyramid_levels": [row, {**row, "nscales": 5}],
    }}
    paths = plot_record(rec, str(tmp_path))
    assert len(paths) == 3
    import os
    assert all(os.path.getsize(p) > 1000 for p in paths)
