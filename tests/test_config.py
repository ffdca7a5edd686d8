"""Config round-trip and reference INI compatibility."""

import numpy as np
import pytest

import inverse_compositional_algorithm_tpu as ica
from inverse_compositional_algorithm_tpu.config import (
    AlignConfig, read_config_file, write_config_file,
)
from inverse_compositional_algorithm_tpu.ops.normal_equations import RobustLoss
from inverse_compositional_algorithm_tpu.ops.transforms import TransformType


def test_roundtrip(tmp_path):
    cfg = AlignConfig(transform=TransformType.HOMOGRAPHY,
                      robust=RobustLoss.LORENTZIAN, lam=3.0, tol=2e-4,
                      nscales=4, nu=0.6)
    path = str(tmp_path / "c.ini")
    write_config_file(path, cfg)
    back = read_config_file(path)
    pyr = back["pyramidal_inverse_compositional_algorithm"]
    assert pyr.transform is TransformType.HOMOGRAPHY
    assert pyr.robust is RobustLoss.LORENTZIAN
    assert pyr.lam == 3.0
    assert pyr.tol == 2e-4
    assert pyr.nscales == 4
    assert pyr.nu == 0.6


def test_reads_reference_config():
    """A config.ini in the reference's format (its three sections, with
    inline comments; reference: config.ini:1-21) parses."""
    import os

    cfgs = read_config_file(os.path.join(os.path.dirname(__file__), "data",
                                         "config.ini"))
    pyr = cfgs["pyramidal_inverse_compositional_algorithm"]
    assert pyr.transform is TransformType.EUCLIDEAN
    assert pyr.nscales == 5
    assert pyr.nu == 0.5
    assert pyr.robust is RobustLoss.QUADRATIC
    rob = cfgs["robust_inverse_compositional_algorithm"]
    assert rob.robust is RobustLoss.CHARBONNIER
    assert rob.lam == 0.0


def test_validate_rejects_reference_constraints():
    # TOL must be < 0.01 (reference src/inverse_compositional_algorithm.py:59-60)
    with pytest.raises(ValueError):
        AlignConfig(tol=0.5).validate()
    with pytest.raises(ValueError):
        AlignConfig(nscales=0).validate()
    with pytest.raises(ValueError):
        AlignConfig(nu=1.5).validate()


def test_config_is_hashable_static_arg():
    a = AlignConfig()
    b = AlignConfig()
    assert hash(a) == hash(b) and a == b
    c = a.replace(nscales=2)
    assert c != a


def test_valid_values():
    from inverse_compositional_algorithm_tpu.utils.validation import valid_values
    assert valid_values(np.ones((3, 3)))
    assert not valid_values(np.array([1.0, np.nan]))
    assert not valid_values(np.array([np.inf, 1.0]))
