"""Batched parametric image registration (inverse compositional algorithm).

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
`inverse_compositional_algorithm` reference (IPOL 2016.153 / 2018.222):
global parametric motion estimation (translation / euclidean / similarity /
affinity / homography) between image pairs by Gauss-Newton on the
inverse-compositional formulation, with robust IRLS error functions and a
coarse-to-fine pyramid — batched, jit-compiled, and shardable across
device meshes.

Quick start::

    import inverse_compositional_algorithm_tpu as ica

    cfg = ica.AlignConfig(transform=ica.TransformType.HOMOGRAPHY,
                          robust=ica.RobustLoss.CHARBONNIER, nscales=5)
    result = ica.align(I1, I2, cfg)       # I*: [H,W,C] or [B,H,W,C]
    p = result.params(cfg)
"""

from .config import AlignConfig, read_config_file, write_config_file
from .constants import MAX_ITER, LAMBDA_0, LAMBDA_N, LAMBDA_RATIO, ZOOM_SIGMA_ZERO
from .models.api import AlignResult, align, transform_image, warp
from .models.ic import ICState, ic_solve
from .models.pyramidal import pyramidal_solve
from .ops.normal_equations import RobustLoss
from .ops.transforms import (
    TransformType,
    compose_inverse,
    invert_params,
    matrix_to_params,
    nparams,
    pad_params,
    params_to_matrix,
    transform_grid,
    zoom_in_params,
)

__version__ = "0.1.0"

__all__ = [
    "AlignConfig",
    "AlignResult",
    "ICState",
    "RobustLoss",
    "TransformType",
    "align",
    "warp",
    "transform_image",
    "ic_solve",
    "pyramidal_solve",
    "compose_inverse",
    "invert_params",
    "params_to_matrix",
    "matrix_to_params",
    "transform_grid",
    "zoom_in_params",
    "pad_params",
    "nparams",
    "read_config_file",
    "write_config_file",
]
