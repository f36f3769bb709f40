"""FLGP: a JAX framework for heat-kernel Gaussian processes on GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the FLGP
reference package (graph-spectral heat-kernel GP regression and
classification with subsampled, reduced-rank Laplacian approximations), built
for single-chip speed and multi-host scale.

Public fit surface mirrors the reference's 12 ``fit_*`` entry points plus the
covariance-only and eigenmap extras (reference NAMESPACE:5-25).
"""

from .config import (
    Approach,
    FitConfig,
    GraphConfig,
    KernelType,
    LaplacianType,
    NoiseModel,
    Subsample,
    TrainConfig,
    default_a2s,
)
from .types import EigenPair, EllMatrix
from .fit.drivers import (
    FitResult,
    fit_gl_logit_gp,
    fit_gl_regression_gp,
    fit_lae_logit_gp,
    fit_lae_regression_gp,
    fit_nystrom_logit_gp,
    fit_nystrom_regression_gp,
    fit_se_logit_gp,
    fit_se_regression_gp,
)
from .fit.multiclass import (
    fit_gl_logit_mult_gp,
    fit_lae_logit_mult_gp,
    fit_nystrom_logit_mult_gp,
    fit_se_logit_mult_gp,
)
from .fit.extras import heat_kernel_covariance, lae_eigenmap

__version__ = "0.4.0"

__all__ = [
    "Approach",
    "EigenPair",
    "EllMatrix",
    "FitConfig",
    "FitResult",
    "GraphConfig",
    "KernelType",
    "LaplacianType",
    "NoiseModel",
    "Subsample",
    "TrainConfig",
    "default_a2s",
    "fit_gl_logit_gp",
    "fit_gl_logit_mult_gp",
    "fit_gl_regression_gp",
    "fit_lae_logit_gp",
    "fit_lae_logit_mult_gp",
    "fit_lae_regression_gp",
    "fit_nystrom_logit_gp",
    "fit_nystrom_logit_mult_gp",
    "fit_nystrom_regression_gp",
    "fit_se_logit_gp",
    "fit_se_logit_mult_gp",
    "fit_se_regression_gp",
    "heat_kernel_covariance",
    "lae_eigenmap",
]
