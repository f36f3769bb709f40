"""Typed configuration for FLGP.

The reference threads a stringly-typed R list ``models = {subsample, kernel,
gl, root}`` plus per-call scalars through every entry point and dispatches on
string compares (reference: R/Fit.R:56-61, src/Spectrum.cpp:60-67,
src/Utils.cpp:36-65).  Here the same surface is a frozen dataclass with enums,
a single source of defaults, and explicit dtype policy.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence

import jax.numpy as jnp


class Subsample(str, enum.Enum):
    """Anchor-point selection method (reference: src/Utils.cpp:32-68)."""

    KMEANS = "kmeans"
    RANDOM = "random"
    MINIBATCH_KMEANS = "minibatchkmeans"


class KernelType(str, enum.Enum):
    """Cross-similarity flavor (reference: src/Spectrum.cpp:60-67)."""

    LAE = "lae"
    SE = "se"


class LaplacianType(str, enum.Enum):
    """Graph-Laplacian normalization (reference: src/Utils.cpp:195-212)."""

    RW = "rw"
    NORMALIZED = "normalized"
    CLUSTER_NORMALIZED = "cluster-normalized"


class Approach(str, enum.Enum):
    """Empirical-Bayes objective (reference: src/train.cpp:50-57)."""

    MARGINAL = "marginal"
    POSTERIOR = "posterior"


class NoiseModel(str, enum.Enum):
    """Homoscedastic vs per-point observation noise (src/train.cpp:567-617)."""

    SAME = "same"
    DIFFERENT = "different"


# Numerical jitter used throughout the reference on divisions / log-chol
# diagonals (e.g. src/Utils.cpp:201-211, src/train.cpp:392).
EPS = 1e-9

# Matmul precision for the numerically critical contractions (distance
# expansion, Gram matrices, heat-kernel assembly, model solves).  On the GPU
# HIGHEST means full FP32 (no TF32 on the tensor cores): the |x|²−2x·u+|u|²
# cancellation and spectra clustered near 1 need the f32 mantissa.  A
# contraction that passes no ``precision=`` runs in TF32 on an H100.
import jax as _jax  # noqa: E402

PRECISION = _jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Configuration of the spectral (graph) stage.

    Mirrors the reference's ``models`` list plus the per-call scalars
    (s, r, K, nstart) threaded alongside it (R/Fit.R:56-70).
    """

    s: int = 600                      # number of anchor/induced points
    r: int = 3                        # kNN fan-in per point
    K: int = -1                       # spectral truncation; -1 -> K = s
    subsample: Subsample = Subsample.KMEANS
    kernel: KernelType = KernelType.LAE
    gl: LaplacianType = LaplacianType.CLUSTER_NORMALIZED
    root: bool = True                 # sqrt the eigenvalues of W (Spectrum.cpp:153-155)
    nstart: int = 1                   # k-means restarts
    kmeans_iters: int = 100           # Lloyd iterations (src/Utils.cpp:41)
    epsilon: float = 0.1              # SE bandwidth for covariance-only entry point
    # pinv-style relative cutoff on the Nyström extension's inverse
    # eigenvalues (fit/spectral.py:nystrom_extend).  0.0 = the reference's
    # raw 1/λ (src/Fit.cpp:289); ~1e-3 recommended when sampling the
    # resulting posterior (near-null anchor eigenvalues otherwise amplify
    # noise into pathologically stiff latent directions).
    nystrom_rcond: float = 0.0

    def __post_init__(self):
        # Eager validation: the reference aborts deep inside C++ on bad
        # config strings (src/Utils.cpp:64,123); here misconfiguration is a
        # construction-time ValueError with the offending field named.
        if self.s < 1:
            raise ValueError(f"GraphConfig.s must be >= 1, got {self.s}")
        if self.r < 1:
            raise ValueError(f"GraphConfig.r must be >= 1, got {self.r}")
        if self.r > self.s:
            raise ValueError(
                f"GraphConfig.r ({self.r}) cannot exceed the anchor count s ({self.s})"
            )
        # K is NOT coupled to s here: anchor-based builders clamp K <= s at
        # the call site, while GL drivers bound K by n (the reference's
        # fit_gl_* take K independent of any anchor count, src/Fit.cpp:361).
        if self.K != -1 and self.K < 1:
            raise ValueError(
                f"GraphConfig.K must be -1 (=> s) or >= 1, got {self.K}"
            )
        if self.nstart < 1:
            raise ValueError(f"GraphConfig.nstart must be >= 1, got {self.nstart}")
        if self.epsilon <= 0:
            raise ValueError(f"GraphConfig.epsilon must be > 0, got {self.epsilon}")
        if not 0.0 <= self.nystrom_rcond < 1.0:
            raise ValueError(
                f"GraphConfig.nystrom_rcond must be in [0, 1), got {self.nystrom_rcond}"
            )
        # Coerce raw strings ("kmeans", "lae", "rw") to the enums so the
        # reference's stringly-typed call sites translate one-for-one.
        for field, enum_t in (
            ("subsample", Subsample), ("kernel", KernelType), ("gl", LaplacianType)
        ):
            v = getattr(self, field)
            if not isinstance(v, enum_t):
                object.__setattr__(self, field, enum_t(v))

    def resolved_K(self) -> int:
        return self.s if self.K < 0 else self.K


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameter-learning configuration.

    The reference optimizes with NLopt (COBYLA for GPC t, MMA for GPR
    (t, noise); src/train.cpp:45-67, 619-656).  We optimize the identical
    objectives with autodiff gradients: a log-space grid scan followed by
    Adam polish, fully jit/vmap-able.
    """

    approach: Approach = Approach.POSTERIOR
    noise: NoiseModel = NoiseModel.SAME
    t0: float = 10.0
    t_lb: float = 1e-3                 # src/train.cpp lb for t
    t_ub: float = 1e4                  # INITIAL scan window top — the 1-D optimizer
                                       # expands above it when the optimum pins there
                                       # (reference COBYLA ub=inf, src/train.cpp:45-58)
    noise0: float = 1.0
    noise_lb: float = 1e-4             # src/train.cpp lb for noise
    # t-prior  p*log t + (t/tau)^(-q)   (src/train.h:136-156)
    prior_p_gpc: float = 1e-2
    prior_p_gpr: float = 1.0
    prior_q: float = 10.0
    prior_tau: float = 2.0
    # inverse-gamma noise prior (src/train.h:151-155)
    prior_alpha: float = 1e-1
    prior_beta: float = 1e-3
    # optimizer schedule
    grid_size: int = 32                # log-spaced coarse scan points
    adam_steps: int = 200
    adam_lr: float = 0.05
    # Laplace Newton iteration (src/train.cpp:716-760)
    newton_tol: float = 1e-5
    newton_max_iter: int = 100

    def __post_init__(self):
        if self.t0 <= 0 or self.t_lb <= 0:
            raise ValueError("TrainConfig.t0 and t_lb must be > 0")
        if self.t_ub <= self.t_lb:
            raise ValueError(
                f"TrainConfig.t_ub ({self.t_ub}) must exceed t_lb ({self.t_lb})"
            )
        if self.noise0 <= 0 or self.noise_lb <= 0:
            raise ValueError("TrainConfig.noise0 and noise_lb must be > 0")
        if self.grid_size < 2:
            raise ValueError(f"TrainConfig.grid_size must be >= 2, got {self.grid_size}")
        for field, enum_t in (("approach", Approach), ("noise", NoiseModel)):
            v = getattr(self, field)
            if not isinstance(v, enum_t):
                object.__setattr__(self, field, enum_t(v))


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Top-level fit configuration shared by all drivers."""

    graph: GraphConfig = dataclasses.field(default_factory=GraphConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    sigma: float = 1e-3                # ridge on H; 1e-3 clf / 1e-5 reg defaults
    a2s: Optional[Sequence[float]] = None   # SE bandwidth grid; None -> default
    # GLGP options (src/Fit.cpp:361-512)
    gl_sparse: bool = False
    gl_threshold: float = 0.01
    # "dense": materialize + eigh (reference semantics); "lobpcg": implicit
    # ELL operator + blocked LOBPCG — the large-n path (requires gl_sparse)
    gl_solver: str = "dense"
    gl_lobpcg_iters: int = 80
    # prediction
    n_gibbs: int = 100                 # PG Gibbs sweeps (src/PGLogitModel.cpp:48-53)
    # Rao-Blackwellized prediction: average the collapsed predictor over the
    # last `gibbs_avg_sweeps` ω states instead of the reference's final-state-
    # only estimate (one-sample noise: measured ±0.01 torus error).  0 =
    # exact reference semantics.
    gibbs_avg_sweeps: int = 50
    output_cov: bool = False
    dtype: jnp.dtype = jnp.float32
    # dtype for the train/predict solve tail (Newton mode-finding, Cholesky,
    # Woodbury, PG Gibbs).  None = same as ``dtype``.  The tail matrices
    # are m×m, so an f64 tail costs little where the graph/spectral stage
    # stays f32.  Requires jax_enable_x64 when set to float64.
    solve_dtype: Optional[jnp.dtype] = None

    def __post_init__(self):
        if self.sigma < 0:
            raise ValueError(f"FitConfig.sigma must be >= 0, got {self.sigma}")
        if self.gl_solver not in ("dense", "lobpcg"):
            raise ValueError(
                f"FitConfig.gl_solver must be 'dense' or 'lobpcg', got {self.gl_solver!r}"
            )
        if self.gl_solver == "lobpcg" and not self.gl_sparse:
            raise ValueError("FitConfig.gl_solver='lobpcg' requires gl_sparse=True")
        if not 0.0 < self.gl_threshold <= 1.0:
            raise ValueError(
                f"FitConfig.gl_threshold must be in (0, 1], got {self.gl_threshold}"
            )
        if self.n_gibbs < 1:
            raise ValueError(f"FitConfig.n_gibbs must be >= 1, got {self.n_gibbs}")
        if not 0 <= self.gibbs_avg_sweeps <= self.n_gibbs:
            raise ValueError(
                "FitConfig.gibbs_avg_sweeps must be in [0, n_gibbs="
                f"{self.n_gibbs}], got {self.gibbs_avg_sweeps}"
            )


def default_a2s() -> jnp.ndarray:
    """Default SE bandwidth-squared grid: exp(linspace(log .1, log 10, 10))
    (reference: R/Fit.R:128-130)."""
    return jnp.exp(jnp.linspace(jnp.log(0.1), jnp.log(10.0), 10))
