"""Core type aliases and task enums.

The port's copy of ``photon_tpu/types.py``: the same enum names and
string values, so a model written by either package names its task
identically (reference: photon-lib .../Types.scala:21-44,
TaskType.scala:24).
"""

from __future__ import annotations

import enum

# Reference: UniqueSampleId = Long, CoordinateId = String, REId = String.
# In this build, sample / entity identity is positional: every sample has a
# dense row index in the device-resident arrays, and entities have dense block
# indices assigned at ingest. The string identities survive only on the host
# side (ingest tables, model IO).
UniqueSampleId = int
CoordinateId = str
REId = str
REType = str
FeatureShardId = str


class TaskType(enum.Enum):
    """Supported GLM training tasks (reference: TaskType.scala:24)."""

    LINEAR_REGRESSION = "LINEAR_REGRESSION"
    POISSON_REGRESSION = "POISSON_REGRESSION"
    LOGISTIC_REGRESSION = "LOGISTIC_REGRESSION"
    SMOOTHED_HINGE_LOSS_LINEAR_SVM = "SMOOTHED_HINGE_LOSS_LINEAR_SVM"

    @property
    def is_classification(self) -> bool:
        return self in (
            TaskType.LOGISTIC_REGRESSION,
            TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM,
        )


class VarianceComputationType(enum.Enum):
    """Coefficient-variance computation mode
    (reference: optimization/VarianceComputationType.scala:20)."""

    NONE = "NONE"
    SIMPLE = "SIMPLE"  # 1 / diag(H)
    FULL = "FULL"      # diag(H^-1) via Cholesky


class OptimizerType(enum.Enum):
    """Available convex solvers (reference: OptimizerType.scala)."""

    LBFGS = "LBFGS"
    OWLQN = "OWLQN"
    LBFGSB = "LBFGSB"
    TRON = "TRON"
    # TPU-native extension (no reference analog): exact normal-equations
    # solve for squared loss — one weighted-Gram contraction (MXU) plus a
    # Cholesky factorization, batched over entities under vmap. The same
    # minimizer the iterative solvers converge to, computed directly
    # (sklearn Ridge's own cholesky solver is the CPU-world equivalent).
    DIRECT = "DIRECT"
    # TPU-native extension: chunk-local stochastic dual coordinate ascent
    # over the streaming chunk store (optim/sdca.py) — one storage pass
    # per outer epoch with a duality-gap stopping certificate, for fits
    # whose data lives on disk (Snap ML / TPA-SCD, see PAPERS.md).
    SDCA = "SDCA"
    # TPU-native extension (no reference analog): damped Newton / IRLS
    # with an explicit Hessian Cholesky per outer iteration — DIRECT's
    # batched [E, K, K] machinery extended to logistic/Poisson, replacing
    # TRON's nested outer x CG sequential loop with ~5 batched
    # factorizations (optim/newton.py).
    NEWTON = "NEWTON"
