"""Optimization problems: config + objective + solver.

The port of ``photon_tpu/optim/problem.py`` for the fixed-effect GLM fit
(reference: photon-api optimization/GeneralizedLinearOptimizationProblem
.scala, DistributedOptimizationProblem.scala:46 run :177,
OptimizerConfig.scala:28, CoordinateOptimizationConfiguration.scala:30,48).

``GlmOptimizationProblem.run`` solves with L-BFGS or NEWTON. Every
evaluation of the objective goes through ``ops/aggregators
.value_and_gradient``, which picks the fused kernel (K1 dense, K2 ELL) or
the two-pass path by the batch's structure. The other optimizer types
(TRON, OWL-QN, L-BFGS-B, DIRECT, SDCA) are not yet ported and raise
``ValueError``. PyTorch runs eagerly, so there is no compiled-solve cache.

Model space: the solver runs in transformed (normalized) coefficient
space, while every model ``run`` accepts (warm starts) and returns lives
in ORIGINAL feature space, converted at this boundary by the
margin-invariant maps (reference: NormalizationContext.scala:80-126).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from photon_tpu_torch.data.dataset import DataBatch
from photon_tpu_torch.device import DeviceLike, resolve_device
from photon_tpu_torch.function.objective import (
    GLMObjective,
    Hyper,
    NoRegularization,
    RegularizationContext,
)
from photon_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_tpu_torch.ops.losses import loss_for_task
from photon_tpu_torch.ops.normalization import (NormalizationContext,
                                                no_normalization)
from photon_tpu_torch.optim import lbfgs, newton
from photon_tpu_torch.optim.base import SolverConfig, SolverResult
from photon_tpu_torch.types import OptimizerType, TaskType

Tensor = torch.Tensor

#: optimizer types this package solves today
PORTED_OPTIMIZERS = (OptimizerType.LBFGS, OptimizerType.NEWTON)


def _validate_newton(task, opt: "OptimizerConfig", regularization) -> None:
    """NEWTON needs second derivatives and a smooth objective."""
    if not loss_for_task(task).has_hessian:
        raise ValueError(
            f"OptimizerType.NEWTON needs a twice-differentiable loss; "
            f"{task} has no Hessian — use LBFGS")
    if opt.lower_bounds is not None or opt.upper_bounds is not None:
        raise ValueError("NEWTON does not support box constraints; "
                         "use LBFGSB")
    if regularization.l1_weight(1.0) != 0.0:
        raise ValueError("NEWTON needs a smooth objective; L1/elastic-net "
                         "needs OWLQN")


def check_ported(optimizer_type: OptimizerType) -> None:
    if optimizer_type not in PORTED_OPTIMIZERS:
        raise ValueError(
            f"OptimizerType.{optimizer_type.name} is not yet ported to "
            f"photon_tpu_torch (ported: "
            f"{', '.join(t.name for t in PORTED_OPTIMIZERS)})")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Reference: OptimizerConfig.scala:28 (+ per-solver defaults)."""

    optimizer_type: OptimizerType = OptimizerType.LBFGS
    max_iterations: int = 100
    tolerance: float = 1e-7
    num_corrections: int = 10
    lower_bounds: Optional[Tensor] = None
    upper_bounds: Optional[Tensor] = None
    track_states: int = 0
    # NEWTON builds an explicit [d, d] Hessian; above d=8192 it refuses
    # unless this is True
    explicit_hessian: Optional[bool] = None

    def solver_config(self) -> SolverConfig:
        return SolverConfig(
            max_iterations=self.max_iterations,
            tolerance=self.tolerance,
            num_corrections=self.num_corrections,
            lower_bounds=self.lower_bounds,
            upper_bounds=self.upper_bounds,
            track_states=self.track_states,
        )


@dataclasses.dataclass(frozen=True)
class GLMOptimizationConfiguration:
    """Per-coordinate optimization config (reference:
    CoordinateOptimizationConfiguration.scala:30,48)."""

    optimizer: OptimizerConfig = OptimizerConfig()
    regularization: RegularizationContext = NoRegularization
    regularization_weight: float = 0.0


class GlmOptimizationProblem:
    """Task + config + normalization -> a GLM solve on one device."""

    def __init__(self, task: TaskType,
                 config: GLMOptimizationConfiguration =
                 GLMOptimizationConfiguration(),
                 norm: NormalizationContext = no_normalization(),
                 intercept_index: Optional[int] = None):
        if norm.shifts is not None and intercept_index is None:
            # a shift moves margins by a constant; only an intercept can
            # absorb it
            raise ValueError(
                "normalization with shifts (STANDARDIZATION) requires an "
                "intercept feature; pass intercept_index")
        opt = config.optimizer
        check_ported(opt.optimizer_type)
        if opt.optimizer_type == OptimizerType.NEWTON:
            _validate_newton(task, opt, config.regularization)
        self.task = task
        self.config = config
        self.intercept_index = intercept_index
        self.objective = GLMObjective(loss_for_task(task), norm)

    def _solve(self, obj: GLMObjective, x0: Tensor, batch: DataBatch,
               hyper: Hyper) -> SolverResult:
        opt = self.config.optimizer
        cfg = opt.solver_config()
        vg = lambda c: obj.value_and_gradient(c, batch, hyper)
        if opt.optimizer_type == OptimizerType.NEWTON:
            dim = x0.shape[0]
            if opt.explicit_hessian is not True and dim > 8192:
                raise ValueError(
                    f"NEWTON builds an explicit [{dim}, {dim}] Hessian; "
                    f"TRON (matrix-free) is the solver above d=8192, or "
                    f"set explicit_hessian=True to override")
            hm = lambda c: obj.hessian_matrix_from_weights(
                obj.hessian_weights(c, batch), dim, batch, hyper)
            return newton.minimize(vg, hm, x0, config=cfg)
        return lbfgs.minimize(vg, x0, config=cfg)

    def run(self, batch: DataBatch, initial=None, dim: Optional[int] = None,
            dtype: Optional[torch.dtype] = None,
            regularization_weight: Optional[float] = None,
            device: DeviceLike = None
            ) -> Tuple[GeneralizedLinearModel, SolverResult]:
        """Solve on ``device`` (None: the card; raises without one) and
        return (model in original space, solver stats). The batch and a
        warm start are moved there first. ``dtype`` defaults to the
        labels' type: an f32 solve over f32/bf16 features takes the fused
        kernels, an f64 solve the two-pass path."""
        dev = resolve_device(device)
        batch = batch.to(dev)
        norm = self.objective.norm
        if dtype is None:
            dtype = batch.labels.dtype
        objective = self.objective
        if not norm.is_identity:
            norm = norm.to(dev, dtype)
            objective = GLMObjective(objective.loss, norm)
        if initial is None:
            if dim is None:
                raise ValueError("need dim when no initial coefficients")
            x0 = torch.zeros(dim, dtype=dtype, device=dev)
        else:
            x0 = torch.as_tensor(initial).to(device=dev, dtype=dtype)
            if not norm.is_identity:
                # warm starts arrive in original space
                x0 = norm.model_to_transformed_space(x0,
                                                     self.intercept_index)
        lam = (self.config.regularization_weight
               if regularization_weight is None else regularization_weight)
        hyper = Hyper.of(self.config.regularization.l2_weight(lam))
        result = self._solve(objective, x0, batch, hyper)
        coef = result.coef
        if not norm.is_identity:
            coef = norm.transformed_space_to_model(coef, self.intercept_index)
        return (GeneralizedLinearModel(Coefficients(coef), self.task),
                result)
