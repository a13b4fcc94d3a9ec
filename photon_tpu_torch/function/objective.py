"""Objective functions: the optimizer <-> model contract.

The port of ``photon_tpu/function/objective.py`` (reference:
function/ObjectiveFunction.scala:25, DiffFunction.scala:25,
TwiceDiffFunction.scala:25, the L2Regularization mixins
(function/L2Regularization.scala:26,77,140), and the GLM loss functions
that delegate to the four aggregators).

An objective is a bundle of functions over ``(coef, batch, hyper)``;
``hyper`` carries the L2 weight, so a regularization path reuses one
objective. The streamed and directional (margin-resident) methods of the
JAX package come with their slices.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple, Optional, Tuple

import torch

from photon_tpu_torch.data.dataset import DataBatch
from photon_tpu_torch.ops import aggregators
from photon_tpu_torch.ops.losses import PointwiseLoss
from photon_tpu_torch.ops.normalization import (NormalizationContext,
                                                no_normalization)

Tensor = torch.Tensor


class RegularizationType(enum.Enum):
    """Reference: optimization/RegularizationContext.scala:38."""

    NONE = "NONE"
    L1 = "L1"
    L2 = "L2"
    ELASTIC_NET = "ELASTIC_NET"


@dataclasses.dataclass(frozen=True)
class RegularizationContext:
    """Splits a total regularization weight into L1/L2 parts (reference:
    RegularizationContext.scala:115-130; l1 = alpha * lambda,
    l2 = (1 - alpha) * lambda for the elastic net)."""

    reg_type: RegularizationType = RegularizationType.NONE
    elastic_net_alpha: Optional[float] = None

    def l1_weight(self, reg_weight: float) -> float:
        if self.reg_type == RegularizationType.L1:
            return reg_weight
        if self.reg_type == RegularizationType.ELASTIC_NET:
            return (self.elastic_net_alpha or 0.0) * reg_weight
        return 0.0

    def l2_weight(self, reg_weight: float) -> float:
        if self.reg_type == RegularizationType.L2:
            return reg_weight
        if self.reg_type == RegularizationType.ELASTIC_NET:
            return (1.0 - (self.elastic_net_alpha or 0.0)) * reg_weight
        return 0.0


NoRegularization = RegularizationContext(RegularizationType.NONE)
L1Regularization = RegularizationContext(RegularizationType.L1)
L2Regularization = RegularizationContext(RegularizationType.L2)


class Hyper(NamedTuple):
    """Objective hyperparameters: the L2 weight, a Python float."""

    l2_weight: float

    @staticmethod
    def of(l2_weight: float = 0.0) -> "Hyper":
        return Hyper(l2_weight=float(l2_weight))


@dataclasses.dataclass(frozen=True)
class GLMObjective:
    """GLM loss with L2 folded in (L1 is the solver's job, as in the
    reference). ``coef`` lives in transformed (normalized) space; ``norm``
    folds the affine feature map into the kernels."""

    loss: PointwiseLoss
    norm: NormalizationContext = no_normalization()

    def _args(self, batch: DataBatch):
        return (batch.features, batch.labels, batch.offsets, batch.weights)

    def value(self, coef: Tensor, batch: DataBatch, hyper: Hyper) -> Tensor:
        return self.value_and_gradient(coef, batch, hyper)[0]

    def value_and_gradient(self, coef: Tensor, batch: DataBatch,
                           hyper: Hyper) -> Tuple[Tensor, Tensor]:
        v, g = aggregators.value_and_gradient(
            self.loss, *self._args(batch), coef, self.norm)
        # L2 mixin (reference: L2Regularization.scala:26,77) — the full
        # vector, intercept included
        v = v + 0.5 * hyper.l2_weight * torch.dot(coef, coef)
        g = g + hyper.l2_weight * coef
        return v, g

    def hessian_vector(self, coef: Tensor, vector: Tensor, batch: DataBatch,
                       hyper: Hyper) -> Tensor:
        hv = aggregators.hessian_vector(self.loss, *self._args(batch), coef,
                                        vector, self.norm)
        return hv + hyper.l2_weight * vector

    def hessian_weights(self, coef: Tensor, batch: DataBatch) -> Tensor:
        """Per-sample curvature weights, constant over one Hessian build."""
        return aggregators.hessian_weights(self.loss, *self._args(batch),
                                           coef, self.norm)

    def hessian_vector_from_weights(self, d2: Tensor, vector: Tensor,
                                    batch: DataBatch, hyper: Hyper) -> Tensor:
        hv = aggregators.hessian_vector_from_weights(
            batch.features, d2, vector, self.norm, vector.shape[0])
        return hv + hyper.l2_weight * vector

    def hessian_matrix_from_weights(self, d2: Tensor, dim: int,
                                    batch: DataBatch,
                                    hyper: Hyper) -> Tensor:
        h = aggregators.hessian_matrix_from_weights(batch.features, d2,
                                                    self.norm, dim)
        return h + hyper.l2_weight * torch.eye(dim, dtype=h.dtype,
                                               device=h.device)

    def hessian_diagonal(self, coef: Tensor, batch: DataBatch,
                         hyper: Hyper) -> Tensor:
        d = aggregators.hessian_diagonal(self.loss, *self._args(batch),
                                         coef, self.norm)
        return d + hyper.l2_weight

    def hessian_matrix(self, coef: Tensor, batch: DataBatch,
                       hyper: Hyper) -> Tensor:
        h = aggregators.hessian_matrix(self.loss, *self._args(batch), coef,
                                       self.norm)
        return h + hyper.l2_weight * torch.eye(coef.shape[0], dtype=h.dtype,
                                               device=h.device)
