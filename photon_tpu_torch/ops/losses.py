"""Pointwise GLM losses.

The port of ``photon_tpu/ops/losses.py`` (reference: photon-lib
function/glm/PointwiseLossFunction.scala:36). Given a per-sample margin
``z = theta . x + offset`` and a label, each loss gives

  * ``loss_and_dz(z, y) -> (l(z, y), dl/dz)``
  * ``d2z(z, y)        -> d2l/dz2``

Labels follow the reference conventions: ``{0, 1}`` for logistic
regression, non-negative counts for Poisson, reals for squared loss, and
``{0, 1}`` (mapped internally to ``{-1, +1}``) for the Rennie smoothed
hinge (reference: function/svm/SmoothedHingeLossFunction.scala:26-60).

``kernel_id`` names the loss inside the fused value+gradient kernels
(``csrc/fused_value_grad.cu``), whose ``switch`` computes the same four
functions in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

Tensor = torch.Tensor


def log1p_exp(x: Tensor) -> Tensor:
    """Numerically stable log(1 + exp(x)) — ``logaddexp(0, x)``
    (reference: util/MathUtils log1pExp)."""
    return torch.logaddexp(torch.zeros_like(x), x)


@dataclasses.dataclass(frozen=True)
class PointwiseLoss:
    """A pointwise GLM loss: everything the aggregators need.

    ``has_hessian`` mirrors the reference's split between ``DiffFunction``
    (smoothed hinge is first-order only) and ``TwiceDiffFunction``."""

    name: str
    loss_and_dz: Callable[[Tensor, Tensor], Tuple[Tensor, Tensor]]
    d2z: Callable[[Tensor, Tensor], Tensor]
    # inverse link: margin -> mean prediction
    mean: Callable[[Tensor], Tensor]
    kernel_id: int
    has_hessian: bool = True

    def value(self, z: Tensor, y: Tensor) -> Tensor:
        return self.loss_and_dz(z, y)[0]


# Logistic (reference: function/glm/LogisticLossFunction.scala:45)
#   l = log(1 + e^z) - y z,  dl/dz = sigmoid(z) - y,  d2l/dz2 = s (1 - s)

def _logistic_loss_and_dz(z: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    return log1p_exp(z) - y * z, torch.sigmoid(z) - y


def _logistic_d2z(z: Tensor, y: Tensor) -> Tensor:
    s = torch.sigmoid(z)
    return s * (1.0 - s)


LogisticLoss = PointwiseLoss("logistic", _logistic_loss_and_dz,
                             _logistic_d2z, torch.sigmoid, kernel_id=0)


# Squared (reference: function/glm/SquaredLossFunction.scala:32)
#   l = (z - y)^2 / 2

def _squared_loss_and_dz(z: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    r = z - y
    return 0.5 * r * r, r


def _squared_d2z(z: Tensor, y: Tensor) -> Tensor:
    return torch.ones_like(z)


SquaredLoss = PointwiseLoss("squared", _squared_loss_and_dz, _squared_d2z,
                            lambda z: z, kernel_id=1)


# Poisson (reference: function/glm/PoissonLossFunction.scala:31)
#   l = e^z - y z

def _poisson_loss_and_dz(z: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    ez = torch.exp(z)
    return ez - y * z, ez - y


def _poisson_d2z(z: Tensor, y: Tensor) -> Tensor:
    return torch.exp(z)


PoissonLoss = PointwiseLoss("poisson", _poisson_loss_and_dz, _poisson_d2z,
                            torch.exp, kernel_id=2)


# Rennie smoothed hinge (reference: SmoothedHingeLossFunction.scala:26-60).
# With t = (2y - 1) z:
#   l = 1/2 - t (t <= 0),  (1 - t)^2 / 2 (0 < t < 1),  0 (t >= 1)

def _smoothed_hinge_loss_and_dz(z: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    s = 2.0 * y - 1.0
    t = s * z
    zero = torch.zeros_like(t)
    loss = torch.where(t <= 0.0, 0.5 - t,
                       torch.where(t < 1.0, 0.5 * (1.0 - t) ** 2, zero))
    dldt = torch.where(t <= 0.0, -torch.ones_like(t),
                       torch.where(t < 1.0, t - 1.0, zero))
    return loss, s * dldt


def _smoothed_hinge_d2z(z: Tensor, y: Tensor) -> Tensor:
    t = (2.0 * y - 1.0) * z
    return ((t > 0.0) & (t < 1.0)).to(z.dtype)


SmoothedHingeLoss = PointwiseLoss(
    "smoothed_hinge", _smoothed_hinge_loss_and_dz, _smoothed_hinge_d2z,
    lambda z: z, kernel_id=3, has_hessian=False)


def loss_for_task(task) -> PointwiseLoss:
    """TaskType -> PointwiseLoss (reference: ObjectiveFunctionHelper.scala:27)."""
    from photon_tpu_torch.types import TaskType

    return {
        TaskType.LOGISTIC_REGRESSION: LogisticLoss,
        TaskType.LINEAR_REGRESSION: SquaredLoss,
        TaskType.POISSON_REGRESSION: PoissonLoss,
        TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: SmoothedHingeLoss,
    }[task]
