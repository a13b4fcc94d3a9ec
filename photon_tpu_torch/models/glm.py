"""Supervised GLM model containers.

The port of ``photon_tpu/models/glm.py``. Reference: photon-api
supervised/model/GeneralizedLinearModel.scala:12-27 (computeScore =
theta.x, computeMean via link), photon-lib model/Coefficients.scala:31
(means + optional variances).

One container parameterized by TaskType replaces the subclass-per-task
hierarchy. Coefficients are torch tensors; scoring takes a dense
``[n, d]`` feature tensor on the coefficients' device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from photon_tpu_torch.types import TaskType


def inverse_link(task: TaskType, z: torch.Tensor) -> torch.Tensor:
    """Margin -> mean response: sigmoid (logistic), exp (Poisson),
    identity (linear regression, smoothed-hinge SVM) — the ``mean`` of
    each task's loss in ``photon_tpu/ops/losses.py``."""
    if task == TaskType.LOGISTIC_REGRESSION:
        return torch.sigmoid(z)
    if task == TaskType.POISSON_REGRESSION:
        return torch.exp(z)
    return z


class Coefficients(NamedTuple):
    """means + optional variances (reference: Coefficients.scala:31)."""

    means: torch.Tensor                       # [d]
    variances: Optional[torch.Tensor] = None  # [d]

    @property
    def dim(self) -> int:
        return self.means.shape[0]

    def compute_score(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.means

    @staticmethod
    def zeros(dim: int, dtype=torch.float32,
              device: Optional[torch.device] = None) -> "Coefficients":
        return Coefficients(means=torch.zeros(dim, dtype=dtype,
                                              device=device))


class GeneralizedLinearModel(NamedTuple):
    """A trained GLM: coefficients + task (link)."""

    coefficients: Coefficients
    task: TaskType

    @property
    def dim(self) -> int:
        return self.coefficients.dim

    def compute_score(self, x: torch.Tensor,
                      offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Raw margin theta.x (+ offset) — what GAME score algebra sums."""
        s = self.coefficients.compute_score(x)
        return s if offsets is None else s + offsets

    def compute_mean(self, x: torch.Tensor,
                     offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mean response via the inverse link."""
        return inverse_link(self.task, self.compute_score(x, offsets))

    def predict_class(self, x: torch.Tensor, threshold: float = 0.5,
                      offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Binary prediction (reference: BinaryClassifier threshold)."""
        if not self.task.is_classification:
            raise ValueError(f"{self.task} is not a classification task")
        return (self.compute_mean(x, offsets) >= threshold).to(torch.int32)


def glm_from_arrays(means, task, variances=None) -> GeneralizedLinearModel:
    """A GLM from plain arrays (numpy, lists or tensors; CPU tensors
    result) — the way one coefficient vector crosses from a JAX fit into
    the port, e.g. as a warm start for ``GlmOptimizationProblem.run``."""
    task = task if isinstance(task, TaskType) else TaskType(task)
    as_t = lambda a: (a.detach().cpu().clone() if isinstance(a, torch.Tensor)
                      else torch.as_tensor(np.array(a)))
    return GeneralizedLinearModel(
        Coefficients(as_t(means),
                     None if variances is None else as_t(variances)),
        task)
