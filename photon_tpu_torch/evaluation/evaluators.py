"""Evaluation metrics: AUC and RMSE, weighted and tie-correct.

The port of part of ``photon_tpu/evaluation/evaluators.py`` (reference:
photon-lib evaluation/EvaluatorType.scala:56-65, photon-api evaluation/
AreaUnderROCCurveLocalEvaluator.scala:33 — Mann-Whitney with ties).
Scores, labels and weights are [n] tensors on any device; zero-weight
rows count for nothing. The other metrics come with their slices.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch

Tensor = torch.Tensor


class EvaluatorType(enum.Enum):
    AUC = "AUC"
    AUPR = "AUPR"
    RMSE = "RMSE"
    LOGISTIC_LOSS = "LOGISTIC_LOSS"
    POISSON_LOSS = "POISSON_LOSS"
    SMOOTHED_HINGE_LOSS = "SMOOTHED_HINGE_LOSS"
    SQUARED_LOSS = "SQUARED_LOSS"


def _weights(scores: Tensor, weights: Optional[Tensor]) -> Tensor:
    return torch.ones_like(scores) if weights is None else weights


def auc(scores: Tensor, labels: Tensor,
        weights: Optional[Tensor] = None) -> Tensor:
    """Weighted, tie-corrected area under the ROC curve (Mann-Whitney):
    AUC = sum_{pos i} w_i (W_neg<s_i + W_neg=s_i / 2) / (W_pos W_neg)."""
    w = _weights(scores, weights)
    order = torch.argsort(scores, stable=True)
    s = scores[order].contiguous()
    y = labels[order] > 0.5
    ww = w[order]
    zero = torch.zeros((), dtype=ww.dtype, device=ww.device)
    neg_w = torch.where(y, zero, ww)
    cum_neg = torch.cumsum(neg_w, dim=0)
    # tie groups: the first and one-past-last position of each score
    first = torch.searchsorted(s, s, side="left")
    last = torch.searchsorted(s, s, side="right")
    below = torch.where(first > 0, cum_neg[(first - 1).clamp(min=0)], zero)
    eq = cum_neg[last - 1] - below
    pos_w = torch.where(y, ww, zero)
    num = (pos_w * (below + 0.5 * eq)).sum()
    denom = pos_w.sum() * neg_w.sum()
    return num / denom.clamp(min=torch.finfo(scores.dtype).tiny)


def rmse(scores: Tensor, labels: Tensor,
         weights: Optional[Tensor] = None) -> Tensor:
    w = _weights(scores, weights)
    se = w * (scores - labels) ** 2
    return torch.sqrt(se.sum() / w.sum().clamp(min=1e-30))


def default_evaluator_for_task(task) -> EvaluatorType:
    """Reference: the per-task primary metric used for model selection."""
    from photon_tpu_torch.types import TaskType

    return {
        TaskType.LOGISTIC_REGRESSION: EvaluatorType.AUC,
        TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: EvaluatorType.AUC,
        TaskType.LINEAR_REGRESSION: EvaluatorType.RMSE,
        TaskType.POISSON_REGRESSION: EvaluatorType.POISSON_LOSS,
    }[task]
