"""Plain-GLM training over a regularization path with warm starts.

The port of ``photon_tpu/estimators/model_training.py`` (reference:
photon-api ModelTraining.trainGeneralizedLinearModel, ModelTraining
.scala:34,73-108; warm-start chain :134-147) — the engine behind the
reference's legacy lambda sweep. Each lambda is one
``GlmOptimizationProblem.run``; warm starting feeds the previous
lambda's original-space coefficients in as the next start.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from photon_tpu_torch.data.dataset import DataBatch
from photon_tpu_torch.device import DeviceLike, resolve_device
from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.ops.normalization import (NormalizationContext,
                                                no_normalization)
from photon_tpu_torch.optim.base import SolverResult
from photon_tpu_torch.optim.problem import (GLMOptimizationConfiguration,
                                            GlmOptimizationProblem)
from photon_tpu_torch.types import TaskType


def train_generalized_linear_model(
    task: TaskType,
    batch: DataBatch,
    dim: int,
    config: GLMOptimizationConfiguration = GLMOptimizationConfiguration(),
    regularization_weights: Sequence[float] = (0.0,),
    norm: NormalizationContext = no_normalization(),
    warm_start: bool = True,
    initial=None,
    dtype: torch.dtype = torch.float32,
    intercept_index: Optional[int] = None,
    device: DeviceLike = None,
) -> Tuple[Dict[float, GeneralizedLinearModel], Dict[float, SolverResult]]:
    """Train one GLM per regularization weight on ``device`` (None: the
    card; raises without one), warm-starting along the path in the
    caller's order. Returns ({lambda: model}, {lambda: solver stats}).
    Optimizer types not yet ported (DIRECT among them) raise
    ``ValueError``."""
    dev = resolve_device(device)
    problem = GlmOptimizationProblem(task, config, norm,
                                     intercept_index=intercept_index)
    batch = batch.to(dev)
    models: Dict[float, GeneralizedLinearModel] = {}
    stats: Dict[float, SolverResult] = {}
    coef = initial
    for lam in regularization_weights:
        model, result = problem.run(batch, initial=coef, dim=dim,
                                    dtype=dtype, regularization_weight=lam,
                                    device=dev)
        models[lam] = model
        stats[lam] = result
        if warm_start:
            coef = model.coefficients.means
    return models, stats
