"""GAME model containers: fixed-effect and random-effect models.

The port of ``photon_tpu/game/model.py``. Reference: photon-api
model/FixedEffectModel.scala:32, model/RandomEffectModel.scala:36,
photon-lib model/GameModel.scala:32.

A random-effect model is ONE dense [E, K] coefficient block in
per-entity projected feature space; entities are dense integer rows and
the string REIds live in a host-side vocabulary (game/dataset.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from photon_tpu_torch.models.glm import GeneralizedLinearModel
from photon_tpu_torch.types import TaskType


@dataclasses.dataclass(frozen=True)
class FixedEffectModel:
    """GLM + feature shard id (reference: FixedEffectModel.scala:32)."""

    model: GeneralizedLinearModel
    feature_shard_id: str

    @property
    def task(self) -> TaskType:
        return self.model.task


@dataclasses.dataclass(frozen=True)
class RandomEffectModel:
    """Per-entity coefficient block in projected space.

    ``coefficients``: [E, K] — row e is entity e's model over its projected
    (local) feature slots; ``variances`` optional [E, K].
    """

    coefficients: torch.Tensor
    random_effect_type: str
    feature_shard_id: str
    task: TaskType
    variances: Optional[torch.Tensor] = None

    @property
    def num_entities(self) -> int:
        return self.coefficients.shape[0]

    @property
    def projected_dim(self) -> int:
        return self.coefficients.shape[1]


@dataclasses.dataclass(frozen=True)
class GameModel:
    """Map coordinate-id -> model, with task consistency
    (reference: GameModel.scala:32,161)."""

    models: Dict[str, object]  # FixedEffectModel | RandomEffectModel

    def __post_init__(self):
        tasks = {m.task for m in self.models.values()}
        if len(tasks) > 1:
            raise ValueError(f"inconsistent task types in GAME model: {tasks}")

    def __getitem__(self, coordinate_id: str):
        return self.models[coordinate_id]

    def __contains__(self, coordinate_id: str) -> bool:
        return coordinate_id in self.models

    @property
    def coordinate_ids(self):
        return list(self.models.keys())

    @property
    def task(self) -> TaskType:
        return next(iter(self.models.values())).task
