"""Online GLMix serving: micro-batching, SLO ladder, breaker, scorer.

The port of ``photon_tpu.serving`` for full-resident models on one
device. Usage::

    engine = ServingEngine.from_model_dir(model_dir, ServingConfig())
    engine.warmup()
    responses = engine.serve(requests)
"""

from photon_tpu_torch.serving.engine import ServingEngine
from photon_tpu_torch.serving.model_state import DeviceResidentModel
from photon_tpu_torch.serving.scorer import MODES
from photon_tpu_torch.serving.types import (
    BreakerConfig,
    DeadlineConfig,
    Fallback,
    FallbackReason,
    ScoreRequest,
    ScoreResponse,
    ServingConfig,
    SLOConfig,
)

__all__ = [
    "BreakerConfig", "DeadlineConfig", "DeviceResidentModel", "Fallback",
    "FallbackReason", "MODES", "ScoreRequest", "ScoreResponse",
    "ServingConfig", "ServingEngine", "SLOConfig",
]
