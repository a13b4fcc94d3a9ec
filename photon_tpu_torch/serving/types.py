"""Typed requests, responses, and configuration for online serving.

The port of ``photon_tpu/serving/types.py`` for the first serving slice:
the fallback reasons this engine can produce (same string values, so
responses compare one to one with the JAX engine's), requests,
responses, and the SLO / deadline / breaker / engine configs. The live
swap, two-tier store, int8 and Thompson settings are not carried over.

A request is one sample — per-shard (name, term, value) features plus
the entity ids that select per-entity random-effect models — and a
response is one score plus a *typed* account of every way the engine
degraded it. Degradation is data, not an exception.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Sequence, Tuple


class FallbackReason(str, enum.Enum):
    """Why a score is degraded. String-valued: serializes verbatim into
    JSONL responses, metrics labels, and the RunReport serving section."""

    #: entity id absent from the model vocabulary (cold user/item) —
    #: the coordinate contributes zero, matching the reference's
    #: missing-per-entity-model semantics
    UNKNOWN_ENTITY = "unknown_entity"
    #: admission queue above the shed threshold: random-effect gathers
    #: skipped for the whole batch, fixed-effect-only scores returned
    SLO_SHED_RANDOM_EFFECTS = "slo_shed_random_effects"
    #: admission queue above the reject threshold: request not scored
    SLO_REJECTED = "slo_rejected"
    #: request carried more features than the padded width for a shard;
    #: overflow features dropped (first-N kept, deterministic)
    FEATURE_OVERFLOW = "feature_overflow"
    #: the request's absolute deadline cannot be met — either refused at
    #: admission (budget below the service floor) or expired while queued;
    #: it never occupies a bucket slot it cannot use
    DEADLINE_EXCEEDED = "deadline_exceeded"
    #: the engine is draining (SIGTERM / operator drain): admission
    #: refuses instead of queueing work that may never score
    SHUTTING_DOWN = "shutting_down"
    #: circuit breaker tripped to fixed-effect-only scoring (stage
    #: latency or failure-rate breach; distinct from the SLO shed so
    #: operators can tell load from fault)
    BREAKER_SHED_RANDOM_EFFECTS = "breaker_shed_random_effects"
    #: circuit breaker open: admission refuses outright until the
    #: half-open probe succeeds
    BREAKER_REJECTED = "breaker_rejected"
    #: the scorer raised or produced non-finite scores; the
    #: request gets a typed failure, never a hot-path exception
    SCORER_FAILURE = "scorer_failure"


@dataclasses.dataclass(frozen=True)
class Fallback:
    """One typed degradation event on one request."""

    reason: FallbackReason
    coordinate: Optional[str] = None
    detail: str = ""


@dataclasses.dataclass
class ScoreRequest:
    """One sample to score.

    ``features``: shard id -> sequence of (name, term, value);
    ``entity_ids``: random-effect type -> entity id string.
    """

    uid: str
    features: Dict[str, Sequence[Tuple[str, str, float]]]
    entity_ids: Dict[str, str] = dataclasses.field(default_factory=dict)
    offset: float = 0.0
    #: per-request latency budget in seconds; the engine turns it into an
    #: absolute deadline on its own clock at admission. None falls back
    #: to ``DeadlineConfig.default_timeout_s`` (which may also be None =
    #: no deadline).
    timeout_s: Optional[float] = None


@dataclasses.dataclass
class ScoreResponse:
    """One scored (or shed) request. ``score`` is None only for
    SLO_REJECTED; every other degradation still returns a usable score."""

    uid: str
    score: Optional[float]
    degraded: bool = False
    fallbacks: Tuple[Fallback, ...] = ()


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Load-shedding thresholds on admission-queue depth.

    Depth is the one signal that is both instantaneous and causal for
    tail latency (every queued request ahead of you is latency you will
    inherit), so the degradation ladder keys on it:

      depth <= shed_queue_depth                 full GAME scoring
      shed_queue_depth < depth <= reject_depth  fixed-effect-only batches
      depth > reject_queue_depth                typed rejection at admission
    """

    shed_queue_depth: int = 512
    reject_queue_depth: int = 4096

    def __post_init__(self):
        if self.shed_queue_depth < 1:
            raise ValueError("shed_queue_depth must be >= 1")
        if self.reject_queue_depth < self.shed_queue_depth:
            raise ValueError("reject_queue_depth < shed_queue_depth")


@dataclasses.dataclass(frozen=True)
class DeadlineConfig:
    """Per-request deadline propagation: admission -> queue -> scoring.

    A request's absolute deadline is ``admission_time + timeout``; the
    per-stage budgets below decide where along the pipeline it is refused
    rather than scored late:

      admission  budget < min_service_s          DEADLINE_EXCEEDED now
      queue      now > deadline - score_headroom DEADLINE_EXCEEDED at pop
      release    a batch ships early enough that its tightest deadline
                 still has score_headroom_s left (overriding the
                 oldest-waiter coalescing wait)
    """

    #: deadline applied to requests that carry no ``timeout_s`` of their
    #: own; None = such requests never expire
    default_timeout_s: Optional[float] = None
    #: the assemble+score floor: a request whose whole budget is below
    #: this cannot be served in time no matter what, so admission refuses
    #: it immediately instead of letting it occupy a bucket slot
    min_service_s: float = 0.0
    #: time reserved for assemble+score after a request leaves the queue;
    #: a queued request is expired once ``now > deadline - this``
    score_headroom_s: float = 0.0

    def __post_init__(self):
        if self.min_service_s < 0 or self.score_headroom_s < 0:
            raise ValueError("deadline budgets must be >= 0")
        if self.default_timeout_s is not None and self.default_timeout_s <= 0:
            raise ValueError("default_timeout_s must be positive")


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Sliding-window circuit breaker over the scorer stage.

    State ladder: ``closed`` (full scoring) -> ``shed`` (fixed-effect
    only) -> ``open`` (reject at admission) -> ``half_open`` (bounded
    full-effort probes after ``cooldown_s``) -> ``closed`` again when the
    probes come back healthy. A breach is either the window's p99 scorer
    latency above ``latency_p99_s`` or its failure rate above
    ``failure_rate``, evaluated once ``min_samples`` observations exist.
    """

    #: number of most-recent scorer-stage observations kept
    window: int = 256
    #: observations required before the breaker may trip (a single slow
    #: batch on a cold window must not flap the state)
    min_samples: int = 16
    #: p99 scorer-stage latency threshold; inf disables the latency trip
    latency_p99_s: float = float("inf")
    #: scorer failure-rate threshold (exceptions / non-finite scores)
    failure_rate: float = 0.5
    #: time spent open before half-open probing starts
    cooldown_s: float = 1.0
    #: healthy full-effort probe batches required to close again
    probe_batches: int = 2

    def __post_init__(self):
        if self.window < 1 or self.min_samples < 1 or self.probe_batches < 1:
            raise ValueError("breaker window/min_samples/probe_batches >= 1")
        if not 0.0 < self.failure_rate <= 1.0:
            raise ValueError("failure_rate must be in (0, 1]")
        if self.cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Engine knobs. Every shape-bearing value here decides which
    (mode, bucket) shapes warmup dispatches, so the config is frozen."""

    #: top of the power-of-two bucket ladder (rounded up to a power of 2)
    max_batch: int = 64
    #: smallest bucket (1 keeps single-request latency honest)
    min_bucket: int = 1
    #: coalescing window: a batch forms when the ladder top fills OR the
    #: oldest queued request has waited this long
    max_wait_s: float = 0.002
    #: per-shard padded feature width; None = smallest power of two
    #: covering the shard dimension, capped at 256
    feature_pad: Optional[int] = None
    slo: SLOConfig = dataclasses.field(default_factory=SLOConfig)
    deadline: DeadlineConfig = dataclasses.field(default_factory=DeadlineConfig)
    breaker: BreakerConfig = dataclasses.field(default_factory=BreakerConfig)
    #: graceful drain: after ``begin_drain`` the engine keeps flushing
    #: in-flight micro-batches for at most this long; whatever is still
    #: queued past the budget gets a typed SHUTTING_DOWN refusal
    drain_budget_s: float = 5.0
