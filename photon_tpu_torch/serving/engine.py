"""The serving engine: admission, SLO ladder, dispatch, telemetry.

The port of ``photon_tpu/serving/engine.py``. Request lifecycle::

    submit() ── draining? ──────────> typed SHUTTING_DOWN response
        │  ── breaker open? ────────> typed BREAKER_REJECTED response
        │  ── deadline infeasible? ─> typed DEADLINE_EXCEEDED response
        │  ── depth > reject? ──────> typed SLO_REJECTED response
        ▼ queue (MicroBatcher, deadline-aware release)
    pump() ── batch ready? ──> expire overdue ──> typed DEADLINE_EXCEEDED
        │                          │ survivors: assemble (host pack, pad)
        ▼                          ▼ depth > shed / breaker shed? fixed_only
    responses <── unpad <── scorer (one staged copy in, one kernel
                                │   launch, one copy out per batch)
                                └ stage latency + ok ──> circuit breaker

Everything observable lands in the port's metrics registry under the
``serving.*`` namespace; ``stats()`` folds the registry snapshot plus the
kernel-library build accounting into one dict. The steady-state promise
of the JAX engine (zero compiles after warmup) becomes: ``warmup()``
builds or loads the kernel library and dispatches every (mode, bucket)
once, and no library build or load happens after it.

Live model swap, rollback, the chaos hooks and the windowed time series
are not carried over yet.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from photon_tpu_torch.device import DeviceLike
from photon_tpu_torch.obs.metrics import registry as _metrics
from photon_tpu_torch.ops import cuda_build
from photon_tpu_torch.serving.batching import (
    BucketLadder,
    MicroBatcher,
    Pending,
    QueueClosedError,
)
from photon_tpu_torch.serving.breaker import (
    OPEN,
    SHED,
    STATE_LEVELS,
    CircuitBreaker,
)
from photon_tpu_torch.serving.model_state import DeviceResidentModel
from photon_tpu_torch.serving.scorer import MODES, dispatch, warmup_scorers
from photon_tpu_torch.serving.types import (
    Fallback,
    FallbackReason,
    ScoreRequest,
    ScoreResponse,
    ServingConfig,
)

logger = logging.getLogger(__name__)

# serving latencies live well under the registry's default buckets;
# ~1.3x geometric steps from 50us to ~5s keep the interpolated
# p50/p95/p99 honest at sub-millisecond scale
LATENCY_BUCKETS = tuple(50e-6 * 1.3 ** i for i in range(36))


def _library_events() -> int:
    """Kernel-library builds plus loads so far in this process."""
    return cuda_build.builds + cuda_build.loads


class ServingEngine:
    """Online scorer over a device-resident GAME model."""

    def __init__(self, model: DeviceResidentModel,
                 config: Optional[ServingConfig] = None,
                 clock=None):
        self.model = model
        self.config = config or ServingConfig()
        self.ladder = BucketLadder(self.config.max_batch,
                                   self.config.min_bucket)
        self.batcher = MicroBatcher(
            self.ladder, self.config.max_wait_s, clock=clock,
            deadline_headroom_s=self.config.deadline.score_headroom_s)
        self.clock = self.batcher.clock
        self.breaker = CircuitBreaker(self.config.breaker, clock=self.clock,
                                      on_transition=self._on_breaker)
        self._warmed = False
        self._warmup_seconds = 0.0
        self._warmup_programs = 0
        # kernel-library builds+loads: before warmup, in it, and the
        # count when it ended (steady state must add none)
        self._lib_at_start = _library_events()
        self._lib_warmup = 0
        self._lib_after_warmup: Optional[int] = None
        self._draining = False
        self._drain_reason: Optional[str] = None
        self._drain_info: Optional[dict] = None

    @classmethod
    def from_model_dir(cls, model_dir: str,
                       config: Optional[ServingConfig] = None,
                       device: DeviceLike = None, clock=None,
                       coordinates_to_load=None) -> "ServingEngine":
        """Load a saved GAME model dir and stage it on ``device`` (the
        card when None; ``RuntimeError`` when there is no card)."""
        from photon_tpu_torch.device import resolve_device
        from photon_tpu_torch.io.model_io import load_for_serving

        dev = resolve_device(device)
        serving_model = load_for_serving(
            model_dir, coordinates_to_load=coordinates_to_load)
        model = DeviceResidentModel(
            serving_model,
            feature_pad=config.feature_pad if config else None,
            device=dev)
        return cls(model, config=config, clock=clock)

    # -- warmup --------------------------------------------------------------

    def warmup(self) -> dict:
        """Build or load the kernel library and dispatch the whole
        (mode x bucket) ladder. After this returns, steady-state serving
        builds and loads nothing."""
        before = _library_events()
        t0 = time.perf_counter()
        self._warmup_programs = warmup_scorers(self.model,
                                               self.ladder.buckets)
        self._warmup_seconds = time.perf_counter() - t0
        self._lib_after_warmup = _library_events()
        self._lib_warmup += self._lib_after_warmup - before
        self._warmed = True
        _metrics.gauge("serving.warmup_seconds").set(self._warmup_seconds)
        _metrics.gauge("serving.warmup_programs").set(self._warmup_programs)
        return {"programs": self._warmup_programs,
                "buckets": list(self.ladder.buckets),
                "modes": list(MODES),
                "seconds": self._warmup_seconds,
                "kernel_builds": self.kernel_builds()}

    def kernel_builds(self) -> dict:
        """Kernel-library builds+loads by phase: ``warmup`` (inside
        ``warmup()``) and ``steady`` (after it; the promise is 0)."""
        now = _library_events()
        steady = (0 if self._lib_after_warmup is None
                  else now - self._lib_after_warmup)
        return {"warmup": self._lib_warmup, "steady": steady}

    # -- admission -----------------------------------------------------------

    def _refuse(self, request: ScoreRequest, reason: FallbackReason,
                detail: str = "") -> ScoreResponse:
        _metrics.counter("serving.degraded", reason=reason.value).inc()
        return ScoreResponse(
            request.uid, score=None, degraded=True,
            fallbacks=(Fallback(reason, detail=detail),))

    def submit(self, request: ScoreRequest) -> Optional[ScoreResponse]:
        """Admit one request. Returns an immediate typed refusal when the
        engine cannot serve it (draining, breaker open, infeasible
        deadline, queue past the reject threshold), else None (the
        response arrives from a later ``pump``)."""
        _metrics.counter("serving.requests").inc()
        if self._draining:
            return self._refuse(request, FallbackReason.SHUTTING_DOWN,
                                detail=self._drain_reason or "draining")
        if not self.breaker.admit():
            return self._refuse(request, FallbackReason.BREAKER_REJECTED,
                                detail="circuit breaker open")
        now = self.clock()
        timeout = (request.timeout_s if request.timeout_s is not None
                   else self.config.deadline.default_timeout_s)
        deadline = None
        if timeout is not None:
            if timeout < self.config.deadline.min_service_s:
                return self._refuse(
                    request, FallbackReason.DEADLINE_EXCEEDED,
                    detail=f"budget {timeout * 1e3:.1f}ms below service "
                           f"floor "
                           f"{self.config.deadline.min_service_s * 1e3:.1f}ms")
            deadline = now + timeout
        depth = self.batcher.depth()
        if depth >= self.config.slo.reject_queue_depth:
            return self._refuse(request, FallbackReason.SLO_REJECTED,
                                detail=f"queue depth {depth}")
        try:
            self.batcher.submit(request, deadline=deadline)
        except QueueClosedError:
            # drain began between the flag check and the enqueue: still a
            # typed response, never a raised exception to the client
            return self._refuse(request, FallbackReason.SHUTTING_DOWN,
                                detail=self._drain_reason or "draining")
        _metrics.gauge("serving.queue_depth").set(self.batcher.depth())
        return None

    # -- dispatch ------------------------------------------------------------

    def pump(self, flush: bool = False) -> List[ScoreResponse]:
        """Form and score at most one batch; [] when none is ready.
        ``flush`` overrides the coalescing deadline (stream end /
        synchronous serve)."""
        depth_before = self.batcher.depth()
        popped = self.batcher.next_batch(flush=flush)
        if popped is None:
            return []
        items, _bucket = popped
        # deadline enforcement at the queue->score boundary: requests that
        # can no longer make their deadline are refused instead of
        # occupying a slot; the rest of the batch still scores (in the
        # smallest covering bucket, which warmup has dispatched)
        now = self.clock()
        headroom = self.config.deadline.score_headroom_s
        responses: List[ScoreResponse] = []
        live: List[Pending] = []
        for p in items:
            if p.deadline is not None and now > p.deadline - headroom:
                responses.append(self._refuse(
                    p.request, FallbackReason.DEADLINE_EXCEEDED,
                    detail=f"expired in queue after "
                           f"{(now - p.t_submit) * 1e3:.1f}ms"))
            else:
                live.append(p)
        if live:
            bucket = self.ladder.bucket_for(len(live))
            shed = depth_before > self.config.slo.shed_queue_depth
            t_start = self.clock()
            responses.extend(self._score_batch(live, bucket, shed, t_start))
        _metrics.gauge("serving.queue_depth").set(self.batcher.depth())
        return responses

    def _score_batch(self, items: Sequence[Pending], bucket: int,
                     shed: bool, t_start: float) -> List[ScoreResponse]:
        requests = [p.request for p in items]
        full_ok, probe = self.breaker.allow_full()
        breaker_shed = not full_ok
        shed_any = shed or breaker_shed
        mode = "fixed_only" if shed_any else "full"
        model = self.model

        t0 = time.perf_counter()
        args, fallbacks, counters = model.assemble(
            requests, bucket, shed_random=shed_any)
        t_assemble = time.perf_counter() - t0

        # the score stage: the pack into the staging buffer, the copy in,
        # the kernel launch and the copy out that dispatch waits for
        t0 = time.perf_counter()
        scores = None
        try:
            scores = dispatch(model, mode, args).cpu().numpy()
        except Exception as e:  # device/dispatch fault: typed, counted
            logger.warning("serving scorer failed (bucket %d, mode %s): %r",
                           bucket, mode, e)
            _metrics.counter("serving.scorer_errors").inc()
        t_score = time.perf_counter() - t0

        n = len(requests)
        scorer_ok = scores is not None
        if scorer_ok and not np.all(np.isfinite(scores[:n])):
            scorer_ok = False
            _metrics.counter("serving.nonfinite_batches").inc()
        self.breaker.record(t_score, scorer_ok, probe=probe)

        _metrics.counter("serving.responses").inc(n)
        _metrics.counter("serving.batches", bucket=str(bucket),
                         mode=mode).inc()
        if not scorer_ok:
            return [self._refuse(r, FallbackReason.SCORER_FAILURE,
                                 detail="scorer raised" if scores is None
                                 else "non-finite score")
                    for r in requests]

        if shed:
            for fb in fallbacks:
                fb.append(Fallback(FallbackReason.SLO_SHED_RANDOM_EFFECTS,
                                   detail=f"batch mode {mode}"))
        elif breaker_shed:
            for fb in fallbacks:
                fb.append(Fallback(
                    FallbackReason.BREAKER_SHED_RANDOM_EFFECTS,
                    detail="circuit breaker shed"))

        responses = []
        for i, (pending, req) in enumerate(zip(items, requests)):
            fbs = tuple(fallbacks[i])
            responses.append(ScoreResponse(
                req.uid, score=float(scores[i]),
                degraded=bool(fbs), fallbacks=fbs))
            # queue time from the injected clock (deterministic in tests);
            # total = queue + host assemble + score
            q = max(t_start - pending.t_submit, 0.0)
            _metrics.histogram("serving.latency_seconds", LATENCY_BUCKETS,
                               stage="queue").observe(q)
            _metrics.histogram("serving.latency_seconds", LATENCY_BUCKETS,
                               stage="total").observe(q + t_assemble + t_score)

        _metrics.counter("serving.padded_rows").inc(counters["padded_rows"])
        for reason, count in (
                (FallbackReason.FEATURE_OVERFLOW,
                 counters["truncated_features"]),
                (FallbackReason.UNKNOWN_ENTITY, counters["unknown_entities"]),
                (FallbackReason.SLO_SHED_RANDOM_EFFECTS,
                 len(responses) if shed else 0),
                (FallbackReason.BREAKER_SHED_RANDOM_EFFECTS,
                 len(responses) if breaker_shed and not shed else 0)):
            if count:
                _metrics.counter("serving.degraded",
                                 reason=reason.value).inc(count)
        _metrics.histogram("serving.latency_seconds", LATENCY_BUCKETS,
                           stage="assemble").observe(t_assemble)
        _metrics.histogram("serving.latency_seconds", LATENCY_BUCKETS,
                           stage="score").observe(t_score)
        return responses

    # -- circuit breaker wiring ----------------------------------------------

    def _on_breaker(self, frm: str, to: str, why: str) -> None:
        _metrics.gauge("serving.breaker_state").set(STATE_LEVELS[to])
        _metrics.counter("serving.breaker_transitions", to=to).inc()
        if to in (SHED, OPEN):
            logger.warning("serving breaker tripped %s -> %s: %s",
                           frm, to, why)

    # -- graceful drain ------------------------------------------------------

    def begin_drain(self, reason: str = "drain requested") -> None:
        """Flip to draining: admission refuses with typed SHUTTING_DOWN,
        queued work stays poppable. Lock-free flag flips only — safe from
        a signal handler."""
        if self._draining:
            return
        self._draining = True
        self._drain_reason = reason
        self.batcher.close()
        _metrics.gauge("serving.draining").set(1)

    @property
    def draining(self) -> bool:
        return self._draining

    def shutdown(self, drain_budget_s: Optional[float] = None,
                 reason: str = "shutdown") -> List[ScoreResponse]:
        """Graceful drain to completion: flush in-flight micro-batches
        within the drain budget, refuse the remainder with typed
        SHUTTING_DOWN. Returns every response produced."""
        self.begin_drain(reason)
        budget = (self.config.drain_budget_s if drain_budget_s is None
                  else drain_budget_s)
        t0 = self.clock()
        out: List[ScoreResponse] = []
        flushed = 0
        while self.batcher.depth() and (self.clock() - t0) < budget:
            got = self.pump(flush=True)
            flushed += len(got)
            out.extend(got)
        refused = 0
        for p in self.batcher.pop_all():  # budget exhausted
            refused += 1
            out.append(self._refuse(
                p.request, FallbackReason.SHUTTING_DOWN,
                detail=f"drain budget {budget:.3f}s exhausted"))
        seconds = self.clock() - t0
        self._drain_info = {"reason": self._drain_reason or reason,
                            "budget_s": budget, "seconds": seconds,
                            "flushed": flushed, "refused": refused}
        _metrics.gauge("serving.drain_seconds").set(seconds)
        return out

    # -- synchronous convenience --------------------------------------------

    def serve(self, requests: Sequence[ScoreRequest]) -> List[ScoreResponse]:
        """Score a request sequence synchronously, preserving input order.
        Rejected requests still get (typed) responses."""
        # FIFO queue per uid: duplicate uids stay well-defined because
        # batches pop in submission order
        by_uid: Dict[str, List[ScoreResponse]] = {}
        for r in requests:
            rejected = self.submit(r)
            if rejected is not None:
                by_uid.setdefault(r.uid, []).append(rejected)
            while True:
                got = self.pump(flush=self.batcher.depth()
                                >= self.ladder.max_batch)
                if not got:
                    break
                for resp in got:
                    by_uid.setdefault(resp.uid, []).append(resp)
        while self.batcher.depth():
            for resp in self.pump(flush=True):
                by_uid.setdefault(resp.uid, []).append(resp)
        return [by_uid[r.uid].pop(0) for r in requests]

    def drain(self) -> List[ScoreResponse]:
        """Flush every queued request to completion (stream end)."""
        out: List[ScoreResponse] = []
        while self.batcher.depth():
            out.extend(self.pump(flush=True))
        return out

    # -- reporting -----------------------------------------------------------

    def stats(self) -> dict:
        """The serving section: model shape, ladder, kernel-library build
        accounting by phase, and the latency quantiles."""
        snap = _metrics.snapshot()
        latencies = {}
        for key, h in snap["histograms"].items():
            if key.startswith("serving.latency_seconds{"):
                stage = key.split('stage="')[1].split('"')[0]
                latencies[stage] = {
                    k: h.get(k) for k in ("count", "sum", "p50", "p95", "p99")}
        counters = {k: v for k, v in snap["counters"].items()
                    if k.startswith("serving.")}
        out = {
            "model": self.model.describe(),
            "buckets": list(self.ladder.buckets),
            "modes": list(MODES),
            "warmed": self._warmed,
            "warmup_seconds": self._warmup_seconds,
            "warmup_programs": self._warmup_programs,
            "kernel_builds": self.kernel_builds(),
            "queue_depth": self.batcher.depth(),
            "counters": counters,
            "latency_seconds": latencies,
            "slo": {"shed_queue_depth": self.config.slo.shed_queue_depth,
                    "reject_queue_depth": self.config.slo.reject_queue_depth},
            "deadline": {
                "default_timeout_s": self.config.deadline.default_timeout_s,
                "min_service_s": self.config.deadline.min_service_s,
                "score_headroom_s": self.config.deadline.score_headroom_s},
            "breaker": self.breaker.snapshot(),
            "draining": self._draining,
        }
        if self._drain_info is not None:
            out["drain"] = dict(self._drain_info)
        return out
