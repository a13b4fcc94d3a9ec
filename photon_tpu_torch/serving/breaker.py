"""Sliding-window circuit breaker for the serving scorer stage.

The SLO ladder (types.SLOConfig) sheds on *load* — queue depth is the
signal. The breaker sheds on *fault*: a scorer stage that got slow
(device contention, a pathological model) or started failing
(exceptions, non-finite scores) poisons every queued request behind it,
so the engine must stop feeding it full-effort work even when the queue
is shallow. State ladder::

    closed ──breach──> shed ──breach persists──> open
      ▲                                            │ cooldown_s
      └──── probes healthy ──── half_open <────────┘
                                    │ probe breaches
                                    └────────────> open (cooldown again)

``shed`` scores fixed-effect-only (cheap, no gathers — typed
BREAKER_SHED_RANDOM_EFFECTS fallback); ``open`` refuses at admission
(BREAKER_REJECTED). Half-open lets ``probe_batches`` full-effort batches
through and closes only when every probe is healthy. Breaches are
evaluated over a bounded window of the most recent observations
(latency p99 above threshold, or failure rate above threshold) and the
window clears on every transition so each state decides on evidence
gathered *in* that state — a breaker that tripped on stale samples
would flap.

The clock is injected (the engine passes its own), so cooldown and
probation tests run on a deterministic fake clock; latencies recorded
are real measured stage seconds.
"""

from __future__ import annotations

import logging
import math
import threading
from collections import deque
from typing import Callable, List, Optional, Tuple

from photon_tpu_torch.serving.types import BreakerConfig

logger = logging.getLogger(__name__)

CLOSED = "closed"
SHED = "shed"
OPEN = "open"
HALF_OPEN = "half_open"

#: numeric encoding for the state gauge (monotone in severity)
STATE_LEVELS = {CLOSED: 0.0, HALF_OPEN: 1.0, SHED: 2.0, OPEN: 3.0}


def _p99(latencies: List[float]) -> float:
    if not latencies:
        return 0.0
    ordered = sorted(latencies)
    rank = max(math.ceil(0.99 * len(ordered)) - 1, 0)
    return ordered[rank]


class CircuitBreaker:
    """Fault breaker over (latency, ok) scorer-stage observations."""

    def __init__(self, config: Optional[BreakerConfig] = None,
                 clock: Optional[Callable[[], float]] = None,
                 on_transition: Optional[Callable[[str, str, str], None]]
                 = None):
        import time

        self.config = config or BreakerConfig()
        self.clock = clock if clock is not None else time.monotonic
        self.on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._window: deque = deque(maxlen=self.config.window)
        self._opened_at: Optional[float] = None
        self._probes_left = 0
        self._probe_breached = False
        self.transitions = 0
        self.trips = 0

    # -- state machine --------------------------------------------------------

    def _transition_locked(self, to: str, why: str) -> None:
        frm = self._state
        if frm == to:
            return
        self._state = to
        self._window.clear()
        self.transitions += 1
        if to in (SHED, OPEN):
            self.trips += 1
        if to == OPEN:
            self._opened_at = self.clock()
        if to == HALF_OPEN:
            self._probes_left = self.config.probe_batches
            self._probe_breached = False
        logger.warning("serving breaker %s -> %s (%s)", frm, to, why)
        cb = self.on_transition
        if cb is not None:
            cb(frm, to, why)

    def _maybe_half_open_locked(self) -> None:
        if (self._state == OPEN and self._opened_at is not None
                and self.clock() - self._opened_at >= self.config.cooldown_s):
            self._transition_locked(HALF_OPEN, "cooldown elapsed")

    def _breach_locked(self) -> Optional[str]:
        """The breach description for the current window, or None."""
        n = len(self._window)
        if n < self.config.min_samples:
            return None
        failures = sum(1 for _, ok in self._window if not ok)
        rate = failures / n
        if rate > self.config.failure_rate:
            return (f"failure rate {rate:.2f} > "
                    f"{self.config.failure_rate:.2f} over {n} batches")
        p99 = _p99([lat for lat, _ in self._window])
        if p99 > self.config.latency_p99_s:
            return (f"scorer p99 {p99 * 1e3:.1f}ms > "
                    f"{self.config.latency_p99_s * 1e3:.1f}ms over {n} batches")
        return None

    # -- engine-facing API ----------------------------------------------------

    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def admit(self) -> bool:
        """May a new request enter the queue at all? Only OPEN refuses
        (half-open admits: the probes need traffic)."""
        return self.state() != OPEN

    def allow_full(self) -> Tuple[bool, bool]:
        """(full-effort scoring allowed, this batch is a half-open probe).
        SHED forces fixed-effect-only; half-open grants full effort to a
        bounded number of probe batches and sheds the overflow."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == SHED:
                return False, False
            if self._state == HALF_OPEN:
                if self._probes_left > 0:
                    self._probes_left -= 1
                    return True, True
                return False, False
            return True, False

    def record(self, latency_s: float, ok: bool,
               probe: bool = False) -> None:
        """One scorer-stage observation (one batch dispatch)."""
        with self._lock:
            self._maybe_half_open_locked()
            self._window.append((float(latency_s), bool(ok)))
            if self._state == HALF_OPEN:
                if probe:
                    breached = (not ok or latency_s
                                > self.config.latency_p99_s)
                    if breached:
                        self._probe_breached = True
                    if self._probe_breached:
                        self._transition_locked(OPEN, "probe breached")
                    elif self._probes_left == 0:
                        self._transition_locked(
                            CLOSED,
                            f"{self.config.probe_batches} healthy probes")
                return
            breach = self._breach_locked()
            if breach is None:
                return
            if self._state == CLOSED:
                self._transition_locked(SHED, breach)
            elif self._state == SHED:
                self._transition_locked(OPEN, breach)

    def snapshot(self) -> dict:
        with self._lock:
            self._maybe_half_open_locked()
            n = len(self._window)
            failures = sum(1 for _, ok in self._window if not ok)
            return {
                "state": self._state,
                "level": STATE_LEVELS[self._state],
                "window_samples": n,
                "window_failure_rate": failures / n if n else 0.0,
                "window_p99_s": _p99([lat for lat, _ in self._window]),
                "transitions": self.transitions,
                "trips": self.trips,
                "thresholds": {
                    # None = disabled (inf is not portable JSON)
                    "latency_p99_s": (None
                                      if math.isinf(self.config.latency_p99_s)
                                      else self.config.latency_p99_s),
                    "failure_rate": self.config.failure_rate,
                    "min_samples": self.config.min_samples,
                    "cooldown_s": self.config.cooldown_s,
                },
            }
