"""Bucketed micro-batching: admission queue + power-of-two bucket ladder.

Snap ML's observation (PAPERS.md) carried to serving: the win comes from
keeping device state resident and feeding it *fixed-shape* work. The
batcher never emits an arbitrary batch size — it coalesces queued
requests into the smallest ladder bucket that fits (padding the remainder
with zero rows) and the ladder is finite, so every (mode, bucket) shape
the scorer can see is dispatched once at warmup.

The clock is injected (``clock=``) so the coalescing policy is unit-
testable without sleeping: tests advance a fake clock and assert exactly
when a batch forms.
"""

from __future__ import annotations

import threading
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

from photon_tpu_torch.serving.types import ScoreRequest


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class BucketLadder:
    """Fixed ladder of power-of-two batch sizes, ``min_bucket..max_batch``."""

    def __init__(self, max_batch: int = 64, min_bucket: int = 1):
        if min_bucket < 1 or max_batch < min_bucket:
            raise ValueError(f"bad ladder bounds [{min_bucket}, {max_batch}]")
        lo, hi = _next_pow2(min_bucket), _next_pow2(max_batch)
        b, buckets = lo, []
        while b <= hi:
            buckets.append(b)
            b *= 2
        self.buckets: Tuple[int, ...] = tuple(buckets)

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket that fits ``n`` requests (ladder top when
        ``n`` exceeds it — the caller takes at most ``max_batch``)."""
        if n <= 0:
            raise ValueError(f"bucket_for({n})")
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_batch


class QueueClosedError(RuntimeError):
    """Submit after ``close()`` — the engine is draining. Library callers
    get this typed error; the engine turns it into a SHUTTING_DOWN
    response so the hot path never leaks an exception to clients."""


class Pending(NamedTuple):
    request: ScoreRequest
    t_submit: float
    #: absolute deadline on the batcher clock; None = never expires
    deadline: Optional[float] = None


class MicroBatcher:
    """Thread-safe admission queue with deadline-based coalescing.

    A batch is released when (a) the queue holds a full ladder-top batch,
    (b) the OLDEST queued request has waited ``max_wait_s`` (then
    everything pending ships in the smallest covering bucket — the
    padded-remainder case), or (c) a queued request's absolute deadline
    is close enough that waiting any longer would leave it less than
    ``deadline_headroom_s`` to assemble+score — the oldest-waiter wait
    never overrides a tighter per-request deadline. ``flush=True``
    overrides all of it, used at stream end and by synchronous
    ``serve()``.
    """

    def __init__(self, ladder: BucketLadder, max_wait_s: float = 0.002,
                 clock: Optional[Callable[[], float]] = None,
                 deadline_headroom_s: float = 0.0):
        import time

        self.ladder = ladder
        self.max_wait_s = float(max_wait_s)
        self.deadline_headroom_s = float(deadline_headroom_s)
        self.clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: List[Pending] = []
        # set lock-free: close() may run inside a signal handler that
        # interrupted a thread already holding _lock (a non-reentrant
        # acquire there would deadlock the main thread)
        self._closed = False

    def submit(self, request: ScoreRequest,
               deadline: Optional[float] = None) -> None:
        if self._closed:
            raise QueueClosedError("admission queue closed (draining)")
        with self._cond:
            self._queue.append(Pending(request, self.clock(), deadline))
            self._cond.notify()

    def close(self) -> None:
        """Stop admission (drain). Lock-free on purpose — safe to call
        from a signal handler; queued work remains poppable."""
        self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    def depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def oldest_wait(self) -> Optional[float]:
        with self._lock:
            if not self._queue:
                return None
            return self.clock() - self._queue[0].t_submit

    def ready(self) -> bool:
        with self._lock:
            return self._ready_locked()

    def _ready_locked(self) -> bool:
        q = self._queue
        if not q:
            return False
        if len(q) >= self.ladder.max_batch:
            return True
        now = self.clock()
        if (now - q[0].t_submit) >= self.max_wait_s:
            return True
        # per-request deadlines can be tighter than the oldest-waiter
        # wait: release as soon as the tightest deadline has only the
        # score headroom left (popping exactly at the threshold keeps the
        # request servable — expiry in the engine is strict '>')
        for p in q:
            if (p.deadline is not None
                    and now >= p.deadline - self.deadline_headroom_s):
                return True
        return False

    def next_batch(self, flush: bool = False
                   ) -> Optional[Tuple[Sequence[Pending], int]]:
        """Pop one batch if the release policy allows; None otherwise.
        Returns (pending items, bucket size >= len(items))."""
        with self._lock:
            if not self._queue:
                return None
            if not (flush or self._ready_locked()):
                return None
            take = min(len(self._queue), self.ladder.max_batch)
            items = self._queue[:take]
            del self._queue[:take]
            return items, self.ladder.bucket_for(take)

    def pop_all(self) -> List[Pending]:
        """Take everything still queued (drain-budget exhaustion: the
        engine refuses these with typed SHUTTING_DOWN responses)."""
        with self._lock:
            items = self._queue[:]
            self._queue.clear()
            return items
