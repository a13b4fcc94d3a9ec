"""Durable file primitives: fsync-audited atomic publish.

The port's copy of the part of ``photon_tpu/resilience/io.py`` that the
model writers use. The durability contract is the same:

    write tmp -> fsync(tmp) -> rename -> fsync(dir)

A crash before the rename leaves only a tmp file that readers ignore; a
crash after it leaves the complete new artifact. Reads and publishes
retry transient ``OSError``s with the JAX package's backoff schedule
(exponential, capped, deterministic jitter). The chaos injectors are not
carried over.
"""

from __future__ import annotations

import logging
import os
import time
import zlib
from typing import Callable, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")

#: attempts per operation (first try + retries), first delay, delay cap
MAX_ATTEMPTS = 4
BASE_DELAY_S = 0.05
MAX_DELAY_S = 2.0


def backoff_delay(op: str, attempt: int, base: float = BASE_DELAY_S,
                  cap: float = MAX_DELAY_S) -> float:
    """Delay before retry #``attempt`` (0-based): exponential, capped,
    with deterministic jitter in [0.5, 1.0) x the raw delay."""
    raw = min(cap, base * (2.0 ** attempt))
    h = zlib.crc32(f"{op}:{attempt}".encode()) / 2.0**32
    return raw * (0.5 + 0.5 * h)


def with_retries(fn: Callable[[], T], op: str = "io",
                 attempts: int = MAX_ATTEMPTS) -> T:
    """Run ``fn()``, retrying on ``OSError`` up to ``attempts`` times."""
    for attempt in range(attempts):
        try:
            return fn()
        except OSError as e:
            if attempt + 1 >= attempts:
                raise
            delay = backoff_delay(op, attempt)
            logger.warning("%s failed (attempt %d/%d): %r — retrying in "
                           "%.3fs", op, attempt + 1, attempts, e, delay)
            time.sleep(delay)
    raise AssertionError("unreachable: loop either returns or raises")


def fsync_dir(path: str) -> None:
    """Persist a rename/creation in its directory (POSIX requires syncing
    the directory entry separately from the file data)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms without O_RDONLY dirs — best effort
        return
    try:
        os.fsync(fd)
    except OSError:
        logger.debug("directory fsync unsupported for %s", path)
    finally:
        os.close(fd)


def read_bytes(path: str, op: str = "read") -> bytes:
    def _read() -> bytes:
        with open(path, "rb") as f:
            return f.read()
    return with_retries(_read, op=op)


def atomic_write_bytes(path: str, data: bytes, op: str = "write") -> None:
    """Atomically publish ``data`` at ``path`` with fsync-before-rename.

    Retried as a unit: each attempt rewrites its own tmp file, so a
    transient failure mid-publish never leaves a half-written final
    artifact.
    """
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"

    def _publish() -> None:
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            fsync_dir(d)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    with_retries(_publish, op=op)
