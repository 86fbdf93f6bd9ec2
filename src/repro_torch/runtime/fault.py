"""Fault-tolerance runtime (the port's copy of ``repro/runtime/fault.py``):
retry with backoff, heartbeat file, straggler watchdog (EWMA step-time
anomaly detection), and elastic mesh re-derivation.

On a real multi-host deployment the heartbeat file is replaced by the
cluster's liveness endpoint and the watchdog feeds the scheduler; the logic
and tests are host-count agnostic.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
import zlib
from typing import Callable, Optional, TypeVar

from repro_torch.obs import metrics as obs_metrics

log = logging.getLogger("repro_torch.runtime")
T = TypeVar("T")


def retry_jitter(e: BaseException, i: int) -> float:
    """Deterministic backoff jitter factor in [1.0, 1.6] from the error text
    and attempt index. ``zlib.crc32``, NOT ``hash()``: str hashing is salted
    per process (PYTHONHASHSEED), so ``hash(str(e))`` gave every host a
    different schedule for the same failure — and made retry timing
    unreproducible run to run. CRC32 is stable across processes, platforms,
    and Python versions, so coordinated hosts spread out identically."""
    seed = zlib.crc32(f"{type(e).__name__}:{e}:{i}".encode())
    return 1 + 0.1 * (seed % 7)


def retry(fn: Callable[[], T], *, attempts: int = 3, base_delay: float = 0.5,
          retriable: tuple = (RuntimeError, OSError)) -> T:
    """Retry transient failures with exponential backoff + jitter."""
    for i in range(attempts):
        try:
            return fn()
        except retriable as e:  # noqa: PERF203
            if i == attempts - 1:
                raise
            delay = base_delay * (2 ** i) * retry_jitter(e, i)
            obs_metrics.inc("runtime.retries", 1.0, error=type(e).__name__)
            log.warning("retry %d/%d after %r (sleep %.2fs)", i + 1, attempts, e, delay)
            time.sleep(delay)
    raise AssertionError("unreachable")


class Heartbeat:
    """Periodic liveness marker; restart orchestrators watch its mtime."""

    def __init__(self, path: str, interval: float = 10.0):
        self.path = path
        self.interval = interval
        self._last = 0.0

    def beat(self, step: int) -> None:
        now = time.time()
        if now - self._last >= self.interval:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"step": step, "time": now, "pid": os.getpid()}, f)
            os.replace(tmp, self.path)
            self._last = now


@dataclasses.dataclass
class StragglerWatchdog:
    """EWMA step-time tracker: flags steps slower than ``threshold`` x the
    moving average — on real pods the flagged host triggers data re-routing
    (hook) and shows up in the job log for the scheduler."""

    alpha: float = 0.1
    threshold: float = 3.0
    ewma: Optional[float] = None
    flagged: int = 0
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    def observe(self, step: int, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            obs_metrics.gauge("runtime.watchdog.ewma_seconds", dt)
            return False
        is_straggler = dt > self.threshold * self.ewma
        if is_straggler:
            self.flagged += 1
            obs_metrics.inc("runtime.watchdog.stragglers", 1.0)
            log.warning("straggler step %d: %.3fs vs EWMA %.3fs", step, dt, self.ewma)
            if self.on_straggler:
                self.on_straggler(step, dt, self.ewma)
        # EWMA excludes outliers so a stuck host does not poison the baseline
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        obs_metrics.gauge("runtime.watchdog.ewma_seconds", self.ewma)
        return is_straggler


def elastic_mesh_shape(num_devices: int, model_parallel: int) -> tuple[int, int]:
    """Re-derive (data, model) after losing hosts: keep TP fixed (weights
    shard layout), shrink DP. Raises if TP no longer fits."""
    if num_devices % model_parallel:
        raise ValueError(f"{num_devices} devices cannot host model_parallel={model_parallel}")
    return (num_devices // model_parallel, model_parallel)
