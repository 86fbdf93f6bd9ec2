"""Span tracing: the timing substrate the port reports through (the torch
package's copy of ``repro/obs/trace.py``). A :class:`Span` measures one
named phase of work, as a context manager or a decorator::

    with span("ozmm", policy=spec) as sp:
        c = ozmm(a, b, spec)
        sp.fence(c)    # synchronize the card before the end timestamp

    @span("train.step")
    def step(self): ...

* **Spans always time** (two ``perf_counter`` calls) so call sites can read
  ``sp.elapsed``; they record into the trace buffer only while tracing is
  enabled.
* **Parent linking** is contextvar-scoped: nested spans record their
  parent's id. The contextvar is touched only when tracing is enabled.
* **Device fencing**: CUDA launches are asynchronous, so a span closing
  right after ``ozmm`` on the card measures the enqueue, not the compute.
  ``sp.fence(value)`` synchronizes the CUDA device of every CUDA tensor in
  ``value`` (tensors, tuples/lists/dicts, objects with tensor fields such as
  a ``QuantizedMatrix``) before the end timestamp is taken, where the
  reference blocks until its arrays are ready; CPU tensors need no fence.
  ``fence`` is explicit: host-side spans must not pay a device sync.

The recorder is process-global and thread-safe (append under a lock);
export formats live in :mod:`repro_torch.obs.export`.
"""
from __future__ import annotations

import contextvars
import functools
import itertools
import os
import threading
import time
from typing import Any, Optional

__all__ = ["Span", "span", "tracing_enabled", "enable_tracing",
           "disable_tracing", "clear_trace", "trace_events", "TRACE_CLOCK"]

#: Events record microseconds on this clock (perf_counter epoch).
TRACE_CLOCK = "perf_counter_us"

_EVENTS: list[dict] = []
_EVENTS_LOCK = threading.Lock()
_ENABLED = bool(int(os.environ.get("REPRO_OBS_TRACE", "0") or "0"))
_IDS = itertools.count(1)
_CURRENT: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "repro_obs_current_span", default=None)


def tracing_enabled() -> bool:
    return _ENABLED


def enable_tracing() -> None:
    global _ENABLED
    _ENABLED = True


def disable_tracing() -> None:
    global _ENABLED
    _ENABLED = False


def clear_trace() -> None:
    with _EVENTS_LOCK:
        _EVENTS.clear()


def trace_events() -> list[dict]:
    """Snapshot of the recorded span events (copies the list, not the dicts)."""
    with _EVENTS_LOCK:
        return list(_EVENTS)


class Span:
    """One timed phase. Always measures ``elapsed``; records into the trace
    buffer (with parent linkage) only while tracing is enabled."""

    __slots__ = ("name", "attrs", "_t0", "_t1", "_id", "_parent", "_token",
                 "_recording")

    def __init__(self, name: str, attrs: Optional[dict] = None):
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0
        self._t1 = 0.0
        self._recording = False
        self._token = None

    # -- context manager -------------------------------------------------
    def __enter__(self) -> "Span":
        self._recording = _ENABLED
        if self._recording:
            self._id = next(_IDS)
            self._parent = _CURRENT.get()
            self._token = _CURRENT.set(self._id)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._t1 == 0.0:
            self._t1 = time.perf_counter()
        if self._recording:
            _CURRENT.reset(self._token)
            event = {"name": self.name, "id": self._id, "parent": self._parent,
                     "ts_us": self._t0 * 1e6,
                     "dur_us": (self._t1 - self._t0) * 1e6,
                     "tid": threading.get_ident()}
            if self.attrs:
                event["attrs"] = self.attrs
            if exc_type is not None:
                event["error"] = exc_type.__name__
            with _EVENTS_LOCK:
                _EVENTS.append(event)

    # -- decorator form ---------------------------------------------------
    def __call__(self, fn):
        name = self.name
        attrs = self.attrs

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with Span(name, attrs):
                return fn(*args, **kwargs)
        return wrapper

    # -- explicit device fencing ------------------------------------------
    def fence(self, value: Any) -> Any:
        """Synchronize the CUDA device of every CUDA tensor in ``value``,
        then take the end timestamp — the span measures device time, not
        the enqueue. Returns ``value`` so fencing composes with a return
        expression."""
        import torch

        for dev in _cuda_devices(value, set()):
            torch.cuda.synchronize(dev)
        self._t1 = time.perf_counter()
        return value

    @property
    def elapsed(self) -> float:
        """Seconds between enter and exit (or the last fence). Valid after
        ``__exit__``; call sites feed this into legacy stats dicts."""
        return self._t1 - self._t0

    def set_attrs(self, **attrs) -> None:
        """Attach attributes after entry (e.g. sizes known only mid-phase)."""
        if self._recording:
            if self.attrs is None:
                self.attrs = {}
            self.attrs.update(attrs)


def _cuda_devices(value: Any, seen: set) -> set:
    """The CUDA devices of the tensors found in ``value``: a tensor, a
    tuple/list/dict of values, or a dataclass whose fields hold them (such
    as ``QuantizedMatrix``)."""
    import dataclasses

    import torch

    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            seen.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, seen)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, seen)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            _cuda_devices(getattr(value, f.name), seen)
    return seen


def span(name: str, **attrs) -> Span:
    """Create a span — use as ``with span("x"): ...`` or ``@span("x")``."""
    return Span(name, attrs or None)
