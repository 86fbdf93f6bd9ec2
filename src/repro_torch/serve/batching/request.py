"""Request abstraction for the continuous-batching engine (the torch
counterpart of ``repro/serve/batching/request.py``).

A request is a prompt plus generation limits and QoS knobs: a priority (for
the priority scheduler), an optional wall-clock deadline, and an *accuracy
class* that the engine resolves into a per-request decode
:class:`~repro_torch.precision.PrecisionPolicy` via the cached weight sketches
(``resolve_for_sketches``). Accuracy classes are either a named tier from
:data:`ACCURACY_CLASSES` or a raw ``target_rel_err`` float in the
condition-free metric of docs/precision.md.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Optional

#: Named accuracy tiers -> target relative error (condition-free metric).
#: "fp64" sits near the reconstruction floor; "relaxed" is roughly fp32-grade.
ACCURACY_CLASSES = {
    "fp64": 2.0 ** -48,
    "high": 2.0 ** -40,
    "standard": 2.0 ** -30,
    "relaxed": 2.0 ** -20,
}

_next_id = itertools.count()


def resolve_accuracy_target(accuracy) -> float:
    """Accuracy class (name or float) -> target_rel_err."""
    if isinstance(accuracy, str):
        try:
            return ACCURACY_CLASSES[accuracy]
        except KeyError:
            raise ValueError(
                f"unknown accuracy class {accuracy!r}; expected one of "
                f"{sorted(ACCURACY_CLASSES)} or a target_rel_err float") from None
    target = float(accuracy)
    if not (0.0 < target < 1.0):
        raise ValueError(f"target_rel_err must be in (0, 1), got {target}")
    return target


class RequestStatus(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"   # hit max_new_tokens
    EXPIRED = "expired"     # deadline passed (possibly with partial output)
    REJECTED = "rejected"   # can never be served (prompt + budget too long)


@dataclasses.dataclass
class Request:
    """One generation request. ``deadline`` is absolute ``time.monotonic()``
    seconds (the engine's clock); ``key`` (an int seed) makes temperature
    sampling reproducible (``engine.sample_tokens``)."""
    tokens: tuple  # prompt token ids
    max_new_tokens: int
    accuracy: Optional[object] = None  # None -> engine's base policy
    priority: int = 0  # lower = more urgent (priority scheduler only)
    deadline: Optional[float] = None
    temperature: float = 0.0
    key: Optional[object] = None
    request_id: int = dataclasses.field(default_factory=lambda: next(_next_id))

    def __post_init__(self):
        self.tokens = tuple(int(t) for t in self.tokens)
        if not self.tokens:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.accuracy is not None:
            resolve_accuracy_target(self.accuracy)  # validate eagerly

    @property
    def total_len(self) -> int:
        """KV positions the request may occupy: prompt + generated tokens
        (the final generated token is sampled, never written back)."""
        return len(self.tokens) + self.max_new_tokens


@dataclasses.dataclass
class RequestResult:
    """Terminal record: generated tokens + latency/precision accounting.
    Timestamps are ``time.monotonic()`` seconds; ``first_token_time`` /
    ``finish_time`` are None for requests that never ran."""
    request_id: int
    status: RequestStatus
    tokens: list
    policy_spec: Optional[str] = None  # resolved decode policy ("native", ...)
    submit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    @property
    def ttft(self) -> Optional[float]:
        if self.submit_time is None or self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time

    @property
    def latency(self) -> Optional[float]:
        if self.submit_time is None or self.finish_time is None:
            return None
        return self.finish_time - self.submit_time
