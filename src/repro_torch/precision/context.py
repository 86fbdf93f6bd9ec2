"""Precision-policy context (the torch counterpart of
``repro/precision/context.py``). Precedence at any resolution point:

    per-call ``policy=`` argument  >  innermost ``use_policy()`` block
    >  ``set_default_policy(...)``  >  the caller's fallback (native).

PyTorch runs eagerly, so the context is read at call time. The stack is a
:mod:`contextvars` variable: concurrent threads and tasks see their own.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

from .policy import NATIVE, PrecisionPolicy, coerce_policy

_STACK: contextvars.ContextVar[tuple[PrecisionPolicy, ...]] = \
    contextvars.ContextVar("repro_torch_precision_policy_stack", default=())

#: Process-wide bottom-of-stack default; None = never set.
_DEFAULT: Optional[PrecisionPolicy] = None


def set_default_policy(policy) -> Optional[PrecisionPolicy]:
    """Set the process-wide default policy (a policy, a spec string, or None
    to clear). Returns the previous default so callers can restore it."""
    global _DEFAULT
    prev = _DEFAULT
    _DEFAULT = None if policy is None else coerce_policy(policy)
    return prev


def current_policy() -> Optional[PrecisionPolicy]:
    """Innermost ``use_policy`` block, else the default, else None."""
    stack = _STACK.get()
    return stack[-1] if stack else _DEFAULT


@contextlib.contextmanager
def use_policy(policy):
    """Scope a policy for every policy-resolving call inside the block."""
    pol = coerce_policy(policy)
    token = _STACK.set(_STACK.get() + (pol,))
    try:
        yield pol
    finally:
        _STACK.reset(token)


def resolve_policy(policy=None, *, fallback: Optional[PrecisionPolicy] = None
                   ) -> PrecisionPolicy:
    """Per-call override > context > ``fallback`` > native."""
    if policy is not None:
        return coerce_policy(policy)
    ctx = current_policy()
    if ctx is not None:
        return ctx
    return fallback if fallback is not None else NATIVE


def resolve_pinned_policy(configured, policy) -> PrecisionPolicy:
    """Resolve the policy a long-lived component (the serving engines) pins
    for its calls: explicit ``policy=``, else the component's ``configured``
    policy (``ModelConfig.gemm``), else the context.

    Model layers resolve ``configured`` per call, which outranks any context
    the component establishes, so an explicit ``policy=`` that contradicts
    an explicit ``configured`` could never take effect inside the model; it
    is refused instead of splitting precision between the component (weight
    caches) and the layers.
    """
    if policy is None:
        return resolve_policy(configured)
    pol = coerce_policy(policy)
    if configured is not None and coerce_policy(configured) != pol:
        raise ValueError(
            f"policy={pol.spec!r} contradicts the configured policy "
            f"{coerce_policy(configured).spec!r}; the model layers resolve "
            "the configured policy per-call, so the override would not "
            "reach them. Rebuild the config with gemm=None (resolve from "
            "context) or with the desired policy.")
    return pol
