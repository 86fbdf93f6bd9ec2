"""Precision policies of the port (spec grammar, context stack, and the
accuracy-targeted ``resolve_for`` of ``resolve.py``)."""
from .context import current_policy, resolve_policy, set_default_policy, use_policy
from .policy import (BACKENDS, DEFAULT_NUM_SLICES, MODES, NATIVE, OZAKI2_FAMILY,
                     SCHEMES, PrecisionPolicy, coerce_policy, parse_policy)

__all__ = [
    "BACKENDS", "DEFAULT_NUM_SLICES", "MODES", "NATIVE", "OZAKI2_FAMILY",
    "SCHEMES", "PrecisionPolicy", "coerce_policy", "parse_policy",
    "current_policy", "resolve_policy", "set_default_policy", "use_policy",
]
