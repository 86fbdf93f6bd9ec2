"""Precision policies of the port (spec grammar, context stack, the
accuracy-targeted ``resolve_for`` and the serving side's
``resolve_for_sketches`` of ``resolve.py``)."""
from .context import (current_policy, resolve_pinned_policy, resolve_policy,
                      set_default_policy, use_policy)
from .policy import (BACKENDS, DEFAULT_NUM_SLICES, MODES, NATIVE, OZAKI2_FAMILY,
                     SCHEMES, PrecisionPolicy, coerce_policy, parse_policy)
from .resolve import (DEFAULT_ACTIVATION_SPREAD_LOG2, WeightSketch,
                      estimate_norm_err_log2, operand_spread_log2,
                      resolve_for_sketches, resolve_num_moduli)

__all__ = [
    "BACKENDS", "DEFAULT_NUM_SLICES", "MODES", "NATIVE", "OZAKI2_FAMILY",
    "SCHEMES", "PrecisionPolicy", "coerce_policy", "parse_policy",
    "current_policy", "resolve_pinned_policy", "resolve_policy",
    "set_default_policy", "use_policy",
    "DEFAULT_ACTIVATION_SPREAD_LOG2", "WeightSketch", "estimate_norm_err_log2",
    "operand_spread_log2", "resolve_for_sketches", "resolve_num_moduli",
]
