"""``resolve_fastest``: the perf-aware face of the accuracy resolver (the
torch package's copy of ``repro/precision/fastest.py``).

A thin delegating wrapper: the implementation lives in
:mod:`repro_torch.perf.model` (it needs the preset store and the hardware
fingerprint), but the API belongs here next to ``resolve_for``: callers pick
"minimal moduli for this target" (``policy.resolve_for``) or "minimal moduli
AND the measured-fastest scheme/route for this target"
(``resolve_fastest``) from the same namespace.

The import is deferred into the call so the precision <- core <- everything
layering stays acyclic (``repro_torch.perf.model`` imports
``repro_torch.precision``; this module must not import it back at import
time).
"""
from __future__ import annotations

from typing import Optional


def resolve_fastest(a, b, target_rel_err: float, *, policy=None, model=None,
                    k: Optional[int] = None,
                    spread_log2: Optional[float] = None):
    """Fastest policy meeting ``target_rel_err`` on ``a @ b``.

    Accuracy comes from the ``resolve_for`` estimator (minimal
    ``num_moduli``, never loosened); a fresh checked-in perf preset for this
    (shape bucket, operands' device type) breaks the remaining scheme /
    route ties toward the measured winner. With no matching preset, or a
    stale hardware fingerprint, the result is exactly
    ``policy.resolve_for(a, b, target_rel_err)``.
    """
    from repro_torch.perf.model import resolve_fastest as _impl

    return _impl(a, b, target_rel_err, policy=policy, model=model, k=k,
                 spread_log2=spread_log2)
