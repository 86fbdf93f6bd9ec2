"""Oracle of the fused path: the port's core executor itself (same scaling,
residues, schedule, digits and reconstruction)."""
from __future__ import annotations

import torch

from repro_torch.core.ozaki2 import ozmm_ozaki2


def ozmm_fused_ref(a: torch.Tensor, b: torch.Tensor, *, family: str,
                   num_moduli: int | None, mode: str) -> torch.Tensor:
    """Ground truth for ``ozmm_pallas_fused``'s f64 output: the core path."""
    return ozmm_ozaki2(a, b, family=family, num_moduli=num_moduli, mode=mode)
