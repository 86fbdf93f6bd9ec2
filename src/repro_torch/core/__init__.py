"""repro_torch.core: FP64 GEMM emulation in PyTorch — the Ozaki-II scheme
(moduli, scaling, quantization, CRT, plans, the core executor), the Ozaki-I
baseline, the paper's §IV analytic models (``perf_model``) and the public,
differentiable ``ozmm``."""
from repro_torch.precision import (PrecisionPolicy, parse_policy, resolve_policy,
                                   set_default_policy, use_policy)
from repro_torch.precision.policy import DEFAULT_NUM_SLICES, OZAKI2_FAMILY, SCHEMES

from . import perf_model
from .gemm import (OZMM_DEFAULT_POLICY, backend_matmul, default_num_moduli, ozmm,
                   prepare_operand, resolve_device)
from .moduli import (DEFAULT_NUM_MODULI, ModuliSet, family_moduli, make_moduli_set,
                     min_moduli_for_bits)
from .ozaki1 import ozmm_ozaki1_fp8
from .ozaki2 import ozmm_ozaki2
from .plan import (PLAN_WIRE_VERSION, QuantizedMatrix, ozmm_prepared, plan_from_arrays,
                   plan_from_wire, plan_to_wire, quantize_matrix, transpose_plan,
                   wire_bytes)

__all__ = [
    "DEFAULT_NUM_SLICES", "OZAKI2_FAMILY", "SCHEMES",
    "PrecisionPolicy", "parse_policy", "resolve_policy", "set_default_policy",
    "use_policy",
    "OZMM_DEFAULT_POLICY", "backend_matmul", "default_num_moduli", "ozmm",
    "prepare_operand", "resolve_device", "DEFAULT_NUM_MODULI", "ModuliSet",
    "family_moduli", "make_moduli_set", "min_moduli_for_bits", "ozmm_ozaki1_fp8",
    "ozmm_ozaki2", "QuantizedMatrix", "ozmm_prepared", "plan_from_arrays",
    "quantize_matrix", "transpose_plan", "perf_model", "PLAN_WIRE_VERSION",
    "plan_to_wire", "plan_from_wire", "wire_bytes",
]
