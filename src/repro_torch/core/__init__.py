"""repro_torch.core: the Ozaki-II emulated DGEMM in PyTorch (moduli, scaling,
quantization, CRT, plans, the core executor and the public ``ozmm``)."""
from .gemm import (OZMM_DEFAULT_POLICY, backend_matmul, ozmm, prepare_operand,
                   resolve_device)
from .moduli import DEFAULT_NUM_MODULI, ModuliSet, family_moduli, make_moduli_set
from .ozaki2 import ozmm_ozaki2
from .plan import (QuantizedMatrix, ozmm_prepared, plan_from_arrays,
                   quantize_matrix)

__all__ = [
    "OZMM_DEFAULT_POLICY", "backend_matmul", "ozmm", "prepare_operand",
    "resolve_device", "DEFAULT_NUM_MODULI", "ModuliSet", "family_moduli",
    "make_moduli_set", "ozmm_ozaki2", "QuantizedMatrix", "ozmm_prepared",
    "plan_from_arrays", "quantize_matrix",
]
