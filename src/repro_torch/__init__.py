"""repro_torch: FP64 GEMM emulation via the Ozaki-II scheme with FP8
quantization, in PyTorch and CUDA for an NVIDIA H100.

The port of the JAX package ``repro`` (its reference, held against it by
``tests/test_torch_*.py``). It imports neither JAX nor anything of
``repro``. Entry points run on the card unless the caller passes
``device="cpu"``::

    from repro_torch import ozmm
    c = ozmm(a, b, "ozaki2-fp8/accurate")           # on the H100
    c = ozmm(a, b, "ozaki2-fp8/fast", device="cpu")  # on the CPU

``ozmm`` is differentiable (the cotangent GEMMs are emulated too);
``"ozaki1-fp8/..."`` policies run the paper's Ozaki-I baseline.
``repro_torch.linalg`` holds the blocked factorizations, solves and the HPL
harness on top of it; ``repro_torch.obs`` the spans, metrics and health
monitors.
"""
from .core import (DEFAULT_NUM_MODULI, QuantizedMatrix, backend_matmul,
                   default_num_moduli, make_moduli_set, ozmm, ozmm_ozaki1_fp8,
                   ozmm_ozaki2, ozmm_prepared, plan_from_arrays, prepare_operand,
                   quantize_matrix, transpose_plan)
from .precision import (PrecisionPolicy, parse_policy, resolve_policy,
                        set_default_policy, use_policy)

__all__ = [
    "DEFAULT_NUM_MODULI", "QuantizedMatrix", "backend_matmul", "default_num_moduli",
    "make_moduli_set", "ozmm", "ozmm_ozaki1_fp8", "ozmm_ozaki2", "ozmm_prepared",
    "plan_from_arrays", "prepare_operand", "quantize_matrix", "transpose_plan", "PrecisionPolicy", "parse_policy",
    "resolve_policy", "set_default_policy", "use_policy",
]
