"""The int8 residue GEMM (K4): wrapper of the hand-written Hopper kernel
``csrc/residue_gemm.cu`` (entry ``int8_gemm_launch``: K3's routes with the
s8 MMA, on the wgmma route 128 x 256 blocks with no promotion), which
replaces
``repro/kernels/int8_gemm/kernel.py::int8_gemm`` (body ``_gemm_kernel``),
and its plain PyTorch version.

int8 A (m, k) @ int8 B (k, n) -> int32 C (m, n), exact for |x| <= 127 and
k <= 2^17, the reference's limit, which the wrapper guards
(``fp8_gemm.kernel.max_k``). Any m, n, k (masked edges, no padding);
``out=`` writes C into a preallocated plane. B K-major or contiguous, and
the route, as for K3 (``fp8_gemm.kernel.residue_gemm``).

A CUDA tensor goes to the kernel or raises; only CPU tensors take the plain
version ``int8_gemm_plain``. ``int8_gemm.launches`` counts kernel launches
(``int8_gemm.launches_by_route`` by route, ``int8_gemm.b_copies`` the
transposes of a contiguous B) and ``int8_gemm_plain.calls`` plain-version
calls.
"""
from __future__ import annotations

import torch

from repro_torch.core import numerics

from ..fp8_gemm.kernel import reset_counts, residue_gemm
from ..launch import kernel_scope


def int8_gemm_plain(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor | None = None):
    """Plain PyTorch version of ``int8_gemm``: the core route's exact int32
    product (``numerics.matmul_exact_int8``), into ``out`` when given."""
    int8_gemm_plain.calls += 1
    c = numerics.matmul_exact_int8(a, b)
    return c if out is None else out.copy_(c)


int8_gemm_plain.calls = 0


@kernel_scope("int8_gemm")
def int8_gemm(a: torch.Tensor, b: torch.Tensor, *, out: torch.Tensor | None = None):
    """C = A @ B for int8 A (m, k), B (k, n) K-major or contiguous, as int32
    (m, n), written into ``out`` when given. CUDA tensors run the kernel (or
    raise); CPU tensors run ``int8_gemm_plain``."""
    return residue_gemm(int8_gemm, int8_gemm_plain, a, b, out, torch.int8, torch.int32)


reset_counts(int8_gemm)
