"""The e4m3 residue GEMM (K3): wrapper of the hand-written Hopper kernel
``csrc/residue_gemm.cu`` (entry ``fp8_gemm_launch``), which replaces
``repro/kernels/fp8_gemm/kernel.py::fp8_gemm`` (body ``_gemm_kernel``), and
its plain PyTorch version. ``residue_gemm`` is the launch code it shares
with the int8 GEMM (K4, ``kernels/int8_gemm``), the other entry of the same
source.

e4m3 A (m, k) @ e4m3 B (k, n) -> f32 C (m, n), exact for integer entries
|x| <= 16 and k <= 2^16. Any m, n, k: the kernel masks the ragged edges, so
nothing is padded (the reference's ops.py pads; there is no ops.py here),
and ``out=`` writes C into a preallocated plane, such as one modulus' plane
of the pipeline's (N, m, n) product stack.

B is taken K-major (``b.t()`` contiguous, as the pipeline hands it: the
transpose of an (n, k) plane) or contiguous; a contiguous B is transposed
once before the launch and counted on ``fp8_gemm.b_copies``. The kernel
route is a function of k and the operands' alignment alone
(``residue_gemm_route``): ``"wgmma"`` (TMA ring, wgmma, two-block clusters)
where TMA can address the operands, else ``"mma_sync"``. No error switches
route.

A CUDA tensor goes to the kernel or raises; only CPU tensors take the plain
version ``fp8_gemm_plain``, which takes either layout of B.
``fp8_gemm.launches`` counts kernel launches (``fp8_gemm.launches_by_route``
by route) and ``fp8_gemm_plain.calls`` plain-version calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import numerics

from ..launch import bind, check_tensors, kernel_scope, raise_on_error, stream

_MAX_K = 2 ** 16
_MAX_K_INT8 = 2 ** 17


def max_k(in_dtype: torch.dtype) -> int:
    """The largest contraction a residue GEMM keeps exact for operands of
    ``in_dtype``, the reference's for each type: the FP8 sum reaches k*2^8
    and must stay within f32's 2^24 (K3's output is that f32 sum); the int8
    sum of entries |x| <= 127 reaches k*127^2 < 2^31 (K4)."""
    return _MAX_K_INT8 if in_dtype == torch.int8 else _MAX_K


def fp8_gemm_plain(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor | None = None):
    """Plain PyTorch version of ``fp8_gemm``: the core route's exact f32
    product (``numerics.matmul_exact_fp8``), into ``out`` when given."""
    fp8_gemm_plain.calls += 1
    c = numerics.matmul_exact_fp8(a, b)
    return c if out is None else out.copy_(c)


fp8_gemm_plain.calls = 0


#: The kernel routes of ``csrc/residue_gemm.cu``.
ROUTES = ("wgmma", "mma_sync")


def residue_gemm_route(k: int, a_addr: int, b_addr: int) -> str:
    """The kernel route of one residue GEMM with contraction depth ``k`` over
    A at device address ``a_addr`` and K-major B^T at ``b_addr``: "wgmma"
    where TMA can address both (rows of k bytes at a 16-byte stride, bases
    16-byte aligned), else "mma_sync". m and n do not matter: the TMA boxes
    and the stores are masked at every edge."""
    return "wgmma" if k % 16 == 0 and a_addr % 16 == 0 and b_addr % 16 == 0 else "mma_sync"


@functools.cache
def _load(entry: str) -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return bind("residue_gemm.cu", entry, [ptr] * 3 + [i32] * 5 + [ptr])


def residue_gemm(kernel, plain, a, b, out, in_dtype: torch.dtype, out_dtype: torch.dtype):
    """Check and run one residue GEMM of ``csrc/residue_gemm.cu``: the entry
    ``<kernel.__name__>_launch`` on CUDA tensors (counted on
    ``kernel.launches`` and ``kernel.launches_by_route``), ``plain`` on CPU
    tensors. ``b`` (k, n) K-major or contiguous (any other strides raise);
    ``out`` (m, n) or None (allocated)."""
    name = kernel.__name__
    m, k = a.shape
    n = b.shape[1]
    kmajor = b.t().is_contiguous()
    if not (kmajor or b.is_contiguous()):
        raise ValueError(f"{name}: b must be contiguous or K-major (b.t() contiguous), "
                         f"got shape {tuple(b.shape)} strides {b.stride()}")
    named = [("a", a, in_dtype, (m, k)),
             ("b^T", b.t(), in_dtype, (n, k)) if kmajor else ("b", b, in_dtype, (k, n))]
    if out is not None:
        named.append(("out", out, out_dtype, (m, n)))
    dev = check_tensors(name, named)
    limit = max_k(in_dtype)
    if k > limit:
        raise ValueError(f"{name}: k = {k} exceeds {limit}, beyond which the "
                         "residue products are not kept exact")
    if dev.type == "cpu":
        return plain(a, b, out)
    lib = _load(f"{name}_launch")
    if out is None:
        out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if kmajor:
        bt = b.t()
    else:
        bt = b.t().contiguous()
        kernel.b_copies += 1
    route = residue_gemm_route(k, a.data_ptr(), bt.data_ptr())
    err = getattr(lib, f"{name}_launch")(a.data_ptr(), bt.data_ptr(), out.data_ptr(), m, n, k,
                                         int(route == "wgmma"), dev.index, stream(dev))
    raise_on_error(name, lib, err)
    kernel.launches += 1
    kernel.launches_by_route[route] += 1
    return out


def reset_counts(kernel) -> None:
    """Set a residue GEMM's launch counts and B copy count to 0."""
    kernel.launches = kernel.b_copies = 0
    kernel.launches_by_route = dict.fromkeys(ROUTES, 0)


@kernel_scope("fp8_gemm")
def fp8_gemm(a: torch.Tensor, b: torch.Tensor, *, out: torch.Tensor | None = None):
    """C = A @ B for e4m3 A (m, k), B (k, n) K-major or contiguous, as
    float32 (m, n), written into ``out`` when given. CUDA tensors run the
    kernel (or raise); CPU tensors run ``fp8_gemm_plain``."""
    return residue_gemm(fp8_gemm, fp8_gemm_plain, a, b, out, numerics.E4M3, torch.float32)


reset_counts(fp8_gemm)
