"""The phase-split emulated GEMM on the kernel route (the torch counterpart
of ``repro/kernels/pipeline.py``), the ``+pallas+unfused`` executor:

  quant_residues_f64 (K6, fused over moduli, from the f64 operand)  ->  the
  fp8 (K3) or int8 (K4) GEMM schedule  ->  requant_garner (K5, on to the
  f64 C).

Every phase is exact, so the digits, and the f64 result, equal the core
route's (``core.ozaki2.ozmm_ozaki2``) and the fused kernels' bit for bit.
B's residue parts are made K-major, (N, n, k), since the GEMMs' tensor-core
instructions take 8-bit operands only K-major: K6 runs on B^T
(``common.k_major``, one f64 copy; the residues are elementwise under a
per-column exponent, so these are B's parts transposed, bit for bit), and
a fast-mode plan's (N, k, n) stacks go through K2's ``transpose_parts``
once per call. Each
GEMM then reads B^T's plane in place, as the K-major view ``plane.t()``: no
B is copied in the schedule. Between the phases the residue parts
(N, m, k) / (N, n, k) and the product stacks (N, m, n) live in device
memory: 9 GiB of f32 products at 8192^3 and N = 12, written in place by
the GEMMs, with no pad or stack copy. The epilogue, a
Kahan sum over the digits and ``ldexp_wide``, is the reference's XLA
epilogue (``reconstruct_f64``; the TPU has no f64): here K5 runs it on the
card, after the digits, so no digit plane is written; on CPU tensors K5's
plain version is ``crt.reconstruct`` of the plain digits.

``ozmm_pallas`` takes 2-D operands (``core.gemm`` batches over leading
dims); ``ozmm_pallas_prepared`` composes with ``core.plan``.
"""
from __future__ import annotations

import torch

from repro_torch.core import scaling
from repro_torch.core.moduli import DEFAULT_NUM_MODULI, ModuliSet, make_moduli_set
from repro_torch.core.plan import QuantizedMatrix, pair_exponents

from .common import k_major, row_major, stack_parts
from .crt_reconstruct import requant_garner
from .fp8_gemm import fp8_gemm
from .fused import transpose_parts
from .int8_gemm import int8_gemm
from .quant_residues import quant_residues_op


def residue_gemms(sa, sbt, ms: ModuliSet) -> tuple[torch.Tensor, ...]:
    """The low-precision GEMM schedule over stacked residue operands, A's
    (N, m, k) and B's K-major (N, n, k), in the reference's order, each
    product written into its plane of the product stacks: (c1, c2, c3)
    float32 (N, m, n) for the fp8 families, (c,) int32 for int8."""
    if ms.family == "int8":
        m, n = sa.shape[1], sbt.shape[1]
        cs = torch.empty((ms.n, m, n), dtype=torch.int32, device=sa.device)
        for l in range(ms.n):
            int8_gemm(sa[l], sbt[l].t(), out=cs[l])
        return (cs,)
    a_hi, a_lo, a_hs = sa
    b_hi, b_lo, b_hs = (t.transpose(1, 2) for t in sbt)  # (N, k, n) K-major views
    m, n = a_hi.shape[1], b_hi.shape[2]
    c1, c2, c3 = torch.empty((3, ms.n, m, n), dtype=torch.float32, device=a_hi.device)
    for l, sq in enumerate(ms.is_square):
        if sq:  # eq. (12) schedule: A1B2, A2B1, A2B2
            fp8_gemm(a_hi[l], b_lo[l], out=c1[l])
            fp8_gemm(a_lo[l], b_hi[l], out=c2[l])
            fp8_gemm(a_lo[l], b_lo[l], out=c3[l])
        else:  # eq. (8) schedule: A1B1, A2B2, (A1+A2)(B1+B2)
            fp8_gemm(a_hi[l], b_hi[l], out=c1[l])
            fp8_gemm(a_lo[l], b_lo[l], out=c2[l])
            fp8_gemm(a_hs[l], b_hs[l], out=c3[l])
    return c1, c2, c3


def _gemm_schedule(sa, sbt, ms: ModuliSet, lmu: torch.Tensor, lnu: torch.Tensor
                   ) -> torch.Tensor:
    """The GEMM schedule, then one requant/Garner pass on to C (m, n) f64."""
    return requant_garner(residue_gemms(sa, sbt, ms), ms=ms, lmu=lmu, lnu=lnu)


def ozmm_pallas(a: torch.Tensor, b: torch.Tensor, *, family: str = "fp8-hybrid",
                num_moduli: int | None = None, mode: str = "accurate") -> torch.Tensor:
    """Emulated FP64 matmul of 2-D tensors on the phase-split kernel path,
    on their device. Bitwise-equal to ``core.ozaki2.ozmm_ozaki2``."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"ozmm_pallas takes 2-D operands, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    ms = make_moduli_set(family, num_moduli or DEFAULT_NUM_MODULI[family])
    a = a.to(torch.float64)
    b = b.to(torch.float64)
    scal = scaling.compute_scaling(a, b, ms, mode)
    sa = quant_residues_op(row_major(a), scal.lmu, ms=ms, axis=0)
    sbt = quant_residues_op(k_major(b), scal.lnu, ms=ms, axis=0)  # (N, n, k)
    return _gemm_schedule(sa, sbt, ms, scal.lmu, scal.lnu)


def ozmm_pallas_prepared(qa: QuantizedMatrix, qb: QuantizedMatrix) -> torch.Tensor:
    """Execute a prepared pairing (``core.plan``) on the phase-split kernel
    path, on the plans' device. Fast mode streams the plans' cached residue
    parts (``stack_parts``; B's made K-major by ``transpose_parts``) through
    the GEMM schedule; accurate mode derives the pairing exponents from the
    cached casts (``pair_exponents``: the bound GEMM, an f32 ``torch.matmul``
    outside any kernel) and extracts the residues with K6, B's from B^T.
    Bitwise equal to ``ozmm_prepared`` in both modes."""
    ms = qa.ms
    lmu, lnu = pair_exponents(qa, qb)
    if qa.mode == "fast":
        sa = stack_parts(qa.parts, ms)
        sbt = transpose_parts(stack_parts(qb.parts, ms), ms=ms)
    else:
        sa = quant_residues_op(qa.x, lmu, ms=ms, axis=0)
        sbt = quant_residues_op(k_major(qb.x), lnu, ms=ms, axis=0)
    return _gemm_schedule(sa, sbt, ms, lmu, lnu)
