"""Plan / quantize / execute split for the Ozaki-II emulated GEMM; the torch
counterpart of ``repro/core/plan.py``.

  qa = quantize_matrix(A, "lhs", ms, mode="fast")   # plan + quantize
  qb = quantize_matrix(B, "rhs", ms, mode="fast")
  C  = ozmm_prepared(qa, qb)                        # execute (reuses digits)

Fast-mode execution is bitwise-equal to ``ozmm``; accurate mode runs the
bound GEMM between the cached round-up casts and extracts residues at
pairing time, reproducing the unprepared path exactly.
``transpose_plan`` re-plans a plan's source transposed in the same role,
reusing its magnitude sketches (the backward primitive of ``core.gemm``).
``plan_from_arrays`` turns a JAX plan's leaves (as numpy arrays) into a
plan of this package, so a plan built by the reference executes here with
the same bits. ``plan_to_wire`` / ``plan_from_wire`` / ``wire_bytes`` are the
plan wire format of the distributed panel broadcasts (``core.distributed``,
``linalg.dist``), the reference's version 1 layout.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import crt, numerics, quantize, scaling
from .moduli import ModuliSet, make_moduli_set

ROLES = ("lhs", "rhs")
MODES = ("fast", "accurate")


@dataclasses.dataclass(frozen=True)
class OperandStats:
    """Magnitude sketches of one operand along both axes."""

    row_sq: Optional[torch.Tensor]   # (m,) sum of squares along axis 1
    row_max: Optional[torch.Tensor]  # (m,) abs-max along axis 1
    col_sq: Optional[torch.Tensor]   # (k,) sum of squares along axis 0
    col_max: Optional[torch.Tensor]  # (k,) abs-max along axis 0

    def transpose(self) -> "OperandStats":
        return OperandStats(self.col_sq, self.col_max, self.row_sq, self.row_max)


@dataclasses.dataclass(frozen=True)
class QuantizedMatrix:
    """A prepared Ozaki-II operand: plan metadata + cached quantization.

    ``role`` is "lhs" (rows scaled, contraction along axis 1) or "rhs"
    (columns scaled, contraction along axis 0). Fast mode caches ``lscale``
    and the per-modulus residue ``parts``; accurate mode caches the
    round-up e4m3 cast ``bar`` and its prescale ``lpre``.
    """

    role: str
    family: str
    num_moduli: int
    mode: str
    x: Optional[torch.Tensor]        # float64 source
    stats: Optional[OperandStats]
    lscale: Optional[torch.Tensor]   # fast mode: int32 scale exponents
    parts: Optional[tuple]           # fast mode: per-modulus residue parts
    lpre: Optional[torch.Tensor]     # accurate mode: prescale exponents
    bar: Optional[torch.Tensor]      # accurate mode: round-up e4m3 cast

    @property
    def ms(self) -> ModuliSet:
        return make_moduli_set(self.family, self.num_moduli)

    @property
    def shape(self) -> tuple[int, ...]:
        if self.x is not None:
            return tuple(self.x.shape)
        return tuple(self.parts[0][0].shape)  # residue parts mirror the operand

    @property
    def contract_dim(self) -> int:
        """Length of the contraction axis (k of the pairing GEMM)."""
        return self.shape[1] if self.role == "lhs" else self.shape[0]

    @property
    def device(self) -> torch.device:
        return (self.x if self.x is not None else self.parts[0][0]).device

    def drop_source(self) -> "QuantizedMatrix":
        """Shed the retained f64 source (fast mode only). Fast-mode execution
        reads only ``lscale``/``parts``; the slimmed plan cannot be
        transposed (backward) or used as a native fallback."""
        if self.mode != "fast":
            raise ValueError("accurate-mode plans need x for pairing-time "
                             "residue extraction; cannot drop it")
        return dataclasses.replace(self, x=None)

    @property
    def scale_stats(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(sq_norm, abs_max) along the contraction axis: the fast-mode
        scaling inputs and the accurate-mode clip guard."""
        if self.role == "lhs":
            return self.stats.row_sq, self.stats.row_max
        return self.stats.col_sq, self.stats.col_max


def operand_stats(x: torch.Tensor) -> OperandStats:
    """Both-axis magnitude sketches (row/col squared norms and abs-maxima)."""
    ax = x.abs()
    sq = x * x
    return OperandStats(sq.sum(dim=1), ax.amax(dim=1), sq.sum(dim=0), ax.amax(dim=0))


def quantize_matrix(x: torch.Tensor, role: str, ms: ModuliSet, *,
                    mode: str = "accurate",
                    stats: OperandStats | None = None) -> QuantizedMatrix:
    """Build the reusable quantization plan of one 2-D operand. ``stats``
    injects already-computed sketches (the transposed stats of a forward
    operand, or the cotangent's, inside the VJP), used as given."""
    if role not in ROLES:
        raise ValueError(f"role must be one of {ROLES}, got {role!r}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    x = x.to(torch.float64)
    if x.ndim != 2:
        raise ValueError(f"quantize_matrix needs a 2-D operand, got {tuple(x.shape)}")
    st = operand_stats(x) if stats is None else stats
    lscale = parts = lpre = bar = None
    if mode == "fast":
        k = x.shape[1] if role == "lhs" else x.shape[0]
        sq, mx = (st.row_sq, st.row_max) if role == "lhs" else (st.col_sq, st.col_max)
        lscale = scaling.fast_exponents(sq, mx, k, ms)
        parts = quantize.quantize_operand(
            x, lscale, 0 if role == "lhs" else 1, ms, pow2_tables(ms, x.device))
    else:
        lpre, bar = scaling.accurate_prescale(x, 1 if role == "lhs" else 0)
    return QuantizedMatrix(role=role, family=ms.family, num_moduli=ms.n,
                           mode=mode, x=x, stats=st, lscale=lscale,
                           parts=parts, lpre=lpre, bar=bar)


def transpose_plan(q: QuantizedMatrix) -> QuantizedMatrix:
    """Plan for ``q.x.T`` in the SAME role, reusing the magnitude sketches:
    the residue parts / bound cast are re-derived along the flipped scaling
    axis, the norm/max reductions are not. The backward primitive:
    dA = dC @ B^T pairs B^T as rhs with the forward rhs plan's row stats."""
    if q.x is None:
        raise ValueError("plan source was dropped (drop_source); transposing "
                         "needs the original operand")
    return quantize_matrix(q.x.T, q.role, q.ms, mode=q.mode, stats=q.stats.transpose())


def pow2_tables(ms: ModuliSet, device) -> torch.Tensor:
    """The (N, POW2_TABLE_LEN) int32 2^e-mod-p tables on ``device``."""
    return torch.as_tensor(ms.pow2_mod_tables, device=device)


def residue_products(pa, pb, ms: ModuliSet) -> list[torch.Tensor]:
    """Run the low-precision GEMM schedule on two per-modulus part tuples;
    return the centred residues C'_l. Per modulus: int8 1 GEMM; square
    p = s^2 3 GEMMs (eq. 12); Karatsuba 3 GEMMs (eq. 8/9)."""
    cs: list[torch.Tensor] = []
    for l, (p, sq, s) in enumerate(zip(ms.ps, ms.is_square, ms.split_s)):
        ap, bp = pa[l], pb[l]
        if ms.family == "int8":
            cparts = (numerics.matmul_exact_int8(ap[0], bp[0]),)
        elif sq:
            (a1, a2), (b1, b2) = ap, bp
            cparts = (numerics.matmul_exact_fp8(a1, b2),
                      numerics.matmul_exact_fp8(a2, b1),
                      numerics.matmul_exact_fp8(a2, b2))
        else:
            cparts = tuple(numerics.matmul_exact_fp8(x, y) for x, y in zip(ap, bp))
        cs.append(crt.combine_residue_product(cparts, p, sq, s, ms.family))
    return cs


# ---------------------------------------------------------------------------
# Wire format: plans as collective payloads (distributed HPL panel broadcast)
# ---------------------------------------------------------------------------
#
# A fast-mode plan executes from ``lscale`` + ``parts`` alone, so that IS the
# wire format: per-modulus 1-byte residue matrices plus one int32 exponent per
# scaled row/column. The f64 source, the sketches and the Karatsuba third
# part (hs = hi + lo, exact in e4m3 because |hs| <= 16) do not travel;
# receivers can execute the pairing but not transpose or re-pair the plan.
# Accurate-mode plans are pairing-coupled (the bound GEMM runs between both
# operands' casts, residues are extracted per pairing), so their wire carries
# the f64 source beside the cast, its prescale and the contraction-axis
# maxima: slightly MORE bytes than the f64 block it replaces.

#: Wire schema version (bump on layout changes); the reference's.
PLAN_WIRE_VERSION = 1


def plan_to_wire(q: QuantizedMatrix) -> tuple[dict, list[torch.Tensor]]:
    """Serialize a plan into ``(header, leaves)``: a small static dict
    (schema version, the plan's static fields, per-modulus part counts) and
    the flat list of tensors that travels. ``plan_from_wire`` inverts."""
    header = {"version": PLAN_WIRE_VERSION, "role": q.role,
              "family": q.family, "num_moduli": q.num_moduli, "mode": q.mode,
              "shape": tuple(int(s) for s in q.shape)}
    if q.mode == "fast":
        leaves: list[torch.Tensor] = [q.lscale]
        shipped: list[int] = []
        for part in q.parts:
            ship = part[:2] if len(part) == 3 else part  # Karatsuba hs is derivable
            shipped.append(len(ship))
            leaves.extend(ship)
        header["parts_per_modulus"] = tuple(shipped)
        return header, leaves
    mx = q.stats.row_max if q.role == "lhs" else q.stats.col_max
    return header, [q.x, q.lpre, q.bar, mx]


def plan_from_wire(header: dict, leaves: list[torch.Tensor]) -> QuantizedMatrix:
    """Rebuild an execute-only plan from a received payload: its pairing is
    bitwise equal to the owner plan's, but it cannot be transposed or
    re-paired under another mode. Raises on a schema version mismatch."""
    if header.get("version") != PLAN_WIRE_VERSION:
        raise ValueError(f"plan wire version mismatch: {header.get('version')}"
                         f" != {PLAN_WIRE_VERSION}")
    ms = make_moduli_set(header["family"], header["num_moduli"])
    role, mode = header["role"], header["mode"]
    if mode == "fast":
        lscale, rest = leaves[0], leaves[1:]
        parts: list[tuple[torch.Tensor, ...]] = []
        i = 0
        for n_ship, sq in zip(header["parts_per_modulus"], ms.is_square):
            part = tuple(rest[i:i + n_ship])
            i += n_ship
            if ms.family != "int8" and not sq:
                hi, lo = part
                # hs = hi + lo is exact: |hs| <= 16 sits in e4m3's integer window
                part = (hi, lo, (hi.to(torch.float32) + lo.to(torch.float32)).to(hi.dtype))
            parts.append(part)
        return QuantizedMatrix(role=role, family=ms.family, num_moduli=ms.n,
                               mode=mode, x=None, stats=None, lscale=lscale,
                               parts=tuple(parts), lpre=None, bar=None)
    x, lpre, bar, mx = leaves
    st = (OperandStats(None, mx, None, None) if role == "lhs"
          else OperandStats(None, None, None, mx))
    return QuantizedMatrix(role=role, family=ms.family, num_moduli=ms.n,
                           mode=mode, x=x, stats=st, lscale=None, parts=None,
                           lpre=lpre, bar=bar)


def wire_bytes(leaves) -> int:
    """Payload size of a wire leaf list (what one broadcast hop moves); an
    e4m3 or int8 leaf counts one byte an element."""
    return int(sum(t.numel() * t.element_size() for t in leaves))


def _check_pair(qa: QuantizedMatrix, qb: QuantizedMatrix) -> ModuliSet:
    if qa.role != "lhs" or qb.role != "rhs":
        raise ValueError(f"ozmm_prepared needs (lhs, rhs), got ({qa.role}, {qb.role})")
    if (qa.family, qa.num_moduli, qa.mode) != (qb.family, qb.num_moduli, qb.mode):
        raise ValueError(
            "operand plans disagree: "
            f"({qa.family}, {qa.num_moduli}, {qa.mode}) vs "
            f"({qb.family}, {qb.num_moduli}, {qb.mode})")
    if qa.shape[1] != qb.shape[0]:
        raise ValueError(f"contraction mismatch {qa.shape} @ {qb.shape}")
    return qa.ms


def pair_exponents(qa: QuantizedMatrix, qb: QuantizedMatrix):
    """Scale exponents (lmu, lnu) of the pairing: cached in fast mode; the
    single bound GEMM between the cached round-up casts in accurate mode."""
    ms = _check_pair(qa, qb)
    if qa.mode == "fast":
        return qa.lscale, qb.lscale
    k = qa.x.shape[1]
    cbar = scaling.bound_gemm_inflate(numerics.matmul_exact_fp8(qa.bar, qb.bar), k)
    lmu = scaling.accurate_exponents(cbar.amax(dim=1), qa.lpre, qa.stats.row_max, ms)
    lnu = scaling.accurate_exponents(cbar.amax(dim=0), qb.lpre, qb.stats.col_max, ms)
    return lmu, lnu


def pair_scales(qa: QuantizedMatrix, qb: QuantizedMatrix):
    """Resolve the pairing: (lmu, lnu, parts_a, parts_b). Fast mode returns
    the cached exponents and residues; accurate mode derives the exponents
    by the bound GEMM and extracts residues for this pairing."""
    ms = _check_pair(qa, qb)
    lmu, lnu = pair_exponents(qa, qb)
    if qa.mode == "fast":
        return lmu, lnu, qa.parts, qb.parts
    tables = pow2_tables(ms, qa.x.device)
    return (lmu, lnu, quantize.quantize_operand(qa.x, lmu, 0, ms, tables),
            quantize.quantize_operand(qb.x, lnu, 1, ms, tables))


def ozmm_prepared(qa: QuantizedMatrix, qb: QuantizedMatrix) -> torch.Tensor:
    """Execute the emulated GEMM from two prepared operands: bitwise equal to
    ``ozmm_ozaki2(a, b)`` in fast mode, exactly reproduced in accurate mode."""
    ms = _check_pair(qa, qb)
    lmu, lnu, parts_a, parts_b = pair_scales(qa, qb)
    digits = crt.garner_digits(residue_products(parts_a, parts_b, ms), ms)
    return crt.reconstruct(digits, ms, lmu, lnu)


# ---------------------------------------------------------------------------
# Interchange with the JAX package
# ---------------------------------------------------------------------------

def _tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> tensor; ml_dtypes' float8_e4m3fn (which numpy knows only as
    an opaque 1-byte type) travels as its uint8 bit pattern."""
    a = np.array(a)  # a writable, contiguous copy (JAX hands out read-only views)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(numerics.E4M3).to(device)
    return torch.from_numpy(a).to(device)


def plan_from_arrays(role: str, family: str, num_moduli: int, mode: str,
                     arrays: dict[str, np.ndarray], *, device="cpu") -> QuantizedMatrix:
    """Rebuild a plan from a JAX ``QuantizedMatrix``'s leaves as numpy arrays.

    Keys: ``x``, ``row_sq``, ``row_max``, ``col_sq``, ``col_max``,
    ``lscale``, ``lpre``, ``bar`` (absent leaves may be left out), and one
    ``parts.<l>.<i>`` per residue part (modulus l in selection order, part i
    of that modulus' tuple). A fast-mode plan built by ``repro`` executes
    here with the same bits.
    """
    ms = make_moduli_set(family, num_moduli)
    if role not in ROLES or mode not in MODES:
        raise ValueError(f"bad plan metadata: role={role!r}, mode={mode!r}")

    def get(key):
        return _tensor_from_numpy(arrays[key], device) if key in arrays else None

    stats = OperandStats(get("row_sq"), get("row_max"), get("col_sq"), get("col_max"))
    parts = None
    if any(key.startswith("parts.") for key in arrays):
        parts = tuple(
            tuple(get(f"parts.{l}.{i}") for i in range(_count_parts(arrays, l)))
            for l in range(ms.n))
    return QuantizedMatrix(role=role, family=family, num_moduli=num_moduli,
                           mode=mode, x=get("x"), stats=stats,
                           lscale=get("lscale"), parts=parts,
                           lpre=get("lpre"), bar=get("bar"))


def _count_parts(arrays: dict, l: int) -> int:
    n = 0
    while f"parts.{l}.{n}" in arrays:
        n += 1
    if n == 0:
        raise ValueError(f"plan arrays hold no parts for modulus {l}")
    return n
