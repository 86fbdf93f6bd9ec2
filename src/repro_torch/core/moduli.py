"""Moduli selection for the Ozaki-II scheme (paper §II, §III-B, §III-D).

A copy of ``repro/core/moduli.py``: importing that module would run
``repro/core/__init__.py``, which imports JAX, and this package never does.
Keep the two in step; ``tests/test_torch_core.py`` holds every constant here
equal to the reference's.

All constants here are exact Python integers. The three families:

* ``INT8``      — pairwise-coprime integers greedily selected descending from
                  256 (residues fit INT8; one INT8 GEMM per modulus).
* ``FP8_KARATSUBA`` — descending from 513 (residues ≤ 256 in magnitude, split
                  into two e4m3 matrices with s = 16; 3 FP8 GEMMs per modulus
                  via Karatsuba, eq. (9)).
* ``FP8_HYBRID``  — the paper's contribution (§III-D): squares
                  {1089, 1024, 961, 841, 625, 529} first (3 FP8 GEMMs each via
                  the modular-reduction identity eq. (12), s = sqrt(p)), then
                  Karatsuba moduli from 511 downward.

Garner (mixed-radix CRT) constants are derived here as exact ints and exported
as numpy arrays for the reconstruction and the CUDA kernel. The single even modulus of
each family is placed FIRST in the radix order so that the asymmetric centred
digit range of an even modulus (| [-p/2, p/2-1] |) shifts the representable
balanced window by less than one integer (DESIGN.md invariant I5).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Literal, Sequence

import numpy as np

Family = Literal["int8", "fp8-karatsuba", "fp8-hybrid"]

#: Exponent-table length for the power-of-two residue tables (quantize step).
#: Covers scaled integers up to 2**(POW2_TABLE_LEN - 1); scaling is capped so
#: that exponents stay within range (see scaling.MAX_LOG2_SCALE).
POW2_TABLE_LEN = 1024

# Karatsuba split radix (paper §III-B): residue = 16*hi + lo.
KARATSUBA_S = 16


def greedy_coprime(start: int, count: int, *, preselected: Sequence[int] = ()) -> list[int]:
    """Greedily select ``count`` pairwise-coprime integers descending from ``start``.

    ``preselected`` values are treated as already chosen (they constrain
    coprimality but are not re-emitted).
    """
    chosen: list[int] = list(preselected)
    out: list[int] = []
    c = start
    while len(out) < count:
        if c < 2:
            raise ValueError(f"ran out of coprime candidates below {start}")
        if all(math.gcd(c, q) == 1 for q in chosen):
            chosen.append(c)
            out.append(c)
        c -= 1
    return out


def _square_candidates(hi_root: int, lo_exclusive: int) -> list[int]:
    """Pairwise-coprime squares, descending, with value > ``lo_exclusive``."""
    chosen: list[int] = []
    for r in range(hi_root, 1, -1):
        sq = r * r
        if sq <= lo_exclusive:
            break
        if all(math.gcd(sq, q) == 1 for q in chosen):
            chosen.append(sq)
    return chosen


@functools.lru_cache(maxsize=None)
def family_moduli(family: Family, count: int) -> tuple[int, ...]:
    """The first ``count`` moduli of a family, in the paper's selection order."""
    if family == "int8":
        return tuple(greedy_coprime(256, count))
    if family == "fp8-karatsuba":
        return tuple(greedy_coprime(513, count))
    if family == "fp8-hybrid":
        squares = _square_candidates(33, 511)  # -> [1089, 1024, 961, 841, 625, 529]
        if count <= len(squares):
            return tuple(squares[:count])
        rest = greedy_coprime(511, count - len(squares), preselected=squares)
        return tuple(squares + rest)
    raise ValueError(f"unknown family {family!r}")


def min_moduli_for_bits(family: Family, bits: int) -> int:
    """Smallest N with log2(P/2) > ``bits`` (paper: FP64 needs bits = 106)."""
    n = 1
    while True:
        ps = family_moduli(family, n)
        p = math.prod(ps)
        if math.log2(p) - 1.0 > bits:
            return n
        n += 1


@dataclasses.dataclass(frozen=True)
class ModuliSet:
    """A fixed, hashable selection of moduli plus derived CRT constants.

    Hashability matters: instances are closed over / passed as static
    arguments to jitted functions.
    """

    family: Family
    ps: tuple[int, ...]  # selection order (largest first)

    # ---- basic derived quantities (exact Python ints) ----
    @property
    def n(self) -> int:
        return len(self.ps)

    @functools.cached_property
    def P(self) -> int:  # noqa: N802 - paper notation
        return math.prod(self.ps)

    @functools.cached_property
    def log2_half_P(self) -> float:
        """log2(P/2): the effective-bit budget (paper Table II)."""
        return math.log2(self.P) - 1.0

    @functools.cached_property
    def is_square(self) -> tuple[bool, ...]:
        return tuple(math.isqrt(p) ** 2 == p and self.family == "fp8-hybrid" for p in self.ps)

    @functools.cached_property
    def split_s(self) -> tuple[int, ...]:
        """Per-modulus split radix: sqrt(p) for square moduli else 16."""
        return tuple(math.isqrt(p) if sq else KARATSUBA_S for p, sq in zip(self.ps, self.is_square))

    @functools.cached_property
    def num_lowprec_matmuls_fast(self) -> int:
        """Paper Table II: N for int8, 3N for fp8."""
        return self.n if self.family == "int8" else 3 * self.n

    @property
    def num_lowprec_matmuls_accurate(self) -> int:
        return self.num_lowprec_matmuls_fast + 1

    @functools.cached_property
    def num_split_matrices(self) -> int:
        """M_N of eq. (17): FP8 residue matrices per input (2 per square
        modulus, 3 per Karatsuba modulus); N for int8."""
        if self.family == "int8":
            return self.n
        return sum(2 if sq else 3 for sq in self.is_square)

    # ---- Garner / balanced mixed-radix constants ----
    @functools.cached_property
    def radix_order(self) -> tuple[int, ...]:
        """Indices into ``ps`` giving the Garner digit order (even modulus first)."""
        evens = [i for i, p in enumerate(self.ps) if p % 2 == 0]
        odds = [i for i, p in enumerate(self.ps) if p % 2 == 1]
        assert len(evens) <= 1, "families contain at most one even modulus"
        return tuple(evens + odds)

    @functools.cached_property
    def radix_ps(self) -> tuple[int, ...]:
        return tuple(self.ps[i] for i in self.radix_order)

    @functools.cached_property
    def garner_inv(self) -> np.ndarray:
        """inv[j, i] = (p_j)^-1 mod p_i for j < i in radix order, int32."""
        ps = self.radix_ps
        n = len(ps)
        inv = np.zeros((n, n), dtype=np.int32)
        for i in range(n):
            for j in range(i):
                inv[j, i] = pow(ps[j], -1, ps[i])
        return inv

    @functools.cached_property
    def radix_weights_f64(self) -> np.ndarray:
        """W_i = prod_{j<i} p_j (radix order), correctly-rounded to float64."""
        ps = self.radix_ps
        w, acc = [], 1
        for p in ps:
            w.append(float(acc))  # Python int -> float64 is correctly rounded
            acc *= p
        return np.asarray(w, dtype=np.float64)

    @functools.cached_property
    def radix_weights_exact(self) -> tuple[int, ...]:
        ps = self.radix_ps
        w, acc = [], 1
        for p in ps:
            w.append(acc)
            acc *= p
        return tuple(w)

    @functools.cached_property
    def pow2_mod_tables(self) -> np.ndarray:
        """tables[l, e] = 2^e mod ps[l] (selection order), int32, e < POW2_TABLE_LEN."""
        out = np.zeros((self.n, POW2_TABLE_LEN), dtype=np.int32)
        for l, p in enumerate(self.ps):
            v = 1 % p
            for e in range(POW2_TABLE_LEN):
                out[l, e] = v
                v = (v * 2) % p
        return out

    @functools.cached_property
    def centered_half(self) -> tuple[int, ...]:
        """Residues are centred into [-h_p, h_p] (odd p, h=(p-1)/2) or
        [-p/2, p/2-1] (even p). Value = largest positive representative."""
        return tuple((p - 1) // 2 for p in self.ps)

    def validate(self) -> None:
        for i, p in enumerate(self.ps):
            for q in self.ps[i + 1:]:
                assert math.gcd(p, q) == 1, (p, q)
        if self.family == "int8":
            assert all(p <= 256 for p in self.ps)
        else:
            for p, sq in zip(self.ps, self.is_square):
                assert p <= (1089 if sq else 513), p


@functools.lru_cache(maxsize=None)
def make_moduli_set(family: Family, num_moduli: int) -> ModuliSet:
    ms = ModuliSet(family=family, ps=family_moduli(family, num_moduli))
    ms.validate()
    return ms


# Defaults matching the paper's FP64-emulation operating points (Table II).
DEFAULT_NUM_MODULI = {"int8": 14, "fp8-karatsuba": 13, "fp8-hybrid": 12}
