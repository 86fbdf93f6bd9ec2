"""``PrecisionPolicy``: how one emulated matmul runs (scheme family x
fast/accurate mode x modulus count x executor). The torch counterpart of
``repro/precision/policy.py``; spec strings round-trip to the same ``spec``
as the reference, so results of the two packages compare policy by policy::

    "ozaki2-fp8/accurate@8"     scheme / mode @ num_moduli
    "ozaki2-int8/fast"          paper-default modulus count
    "ozaki1-fp8/accurate@11"    @N is num_slices for the Ozaki-I scheme
    "native"                    plain matmul (mode/@N not meaningful)
    "ozaki2-fp8/fast+pallas"    '+' flags: backend/interpret/plan-cache knobs
    "ozaki2-fp8/fast+pallas+unfused"  phase-split kernels (fused is default)

Grammar::

    spec  ::= scheme [ "/" mode ] [ "@" int ] { "+" flag }
    mode  ::= "fast" | "accurate"
    flag  ::= "core" | "pallas" | "unfused"
            | "interpret" | "compiled" | "nocache"

The flag names are the reference's. In this package ``pallas`` selects the
kernel route (the hand-written Hopper kernels; their plain PyTorch versions
on CPU tensors), ``interpret`` asks for those plain versions and
``compiled`` for the kernels; which one runs follows from the tensors'
device, and ``ozmm`` refuses a flag that contradicts it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

#: Every emulation scheme the reference routes (paper Table II + native).
SCHEMES = ("native", "ozaki2-fp8", "ozaki2-karatsuba", "ozaki2-int8", "ozaki1-fp8")

#: Moduli family backing each Ozaki-II scheme.
OZAKI2_FAMILY = {
    "ozaki2-fp8": "fp8-hybrid",
    "ozaki2-karatsuba": "fp8-karatsuba",
    "ozaki2-int8": "int8",
}

#: Paper default slice count for Ozaki-I (FP64-grade).
DEFAULT_NUM_SLICES = 11

MODES = ("fast", "accurate")
BACKENDS = ("auto", "core", "pallas")


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """``scheme``/``mode``/``num_moduli``/``num_slices`` select the paper
    operating point; ``backend`` picks the executor (``"core"`` torch path,
    ``"pallas"`` kernel route, ``"auto"`` = the kernel route on a Hopper
    card for Ozaki-II schemes, core elsewhere); ``fused`` selects the
    single fused kernel (default) over the phase-split pipeline;
    ``interpret`` pins the kernels' plain versions (True) or the kernels
    (False); ``cache_plans`` gates long-lived operand-plan reuse."""

    scheme: str = "native"
    mode: str = "accurate"
    num_moduli: Optional[int] = None
    num_slices: int = DEFAULT_NUM_SLICES
    backend: str = "auto"
    fused: bool = True
    interpret: Optional[bool] = None
    cache_plans: bool = True

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {self.scheme!r}; expected one of {SCHEMES}")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.num_moduli is not None and self.num_moduli < 1:
            raise ValueError(f"num_moduli must be >= 1, got {self.num_moduli}")
        if self.num_slices < 2:
            raise ValueError(f"num_slices must be >= 2, got {self.num_slices}")
        if self.backend == "pallas" and self.scheme not in OZAKI2_FAMILY:
            raise ValueError(
                f"backend='pallas' needs an Ozaki-II scheme (it routes the "
                f"fused emulation kernel by default, or the phase-split "
                f"pipeline under '+unfused'), got {self.scheme!r}")
        if not self.fused and (self.backend == "core"
                               or self.scheme not in OZAKI2_FAMILY):
            raise ValueError(
                "'+unfused' selects the phase-split kernels and is only "
                "meaningful for an Ozaki-II scheme with the pallas backend "
                "(explicit '+pallas' or auto); drop the flag or use '+pallas'")

    @property
    def is_emulated(self) -> bool:
        return self.scheme != "native"

    @property
    def supports_plans(self) -> bool:
        """Whether operands can be prepared once and reused (Ozaki-II only)."""
        return self.scheme in OZAKI2_FAMILY

    @property
    def plans_enabled(self) -> bool:
        """Plan reuse both supported by the scheme AND allowed by the policy
        (``cache_plans``): the predicate the linalg block caches gate on."""
        return self.supports_plans and self.cache_plans

    @property
    def family(self) -> Optional[str]:
        """Moduli family backing the scheme (None for native/ozaki1)."""
        return OZAKI2_FAMILY.get(self.scheme)

    def moduli_set(self):
        if not self.supports_plans:
            raise ValueError(f"scheme {self.scheme!r} has no moduli set")
        from repro_torch.core.moduli import DEFAULT_NUM_MODULI, make_moduli_set

        family = OZAKI2_FAMILY[self.scheme]
        return make_moduli_set(family, self.num_moduli or DEFAULT_NUM_MODULI[family])

    @property
    def spec(self) -> str:
        """Compact canonical string; ``parse_policy(p.spec) == p``."""
        if self.scheme == "native":
            s = "native" if self.mode == "accurate" else f"native/{self.mode}"
        elif self.scheme == "ozaki1-fp8":
            s = f"{self.scheme}/{self.mode}"
            if self.num_slices != DEFAULT_NUM_SLICES:
                s += f"@{self.num_slices}"
        else:
            s = f"{self.scheme}/{self.mode}"
            if self.num_moduli is not None:
                s += f"@{self.num_moduli}"
        if self.backend != "auto":
            s += f"+{self.backend}"
        if not self.fused:
            s += "+unfused"
        if self.interpret is not None:
            s += "+interpret" if self.interpret else "+compiled"
        if not self.cache_plans:
            s += "+nocache"
        return s

    def __str__(self) -> str:
        return self.spec

    def resolve_for(self, a, b, target_rel_err: float, *, k: Optional[int] = None,
                    spread_log2: Optional[float] = None) -> "PrecisionPolicy":
        """Pick the smallest ``num_moduli`` predicted to meet
        ``target_rel_err`` (in the |A||B|-normalized metric) for operands
        ``a`` @ ``b``; see ``repro_torch.precision.resolve`` for the estimator."""
        from .resolve import resolve_num_moduli

        n = resolve_num_moduli(self, a, b, target_rel_err, k=k,
                               spread_log2=spread_log2)
        return dataclasses.replace(self, num_moduli=n)


#: The context default when nothing was requested anywhere: plain matmul.
NATIVE = PrecisionPolicy()

_FLAG_FIELDS = {
    "core": ("backend", "core"),
    "pallas": ("backend", "pallas"),
    "unfused": ("fused", False),
    "interpret": ("interpret", True),
    "compiled": ("interpret", False),
    "nocache": ("cache_plans", False),
}


def parse_policy(spec: str) -> PrecisionPolicy:
    """Parse a policy spec string (grammar in the module docstring)."""
    if not isinstance(spec, str):
        raise TypeError(f"policy spec must be a string, got {type(spec).__name__}")
    body, *flags = spec.strip().split("+")
    kw: dict = {}
    for flag in flags:
        if flag not in _FLAG_FIELDS:
            raise ValueError(
                f"unknown policy flag {flag!r} in {spec!r}; "
                f"expected one of {sorted(_FLAG_FIELDS)}")
        field, value = _FLAG_FIELDS[flag]
        if field in kw:
            raise ValueError(f"conflicting {field!r} flags in {spec!r}")
        kw[field] = value
    body, at, arity = body.partition("@")
    scheme, slash, mode = body.partition("/")
    scheme = scheme.strip()
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r} in policy spec {spec!r}; "
                         f"expected one of {SCHEMES}")
    if slash:
        kw["mode"] = mode.strip()
    if at:
        try:
            n = int(arity)
        except ValueError:
            raise ValueError(f"non-integer arity {arity!r} in policy spec {spec!r}") from None
        if scheme == "native":
            raise ValueError(f"native takes no @arity (got {spec!r})")
        kw["num_slices" if scheme == "ozaki1-fp8" else "num_moduli"] = n
    return PrecisionPolicy(scheme=scheme, **kw)


def coerce_policy(obj) -> PrecisionPolicy:
    """Normalize a policy-ish value: spec strings parse, policies pass."""
    if isinstance(obj, PrecisionPolicy):
        return obj
    if isinstance(obj, str):
        return parse_policy(obj)
    raise TypeError(f"expected a PrecisionPolicy or a policy spec string; "
                    f"got {type(obj).__name__}")
