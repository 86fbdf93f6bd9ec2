"""Project-specific numerical-safety AST rules (the RPL rule pack), retargeted
to torch: the torch counterpart of ``repro/analysis/rules.py``, with the
reference's codes, names and messages.

Each rule encodes an invariant the type checkers and ruff cannot see: the
raw ``ldexp`` overflow, the ``sorted()`` fold-order break of bitwise
equality, host math inside traced functions, deprecated precision plumbing,
and products whose accumulator the backend may narrow (on the H100 a float32
``torch.matmul`` runs on TF32 tensor cores while
``torch.backends.cuda.matmul.allow_tf32`` is on).

A rule is metadata (code, summary, fix hint) plus a ``check`` callback run
against every in-scope file by :mod:`repro_torch.analysis.astlint`. Scopes
are the reference's with ``repro/`` -> ``repro_torch/``. Findings are
suppressible inline with the reference's marker

    # reprolint: disable=RPLxxx(reason)

where the reason string is REQUIRED: a bare ``disable=RPLxxx`` is itself a
finding (RPL000). The reference's engine, which lints every file under
``src/``, reads the same marker, so a suppression in the port must name a
code both packs know.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Iterator

PACKAGE = "repro_torch/"

#: Modules under the bitwise-equality contract (fused kernel == core,
#: distributed == single-device, paged == dense): reduction/fold order in
#: these is part of the interface. ``core/collectives.py`` folds a psum in
#: ascending rank order, so its order is the contract too.
BITWISE_CONTRACT_SCOPE = ("repro_torch/linalg/", "repro_torch/kernels/",
                          "repro_torch/core/plan.py", "repro_torch/core/collectives.py")

#: Packages whose functions run (or are traced) on device.
DEVICE_PATH_SCOPE = ("repro_torch/linalg/", "repro_torch/kernels/", "repro_torch/models/")

#: Packages where a literal ``2 ** e`` (or torch's ``exp2(e)`` /
#: ``pow(2.0, e)``) is almost certainly a scale factor with a tensor exponent.
NUMERIC_CORE_SCOPE = ("repro_torch/core/", "repro_torch/kernels/", "repro_torch/linalg/")

#: The one module allowed to touch raw ldexp and unpinned products: it owns
#: ``ldexp_wide`` and ``matmul_exact_fp8`` (which switches TF32 off).
NUMERICS_MODULE = "repro_torch/core/numerics.py"

#: np attributes that are dtype/constant accesses, not host math.
_NP_DTYPE_ATTRS = frozenset({
    "float64", "float32", "float16", "int64", "int32", "int16", "int8",
    "uint8", "bool_", "dtype", "inf", "nan", "pi", "newaxis", "ndarray",
})

#: Callables whose legacy ``scheme=``/``mode=`` kwargs are deprecation shims.
_LEGACY_KWARG_CALLEES = frozenset({"ozmm", "backend_matmul"})
_LEGACY_KWARGS = frozenset({"scheme", "mode", "num_moduli", "num_slices"})

#: torch's spellings of ``matmul``/``dot``/``dot_general``.
_MATMUL_ATTRS = frozenset({"matmul", "mm", "bmm", "dot"})
#: Methods that cast an operand to float64 or an integer dtype: the casts
#: that pin a product's accumulator (a float32 cast does not: TF32 may still
#: narrow that product on the card).
_PIN_METHODS = frozenset({"double", "long", "int", "short", "char", "byte"})
#: The dtypes that ``x.to(dtype)`` pins to.
_PIN_DTYPES = frozenset({
    "torch.float64", "torch.double", "torch.int64", "torch.long", "torch.int32",
    "torch.int", "torch.int16", "torch.short", "torch.int8", "torch.uint8",
})


def _dotted(node: ast.expr) -> str | None:
    """'torch.matmul' / 'torch.func.vmap' for a Name/Attribute chain."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _is_const_number(node: ast.expr) -> bool:
    """Literal numbers, incl. the ``-40`` in ``2.0 ** -40``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return True
    return (isinstance(node, ast.UnaryOp)
            and isinstance(node.op, (ast.USub, ast.UAdd))
            and _is_const_number(node.operand))


def _is_two(node: ast.expr) -> bool:
    return (isinstance(node, ast.Constant) and not isinstance(node.value, bool)
            and node.value in (2, 2.0))


def _in_scope(relpath: str, prefixes: tuple[str, ...]) -> bool:
    return any(relpath.startswith(p) or relpath == p.rstrip("/")
               for p in prefixes)


def _call_arg(node: ast.Call, pos: int, name: str) -> ast.expr | None:
    if len(node.args) > pos:
        return node.args[pos]
    return next((kw.value for kw in node.keywords if kw.arg == name), None)


@dataclasses.dataclass(frozen=True)
class Rule:
    code: str
    name: str
    summary: str
    fix_hint: str
    #: ``check(tree, relpath)`` yields ``(node, message)`` pairs.
    check: Callable[[ast.AST, str], Iterator[tuple[ast.AST, str]]]


# ---------------------------------------------------------------------------
# RPL001 — raw ldexp / 2**e scale application outside core/numerics.py
# ---------------------------------------------------------------------------
def _check_rpl001(tree: ast.AST, relpath: str):
    if relpath == NUMERICS_MODULE or not relpath.startswith(PACKAGE):
        return
    in_numeric_core = _in_scope(relpath, NUMERIC_CORE_SCOPE)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "ldexp"
                and _dotted(node.func.value) in ("torch", "np", "numpy")):
            # A constant exponent cannot overflow the 2.0**e materialization;
            # anything else (tensor exponents from scale frames) can.
            exp = _call_arg(node, 1, "other")
            if exp is not None and _is_const_number(exp):
                continue
            yield node, ("raw ldexp with a non-constant exponent: "
                         "torch.ldexp materializes 2.0**e as ONE float64, which "
                         "over/underflows for |e| >~ 1023 (denormal-range "
                         "scale frames reach ~1900)")
        elif not in_numeric_core:
            continue
        elif (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Pow)
                and _is_two(node.left) and not _is_const_number(node.right)):
            yield node, ("2.0 ** e with a non-constant exponent builds the "
                         "scale as one float64 factor — same overflow class "
                         "as raw ldexp")
        elif isinstance(node, ast.Call) and _dotted(node.func) in ("torch.exp2", "torch.pow"):
            pow_ = node.func.attr == "pow"
            base = _call_arg(node, 0, "input") if pow_ else None
            exp = _call_arg(node, 1, "exponent") if pow_ else _call_arg(node, 0, "input")
            if (pow_ and (base is None or not _is_two(base))) or exp is None \
                    or _is_const_number(exp):
                continue
            yield node, (f"{_dotted(node.func)}() of a non-constant exponent builds "
                         "the scale 2^e as one float64 factor — same overflow "
                         "class as raw ldexp")


# ---------------------------------------------------------------------------
# RPL002 — sorted()/set-iteration folds inside bitwise-contract modules
# ---------------------------------------------------------------------------
def _iter_sources(node: ast.AST):
    """Iteration sources of for-loops and comprehensions."""
    if isinstance(node, ast.For):
        yield node.iter
    elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                           ast.GeneratorExp)):
        for gen in node.generators:
            yield gen.iter


def _check_rpl002(tree: ast.AST, relpath: str):
    if not _in_scope(relpath, BITWISE_CONTRACT_SCOPE):
        return
    for node in ast.walk(tree):
        for src in _iter_sources(node):
            if (isinstance(src, ast.Call) and isinstance(src.func, ast.Name)
                    and src.func.id == "sorted"):
                yield src, ("iteration over sorted() keys in a "
                            "bitwise-contract module: key order is not the "
                            "elimination/accumulation order, so folds break "
                            "bitwise equality with the distributed path "
                            "(the trsm fold-order contract)")
            elif (isinstance(src, ast.Set)
                    or (isinstance(src, ast.Call)
                        and isinstance(src.func, ast.Name)
                        and src.func.id in ("set", "frozenset"))):
                yield src, ("iteration over a set in a bitwise-contract "
                            "module: set order is not a stable accumulation "
                            "order")


# ---------------------------------------------------------------------------
# RPL003 — host numpy math inside traced (device-path) functions
# ---------------------------------------------------------------------------
#: The reference's jax names, then torch's tracing decorators: torch.compile,
#: torch.jit.script/trace, torch.vmap, torch.library.custom_op/register_fake
#: (and anything under torch.func, below).
_TRACE_DECORATOR_NAMES = frozenset({"jit", "vmap", "pmap", "pallas_call",
                                    "shard_map", "custom_vjp", "checkpoint",
                                    "compile", "script", "trace", "custom_op",
                                    "register_fake"})


def _is_traced_def(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> bool:
    for dec in fn.decorator_list:
        for sub in ast.walk(dec):
            if isinstance(sub, ast.Attribute) and (
                    sub.attr in _TRACE_DECORATOR_NAMES
                    or (_dotted(sub) or "").startswith("torch.func.")):
                return True
            if isinstance(sub, ast.Name) and sub.id in _TRACE_DECORATOR_NAMES:
                return True
    return False


def _check_rpl003(tree: ast.AST, relpath: str):
    if not _in_scope(relpath, DEVICE_PATH_SCOPE):
        return
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not _is_traced_def(fn):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and _dotted(node.func.value) in ("np", "numpy")
                    and node.func.attr not in _NP_DTYPE_ATTRS):
                yield node, (f"host np.{node.func.attr}() inside a traced "
                             "function: under tracing this bakes a trace-time "
                             "constant (or fails on traced tensors) instead of "
                             "running on device")


# ---------------------------------------------------------------------------
# RPL004 — deprecated precision plumbing (legacy kwargs, bare GemmConfig)
# ---------------------------------------------------------------------------
def _check_rpl004(tree: ast.AST, relpath: str):
    if not relpath.startswith(PACKAGE):
        return
    if relpath.startswith("repro_torch/precision/") or relpath == "repro_torch/core/gemm.py":
        return  # where the reference keeps its shims; the port has none
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        callee = node.func.attr if isinstance(node.func, ast.Attribute) else (
            node.func.id if isinstance(node.func, ast.Name) else None)
        if callee == "GemmConfig":
            yield node, ("bare GemmConfig construction is a deprecated "
                         "PrecisionPolicy shim (the port declined the shims: "
                         "pass a policy)")
        elif callee in _LEGACY_KWARG_CALLEES:
            bad = [kw.arg for kw in node.keywords if kw.arg in _LEGACY_KWARGS]
            if bad:
                yield node, (f"deprecated kwarg(s) {', '.join(sorted(bad))}= "
                             f"on {callee}(): the legacy scheme/mode threading "
                             "(the port declined the shims: pass a policy)")


# ---------------------------------------------------------------------------
# RPL005 — matmul without an explicit accumulator dtype
# ---------------------------------------------------------------------------
def _is_pinned(node: ast.expr) -> bool:
    """``x.double()``, ``x.to(torch.float64)``, ``x.to(dtype=torch.int32)``,
    ...: an operand cast in the call expression to float64 or an integer
    dtype. ``x.float()`` / ``x.to(torch.float32)`` does not count."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
        return False
    if node.func.attr in _PIN_METHODS:
        return True
    return node.func.attr == "to" and any(
        _dotted(x) in _PIN_DTYPES for x in [*node.args, *(kw.value for kw in node.keywords)])


def _check_rpl005(tree: ast.AST, relpath: str):
    if not relpath.startswith(PACKAGE) or relpath == NUMERICS_MODULE:
        return
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        if node.func.attr not in _MATMUL_ATTRS or _dotted(node.func.value) != "torch":
            continue
        operands = node.args[:2]
        if len(operands) == 2 and all(_is_pinned(x) for x in operands):
            continue
        yield node, (f"{_dotted(node.func)}() without both operands cast to "
                     "float64 or an integer dtype: the exactness windows (e4m3 -> f32, "
                     "int8 -> int32, paper eq. (11)) hold only for a pinned "
                     "accumulator; on the H100 an unpinned float32 product runs "
                     "on TF32 tensor cores whenever "
                     "torch.backends.cuda.matmul.allow_tf32 is on")


RULES: dict[str, Rule] = {
    "RPL000": Rule(
        code="RPL000", name="bare-suppression",
        summary="inline suppression without a reason string",
        fix_hint="write `# reprolint: disable=RPLxxx(why this site is safe)` "
                 "— the reason is part of the suppression",
        check=lambda tree, relpath: iter(())),  # emitted by the engine itself
    "RPL001": Rule(
        code="RPL001", name="raw-ldexp",
        summary="raw torch.ldexp / 2.0**e / torch.exp2 / torch.pow(2.0, e) scale "
                "with non-constant exponent outside core/numerics.py",
        fix_hint="use repro_torch.core.numerics.ldexp_wide (splits the exponent "
                 "so each factor stays in float64 range)",
        check=_check_rpl001),
    "RPL002": Rule(
        code="RPL002", name="unstable-fold-order",
        summary="sorted()/set iteration in a bitwise-contract module "
                "(linalg/, kernels/, core/plan.py, core/collectives.py)",
        fix_hint="iterate in elimination/insertion order (dict order is the "
                 "fold contract), or prove order-independence and suppress "
                 "with the proof as the reason",
        check=_check_rpl002),
    "RPL003": Rule(
        code="RPL003", name="host-math-in-traced-fn",
        summary="host np. math inside a torch.compile/jit/vmap/custom_op-traced "
                "function in a device path (linalg/, kernels/, models/)",
        fix_hint="use the torch equivalent, or hoist the host computation out "
                 "of the traced function",
        check=_check_rpl003),
    "RPL004": Rule(
        code="RPL004", name="deprecated-precision-api",
        summary="legacy scheme=/mode= kwargs or bare GemmConfig construction",
        fix_hint="pass a PrecisionPolicy / spec string "
                 "(e.g. \"ozaki2-fp8/accurate@8\") instead",
        check=_check_rpl004),
    "RPL005": Rule(
        code="RPL005", name="unpinned-accumulator",
        summary="torch.matmul/mm/bmm/dot without both operands cast to float64 "
                "or an integer dtype, outside core/numerics.py (a float32 cast "
                "does not pin against TF32)",
        fix_hint="cast both operands in the call (.double(), "
                 ".to(torch.float64), ...) or go through core.numerics "
                 "(matmul_exact_fp8 switches TF32 off; matmul_exact_int8 "
                 "multiplies in f64)",
        check=_check_rpl005),
}
