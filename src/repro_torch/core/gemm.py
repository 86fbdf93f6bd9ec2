"""Public emulated-GEMM API of the port (the torch counterpart of
``repro/core/gemm.py``): ``ozmm``, ``backend_matmul``, ``prepare_operand``,
``default_num_moduli`` and the executor choice ``_resolve_backend``.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"`` and raises when no CUDA device exists; it
never falls back to the CPU. The tests pass ``device="cpu"``.

Executors of an Ozaki-II policy: the core torch path (``ozmm_ozaki2``,
``ozmm_prepared`` for prepared operands) or the kernel route: the fused
kernels by default (``ozmm_pallas_fused``, ``ozmm_pallas_fused_prepared``),
the phase-split pipeline under ``+unfused`` (``ozmm_pallas``,
``ozmm_pallas_prepared``); the Hopper kernels on CUDA tensors, their plain
versions on CPU tensors. ``backend="auto"`` takes the kernel route on a
compute-capability-9.0 card and core elsewhere. Ozaki-I (``ozaki1-fp8``)
runs on the core executor, as in the reference.

Gradients: naive autodiff would differentiate trunc/mod (zero a.e.); the
true derivative of an exact-product emulation is the matmul derivative, and
the cotangent products dA = dC @ B^T, dB = A^T @ dC are themselves emulated
DGEMMs. On the core route the backward reuses the forward plans
(``_PlannedVJP``, the reference's ``_ozmm_fwd``/``_ozmm_bwd``); on the
kernel route (``_UnpreparedVJP``, the reference's ``_ozmm_pallas_guarded``)
an explicit ``+pallas`` is forward-only and raises, while the auto-derived
route runs the two cotangent products as unprepared emulated GEMMs through
the executor the forward resolved to (on the H100 the kernels; the
reference runs them on its core path, and both routes give the same bits).
Ozaki-I differentiates the same way, on core. The emulated-GEMM counters
(``repro_torch.obs.metrics``) count one call per ``ozmm``; the backward
records nothing, as in the reference. Under ``product_store_contexts``
(a layer's ``remat="dots"`` checkpoint) the forward products are kept and
replayed in the recompute instead of being computed again.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools

import torch

from repro_torch.obs.metrics import metrics_enabled, record_gemm_call
from repro_torch.precision.context import resolve_policy
from repro_torch.precision.policy import (DEFAULT_NUM_SLICES, OZAKI2_FAMILY, SCHEMES,
                                          PrecisionPolicy)

from .moduli import DEFAULT_NUM_MODULI, ModuliSet
from .ozaki1 import ozmm_ozaki1_fp8
from .ozaki2 import ozmm_ozaki2
from .plan import (QuantizedMatrix, operand_stats, ozmm_prepared, quantize_matrix,
                   transpose_plan)

#: ``ozmm``'s own fallback when neither a per-call policy nor a context is
#: set: the paper's flagship operating point.
OZMM_DEFAULT_POLICY = PrecisionPolicy(scheme="ozaki2-fp8", mode="accurate")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's, else the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the CUDA device unless the caller asks for "
            "another, and no CUDA device is available; pass device='cpu' to "
            "run on the CPU")
    return dev


def _as_f64(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=dev, dtype=torch.float64)


def _resolve_backend(pol: PrecisionPolicy, device: torch.device) -> str:
    """Concrete executor for a policy on ``device``: ``"core"`` or
    ``"pallas"`` (the kernel route)."""
    if pol.backend != "auto":
        return pol.backend
    if pol.scheme not in OZAKI2_FAMILY:
        return "core"
    hopper = (device.type == "cuda"
              and torch.cuda.get_device_capability(device) == (9, 0))
    return "pallas" if hopper else "core"


def _executor(pol: PrecisionPolicy, dev: torch.device):
    """The 2-D function that runs ``pol`` on ``dev``, and its route name."""
    if pol.scheme == "native":
        return torch.matmul, "native"
    if pol.scheme == "ozaki1-fp8":
        return functools.partial(ozmm_ozaki1_fp8, num_slices=pol.num_slices,
                                 mode=pol.mode), "core"
    kw = dict(family=OZAKI2_FAMILY[pol.scheme], num_moduli=pol.num_moduli,
              mode=pol.mode)
    if _resolve_backend(pol, dev) == "core":
        return functools.partial(ozmm_ozaki2, **kw), "core"
    _check_kernel_route(pol, dev)
    from repro_torch.kernels import ozmm_pallas, ozmm_pallas_fused  # lazy: core <- kernels

    return functools.partial(ozmm_pallas_fused if pol.fused else ozmm_pallas, **kw), "pallas"


def _check_kernel_route(pol: PrecisionPolicy, dev: torch.device) -> None:
    """Raise where the kernel route cannot run ``pol`` on ``dev``."""
    if pol.interpret is not None and pol.interpret != (dev.type == "cpu"):
        raise ValueError(
            f"policy {pol.spec!r} on {dev}: the port runs the kernels on CUDA "
            "tensors and their plain versions ('+interpret') on CPU tensors")


def _batched(fn, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., m, k) @ (..., k, n) with matching leading dims, one 2-D call each."""
    if a.ndim == b.ndim == 2:
        return fn(a, b)
    if a.ndim != b.ndim or a.ndim < 2 or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"rank mismatch {tuple(a.shape)} @ {tuple(b.shape)}")
    out = torch.stack([fn(x, y) for x, y in zip(a.reshape(-1, *a.shape[-2:]),
                                                b.reshape(-1, *b.shape[-2:]))])
    return out.reshape(*a.shape[:-2], *out.shape[-2:])


#: Reverse of OZAKI2_FAMILY, for labeling prepared-plan executions.
_FAMILY_SCHEME = {fam: sch for sch, fam in OZAKI2_FAMILY.items()}


def _record_emulated(scheme: str, mode: str, family: str,
                     num_moduli: int | None, a_shape, b_shape) -> None:
    """Gated GEMM-call metric for one host-level emulated-GEMM entry.
    Leading batch dims fold into m. No-op unless obs metrics are enabled."""
    if not metrics_enabled():
        return
    m = 1
    for d in a_shape[:-1]:
        m *= int(d)
    record_gemm_call(scheme, mode, family,
                     num_moduli or DEFAULT_NUM_MODULI[family],
                     m, int(a_shape[-1]), int(b_shape[-1]))


#: The forward products of differentiable emulated GEMMs while a layer runs
#: under ``product_store_contexts``: (the list, whether to replay it).
_PRODUCTS: contextvars.ContextVar = contextvars.ContextVar("repro_torch_gemm_products",
                                                           default=None)


def _product(fn, a, b) -> torch.Tensor:
    """``fn(a, b)``, the 2-D product of a differentiable emulated GEMM's
    forward: recorded, or taken in order from the record, under a store."""
    store = _PRODUCTS.get()
    if store is None:
        return fn(a, b)
    outs, replay = store
    if replay:
        return outs.pop(0)
    out = fn(a, b)
    outs.append(out.detach())
    return out


@contextlib.contextmanager
def _storing(outs: list, replay: bool):
    token = _PRODUCTS.set((outs, replay))
    try:
        yield
    finally:
        _PRODUCTS.reset(token)


def product_store_contexts():
    """(forward, recompute) contexts of ``torch.utils.checkpoint``'s
    ``context_fn`` that keep a checkpointed function's emulated products:
    the forward records each differentiable emulated GEMM's product, the
    recompute takes them in the same order and recomputes only the rest
    (the operands, which the backward's cotangent GEMMs need, and plans)."""
    outs: list = []
    return _storing(outs, False), _storing(outs, True)


class _PlannedVJP(torch.autograd.Function):
    """Core-route Ozaki-II GEMM whose backward reuses the forward plans: the
    cotangent is sketched once and quantized in both roles, and the
    transposed forward plans (``transpose_plan``) reuse the operands'
    row/col sketches (the reference's ``_ozmm_fwd``/``_ozmm_bwd``)."""

    @staticmethod
    def forward(ctx, a, b, ms: ModuliSet, mode: str):
        qa = quantize_matrix(a, "lhs", ms, mode=mode)
        qb = quantize_matrix(b, "rhs", ms, mode=mode)
        ctx.plans = (qa, qb)
        return _product(ozmm_prepared, qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.plans
        ms, mode = qa.ms, qa.mode
        g64 = g.to(torch.float64)
        gstats = operand_stats(g64)
        ga = gb = None
        if ctx.needs_input_grad[0]:  # dA = dC @ B^T
            qg_l = quantize_matrix(g64, "lhs", ms, mode=mode, stats=gstats)
            ga = ozmm_prepared(qg_l, transpose_plan(qb))
        if ctx.needs_input_grad[1]:  # dB = A^T @ dC
            qg_r = quantize_matrix(g64, "rhs", ms, mode=mode, stats=gstats)
            gb = ozmm_prepared(transpose_plan(qa), qg_r)
        return ga, gb, None, None


class _UnpreparedVJP(torch.autograd.Function):
    """An emulated GEMM ``fn`` whose backward runs the two cotangent
    products as unprepared calls of ``fn`` itself: the kernel route (the
    reference's ``_ozmm_pallas_guarded``) and Ozaki-I. An explicit
    ``+pallas`` is forward-only and raises instead."""

    @staticmethod
    def forward(ctx, a, b, fn, pol: PrecisionPolicy):
        ctx.save_for_backward(a, b)
        ctx.fn, ctx.pol = fn, pol
        return _product(fn, a, b)

    @staticmethod
    def backward(ctx, g):
        pol = ctx.pol
        if pol.backend == "pallas":  # explicitly requested: refuse, don't reroute
            kernel = "ozmm_pallas_fused" if pol.fused else "ozmm_pallas"
            raise NotImplementedError(
                f"policy {pol.spec!r}: backend='pallas' is forward-only — "
                f"{kernel} has no VJP (serving/inference); differentiate "
                "through the core backend (or backend='auto', which runs the "
                "backward cotangent GEMMs as emulated GEMMs) instead")
        a, b = ctx.saved_tensors
        g64 = g.to(torch.float64)
        ga = ctx.fn(g64, b.T) if ctx.needs_input_grad[0] else None
        gb = ctx.fn(a.T, g64) if ctx.needs_input_grad[1] else None
        return ga, gb, None, None


def ozmm(a, b, policy=None, *, device=None) -> torch.Tensor:
    """Emulated FP64 matmul of numpy arrays or tensors, (..., m, k) @
    (..., k, n) with matching leading dims, on ``device`` (None: the card).

    ``policy`` is a ``PrecisionPolicy``, a spec string like
    ``"ozaki2-fp8/fast@8"``, or None: then the precision context decides,
    falling back to the paper's flagship ``ozaki2-fp8/accurate``. Either
    side may be a prepared ``QuantizedMatrix`` (2-D only); then the plan is
    the spec, and the pairing runs on the plan's device, on the route the
    policy's backend resolves to there.

    Differentiable (module docstring): inputs that require grad get
    gradients of their own dtype, through the emulated backward of the
    route the policy resolves to; an explicit ``+pallas`` raises when the
    gradient is asked for. Prepared operands are data, not differentiable
    inputs.
    """
    pol = resolve_policy(policy, fallback=OZMM_DEFAULT_POLICY)
    if isinstance(a, QuantizedMatrix) or isinstance(b, QuantizedMatrix):
        return _ozmm_prepared_mixed(a, b, pol)
    dev = resolve_device(device)
    a, b = _as_f64(a, dev), _as_f64(b, dev)
    if pol.scheme in OZAKI2_FAMILY:
        _record_emulated(pol.scheme, pol.mode, OZAKI2_FAMILY[pol.scheme],
                         pol.num_moduli, a.shape, b.shape)
    fn, route = _executor(pol, dev)
    if (route == "native" or not torch.is_grad_enabled()
            or not (a.requires_grad or b.requires_grad)):
        return _batched(fn, a, b)
    if route == "core" and pol.scheme in OZAKI2_FAMILY:
        ms, mode = pol.moduli_set(), pol.mode
        return _batched(lambda x, y: _PlannedVJP.apply(x, y, ms, mode), a, b)
    return _batched(lambda x, y: _UnpreparedVJP.apply(x, y, fn, pol), a, b)


def _ozmm_prepared_mixed(a, b, pol: PrecisionPolicy) -> torch.Tensor:
    """Execute with >= 1 prepared operand, quantizing the raw side on the
    fly on the plan's device. When the policy's backend resolves to the
    kernel route there, the pairing runs on the fused kernels
    (``ozmm_pallas_fused_prepared``), or on the phase-split pipeline under
    ``+unfused`` (``ozmm_pallas_prepared``); otherwise on the core path.
    Gradients do not flow through prepared operands (plans are data); use
    plain ``ozmm`` for the VJP."""
    anchor = a if isinstance(a, QuantizedMatrix) else b
    ms, dev = anchor.ms, anchor.device
    _record_emulated(_FAMILY_SCHEME[ms.family], anchor.mode, ms.family, ms.n,
                     a.shape, b.shape)
    qa = a if isinstance(a, QuantizedMatrix) else quantize_matrix(
        _as_f64(a, dev), "lhs", ms, mode=anchor.mode)
    qb = b if isinstance(b, QuantizedMatrix) else quantize_matrix(
        _as_f64(b, dev), "rhs", ms, mode=anchor.mode)
    if _resolve_backend(pol, dev) == "core":
        return ozmm_prepared(qa, qb)
    _check_kernel_route(pol, dev)
    from repro_torch.kernels import ozmm_pallas_fused_prepared, ozmm_pallas_prepared  # lazy

    return (ozmm_pallas_fused_prepared if pol.fused else ozmm_pallas_prepared)(qa, qb)


def _check_plan_matches_policy(q: QuantizedMatrix, pol: PrecisionPolicy) -> None:
    """A prepared operand must have been built for the requested scheme."""
    want, got = (OZAKI2_FAMILY.get(pol.scheme), pol.mode), (q.family, q.mode)
    if want != got:
        raise ValueError(
            f"prepared operand was quantized for {got}, but the policy "
            f"requests {want} (scheme={pol.scheme!r}); re-prepare under the "
            "matching policy")
    if pol.num_moduli is not None and pol.num_moduli != q.num_moduli:
        raise ValueError(f"prepared operand has {q.num_moduli} moduli, policy "
                         f"requests {pol.num_moduli}")


def prepare_operand(x, role: str, policy=None, *, device=None):
    """Quantize ``x`` once for reuse across GEMMs (see core.plan). Schemes
    without plans return ``x`` unchanged; prepared operands pass through
    after a scheme/mode consistency check."""
    pol = resolve_policy(policy)
    if isinstance(x, QuantizedMatrix):
        if pol.supports_plans:
            _check_plan_matches_policy(x, pol)
        return x
    if not pol.supports_plans:
        return x
    return quantize_matrix(_as_f64(x, resolve_device(device)), role,
                           pol.moduli_set(), mode=pol.mode)


def plan_source(q: QuantizedMatrix) -> torch.Tensor:
    """The f64 source of a plan, for native-policy fallbacks."""
    if q.x is None:
        raise ValueError(
            "prepared operand carries no f64 source, so it cannot run under "
            f"a native policy; execute it under the emulated policy it was "
            f"quantized for ({q.family}/{q.mode})")
    return q.x


def backend_matmul(a, b, policy=None, preferred_dtype: torch.dtype | None = None,
                   *, device=None) -> torch.Tensor:
    """Matmul router: native policies run a plain matmul, in
    ``preferred_dtype`` when given (the reference's
    ``preferred_element_type``: the inputs are cast and the product is
    accumulated in that type) and in the inputs' dtype otherwise; emulated
    ones ``ozmm`` (f64 out, cast to ``preferred_dtype`` when given). Either
    side may be a prepared ``QuantizedMatrix``."""
    pol = resolve_policy(policy)
    a_prep, b_prep = isinstance(a, QuantizedMatrix), isinstance(b, QuantizedMatrix)
    if not pol.is_emulated:
        a = plan_source(a) if a_prep else a
        b = plan_source(b) if b_prep else b
        dev = (a if a_prep else b).device if (a_prep or b_prep) else resolve_device(device)
        a, b = (torch.as_tensor(x, device=dev) for x in (a, b))
        if preferred_dtype is not None:
            a, b = a.to(preferred_dtype), b.to(preferred_dtype)
        return torch.matmul(a, b)
    if a_prep or b_prep:
        for q in (a, b):
            if isinstance(q, QuantizedMatrix):
                _check_plan_matches_policy(q, pol)
        out = _ozmm_prepared_mixed(a, b, pol)
    else:
        out = ozmm(a, b, pol, device=device)
    return out if preferred_dtype is None else out.to(preferred_dtype)


def default_num_moduli(scheme: str) -> int | None:
    """Paper-default decomposition arity for ``scheme``: the CRT modulus
    count of an Ozaki-II scheme, the slice count of ``"ozaki1-fp8"`` (fed to
    ``num_slices``), None for ``"native"``."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; expected one of {SCHEMES}")
    return {
        "ozaki2-fp8": DEFAULT_NUM_MODULI["fp8-hybrid"],
        "ozaki2-karatsuba": DEFAULT_NUM_MODULI["fp8-karatsuba"],
        "ozaki2-int8": DEFAULT_NUM_MODULI["int8"],
        "ozaki1-fp8": DEFAULT_NUM_SLICES,
        "native": None,
    }[scheme]
