"""Public emulated-GEMM API of the port (the torch counterpart of
``repro/core/gemm.py``): ``ozmm``, ``backend_matmul``, ``prepare_operand``
and the executor choice ``_resolve_backend``.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"`` and raises when no CUDA device exists; it
never falls back to the CPU. The tests pass ``device="cpu"``.

Executors of an Ozaki-II policy: the core torch path (``ozmm_ozaki2``,
``ozmm_prepared`` for prepared operands) or the kernel route: the fused
kernels by default (``ozmm_pallas_fused``, ``ozmm_pallas_fused_prepared``),
the phase-split pipeline under ``+unfused`` (``ozmm_pallas``,
``ozmm_pallas_prepared``); the Hopper kernels on CUDA tensors, their plain
versions on CPU tensors. ``backend="auto"`` takes the kernel route on a
compute-capability-9.0 card and core elsewhere.

Not ported yet: the custom VJP (a gradient through an emulated ``ozmm``
raises ``NotImplementedError``) and the Ozaki-I scheme.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.precision.context import resolve_policy
from repro_torch.precision.policy import OZAKI2_FAMILY, PrecisionPolicy

from .ozaki2 import ozmm_ozaki2
from .plan import QuantizedMatrix, ozmm_prepared, quantize_matrix

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
    if pol.scheme not in OZAKI2_FAMILY:
        raise NotImplementedError(f"scheme {pol.scheme!r} is not ported yet "
                                  "(ROADMAP, Ozaki-I slice)")
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


class _NoVJP(torch.autograd.Function):
    """Runs an emulated GEMM forward; asking for its gradient raises instead
    of returning the zero-a.e. gradient of trunc/mod."""

    @staticmethod
    def forward(ctx, a, b, fn, message):
        ctx.message = message
        return _batched(fn, a, b)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(ctx.message)


def _no_vjp_message(pol: PrecisionPolicy, route: str) -> str:
    if route == "pallas":
        kernel = "ozmm_pallas_fused" if pol.fused else "ozmm_pallas"
        return (f"policy {pol.spec!r}: backend='pallas' is forward-only — "
                f"{kernel} has no VJP (serving/inference); the "
                "emulated-GEMM backward is not ported yet (ROADMAP, autograd "
                "and training slice)")
    return (f"policy {pol.spec!r}: the emulated-GEMM backward "
            "(repro/core/gemm.py::_ozmm_bwd) is not ported yet (ROADMAP, "
            "autograd and training slice)")


def ozmm(a, b, policy=None, *, device=None) -> torch.Tensor:
    """Emulated FP64 matmul of numpy arrays or tensors, (..., m, k) @
    (..., k, n) with matching leading dims, on ``device`` (None: the card).

    ``policy`` is a ``PrecisionPolicy``, a spec string like
    ``"ozaki2-fp8/fast@8"``, or None: then the precision context decides,
    falling back to the paper's flagship ``ozaki2-fp8/accurate``. Either
    side may be a prepared ``QuantizedMatrix`` (2-D only); then the plan is
    the spec, and the pairing runs on the plan's device, on the route the
    policy's backend resolves to there.
    """
    pol = resolve_policy(policy, fallback=OZMM_DEFAULT_POLICY)
    if isinstance(a, QuantizedMatrix) or isinstance(b, QuantizedMatrix):
        return _ozmm_prepared_mixed(a, b, pol)
    dev = resolve_device(device)
    a, b = _as_f64(a, dev), _as_f64(b, dev)
    fn, route = _executor(pol, dev)
    if (route != "native" and torch.is_grad_enabled()
            and (a.requires_grad or b.requires_grad)):
        return _NoVJP.apply(a, b, fn, _no_vjp_message(pol, route))
    return _batched(fn, a, b)


def _ozmm_prepared_mixed(a, b, pol: PrecisionPolicy) -> torch.Tensor:
    """Execute with >= 1 prepared operand, quantizing the raw side on the
    fly on the plan's device. When the policy's backend resolves to the
    kernel route there, the pairing runs on the fused kernels
    (``ozmm_pallas_fused_prepared``), or on the phase-split pipeline under
    ``+unfused`` (``ozmm_pallas_prepared``); otherwise on the core path."""
    anchor = a if isinstance(a, QuantizedMatrix) else b
    ms, dev = anchor.ms, anchor.device
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
