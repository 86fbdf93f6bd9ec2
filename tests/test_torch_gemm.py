"""repro_torch's public GEMM API vs the reference: the policy spec grammar
round-trips to the same ``spec``, executor resolution, the card-by-default
device rule, plan interchange with the JAX package, gradients on every
route but an explicit '+pallas' (which refuses loudly), and Ozaki-I.
Tolerance: bitwise."""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import plan as jplan
from repro.core.moduli import make_moduli_set as jax_moduli_set
from repro.precision.policy import parse_policy as jax_parse_policy
from repro.testing import lognormal_matrix
from repro_torch import backend_matmul, ozmm, plan_from_arrays, prepare_operand
from repro_torch.core import gemm
from repro_torch.core.ozaki1 import ozmm_ozaki1_fp8
from repro_torch.core.plan import ozmm_prepared
from repro_torch.precision import (parse_policy, resolve_policy, set_default_policy,
                                   use_policy)

from _torch_parity import SCHEME
from _torch_threads import one_torch_thread  # noqa: F401

SPECS = ["ozaki2-fp8", "ozaki2-fp8/accurate@8", "ozaki2-int8/fast",
         "ozaki2-karatsuba/accurate@5+core+nocache", "ozaki1-fp8/accurate@11",
         "ozaki1-fp8/fast@9", "native", "native/fast", "ozaki2-fp8/fast+pallas",
         "ozaki2-fp8/fast+pallas+unfused", "ozaki2-fp8/fast@6+pallas+interpret",
         "ozaki2-int8/accurate+compiled", " ozaki2-fp8/fast@4 "]
INVALID = ["bogus", "ozaki2-fp8/slow", "native@3", "ozaki2-fp8@x", "ozaki2-fp8+warp",
           "ozaki2-fp8+pallas+core", "native+pallas", "ozaki2-fp8+core+unfused",
           "ozaki2-fp8@0"]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_round_trip_matches_reference(spec):
    ref, got = jax_parse_policy(spec), parse_policy(spec)
    assert got.spec == ref.spec
    assert parse_policy(got.spec) == got
    assert dataclasses.asdict(got) == {f.name: getattr(ref, f.name)
                                       for f in dataclasses.fields(got)}


@pytest.mark.parametrize("spec", INVALID)
def test_invalid_specs_rejected_like_reference(spec):
    with pytest.raises(ValueError):
        jax_parse_policy(spec)
    with pytest.raises(ValueError):
        parse_policy(spec)


def test_context_precedence():
    assert resolve_policy().scheme == "native"
    prev = set_default_policy("ozaki2-int8/fast")
    try:
        assert resolve_policy().spec == "ozaki2-int8/fast"
        with use_policy("ozaki2-fp8/fast@8") as outer:
            assert resolve_policy() == outer
            with use_policy("ozaki2-karatsuba/accurate"):
                assert resolve_policy().scheme == "ozaki2-karatsuba"
            assert resolve_policy("native").scheme == "native"  # per call wins
        assert resolve_policy().spec == "ozaki2-int8/fast"
    finally:
        set_default_policy(prev)


def test_backend_resolution(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    fast = parse_policy("ozaki2-fp8/fast@8")
    assert gemm._resolve_backend(fast, cpu) == "core"
    assert gemm._resolve_backend(parse_policy("ozaki2-int8/fast+pallas"), cpu) == "pallas"
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (9, 0))
    assert gemm._resolve_backend(fast, cuda) == "pallas"
    assert gemm._resolve_backend(parse_policy("ozaki2-fp8/fast+core"), cuda) == "core"
    assert gemm._resolve_backend(parse_policy("native"), cuda) == "core"
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (8, 0))
    assert gemm._resolve_backend(fast, cuda) == "core"


def test_default_device_is_the_card(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = lognormal_matrix(rng, (4, 6), 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ozmm(a, a.T)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_operand(a, "lhs", "ozaki2-fp8/fast")
    assert gemm.resolve_device("cpu") == torch.device("cpu")


def _plan_arrays(q) -> dict:
    """A JAX QuantizedMatrix's leaves as the numpy dict plan_from_arrays takes."""
    out = {k: np.asarray(getattr(q, k)) for k in ("x", "lscale", "lpre", "bar")
           if getattr(q, k) is not None}
    out.update({k: np.asarray(getattr(q.stats, k))
                for k in ("row_sq", "row_max", "col_sq", "col_max")})
    for l, part in enumerate(q.parts or ()):
        out.update({f"parts.{l}.{i}": np.asarray(p) for i, p in enumerate(part)})
    return out


@pytest.mark.parametrize("family", ["fp8-hybrid", "int8"])
@pytest.mark.parametrize("mode", ["fast", "accurate"])
def test_plan_from_arrays_interchange(rng, family, mode):
    """A plan built by repro executes in the port with the same bits."""
    a = lognormal_matrix(rng, (40, 70), 0.5)
    b = lognormal_matrix(rng, (70, 30), 2.0)
    ms = jax_moduli_set(family, 4)
    qa = jplan.quantize_matrix(jnp.asarray(a), "lhs", ms, mode=mode)
    qb = jplan.quantize_matrix(jnp.asarray(b), "rhs", ms, mode=mode)
    want = np.asarray(jplan.ozmm_prepared(qa, qb))
    ta = plan_from_arrays("lhs", family, 4, mode, _plan_arrays(qa))
    tb = plan_from_arrays("rhs", family, 4, mode, _plan_arrays(qb))
    np.testing.assert_array_equal(ozmm_prepared(ta, tb).numpy(), want)
    # a JAX plan paired with an operand the port quantizes on the fly
    np.testing.assert_array_equal(ozmm(ta, b).numpy(), want)
    if mode == "fast":  # the port's own plan holds the same digits
        mine = prepare_operand(a, "lhs", f"{SCHEME[family]}/fast@4", device="cpu")
        for got_part, ref_part in zip(mine.parts, ta.parts):
            for g, r in zip(got_part, ref_part):
                assert torch.equal(g.view(torch.uint8) if g.dtype != torch.int8 else g,
                                   r.view(torch.uint8) if r.dtype != torch.int8 else r)


def test_gradient_requests_raise_on_emulated_routes(rng, monkeypatch):
    """Only an explicit '+pallas' refuses a gradient (forward-only, as in the
    reference); the core route and the auto-derived kernel route give
    nonzero gradients, and native differentiates as a plain matmul."""
    a = torch.from_numpy(lognormal_matrix(rng, (8, 16), 1.0)).requires_grad_()
    b = torch.from_numpy(lognormal_matrix(rng, (16, 8), 1.0))
    with pytest.raises(NotImplementedError, match=r"forward-only.*ozmm_pallas_fused"):
        ozmm(a, b, "ozaki2-fp8/fast@4+pallas", device="cpu").sum().backward()
    ozmm(a, b, "ozaki2-fp8/fast@4", device="cpu").sum().backward()  # auto on the CPU: core
    core_grad, a.grad = a.grad, None
    assert core_grad is not None and bool((core_grad != 0).all())
    monkeypatch.setattr(gemm, "_resolve_backend", lambda pol, dev: "pallas")
    ozmm(a, b, "ozaki2-fp8/fast@4", device="cpu").sum().backward()  # auto: the kernel route
    assert torch.equal(a.grad, core_grad)
    monkeypatch.undo()
    a.grad = None
    ozmm(a, b, "native", device="cpu").sum().backward()  # a plain matmul differentiates
    torch.testing.assert_close(a.grad, b.sum(dim=1).expand(8, 16))


def test_unported_routes_refuse(rng):
    """Ozaki-I, which used to refuse, runs (on core) and equals its executor;
    '+compiled' refuses CPU tensors. The phase-split '+pallas+unfused'
    route, which used to refuse, runs (raw and prepared) and equals
    '+core'."""
    a = lognormal_matrix(rng, (8, 16), 1.0)
    np.testing.assert_array_equal(
        ozmm(a, a.T, "ozaki2-fp8/fast+pallas+unfused", device="cpu").numpy(),
        ozmm(a, a.T, "ozaki2-fp8/fast+core", device="cpu").numpy())
    ta = torch.from_numpy(a)
    np.testing.assert_array_equal(
        ozmm(a, a.T, "ozaki1-fp8/fast", device="cpu").numpy(),
        ozmm_ozaki1_fp8(ta, ta.T, num_slices=11, mode="fast").numpy())
    with pytest.raises(ValueError, match="plain versions"):
        ozmm(a, a.T, "ozaki2-fp8/fast+pallas+compiled", device="cpu")
    qa = prepare_operand(a, "lhs", "ozaki2-fp8/fast@4", device="cpu")
    np.testing.assert_array_equal(
        backend_matmul(qa, a.T, "ozaki2-fp8/fast@4+pallas+unfused").numpy(),
        backend_matmul(qa, a.T, "ozaki2-fp8/fast@4+core").numpy())


def test_batched_numpy_and_router(rng):
    a = lognormal_matrix(rng, (2, 8, 12), 2.0)
    b = lognormal_matrix(rng, (2, 12, 6), 2.0)
    spec = "ozaki2-fp8/fast@5+interpret+pallas"
    got = ozmm(a, b, spec, device="cpu")
    for i in range(2):
        np.testing.assert_array_equal(got[i].numpy(),
                                      ozmm(torch.from_numpy(a[i]), b[i], spec, device="cpu").numpy())
    with pytest.raises(ValueError, match="rank mismatch"):
        ozmm(a, b[0], spec, device="cpu")
    qb = prepare_operand(b[0], "rhs", "ozaki2-fp8/fast@5", device="cpu")
    np.testing.assert_array_equal(
        backend_matmul(a[0], qb, "ozaki2-fp8/fast@5").numpy(),
        ozmm(a[0], b[0], "ozaki2-fp8/fast@5+core", device="cpu").numpy())
    with pytest.raises(ValueError, match="moduli"):
        backend_matmul(a[0], qb, "ozaki2-fp8/fast@6")
    out = backend_matmul(a[0], qb, "native", preferred_dtype=torch.float32)
    assert out.dtype == torch.float32
    with use_policy("ozaki2-int8/fast@4"):
        np.testing.assert_array_equal(
            ozmm(a[0], b[0], device="cpu").numpy(),
            ozmm(a[0], b[0], "ozaki2-int8/fast@4", device="cpu").numpy())
