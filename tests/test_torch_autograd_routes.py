"""Gradients through repro_torch's ozmm beyond the 2-D f64 core case:
f32 inputs get f32 gradients and a batched (3-D) gradient, both bitwise
against jax.grad of the reference; the auto-derived kernel route's backward
(forced on CPU tensors, where the kernels' plain versions run) bitwise
against the reference's core cotangent GEMMs ozmm(g, b.T) / ozmm(a.T, g);
and the plan pieces the backward uses (transpose_plan, drop_source) as the
reference's."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import plan as jplan
from repro.core.gemm import ozmm as jax_ozmm
from repro.core.moduli import make_moduli_set as jax_moduli_set
from repro_torch import ozmm
from repro_torch.core import gemm, plan
from repro_torch.core.moduli import make_moduli_set
from repro_torch.kernels import common, ozmm_fused_raw_ref, requant_garner_plain

from _torch_parity import operands, port_grads, reference_grads
from _torch_threads import one_torch_thread  # noqa: F401


def test_f32_inputs_get_f32_gradients_bitwise():
    a, b = operands(6, (10, 24, 6), 0.5)
    a, b = a.astype(np.float32), b.astype(np.float32)
    want = reference_grads(a, b, "ozaki2-fp8/fast@5")
    got = port_grads(a, b, "ozaki2-fp8/fast@5", None)
    for w, x in zip(want, got):
        assert x.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(x, w)


def test_batched_gradient_bitwise():
    rng = np.random.default_rng(9)
    a = (rng.random((3, 8, 20)) - 0.5) * np.exp(rng.standard_normal((3, 8, 20)))
    b = (rng.random((3, 20, 6)) - 0.5) * np.exp(rng.standard_normal((3, 20, 6)))
    g = rng.standard_normal((3, 8, 6))
    spec = "ozaki2-fp8/accurate@5"
    want = reference_grads(a, b, spec, g)
    got = port_grads(a, b, spec, g)
    for w, x in zip(want, got):
        assert x.shape == w.shape
        np.testing.assert_array_equal(x, w)


@pytest.mark.parametrize("spec,plain,calls", [
    ("ozaki2-fp8/fast@4", ozmm_fused_raw_ref, 3),           # K1 per GEMM
    ("ozaki2-int8/accurate@6+unfused", requant_garner_plain, 3),  # K5 per GEMM
])
def test_auto_kernel_route_backward_vs_reference_core(monkeypatch, spec, plain, calls):
    """backend auto on a Hopper card takes the kernel route; forced here on
    CPU tensors, the two cotangent GEMMs run as unprepared emulated GEMMs
    through the same route (the kernels' plain versions). The glue copies
    each transposed f64 view once: B^T and A^T for K1's frames; A^T for K6,
    and B (forward) and G (dB) for its K-major B side, B^T being B."""
    monkeypatch.setattr(gemm, "_resolve_backend", lambda pol, dev: "pallas")
    a, b = operands(11, (12, 40, 8), 0.5)
    g = np.random.default_rng(12).standard_normal((12, 8))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    before = plain.calls
    copies = (common.row_major.copies, common.k_major.copies)
    c = ozmm(ta, tb, spec, device="cpu")
    c.backward(torch.from_numpy(g))
    assert plain.calls == before + calls, "a GEMM left the kernel route"
    made = (common.row_major.copies - copies[0], common.k_major.copies - copies[1])
    assert made == ((1, 2) if spec.endswith("+unfused") else (2, 0))
    core = spec.removesuffix("+unfused") + "+core"
    jg, ja, jb = jnp.asarray(g), jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_array_equal(ta.grad.numpy(), np.asarray(jax_ozmm(jg, jb.T, core)))
    np.testing.assert_array_equal(tb.grad.numpy(), np.asarray(jax_ozmm(ja.T, jg, core)))


def _same(x, y) -> None:
    """Bitwise equality of a port tensor and a reference array (e4m3 by bytes)."""
    if x.dtype == torch.float8_e4m3fn:
        x, y = x.view(torch.uint8).numpy(), np.asarray(y).view(np.uint8)
    np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("mode", ["fast", "accurate"])
def test_transpose_plan_and_drop_source_as_reference(mode):
    a, _ = operands(13, (30, 20, 1), 0.5)
    ms, jms = make_moduli_set("fp8-hybrid", 5), jax_moduli_set("fp8-hybrid", 5)
    for role in ("lhs", "rhs"):
        q = plan.quantize_matrix(torch.from_numpy(a), role, ms, mode=mode)
        jq = jplan.quantize_matrix(jnp.asarray(a), role, jms, mode=mode)
        qt, jqt = plan.transpose_plan(q), jplan.transpose_plan(jq)
        assert (qt.role, qt.shape) == (jqt.role, jqt.shape) == (role, (20, 30))
        # the sketches: the abs-max exactly, the squared norm to a few ulps
        # (torch and XLA sum in different orders); the exponents bitwise
        sq, mx = qt.scale_stats
        _same(mx, jqt.scale_stats[1])
        np.testing.assert_allclose(sq.numpy(), np.asarray(jqt.scale_stats[0]), rtol=2.0 ** -50)
        if mode == "fast":
            _same(qt.lscale, jqt.lscale)
            for part, jpart in zip(qt.parts, jqt.parts):
                for x, y in zip(part, jpart):
                    _same(x, y)
            slim = q.drop_source()
            assert slim.x is None and jq.drop_source().x is None
            with pytest.raises(ValueError, match="source was dropped"):
                plan.transpose_plan(slim)
            with pytest.raises(ValueError, match="source was dropped"):
                jplan.transpose_plan(jq.drop_source())
        else:
            _same(qt.lpre, jqt.lpre)
            _same(qt.bar, jqt.bar)
            for drop in (q.drop_source, jq.drop_source):
                with pytest.raises(ValueError, match="accurate-mode plans need x"):
                    drop()


def test_injected_stats_are_used_as_given():
    """quantize_matrix(stats=) reads the sketches it is given: a doubled row
    norm moves the fast-mode exponents exactly as the reference's do."""
    a, _ = operands(14, (16, 24, 1), 0.5)
    ms, jms = make_moduli_set("fp8-hybrid", 6), jax_moduli_set("fp8-hybrid", 6)
    st = plan.operand_stats(torch.from_numpy(a))
    jst = jplan.operand_stats(jnp.asarray(a))
    st = plan.OperandStats(st.row_sq * 4.0, st.row_max, st.col_sq, st.col_max)
    jst = jplan.OperandStats(jst.row_sq * 4.0, jst.row_max, jst.col_sq, jst.col_max)
    q = plan.quantize_matrix(torch.from_numpy(a), "lhs", ms, mode="fast", stats=st)
    jq = jplan.quantize_matrix(jnp.asarray(a), "lhs", jms, mode="fast", stats=jst)
    assert q.stats is st
    _same(q.lscale, jq.lscale)
    fresh = plan.quantize_matrix(torch.from_numpy(a), "lhs", ms, mode="fast")
    assert not torch.equal(q.lscale, fresh.lscale)
