"""The fused kernel from prepared parts (K2, repro_torch.kernels.fused::
ozmm_fused_parts) and prepared operands on the kernel route, against the
JAX reference on the same numpy inputs. Tolerance: bitwise throughout.

* ``stack_parts`` against ``repro.kernels.common.stack_parts``;
* the plain version ``ozmm_fused_parts_ref`` against the Pallas kernel
  ``ozmm_fused_parts`` in interpret mode, on the same padded stacks;
* the kernel route's fast prepared pairing (plan x plan, and prepared/raw
  mixes of the same pairing) against the cropped kernel output.

tests/test_torch_fused_prepared.py holds ``ozmm(qa, qb, '+pallas')``
against ``ozmm_pallas_fused_prepared`` in fast and accurate mode (a file of
its own: each JAX interpreter run compiles for several seconds).

tests/test_torch_cuda.py holds the kernel itself against its plain version
on the card."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core.moduli import make_moduli_set as jax_moduli_set
from repro.core.plan import quantize_matrix as jax_quantize_matrix
from repro.kernels.common import stack_parts as jax_stack_parts
from repro.kernels.fused.kernel import ozmm_fused_parts as jax_ozmm_fused_parts
from repro.kernels.fused.ops import _pad2 as jax_pad2
from repro.kernels.fused.ops import _pad3 as jax_pad3
from repro_torch import backend_matmul, ozmm, prepare_operand
from repro_torch.core.moduli import DEFAULT_NUM_MODULI, make_moduli_set
from repro_torch.kernels import fused, stack_parts
from repro_torch.kernels.fused import kernel as fused_kernel

from _torch_parity import PRIME_ISH, SCHEME, FakeCudaTensor, operands
from _torch_threads import one_torch_thread  # noqa: F401

TILE = fused.KERNEL_TILE


def _bytes(x) -> np.ndarray:
    """A part stack as comparable integers (e4m3 travels as its bit pattern)."""
    if isinstance(x, torch.Tensor):
        return (x if x.dtype == torch.int8 else x.view(torch.uint8)).numpy()
    x = np.asarray(x)
    return x if x.dtype == np.int8 else x.view(np.uint8)


def _plans(a, b, family: str, n: int, mode: str):
    """The same pairing prepared by the reference and by the port."""
    ms = jax_moduli_set(family, n)
    ja = jax_quantize_matrix(jnp.asarray(a), "lhs", ms, mode=mode)
    jb = jax_quantize_matrix(jnp.asarray(b), "rhs", ms, mode=mode)
    spec = f"{SCHEME[family]}/{mode}@{n}"
    ta = prepare_operand(a, "lhs", spec, device="cpu")
    tb = prepare_operand(b, "rhs", spec, device="cpu")
    return ms, ja, jb, ta, tb, spec


def _assert_stacks_equal(got, want, family: str) -> None:
    if family == "int8":
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bytes(g), _bytes(w))


CASES = [("fp8-hybrid", DEFAULT_NUM_MODULI["fp8-hybrid"]),
         ("fp8-karatsuba", DEFAULT_NUM_MODULI["fp8-karatsuba"]),
         ("int8", DEFAULT_NUM_MODULI["int8"]),
         ("fp8-hybrid", 2)]  # two square moduli: every hs slice is zero-filled


@pytest.mark.parametrize("family,n", CASES)
def test_fast_pairing_kernel_route_bitwise(family, n):
    """stack_parts, the plain version of K2 on the padded stacks, and the
    kernel route's fast prepared pairing (plan x plan and the raw mixes),
    all bitwise equal to the reference at 250x94x61."""
    a, b = operands(3, PRIME_ISH, 0.5)
    ms, ja, jb, ta, tb, spec = _plans(a, b, family, n, "fast")
    tms = make_moduli_set(family, n)
    sa, sb = stack_parts(ta.parts, tms), stack_parts(tb.parts, tms)
    jsa, jsb = jax_stack_parts(ja.parts, ms), jax_stack_parts(jb.parts, ms)
    _assert_stacks_equal(sa, jsa, family)
    _assert_stacks_equal(sb, jsb, family)

    bm, bn, bk = TILE
    if family == "int8":
        jpa, jpb = jax_pad3(jsa, bm, bk), jax_pad3(jsb, bk, bn)
    else:
        jpa = tuple(jax_pad3(v, bm, bk) for v in jsa)
        jpb = tuple(jax_pad3(v, bk, bn) for v in jsb)
    want_full = np.asarray(jax_ozmm_fused_parts(
        jpa, jpb, jax_pad2(ja.lscale[:, None], bm, 1), jax_pad2(jb.lscale[None, :], 1, bn),
        ms=ms, bm=bm, bn=bn, bk=bk, reconstruct="onchip", interpret=True))
    args = fused.fused_parts_args(sa, ta.lscale, sb, tb.lscale, tms, TILE)
    calls, launches = fused.ozmm_fused_parts_ref.calls, fused.ozmm_fused_parts.launches
    got_full = fused.ozmm_fused_parts(*args, ms=tms)
    assert fused.ozmm_fused_parts_ref.calls == calls + 1
    assert fused.ozmm_fused_parts.launches == launches  # no kernel on the CPU
    np.testing.assert_array_equal(got_full.numpy(), want_full)

    want = want_full[:a.shape[0], :b.shape[1]]
    calls = fused.ozmm_fused_parts_ref.calls
    np.testing.assert_array_equal(ozmm(ta, tb, spec + "+pallas").numpy(), want)
    np.testing.assert_array_equal(ozmm(ta, b, spec + "+pallas").numpy(), want)
    np.testing.assert_array_equal(backend_matmul(a, tb, spec + "+pallas",
                                                 device="cpu").numpy(), want)
    assert fused.ozmm_fused_parts_ref.calls == calls + 3
    np.testing.assert_array_equal(ozmm(ta, tb, spec + "+core").numpy(), want)


def test_explicit_pallas_with_prepared_operands_runs(rng):
    """An explicit '+pallas' with prepared operands takes the kernel route
    (it used to raise); so does the phase-split '+unfused' route (it used to
    refuse), with the same bits; '+compiled' refuses CPU tensors."""
    a = rng.random((8, 16)) - 0.5
    qa = prepare_operand(a, "lhs", "ozaki2-fp8/fast@4", device="cpu")
    calls = fused.ozmm_fused_parts_ref.calls
    got = backend_matmul(qa, a.T, "ozaki2-fp8/fast@4+pallas")
    assert fused.ozmm_fused_parts_ref.calls == calls + 1
    np.testing.assert_array_equal(got.numpy(), ozmm(qa, a.T, "ozaki2-fp8/fast@4+core").numpy())
    np.testing.assert_array_equal(
        backend_matmul(qa, a.T, "ozaki2-fp8/fast@4+pallas+unfused").numpy(), got.numpy())
    with pytest.raises(ValueError, match="plain versions"):
        backend_matmul(qa, a.T, "ozaki2-fp8/fast@4+pallas+compiled")


def _stacks(rng, family="fp8-hybrid", n=4, m=64, k=64, cols=64):
    ms = make_moduli_set(family, n)
    spec = f"{SCHEME[family]}/fast@{n}"
    qa = prepare_operand(rng.random((m, k)) - 0.5, "lhs", spec, device="cpu")
    qb = prepare_operand(rng.random((k, cols)) - 0.5, "rhs", spec, device="cpu")
    args = fused.fused_parts_args(stack_parts(qa.parts, ms), qa.lscale,
                                  stack_parts(qb.parts, ms), qb.lscale, ms, TILE)
    return ms, args


def test_cuda_tensor_without_kernel_raises(rng, monkeypatch):
    """A CUDA tensor goes to K2 or raises; it never takes the plain version."""
    ms, (pa, pb, lmu, lnu) = _stacks(rng)
    fake = lambda t: t.as_subclass(FakeCudaTensor)  # noqa: E731
    args = (tuple(map(fake, pa)), tuple(map(fake, pb)), fake(lmu), fake(lnu))

    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(fused_kernel, "_load_parts", no_library)
    calls, launches = fused.ozmm_fused_parts_ref.calls, fused.ozmm_fused_parts.launches
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        fused.ozmm_fused_parts(*args, ms=ms)
    assert fused.ozmm_fused_parts_ref.calls == calls
    assert fused.ozmm_fused_parts.launches == launches


def test_wrapper_rejects_what_the_kernel_does_not_take(rng, monkeypatch):
    ms, (pa, pb, lmu, lnu) = _stacks(rng)
    with pytest.raises(ValueError, match="contiguous float8_e4m3fn"):
        fused.ozmm_fused_parts((pa[0].view(torch.int8),) + pa[1:], pb, lmu, lnu, ms=ms)
    with pytest.raises(ValueError, match="contiguous int32"):
        fused.ozmm_fused_parts(pa, pb, lmu.long(), lnu, ms=ms)
    with pytest.raises(ValueError, match="shape"):
        fused.ozmm_fused_parts(pa, tuple(v[:3] for v in pb), lmu, lnu, ms=ms)
    ms8, (pa8, pb8, lmu8, lnu8) = _stacks(rng, "int8", 3)
    with pytest.raises(ValueError, match="contiguous int8"):
        fused.ozmm_fused_parts(pa8.view(torch.uint8), pb8, lmu8, lnu8, ms=ms8)
    ms, (pa, pb, lmu, lnu) = _stacks(rng, k=32)
    with pytest.raises(ValueError, match="kernel tile"):
        fused.ozmm_fused_parts(tuple(v[:, :, :32].contiguous() for v in pa),
                               tuple(v[:, :32].contiguous() for v in pb), lmu, lnu, ms=ms)
    ms, (pa, pb, lmu, lnu) = _stacks(rng)
    monkeypatch.setattr(fused_kernel, "max_k", lambda ms: 32)
    with pytest.raises(ValueError, match="exceeds"):
        fused.ozmm_fused_parts(pa, pb, lmu, lnu, ms=ms)
