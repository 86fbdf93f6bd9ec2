"""The phase-split pipeline's kernel modules (repro_torch.kernels:
quant_residues K6, fp8_gemm K3, int8_gemm K4, crt_reconstruct K5) against
the JAX reference's Pallas kernels in interpret mode, on the same numpy
inputs, through the port's plain versions (what a wrapper runs on CPU
tensors). Tolerance: bitwise throughout (e4m3 compared as bytes). Also:
each plain version's call count moves, no kernel launches on the CPU, and
each wrapper refuses a CUDA tensor it cannot launch for rather than taking
its plain version. tests/test_torch_cuda.py holds the kernels themselves
against their plain versions on the card."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core.moduli import make_moduli_set as jax_moduli_set
from repro.kernels import decompose_int as jax_decompose_int
from repro.kernels import fp8_gemm_op as jax_fp8_gemm_op
from repro.kernels import int8_gemm_op as jax_int8_gemm_op
from repro.kernels import quant_residues_op as jax_quant_residues_op
from repro.kernels import requant_garner_op as jax_requant_garner_op
from repro.testing import lognormal_matrix
from repro_torch import kernels as kn
from repro_torch.core.moduli import make_moduli_set
from repro_torch.core.plan import pow2_tables
from repro_torch.kernels.crt_reconstruct import kernel as k5_module
from repro_torch.kernels.fp8_gemm import kernel as k3_module
from repro_torch.kernels.quant_residues import kernel as k6_module

from _torch_parity import FakeCudaTensor
from _torch_threads import one_torch_thread  # noqa: F401


def _bytes(x) -> np.ndarray:
    """A stack as comparable integers: e4m3 as its bit pattern."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x).numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype.name == "float8_e4m3fn" else x


def _as_list(stacks):
    return list(stacks) if isinstance(stacks, tuple) else [stacks]


def _operand_with_extremes(rng, shape):
    """Lognormal values with a tiny (1e-300), a huge (1e300) and a zero row,
    and per-row scales that bring the tiny row into the integer range."""
    a = lognormal_matrix(rng, shape, 2.0)
    a[0] *= 1e-300
    a[1] *= 1e300
    a[2] = 0.0
    lscale = rng.integers(0, 60, shape[0]).astype(np.int32)
    lscale[0], lscale[1] = 1000, 0
    return a, lscale


@pytest.mark.parametrize("family,n", [("fp8-hybrid", 12), ("fp8-karatsuba", 13), ("int8", 14)])
def test_quant_residues_op_bitwise(family, n):
    """K6's module: scaled_int + decompose_int + the residue pass, at the
    ragged (100, 300) shape, against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(1)
    a, lscale = _operand_with_extremes(rng, (100, 300))
    want = jax_quant_residues_op(jnp.asarray(a), jnp.asarray(lscale), ms=jax_moduli_set(family, n),
                                 axis=0, interpret=True)
    calls, launches = kn.quant_residues_plain.calls, kn.quant_residues.launches
    got = kn.quant_residues_op(torch.from_numpy(a), torch.from_numpy(lscale),
                               ms=make_moduli_set(family, n), axis=0)
    assert kn.quant_residues_plain.calls == calls + 1
    assert kn.quant_residues.launches == launches  # no kernel on the CPU
    assert len(_as_list(got)) == len(_as_list(want))
    for g, w in zip(_as_list(got), _as_list(want)):
        assert tuple(g.shape) == (n, 100, 300)
        np.testing.assert_array_equal(_bytes(g), _bytes(w))


def test_quant_residues_matches_core_quantization_columnwise():
    """The B side (axis=1, per-column scales) of K6's module against the
    core quantization's stacks (``quant_residues_ref``), for the hybrid
    family's square and Karatsuba moduli."""
    rng = np.random.default_rng(2)
    a, lscale = _operand_with_extremes(rng, (70, 90))
    a, lscale = torch.from_numpy(a.T.copy()), torch.from_numpy(lscale)
    ms = make_moduli_set("fp8-hybrid", 9)
    got = kn.quant_residues_op(a, lscale, ms=ms, axis=1)
    from repro_torch.core.quantize import scaled_int

    want = kn.quant_residues_ref(scaled_int(a, lscale, 1), ms)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bytes(g), _bytes(w))


def test_decompose_int_bitwise(rng):
    a = np.trunc(rng.standard_normal((16, 16)) * 2.0 ** rng.integers(0, 90, (16, 16)))
    a[0] *= 1e280
    a[1] = 0.0
    a[2] = -np.abs(a[2])
    for got, want in zip(kn.decompose_int(torch.from_numpy(a)), jax_decompose_int(jnp.asarray(a))):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("which", ["fp8", "int8", "fp8-kmajor", "int8-kmajor"])
def test_residue_gemm_bitwise(which):
    """K3 (e4m3 -> f32) and K4 (int8 -> int32) at (m, n, k) = (200, 72,
    300), into a fresh tensor and into an ``out=`` plane, against the
    Pallas kernels in interpret mode; B contiguous, or K-major (the
    transpose of a contiguous (n, k) plane, as the pipeline hands it)."""
    rng = np.random.default_rng(3)
    m, n, k = 200, 72, 300
    family = which.split("-")[0]
    lim = 16 if family == "fp8" else 128
    a = rng.integers(-lim, lim + (family == "fp8"), (m, k))
    b = rng.integers(-lim, lim + (family == "fp8"), (k, n))
    if family == "fp8":
        ja = jnp.asarray(a, jnp.float32).astype(jnp.float8_e4m3fn)
        jb = jnp.asarray(b, jnp.float32).astype(jnp.float8_e4m3fn)
        want = np.asarray(jax_fp8_gemm_op(ja, jb, interpret=True))
        ta = torch.tensor(a, dtype=torch.float32).to(torch.float8_e4m3fn)
        tb = torch.tensor(b, dtype=torch.float32).to(torch.float8_e4m3fn)
        kern, plain, out_dtype = kn.fp8_gemm, kn.fp8_gemm_plain, torch.float32
    else:
        want = np.asarray(jax_int8_gemm_op(jnp.asarray(a, jnp.int8), jnp.asarray(b, jnp.int8),
                                           interpret=True))
        ta, tb = torch.tensor(a, dtype=torch.int8), torch.tensor(b, dtype=torch.int8)
        kern, plain, out_dtype = kn.int8_gemm, kn.int8_gemm_plain, torch.int32
    if which.endswith("kmajor"):
        tb = tb.t().contiguous().t()
    calls, launches = plain.calls, kern.launches
    np.testing.assert_array_equal(kern(ta, tb).numpy(), want)
    stack = torch.zeros((2, m, n), dtype=out_dtype)
    got = kern(ta, tb, out=stack[1])
    assert got.data_ptr() == stack[1].data_ptr()
    np.testing.assert_array_equal(stack[1].numpy(), want)
    assert (plain.calls, kern.launches) == (calls + 2, launches)


@pytest.mark.parametrize("family,n", [("fp8-hybrid", 12), ("int8", 14)])
def test_requant_garner_bitwise(family, n):
    """K5 on random product stacks of the schedule's largest magnitudes,
    against the Pallas kernel in interpret mode (``requant_garner_op``)."""
    rng = np.random.default_rng(4)
    shape = (n, 96, 72)
    if family == "int8":
        parts = (rng.integers(-2 ** 30, 2 ** 30, shape).astype(np.int32),)
    else:
        parts = tuple(rng.integers(-2 ** 24, 2 ** 24, shape).astype(np.float32) for _ in range(3))
    want = jax_requant_garner_op(tuple(jnp.asarray(p) for p in parts),
                                 ms=jax_moduli_set(family, n), interpret=True)
    calls = kn.requant_garner_plain.calls
    got = kn.requant_garner(tuple(torch.from_numpy(p) for p in parts),
                            ms=make_moduli_set(family, n))
    assert kn.requant_garner_plain.calls == calls + 1
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _refuses(monkeypatch, module, kernel, plain, *args, **kw):
    """A CUDA tensor goes to the kernel or raises: with no library to load,
    the wrapper raises and neither the plain version nor a launch runs."""
    def no_library(*_):
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(module, "_load", no_library)
    before = (plain.calls, kernel.launches)
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        kernel(*args, **kw)
    assert (plain.calls, kernel.launches) == before


def test_wrappers_refuse_cuda_tensors_without_a_kernel(monkeypatch):
    fake = lambda t: t.as_subclass(FakeCudaTensor)  # noqa: E731
    ms = make_moduli_set("fp8-hybrid", 4)
    frame = [fake(torch.zeros((8, 16), dtype=torch.int32)) for _ in range(3)]
    _refuses(monkeypatch, k6_module, kn.quant_residues, kn.quant_residues_plain,
             *frame, fake(pow2_tables(ms, "cpu")), ms=ms)
    a = fake(torch.zeros((8, 16), dtype=torch.float8_e4m3fn))
    b = fake(torch.zeros((16, 4), dtype=torch.float8_e4m3fn))
    _refuses(monkeypatch, k3_module, kn.fp8_gemm, kn.fp8_gemm_plain, a, b)
    ai = fake(torch.zeros((8, 16), dtype=torch.int8))
    bi = fake(torch.zeros((16, 4), dtype=torch.int8))
    _refuses(monkeypatch, k3_module, kn.int8_gemm, kn.int8_gemm_plain, ai, bi)
    cparts = tuple(fake(torch.zeros((4, 8, 4))) for _ in range(3))
    _refuses(monkeypatch, k5_module, kn.requant_garner, kn.requant_garner_plain, cparts, ms=ms)


def test_wrappers_reject_what_the_kernels_do_not_take(monkeypatch):
    ms = make_moduli_set("fp8-hybrid", 4)
    a = torch.zeros((8, 16), dtype=torch.float8_e4m3fn)
    with pytest.raises(ValueError, match="contiguous float8_e4m3fn"):
        kn.fp8_gemm(a, torch.zeros((12, 4), dtype=torch.float8_e4m3fn))
    with pytest.raises(ValueError, match="out must be a contiguous float32"):
        kn.fp8_gemm(a, torch.zeros((16, 4), dtype=torch.float8_e4m3fn),
                    out=torch.zeros((4, 8)).t())
    monkeypatch.setattr(k3_module, "max_k", lambda in_dtype: 8)
    with pytest.raises(ValueError, match="exceeds"):
        kn.int8_gemm(torch.zeros((8, 16), dtype=torch.int8), torch.zeros((16, 4), dtype=torch.int8))
    frame = [torch.zeros((8, 16), dtype=torch.int32) for _ in range(3)]
    with pytest.raises(ValueError, match="tbl must be"):
        kn.quant_residues(*frame, pow2_tables(make_moduli_set("fp8-hybrid", 5), "cpu"), ms=ms)
    with pytest.raises(ValueError, match="moduli exceed"):
        ms21 = make_moduli_set("int8", 21)
        kn.quant_residues(*frame, pow2_tables(ms21, "cpu"), ms=ms21)
    with pytest.raises(ValueError, match="takes 3 product stacks"):
        kn.requant_garner((torch.zeros((4, 8, 4)),), ms=ms)
    with pytest.raises(ValueError, match="contiguous int32"):
        kn.requant_garner((torch.zeros((4, 8, 4)),), ms=make_moduli_set("int8", 4))
