"""B's K-major layout through the phase-split pipeline (repro_torch.kernels):
K6 on B^T gives B's residue parts transposed, the residue GEMMs K3/K4 take
B K-major or contiguous and equal the JAX reference's Pallas kernels in
interpret mode either way, the kernel route is a function of k and the
operands' alignment alone, other strides of B are refused, and the pipeline
hands every GEMM a K-major B. On CPU tensors every wrapper runs its plain
version. Tolerance: bitwise throughout (e4m3 compared as bytes)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import fp8_gemm_op as jax_fp8_gemm_op
from repro.kernels import int8_gemm_op as jax_int8_gemm_op
from repro_torch import ozmm, prepare_operand
from repro_torch import kernels as kn
from repro_torch.core.moduli import make_moduli_set
from repro_torch.kernels import pipeline
from repro_torch.kernels.fp8_gemm import residue_gemm_route
from repro_torch.kernels.fused import transpose_parts

from _torch_parity import PRIME_ISH, FakeCudaTensor, operands
from _torch_threads import one_torch_thread  # noqa: F401


def _bytes(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t).numpy()


def _stacks(x):
    return list(x) if isinstance(x, tuple) else [x]


@pytest.mark.parametrize("family,n", [("fp8-hybrid", 12), ("fp8-karatsuba", 13), ("int8", 14)])
def test_quant_residues_of_b_transpose_are_b_parts_transposed(family, n):
    """K6's module on B^T with per-row exponents (axis 0) gives, bit for bit,
    its parts of B under per-column exponents (axis 1), transposed: the
    residues are elementwise. B (94, 61) has a tiny, a huge and a zero
    column."""
    rng = np.random.default_rng(21)
    _, b = operands(21, PRIME_ISH, 2.0)
    b[:, 0] *= 1e-300
    b[:, 1] *= 1e300
    b[:, 2] = 0.0
    lnu = rng.integers(0, 60, b.shape[1]).astype(np.int32)
    lnu[0], lnu[1] = 1000, 0
    ms = make_moduli_set(family, n)
    tb, tl = torch.from_numpy(b), torch.from_numpy(lnu)
    by_column = kn.quant_residues_op(tb, tl, ms=ms, axis=1)
    by_row = kn.quant_residues_op(pipeline.k_major(tb), tl, ms=ms, axis=0)
    for col, row in zip(_stacks(by_column), _stacks(by_row)):
        assert tuple(row.shape) == (n, 61, 94)
        np.testing.assert_array_equal(_bytes(row), _bytes(col.transpose(1, 2).contiguous()))


@pytest.mark.parametrize("layout", ["k-major", "contiguous"])
@pytest.mark.parametrize("which", ["fp8", "int8"])
def test_residue_gemm_takes_either_layout_of_b(which, layout):
    """K3 and K4 at the ragged 250 x 94 x 61 with B K-major (the transpose of
    a contiguous (n, k) plane, as the pipeline hands it) or contiguous,
    against the Pallas kernels in interpret mode; on CPU tensors the plain
    version runs and B is never copied."""
    rng = np.random.default_rng(22)
    m, k, n = PRIME_ISH
    lim = 16 if which == "fp8" else 128
    a = rng.integers(-lim, lim + (which == "fp8"), (m, k))
    b = rng.integers(-lim, lim + (which == "fp8"), (k, n))
    if which == "fp8":
        f8 = lambda x: jnp.asarray(x, jnp.float32).astype(jnp.float8_e4m3fn)  # noqa: E731
        want = np.asarray(jax_fp8_gemm_op(f8(a), f8(b), interpret=True))
        t8 = lambda x: torch.tensor(x, dtype=torch.float32).to(torch.float8_e4m3fn)  # noqa: E731
        kern, plain = kn.fp8_gemm, kn.fp8_gemm_plain
    else:
        want = np.asarray(jax_int8_gemm_op(jnp.asarray(a, jnp.int8), jnp.asarray(b, jnp.int8),
                                           interpret=True))
        t8 = lambda x: torch.tensor(x, dtype=torch.int8)  # noqa: E731
        kern, plain = kn.int8_gemm, kn.int8_gemm_plain
    tb = t8(b.T.copy()).t() if layout == "k-major" else t8(b)
    assert tb.t().is_contiguous() == (layout == "k-major")
    before = (plain.calls, kern.launches, kern.b_copies)
    np.testing.assert_array_equal(kern(t8(a), tb).numpy(), want)
    assert (plain.calls, kern.launches, kern.b_copies) == (before[0] + 1, *before[1:])


@pytest.mark.parametrize("k,a_addr,b_addr,route", [
    (1024, 0, 0, "wgmma"),          # the main path's planes
    (16, 16, 4096, "wgmma"),        # the shallowest TMA row
    (65536, 1 << 20, 1 << 30, "wgmma"),
    (128, 94 * 128, 61 * 128, "wgmma"),  # a plane l of a stack: l * rows * k bytes in
    (997, 0, 0, "mma_sync"),        # k % 16: rows at no 16-byte stride
    (94, 0, 0, "mma_sync"),
    (8, 0, 0, "mma_sync"),
    (128, 1, 0, "mma_sync"),        # A not 16-byte aligned
    (128, 0, 8, "mma_sync"),        # B^T not 16-byte aligned
    (1003, 1003 * 3, 0, "mma_sync"),
])
def test_residue_gemm_route_is_a_function_of_k_and_alignment(k, a_addr, b_addr, route):
    assert residue_gemm_route(k, a_addr, b_addr) == route


@pytest.mark.parametrize("device", ["cpu", "fake-cuda"])
def test_other_strides_of_b_raise(device):
    """A B that is neither contiguous nor K-major (every other column of a
    plane; a row slice with a wider stride) is refused before any plain
    version or kernel runs."""
    wrap = (lambda t: t.as_subclass(FakeCudaTensor)) if device == "fake-cuda" else (lambda t: t)
    for kern, plain, dtype in ((kn.fp8_gemm, kn.fp8_gemm_plain, torch.float8_e4m3fn),
                               (kn.int8_gemm, kn.int8_gemm_plain, torch.int8)):
        a = wrap(torch.zeros((8, 16), dtype=dtype))
        for b in (torch.zeros((16, 8), dtype=dtype)[:, ::2],
                  torch.zeros((16, 8), dtype=dtype).t()[:4].t(),
                  torch.zeros((32, 4), dtype=dtype)[::2]):
            before = (plain.calls, kern.launches, kern.b_copies)
            with pytest.raises(ValueError, match="contiguous or K-major"):
                kern(a, wrap(b))
            assert (plain.calls, kern.launches, kern.b_copies) == before


def _k_major_calls(monkeypatch):
    """Record, for every K3/K4 call the pipeline makes, whether its B is
    K-major."""
    seen = []
    for name in ("fp8_gemm", "int8_gemm"):
        orig = getattr(pipeline, name)

        def record(a, b, *, out=None, _orig=orig):
            seen.append(b.t().is_contiguous())
            return _orig(a, b, out=out)

        monkeypatch.setattr(pipeline, name, record)
    return seen


@pytest.mark.parametrize("spec", ["ozaki2-fp8/fast@4", "ozaki2-fp8/accurate@4",
                                  "ozaki2-int8/fast@5"])
def test_pipeline_hands_every_gemm_a_k_major_b(monkeypatch, spec):
    """'+pallas+unfused' on raw and prepared operands hands every GEMM a
    K-major B (so the kernels never copy one), makes B^T once per call
    (K2's transpose for a fast-mode plan), and equals '+core'."""
    a, b = operands(23, (40, 30, 36), 1.0)
    seen = _k_major_calls(monkeypatch)
    transposes = kn.fused.transpose_parts_plain.calls
    qa, qb = prepare_operand(a, "lhs", spec, device="cpu"), prepare_operand(b, "rhs", spec,
                                                                            device="cpu")
    for x, y in ((a, b), (qa, qb)):
        got = ozmm(x, y, spec + "+pallas+unfused", device="cpu")
        np.testing.assert_array_equal(got.numpy(),
                                      ozmm(x, y, spec + "+core", device="cpu").numpy())
    ms = qa.ms
    assert len(seen) == 2 * (ms.n if ms.family == "int8" else 3 * ms.n) and all(seen)
    fast = spec.split("/")[1].startswith("fast")
    assert kn.fused.transpose_parts_plain.calls == transposes + fast


def test_transpose_parts_takes_ragged_planes():
    """K2's B transpose, which the pipeline runs on a fast-mode plan's
    stacks, on ragged (N, 94, 61) planes: each plane transposed."""
    ms = make_moduli_set("fp8-karatsuba", 3)
    rng = np.random.default_rng(24)
    stacks = tuple(torch.tensor(rng.integers(-16, 17, (3, 94, 61)), dtype=torch.float32)
                   .to(torch.float8_e4m3fn) for _ in range(3))
    for got, src in zip(transpose_parts(stacks, ms=ms), stacks):
        np.testing.assert_array_equal(_bytes(got), _bytes(src.transpose(1, 2).contiguous()))
