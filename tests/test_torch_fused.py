"""The fused raw-frame kernel's module (repro_torch.kernels.fused) vs the JAX
reference: the raw-frame decomposition and the kernel's integer core
bitwise, the kernel route against the Pallas kernel in interpret mode,
padding/cropping, tile selection, and the wrapper's refusal to take a
silent plain path for a CUDA tensor. Tolerance: bitwise throughout.
tests/test_torch_cuda.py holds the kernel itself against its plain version
on the card."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ozmm_pallas_fused as jax_ozmm_pallas_fused
from repro.kernels.fused.kernel import _residue_tile as jax_residue_tile
from repro.kernels.fused.ops import decompose_raw as jax_decompose_raw
from repro.testing import lognormal_matrix
from repro_torch import ozmm
from repro_torch.core.moduli import make_moduli_set
from repro_torch.kernels import fused
from repro_torch.kernels.common import resolve_reconstruct
from repro_torch.kernels.fused import kernel as fused_kernel
from repro_torch.precision import parse_policy

from _torch_parity import FakeCudaTensor
from _torch_threads import one_torch_thread  # noqa: F401


def _t(x):
    return torch.from_numpy(np.array(x))


def test_decompose_raw_bitwise(rng):
    x = lognormal_matrix(rng, (64, 48), 2.0)
    x[0] *= 1e-300
    x[1] = 0.0
    x[2] *= 1e300
    for got, want in zip(fused.decompose_raw(_t(x)), jax_decompose_raw(jnp.asarray(x))):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("family,n", [("fp8-hybrid", 12), ("int8", 14)])
def test_residue_tile_bitwise(rng, family, n):
    """The kernel's integer core over the whole exponent range: deep
    truncation past the 31-bit shift clip, the two-limb boundary, and table
    indices past the end of the 2^e-mod-p table."""
    mh, ml, e = jax_decompose_raw(jnp.asarray(lognormal_matrix(rng, (32, 40), 2.0)))
    sc = np.asarray(e) + rng.integers(-80, 1150, (32, 40)).astype(np.int32)
    ms = make_moduli_set(family, n)
    for l, p in enumerate(ms.ps):
        pw = ms.pow2_mod_tables[l]
        want = jax_residue_tile(mh, ml, jnp.asarray(sc), p, jnp.asarray(pw))
        got = fused_kernel._residue_tile(_t(mh), _t(ml), _t(sc), p, _t(pw))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["fast", "accurate"])
def test_kernel_route_matches_jax_fused_interpreter(rng, mode):
    """'+pallas' on CPU tensors runs the plain version, bitwise equal to the
    Pallas kernel under the interpreter; 7 moduli = 6 square + 1 Karatsuba."""
    a = lognormal_matrix(rng, (40, 70), 0.5)
    b = lognormal_matrix(rng, (70, 50), 2.0)
    want = jax_ozmm_pallas_fused(jnp.asarray(a), jnp.asarray(b), family="fp8-hybrid",
                                 num_moduli=7, mode=mode, interpret=True,
                                 blocks=(32, 64, 64))
    calls, launches = fused.ozmm_fused_raw_ref.calls, fused.ozmm_fused_raw.launches
    got = ozmm(a, b, f"ozaki2-fp8/{mode}@7+pallas", device="cpu")
    assert fused.ozmm_fused_raw_ref.calls == calls + 1
    assert fused.ozmm_fused_raw.launches == launches  # no kernel on the CPU
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(1, 5, 3), (65, 130, 63)])
@pytest.mark.parametrize("spec", ["ozaki2-fp8/fast@7", "ozaki2-int8/accurate@5"])
def test_padding_and_cropping_bitwise(rng, shape, spec):
    m, k, n = shape
    a = lognormal_matrix(rng, (m, k), 2.0)
    b = lognormal_matrix(rng, (k, n), 2.0)
    got = ozmm(a, b, spec + "+pallas", device="cpu")
    assert got.shape == (m, n)
    pol = parse_policy(spec)
    want = fused.ozmm_fused_ref(_t(a), _t(b), family=pol.moduli_set().family,
                                num_moduli=pol.num_moduli, mode=pol.mode)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_select_blocks_precedence(monkeypatch):
    monkeypatch.delenv(fused.BLOCKS_ENV, raising=False)
    assert fused.select_blocks("cuda") == fused.KERNEL_TILE
    assert fused.select_blocks("cpu") == fused.KERNEL_TILE
    monkeypatch.setenv(fused.BLOCKS_ENV, "128,64,192")
    assert fused.select_blocks("cuda") == (128, 64, 192)
    assert fused.select_blocks("cuda", (64, 128, 64)) == (64, 128, 64)
    monkeypatch.setenv(fused.BLOCKS_ENV, "not,a,shape")
    with pytest.raises(ValueError, match="REPRO_FUSED_BLOCKS"):
        fused.select_blocks("cuda")
    monkeypatch.delenv(fused.BLOCKS_ENV)
    with pytest.raises(ValueError, match="no fused-kernel tile"):
        fused.select_blocks("mps")


def test_resolve_reconstruct_onchip_only():
    """None resolves to the on-chip f64 epilogue; the digit stack ("xla") is
    taken by name."""
    assert resolve_reconstruct(None) == resolve_reconstruct("onchip") == "onchip"
    assert resolve_reconstruct("xla") == "xla"
    with pytest.raises(ValueError):
        resolve_reconstruct("hbm")


def _frames(rng, ms, m=64, k=64, n=64, blocks=fused.KERNEL_TILE):
    a = _t(lognormal_matrix(rng, (m, k), 0.5))
    b = _t(lognormal_matrix(rng, (k, n), 0.5))
    lmu = torch.full((m,), 40, dtype=torch.int32)
    lnu = torch.full((n,), 40, dtype=torch.int32)
    return fused.fused_raw_args(a, lmu, b, lnu, ms, blocks)


def test_cuda_tensor_without_kernel_raises(rng, monkeypatch):
    """A CUDA tensor goes to the kernel or raises; it never takes the plain
    version silently."""
    ms = make_moduli_set("fp8-hybrid", 4)
    args = [t.as_subclass(FakeCudaTensor) for t in _frames(rng, ms)]

    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(fused_kernel, "_load", no_library)
    calls, launches = fused.ozmm_fused_raw_ref.calls, fused.ozmm_fused_raw.launches
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        fused.ozmm_fused_raw(*args, ms=ms)
    assert fused.ozmm_fused_raw_ref.calls == calls
    assert fused.ozmm_fused_raw.launches == launches


def test_wrapper_rejects_what_the_kernel_does_not_take(rng, monkeypatch):
    ms = make_moduli_set("fp8-hybrid", 4)
    args = list(_frames(rng, ms))
    with pytest.raises(ValueError, match="contiguous int32"):
        fused.ozmm_fused_raw(*[args[0].long()] + args[1:], ms=ms)
    with pytest.raises(ValueError, match="contiguous int32"):
        fused.ozmm_fused_raw(*args[:8] + [args[8][:3]], ms=ms)
    with pytest.raises(ValueError, match="kernel tile"):
        fused.ozmm_fused_raw(*_frames(rng, ms, k=32, blocks=(1, 1, 1)), ms=ms)
    monkeypatch.setattr(fused_kernel, "max_k", lambda ms: 32)
    with pytest.raises(ValueError, match="exceeds"):
        fused.ozmm_fused_raw(*args, ms=ms)
    monkeypatch.setattr(fused_kernel, "max_k", lambda ms: 2 ** 16)
    monkeypatch.setattr(fused_kernel, "MAX_MODULI", 3)
    with pytest.raises(ValueError, match="moduli exceed"):
        fused.ozmm_fused_raw(*args, ms=ms)
