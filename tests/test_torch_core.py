"""repro_torch.core vs the JAX reference, module by module: moduli constants,
numerics helpers, the scaling exponents, and the core executor at a small
modulus count. The same numpy inputs go through both packages.

Tolerance: bitwise everywhere except ``log2_up``, where XLA's and PyTorch's
log2 differ by up to one ulp (the 2^-40 guard dominates that; a flipped
``floor`` in the scaling would show in the exponent tests below)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import crt as jcrt
from repro.core import moduli as jmod
from repro.core import numerics as jnum
from repro.core import scaling as jscal
from repro.testing import lognormal_matrix
from repro_torch.core import crt as tcrt
from repro_torch.core import moduli as tmod
from repro_torch.core import numerics as tnum
from repro_torch.core import scaling as tscal

from _torch_parity import assert_both_routes_match_reference, operands
from _torch_threads import one_torch_thread  # noqa: F401

FAMILY_SIZES = [(fam, n) for fam, top in jmod.DEFAULT_NUM_MODULI.items()
                for n in range(2, top + 1)]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _edge_rows(rng, m, k, phi):
    """Lognormal rows with a 1e-300-scaled row, a zero row and a 1e150 row."""
    x = lognormal_matrix(rng, (m, k), phi)
    x[1] *= 1e-300
    x[2] = 0.0
    x[3] *= 1e150
    return x


def test_module_constants_match():
    assert tmod.DEFAULT_NUM_MODULI == jmod.DEFAULT_NUM_MODULI
    assert (tmod.KARATSUBA_S, tmod.POW2_TABLE_LEN) == (jmod.KARATSUBA_S,
                                                       jmod.POW2_TABLE_LEN)


@pytest.mark.parametrize("family,n", FAMILY_SIZES)
def test_moduli_set_matches_reference(family, n):
    ref, got = jmod.make_moduli_set(family, n), tmod.make_moduli_set(family, n)
    for attr in ("ps", "P", "is_square", "split_s", "radix_order", "radix_ps",
                 "centered_half", "num_split_matrices"):
        assert getattr(got, attr) == getattr(ref, attr), attr
    for attr in ("garner_inv", "radix_weights_f64", "pow2_mod_tables"):
        a, b = getattr(got, attr), getattr(ref, attr)
        assert a.dtype == b.dtype and np.array_equal(a, b), attr


def test_ldexp_wide_bitwise(rng):
    x = lognormal_matrix(rng, (64, 32), 2.0)
    e = rng.integers(-1000, 1000, (64, 32)).astype(np.int32)
    tiny = lognormal_matrix(rng, (64, 32), 0.5) * 1e-300
    e_up = rng.integers(0, 1900, (64, 32)).astype(np.int32)  # denormal-range rows' scales
    for xx, ee in ((x, e), (tiny, e_up), (np.zeros((4, 4)), np.full((4, 4), 700, np.int32))):
        want = np.asarray(jnum.ldexp_wide(jnp.asarray(xx), jnp.asarray(ee)))
        np.testing.assert_array_equal(tnum.ldexp_wide(_t(xx), _t(ee)).numpy(), want)


def test_cast_e4m3_roundup_bitwise(rng):
    x = np.concatenate([(rng.standard_normal(4096) * 60).astype(np.float32),
                        np.array([0.0, -0.0, 1.0, 16.0, 255.9, -255.9, 1e-3],
                                 np.float32)])
    want = np.asarray(jax.lax.bitcast_convert_type(
        jnum.cast_e4m3_roundup(jnp.asarray(x)), jnp.uint8))
    got = tnum.cast_e4m3_roundup(_t(x)).view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, want)


def test_mant_exp_and_residues_bitwise(rng):
    x = np.trunc(_edge_rows(rng, 8, 64, 2.0) * 2.0 ** rng.integers(0, 120, (8, 64)))
    jm, je = jnum.f64_to_mant_exp(jnp.asarray(x))
    tm, te = tnum.f64_to_mant_exp(_t(x))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    ms = tmod.make_moduli_set("fp8-hybrid", 12)
    tables = ms.pow2_mod_tables
    for l, p in enumerate(ms.ps):
        want = jnum.residues_from_mant_exp(jm, je, p, jnp.asarray(tables[l]))
        got = tnum.residues_from_mant_exp(tm, te, p, _t(tables[l]))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p", [1089, 1024, 511, 256, 255])
def test_centered_mod_bitwise(rng, p):
    x = rng.integers(-2 ** 30, 2 ** 30, 4096).astype(np.int32)
    np.testing.assert_array_equal(tnum.centered_mod(_t(x), p).numpy(),
                                  np.asarray(jnum.centered_mod(jnp.asarray(x), p)))


def test_garner_and_kahan_reconstruct_bitwise(rng):
    ms = tmod.make_moduli_set("fp8-hybrid", 12)
    cs = [rng.integers(-(p // 2), (p + 1) // 2, (16, 24)).astype(np.int32) for p in ms.ps]
    lmu = rng.integers(-60, 60, 16).astype(np.int32)
    lnu = rng.integers(-60, 60, 24).astype(np.int32)
    jd = jcrt.garner_digits([jnp.asarray(c) for c in cs], jmod.make_moduli_set("fp8-hybrid", 12))
    td = tcrt.garner_digits([_t(c) for c in cs], ms)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    want = jcrt.reconstruct(jd, jmod.make_moduli_set("fp8-hybrid", 12),
                            jnp.asarray(lmu), jnp.asarray(lnu))
    got = tcrt.reconstruct(td, ms, _t(lmu), _t(lnu))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_log2_up_within_one_ulp(rng):
    x = np.abs(lognormal_matrix(rng, (4096,), 2.0)) * 10.0 ** rng.integers(-300, 300, 4096)
    want = np.asarray(jnum.log2_up(jnp.asarray(x)))
    got = tnum.log2_up(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -52, atol=0)


@pytest.mark.parametrize("mode", ["fast", "accurate"])
@pytest.mark.parametrize("phi", [0.5, 2.0])
def test_scaling_exponents_equal_reference(rng, mode, phi):
    """lmu/lnu equal repro.core.scaling.compute_scaling's (a reduction-order
    or log2 difference would flip a floor here first)."""
    a = _edge_rows(rng, 250, 94, phi)
    b = _edge_rows(rng, 61, 94, phi).T.copy()
    for family, n in (("fp8-hybrid", 12), ("int8", 14)):
        ref = jscal.compute_scaling(jnp.asarray(a), jnp.asarray(b),
                                    jmod.make_moduli_set(family, n), mode)
        got = tscal.compute_scaling(_t(a), _t(b), tmod.make_moduli_set(family, n), mode)
        np.testing.assert_array_equal(got.lmu.numpy(), np.asarray(ref.lmu))
        np.testing.assert_array_equal(got.lnu.numpy(), np.asarray(ref.lnu))
        assert got.extra_matmuls == ref.extra_matmuls


@pytest.mark.parametrize("mode", ["fast", "accurate"])
def test_ozmm_ozaki2_four_moduli_bitwise(mode):
    a, b = operands(6, (64, 96, 80), 2.0)
    assert_both_routes_match_reference(a, b, "fp8-hybrid", mode, num_moduli=4)
