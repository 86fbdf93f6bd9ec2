"""K1's residue hoist against the JAX reference on the CPU. The plain
prologue ``raw_parts_plain`` (the layout the residue prologue of
csrc/fused_raw.cu writes: K-major part stacks, B's transposed to (N, n, k))
against the port's own ``quantize.split_residues`` of ``_residue_tile``;
then the hoisted composition, plain prologue followed by
``ozmm_fused_parts_ref`` on those stacks, against the Pallas kernel
``repro.kernels.fused.kernel.ozmm_fused_raw`` in interpret mode on the same
padded frames. Inputs are numpy from a seed, for fp8 fast and accurate,
Karatsuba and int8 at the ragged 250x94x61 (padded to the kernel tile).
Tolerance: bitwise throughout. tests/test_torch_cuda.py holds the prologue kernel
against this plain version on the card."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core.moduli import make_moduli_set as jax_moduli_set
from repro.kernels.fused.kernel import ozmm_fused_raw as jax_ozmm_fused_raw
from repro_torch.core import quantize
from repro_torch.core.scaling import compute_scaling
from repro_torch.kernels import fused
from repro_torch.kernels.fused import kernel as fused_kernel
from repro_torch.precision import parse_policy

from _torch_parity import PRIME_ISH, operands
from _torch_threads import one_torch_thread  # noqa: F401

#: Moduli counts cut to keep the interpreter's compiles short (one per
#: family: fast and accurate share theirs); fp8@7 is 6 square moduli and
#: one Karatsuba modulus.
SPECS = ["ozaki2-fp8/fast@7", "ozaki2-fp8/accurate@7", "ozaki2-karatsuba/fast@4",
         "ozaki2-int8/fast@5"]


def _frames(spec: str, seed: int):
    """The moduli and the padded inputs of ``ozmm_fused_raw`` for lognormal
    operands of the ragged shape 250x94x61, scaled by ``spec``'s mode."""
    pol = parse_policy(spec)
    ms = pol.moduli_set()
    a, b = (torch.from_numpy(x) for x in operands(seed, PRIME_ISH, 1.0))
    scal = compute_scaling(a, b, ms, pol.mode)
    return ms, fused.fused_raw_args(a, scal.lmu, b, scal.lnu, ms, fused.KERNEL_TILE)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.int8 else t.view(torch.uint8)


@pytest.mark.parametrize("spec", SPECS)
def test_plain_prologue_matches_split_residues(spec):
    """Every plane the prologue writes (hi and lo of each modulus, hs of the
    Karatsuba moduli, or the int8 residue) equals the split of the residue
    tile, B's transposed to K-major."""
    ms, args = _frames(spec, 21)
    tbl = args[8]
    for axis, (mh, ml, e, lexp) in enumerate((args[:4], args[4:8])):
        got = fused.part_planes(fused.raw_parts_plain(mh, ml, e, lexp, tbl, ms=ms, axis=axis), ms)
        rs = [fused_kernel._residue_tile(mh, ml, e + lexp, p, tbl[l])
              for l, p in enumerate(ms.ps)]
        want = [w if axis == 0 else _bytes(w).t().contiguous()
                for parts in quantize.split_residues(rs, ms) for w in parts]
        assert len(got) == len(want) == sum(len(p) for p in quantize.split_residues(rs, ms))
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert torch.equal(_bytes(g), _bytes(w))


@pytest.mark.parametrize("spec", SPECS)
def test_hoisted_composition_matches_jax_fused_raw(spec):
    """Plain prologue of both operands, then the plain GEMM from parts, is
    bitwise the reference's fused raw-frame kernel (interpret mode)."""
    ms, args = _frames(spec, 22)
    tbl = args[8]
    sa = fused.raw_parts_plain(*args[:4], tbl, ms=ms, axis=0)
    sb = fused.transpose_parts_plain(fused.raw_parts_plain(*args[4:8], tbl, ms=ms, axis=1),
                                     ms=ms)
    got = fused.ozmm_fused_parts_ref(sa, sb, args[3], args[7], ms=ms)
    bm, bn, bk = fused.KERNEL_TILE
    want = jax_ozmm_fused_raw(*(jnp.asarray(t.numpy()) for t in args),
                              ms=jax_moduli_set(ms.family, ms.n), bm=bm, bn=bn, bk=bk,
                              reconstruct="onchip", interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
