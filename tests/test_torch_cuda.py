"""The Hopper kernels of repro_torch (K1 ozmm_fused_raw with its residue
prologue raw_parts, K2 ozmm_fused_parts with its B transpose, the wgmma
probe of their GEMM core, and the phase-split pipeline's K3 fp8_gemm, K4
int8_gemm, K5 requant_garner in its digits and f64 modes, K6
quant_residues with its frame and f64 entries) against their plain
versions on the card, bitwise; accurate scaling's bound GEMM under the
global TF32 switch; and the serving path: K2 on a cached weight plan at a
decode batch's few rows, and the smoke engine (qwen2-7b; the MoE and MLA
families' moonshot and deepseek) on the kernel routes against '+core';
training: one train step at smoke width on the kernel route against
'+core', and a checkpoint round trip of a train state on the card; the
distributed paths: the sharded GEMMs on a mesh of the card against
'+core', and the block-cyclic LU and solve against the single-device ones.
Every test here is marked ``cuda`` and
skips without a CUDA device.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch; there, skip the JAX-importing conftest::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import ozmm
from repro_torch.core.scaling import compute_scaling
from repro_torch.kernels import fused
from repro_torch.precision import parse_policy


def _lognormal(rng, shape, phi):
    return (rng.random(shape) - 0.5) * np.exp(rng.standard_normal(shape) * phi)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["ozaki2-fp8/fast", "ozaki2-fp8/accurate",
                                  "ozaki2-karatsuba/fast", "ozaki2-int8/accurate"])
def test_kernel_bitwise_vs_plain_on_card(spec):
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    rng = np.random.default_rng(7)
    pol = parse_policy(spec)
    ms = pol.moduli_set()
    a = torch.from_numpy(_lognormal(rng, (200, 300), 2.0)).cuda()
    b = torch.from_numpy(_lognormal(rng, (300, 130), 2.0)).cuda()
    scal = compute_scaling(a, b, ms, pol.mode)
    args = fused.fused_raw_args(a, scal.lmu, b, scal.lnu, ms, fused.KERNEL_TILE)
    launches = fused.ozmm_fused_raw.launches
    got = fused.ozmm_fused_raw(*args, ms=ms)
    assert fused.ozmm_fused_raw.launches == launches + 1
    assert torch.equal(got, fused.ozmm_fused_raw_ref(*args, ms=ms))
    assert torch.equal(got[:200, :130], ozmm(a, b, spec + "+core"))
    assert torch.equal(got[:200, :130], ozmm(a, b, spec))  # backend auto: the kernel


@pytest.mark.cuda
def test_mma_probe_step_is_exact():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    rng = np.random.default_rng(3)
    a = rng.integers(-16, 17, (16, 256))
    b = rng.integers(-16, 17, (256, 8))
    f8 = lambda x: torch.tensor(x, dtype=torch.float32, device="cuda").to(torch.float8_e4m3fn)
    exact, _ = fused.mma_probe(f8(a), f8(b))
    assert torch.equal(exact.cpu().long(), torch.tensor(a) @ torch.tensor(b))


@pytest.mark.cuda
def test_wgmma_probe_exact_at_4096():
    """The GEMM core's promoted wgmma step is exact at k = 4096 on +-16
    patterns and random parts, and its promotion interval is no longer than
    the longest chain the probe found exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    rng = np.random.default_rng(4)
    k = 4096
    a = rng.integers(-16, 17, (64, k))
    b = rng.integers(-16, 17, (k, 8))
    a[0], b[:, 0] = 16, 16
    a[1] = b[:, 1] = np.where(np.arange(k) % 2 == 0, 16, -16)
    f8 = lambda x: torch.tensor(x, dtype=torch.float32, device="cuda").to(torch.float8_e4m3fn)
    exact, chained, first_bad = fused.wgmma_probe(f8(a), f8(b))
    assert torch.equal(exact.cpu().long(), torch.tensor(a) @ torch.tensor(b))
    bad = first_bad.cpu()
    longest = k // 32 if bool((bad < 0).all()) else int(bad[bad >= 0].min())
    assert fused.gemm_kc() <= longest


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["ozaki2-fp8/accurate", "ozaki2-karatsuba/fast",
                                  "ozaki2-int8/fast", "ozaki2-fp8/fast@20"])
def test_raw_parts_bitwise_vs_plain_on_card(spec):
    """K1's residue prologue, A (row-major) and B (K-major, transposed in the
    kernel), against its plain version on every plane it writes."""
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    rng = np.random.default_rng(14)
    pol = parse_policy(spec)
    ms = pol.moduli_set()
    a = torch.from_numpy(_lognormal(rng, (200, 300), 2.0)).cuda()
    b = torch.from_numpy(_lognormal(rng, (300, 130), 2.0)).cuda()
    scal = compute_scaling(a, b, ms, pol.mode)
    args = fused.fused_raw_args(a, scal.lmu, b, scal.lnu, ms, fused.KERNEL_TILE)
    launches = fused.raw_parts.launches
    for axis, (mh, ml, e, lexp) in enumerate((args[:4], args[4:8])):
        got = fused.raw_parts(mh, ml, e, lexp, args[8], ms=ms, axis=axis)
        want = fused.raw_parts_plain(mh, ml, e, lexp, args[8], ms=ms, axis=axis)
        for g, w in zip(fused.part_planes(got, ms), fused.part_planes(want, ms)):
            assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
    assert fused.raw_parts.launches == launches + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 128, 64), (1000, 997, 1003), (128, 128, 1)],
                         ids=["128x128x64", "ragged", "hpl-fold"])
@pytest.mark.parametrize("spec", ["ozaki2-fp8/fast", "ozaki2-karatsuba/fast", "ozaki2-int8/fast"])
def test_fused_kernels_at_tile_ragged_and_fold_shapes(spec, shape):
    """K1 (prologue + core) and K2 (transpose + core) against their plain
    versions at 128x128x64 (m x k x n), a ragged shape and HPL's TRSM fold
    shape (a 128 x 128 block onto one column); each call launches the
    prologue twice or the transpose once."""
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    from repro_torch import prepare_operand
    from repro_torch.kernels import stack_parts

    m, k, n = shape
    rng = np.random.default_rng(15)
    pol = parse_policy(spec)
    ms = pol.moduli_set()
    a = torch.from_numpy(_lognormal(rng, (m, k), 1.0)).cuda()
    b = torch.from_numpy(_lognormal(rng, (k, n), 1.0)).cuda()
    scal = compute_scaling(a, b, ms, pol.mode)
    args = fused.fused_raw_args(a, scal.lmu, b, scal.lnu, ms, fused.KERNEL_TILE)
    counts = fused.ozmm_fused_raw.launches, fused.raw_parts.launches
    got = fused.ozmm_fused_raw(*args, ms=ms)
    assert (fused.ozmm_fused_raw.launches, fused.raw_parts.launches) == (counts[0] + 1,
                                                                         counts[1] + 2)
    assert torch.equal(got, fused.ozmm_fused_raw_ref(*args, ms=ms))
    qa, qb = prepare_operand(a, "lhs", spec), prepare_operand(b, "rhs", spec)
    pargs = fused.fused_parts_args(stack_parts(qa.parts, ms), qa.lscale,
                                   stack_parts(qb.parts, ms), qb.lscale, ms, fused.KERNEL_TILE)
    counts = fused.ozmm_fused_parts.launches, fused.transpose_parts.launches
    got = fused.ozmm_fused_parts(*pargs, ms=ms)
    assert (fused.ozmm_fused_parts.launches, fused.transpose_parts.launches) == (counts[0] + 1,
                                                                                 counts[1] + 1)
    assert torch.equal(got, fused.ozmm_fused_parts_ref(*pargs, ms=ms))
    assert torch.equal(got[:m, :n], ozmm(qa, qb, spec + "+core"))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["ozaki2-fp8/fast", "ozaki2-karatsuba/fast",
                                  "ozaki2-int8/fast", "ozaki2-fp8/fast@2"])
def test_parts_kernel_bitwise_vs_plain_on_card(spec):
    """K2 (ozmm_fused_parts) against its plain version and the core route,
    on plans prepared on the card, at a shape that needs padding."""
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    from repro_torch import prepare_operand
    from repro_torch.kernels import stack_parts

    rng = np.random.default_rng(8)
    ms = parse_policy(spec).moduli_set()
    qa = prepare_operand(_lognormal(rng, (200, 300), 2.0), "lhs", spec)
    qb = prepare_operand(_lognormal(rng, (300, 130), 2.0), "rhs", spec)
    args = fused.fused_parts_args(stack_parts(qa.parts, ms), qa.lscale,
                                  stack_parts(qb.parts, ms), qb.lscale, ms, fused.KERNEL_TILE)
    launches = fused.ozmm_fused_parts.launches
    got = fused.ozmm_fused_parts(*args, ms=ms)
    assert fused.ozmm_fused_parts.launches == launches + 1
    assert torch.equal(got, fused.ozmm_fused_parts_ref(*args, ms=ms))
    assert torch.equal(got[:200, :130], ozmm(qa, qb, spec + "+core"))
    assert torch.equal(got[:200, :130], ozmm(qa, qb, spec))  # backend auto: K2


@pytest.mark.cuda
def test_prepared_accurate_pairing_on_card():
    """An accurate prepared pairing on the kernel route is K1 under the bound
    GEMM's exponents, bitwise equal to the core route."""
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    from repro_torch import prepare_operand

    rng = np.random.default_rng(9)
    spec = "ozaki2-fp8/accurate"
    qa = prepare_operand(_lognormal(rng, (150, 200), 1.0), "lhs", spec)
    qb = prepare_operand(_lognormal(rng, (200, 70), 1.0), "rhs", spec)
    launches = fused.ozmm_fused_raw.launches
    got = ozmm(qa, qb, spec + "+pallas")
    assert fused.ozmm_fused_raw.launches == launches + 1
    assert torch.equal(got, ozmm(qa, qb, spec + "+core"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fast", "accurate"])
def test_kernel_route_lu_and_solve_on_card(mode):
    """lu_factor + lu_solve on '+pallas' on the card (K2 in fast mode, K1 in
    accurate mode, every trailing update and every TRSM fold of a one-column
    right-hand side) equal '+core' bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    from repro_torch import linalg

    n, blk = 256, 64
    a, b = linalg.hpl_matrix(n, seed=5)
    spec = f"ozaki2-fp8/{mode}"
    k1, k2 = fused.ozmm_fused_raw.launches, fused.ozmm_fused_parts.launches
    lu, perm = linalg.lu_factor(a, spec + "+pallas", block=blk)
    x = linalg.lu_solve(lu, perm, b, spec + "+pallas", block=blk)
    nb = n // blk
    pairings = (nb - 1) + nb * (nb - 1)  # trailing updates + the solve's folds
    want = (0, pairings) if mode == "fast" else (pairings, 0)
    assert (fused.ozmm_fused_raw.launches - k1, fused.ozmm_fused_parts.launches - k2) == want
    lu_c, perm_c = linalg.lu_factor(a, spec + "+core", block=blk)
    np.testing.assert_array_equal(perm, perm_c)
    np.testing.assert_array_equal(lu, lu_c)
    np.testing.assert_array_equal(x, linalg.lu_solve(lu_c, perm_c, b, spec + "+core", block=blk))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(200, 72, 300), (130, 96, 260), (1000, 997, 1003)])
def test_residue_gemms_bitwise_vs_plain_on_card(shape):
    """K3 and K4 at ragged shapes (the mma_sync route where k % 16 is not 0,
    the wgmma route otherwise), with a contiguous B (transposed once by the
    wrapper), written through an out= plane of a stack, against their plain
    versions; edges past the plane untouched."""
    from repro_torch.kernels import fp8_gemm, fp8_gemm_plain, int8_gemm, int8_gemm_plain

    _need_card()
    m, k, n = shape
    rng = np.random.default_rng(10)
    cases = [(fp8_gemm, fp8_gemm_plain, 16, torch.float32),
             (int8_gemm, int8_gemm_plain, 128, torch.int32)]
    for kern, plain, lim, out_dtype in cases:
        a = torch.tensor(rng.integers(-lim, lim, (m, k)), dtype=torch.float32, device="cuda")
        b = torch.tensor(rng.integers(-lim, lim, (k, n)), dtype=torch.float32, device="cuda")
        dtype = torch.float8_e4m3fn if kern is fp8_gemm else torch.int8
        a, b = a.to(dtype), b.to(dtype)
        stack = torch.full((3, m, n), 7, dtype=out_dtype, device="cuda")
        launches = kern.launches
        got = kern(a, b, out=stack[1])
        assert kern.launches == launches + 1
        assert got.data_ptr() == stack[1].data_ptr()
        assert torch.equal(got, plain(a, b))
        assert bool((stack[0] == 7).all() and (stack[2] == 7).all())


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["ozaki2-fp8/fast", "ozaki2-karatsuba/fast",
                                  "ozaki2-int8/fast", "ozaki2-fp8/fast@20"])
def test_quant_residues_bitwise_vs_plain_on_card(spec):
    """K6 on the frames of a scaled operand with tiny, huge and zero rows,
    against its plain version (e4m3 compared as bytes)."""
    from repro_torch.core.plan import pow2_tables
    from repro_torch.core.quantize import scaled_int
    from repro_torch.kernels import decompose_int, quant_residues, quant_residues_plain

    _need_card()
    rng = np.random.default_rng(11)
    ms = parse_policy(spec).moduli_set()
    x = _lognormal(rng, (100, 301), 2.0)
    x[0] *= 1e-300
    x[1] *= 1e300
    x[2] = 0.0
    a = torch.from_numpy(x).cuda()
    lscale = torch.tensor(rng.integers(-20, 60, 100), dtype=torch.int32, device="cuda")
    frame = decompose_int(scaled_int(a, lscale, 0))
    tables = pow2_tables(ms, a.device)
    launches = quant_residues.launches
    got = quant_residues(*frame, tables, ms=ms)
    assert quant_residues.launches == launches + 1
    want = quant_residues_plain(*frame, tables, ms=ms)
    got, want = (got,) if ms.family == "int8" else got, (want,) if ms.family == "int8" else want
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["ozaki2-fp8/fast", "ozaki2-karatsuba/fast", "ozaki2-int8/fast",
                                  "ozaki2-fp8/fast@20", "ozaki2-int8/fast@17"])
def test_requant_garner_bitwise_vs_plain_on_card(spec):
    """K5 on random product stacks of the largest magnitudes the schedule
    makes (|c| < 2^24 for fp8, < 2^30 for int8) at an odd 97 x 131, in its
    digits mode and its f64 mode (scale exponents whose sums pass +-1023),
    against its plain version; N > 14 takes the kernel built for 20 moduli."""
    from repro_torch.kernels import requant_garner, requant_garner_plain

    _need_card()
    rng = np.random.default_rng(12)
    ms = parse_policy(spec).moduli_set()
    shape = (ms.n, 97, 131)
    if ms.family == "int8":
        cparts = (torch.tensor(rng.integers(-2 ** 30, 2 ** 30, shape), dtype=torch.int32,
                               device="cuda"),)
    else:
        cparts = tuple(torch.tensor(rng.integers(-2 ** 24, 2 ** 24, shape),
                                    dtype=torch.float32, device="cuda") for _ in range(3))
    lmu = torch.tensor(rng.integers(-700, 700, 97), dtype=torch.int32, device="cuda")
    lnu = torch.tensor(rng.integers(-700, 700, 131), dtype=torch.int32, device="cuda")
    launches = requant_garner.launches
    got = requant_garner(cparts, ms=ms)
    c = requant_garner(cparts, ms=ms, lmu=lmu, lnu=lnu)
    assert requant_garner.launches == launches + 2
    assert torch.equal(got, requant_garner_plain(cparts, ms=ms))
    assert torch.equal(c, requant_garner_plain(cparts, ms=ms, lmu=lmu, lnu=lnu))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["ozaki2-fp8/fast", "ozaki2-fp8/accurate",
                                  "ozaki2-karatsuba/fast", "ozaki2-int8/accurate"])
def test_unfused_route_on_card(spec):
    """'+pallas+unfused' on the card, raw and prepared, equals '+core' and
    the fused '+pallas' bit for bit, with K6 (its f64 entry) 2, K3 3N (K4 N)
    and K5 1 launches a call."""
    from repro_torch import prepare_operand
    from repro_torch import kernels as kn

    _need_card()
    rng = np.random.default_rng(13)
    ms = parse_policy(spec).moduli_set()
    a = torch.from_numpy(_lognormal(rng, (200, 300), 2.0)).cuda()
    b = torch.from_numpy(_lognormal(rng, (300, 130), 2.0)).cuda()
    gemm = kn.int8_gemm if ms.family == "int8" else kn.fp8_gemm
    per_call = ms.n if ms.family == "int8" else 3 * ms.n

    def counts():
        return kn.quant_residues_f64.launches, gemm.launches, kn.requant_garner.launches

    before = counts()
    got = ozmm(a, b, spec + "+pallas+unfused")
    assert tuple(x - y for x, y in zip(counts(), before)) == (2, per_call, 1)
    assert torch.equal(got, ozmm(a, b, spec + "+core"))
    assert torch.equal(got, ozmm(a, b, spec + "+pallas"))
    qa, qb = prepare_operand(a, "lhs", spec), prepare_operand(b, "rhs", spec)
    before = counts()
    assert torch.equal(ozmm(qa, qb, spec + "+pallas+unfused"), got)
    quant = 0 if parse_policy(spec).mode == "fast" else 2
    assert tuple(x - y for x, y in zip(counts(), before)) == (quant, per_call, 1)


def _residue_operands(rng, m, k, n, lim, dtype):
    """A (m, k) and B^T (n, k) of random parts in [-lim, lim) on the card."""
    def mk(shape):
        return torch.tensor(rng.integers(-lim, lim, shape), dtype=torch.float32,
                            device="cuda").to(dtype)

    return mk((m, k)), mk((n, k))


def _misaligned(x):
    """A copy of x whose data starts 1 byte past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 16, dtype=torch.uint8, device=x.device)
    y = buf[1:1 + x.numel()].view(x.dtype).view(x.shape)
    y.copy_(x)
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("shape,route", [((1024, 1024, 1024), "wgmma"),
                                         ((1000, 1024, 1003), "wgmma"),
                                         ((1000, 997, 1003), "mma_sync"),
                                         ((128, 128, 1), "wgmma")],
                         ids=["1024^3", "ragged-mn", "ragged-k", "hpl-fold"])
def test_residue_gemm_routes_on_card(shape, route):
    """K3 and K4 on a K-major B (the transpose of a contiguous (n, k) plane,
    as the pipeline hands it) take the route the shape and alignment give,
    copy no B, and equal their plain versions bit for bit; a misaligned A
    sends the same product through the mma_sync route."""
    from repro_torch.kernels import fp8_gemm, fp8_gemm_plain, int8_gemm, int8_gemm_plain
    from repro_torch.kernels.fp8_gemm import residue_gemm_route

    _need_card()
    m, k, n = shape
    rng = np.random.default_rng(16)
    for kern, plain, lim, dtype in ((fp8_gemm, fp8_gemm_plain, 16, torch.float8_e4m3fn),
                                    (int8_gemm, int8_gemm_plain, 128, torch.int8)):
        a, bt = _residue_operands(rng, m, k, n, lim, dtype)
        assert residue_gemm_route(k, a.data_ptr(), bt.data_ptr()) == route
        want = plain(a, bt.t())
        for x, via in ((a, route), (_misaligned(a), "mma_sync")):
            before = dict(kern.launches_by_route), kern.b_copies
            got = kern(x, bt.t())
            assert kern.b_copies == before[1]
            assert kern.launches_by_route[via] == before[0][via] + 1
            assert torch.equal(got, want), (kern.__name__, via)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["wgmma", "mma_sync"])
def test_fp8_gemm_exact_at_k65536_on_card(route):
    """K3 at k = 2^16 on both routes: all +16 parts sum to exactly 2^24, and
    +16 then +1 (a small tail after a large running sum), against the int64
    product."""
    from repro_torch.kernels import fp8_gemm

    _need_card()
    k = 2 ** 16
    idx = np.arange(k)
    rows = np.stack([np.full(k, 16), np.where(idx < k // 2, 16, 1)] * 8)  # (16, k)
    def f8(x):
        return torch.tensor(x, dtype=torch.float32, device="cuda").to(torch.float8_e4m3fn)

    a, bt = f8(rows), f8(rows[:8])
    if route == "mma_sync":
        a = _misaligned(a)
    before = fp8_gemm.launches_by_route[route]
    got = fp8_gemm(a, bt.t())
    assert fp8_gemm.launches_by_route[route] == before + 1
    want = torch.tensor(rows) @ torch.tensor(rows[:8]).T
    assert int(want.max()) == 2 ** 24
    assert torch.equal(got.cpu().long(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["ozaki2-fp8/fast", "ozaki2-karatsuba/accurate",
                                  "ozaki2-int8/fast"])
def test_unfused_route_k_major_on_card(spec):
    """'+pallas+unfused' at k % 16 == 0 (the GEMMs' wgmma route) and at a
    ragged k (mma_sync), raw and prepared: bitwise equal to '+core', every
    GEMM on the route its shape gives, and no B copied."""
    from repro_torch import prepare_operand
    from repro_torch import kernels as kn

    _need_card()
    rng = np.random.default_rng(17)
    ms = parse_policy(spec).moduli_set()
    gemm = kn.int8_gemm if ms.family == "int8" else kn.fp8_gemm
    per_call = ms.n if ms.family == "int8" else 3 * ms.n
    for k, route in ((320, "wgmma"), (301, "mma_sync")):
        a = torch.from_numpy(_lognormal(rng, (200, k), 2.0)).cuda()
        b = torch.from_numpy(_lognormal(rng, (k, 130), 2.0)).cuda()
        qa, qb = prepare_operand(a, "lhs", spec), prepare_operand(b, "rhs", spec)
        before, copies = gemm.launches_by_route[route], gemm.b_copies
        got = ozmm(a, b, spec + "+pallas+unfused")
        assert torch.equal(got, ozmm(a, b, spec + "+core"))
        assert torch.equal(ozmm(qa, qb, spec + "+pallas+unfused"), ozmm(qa, qb, spec + "+core"))
        assert gemm.launches_by_route[route] == before + 2 * per_call
        assert gemm.b_copies == copies


def _operands(rng, m, k, n, phi=1.0):
    return (torch.from_numpy(_lognormal(rng, (m, k), phi)).cuda(),
            torch.from_numpy(_lognormal(rng, (k, n), phi)).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 128, 64), (1000, 997, 1003), (128, 128, 1),
                                   (101, 67, 33)],
                         ids=["128x128x64", "ragged", "hpl-fold", "odd"])
@pytest.mark.parametrize("spec", ["ozaki2-fp8/fast", "ozaki2-karatsuba/accurate",
                                  "ozaki2-int8/fast"])
def test_f64_entries_vs_plain_on_card(spec, shape):
    """K6's f64 entry (A by rows, B^T by rows and B by columns) and K5 in
    both modes (on the pipeline's own products) against their plain
    versions at m x k x n = 128x128x64, a ragged shape, HPL's one-column
    fold and odd sizes (the kernels' scalar paths), one launch each; K5's
    f64 mode equals crt.reconstruct of its digits."""
    from repro_torch import kernels as kn
    from repro_torch.core import crt
    from repro_torch.core.plan import pow2_tables
    from repro_torch.kernels import pipeline

    _need_card()
    m, k, n = shape
    rng = np.random.default_rng(18)
    pol = parse_policy(spec)
    ms = pol.moduli_set()
    a, b = _operands(rng, m, k, n)
    scal = compute_scaling(a, b, ms, pol.mode)
    tables = pow2_tables(ms, a.device)
    sides = []
    for x, lscale, axis in ((a, scal.lmu, 0), (pipeline.k_major(b), scal.lnu, 0),
                            (b, scal.lnu, 1)):
        launches = kn.quant_residues_f64.launches
        got = kn.quant_residues_f64(x, lscale, tables, ms=ms, axis=axis)
        assert kn.quant_residues_f64.launches == launches + 1
        want = kn.quant_residues_f64_plain(x, lscale, tables, ms=ms, axis=axis)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
        sides.append(got)
    cparts = pipeline.residue_gemms(sides[0], sides[1], ms)
    launches = kn.requant_garner.launches
    digits = kn.requant_garner(cparts, ms=ms)
    c = kn.requant_garner(cparts, ms=ms, lmu=scal.lmu, lnu=scal.lnu)
    assert kn.requant_garner.launches == launches + 2
    assert torch.equal(digits, kn.requant_garner_plain(cparts, ms=ms))
    assert torch.equal(c, kn.requant_garner_plain(cparts, ms=ms, lmu=scal.lmu, lnu=scal.lnu))
    assert torch.equal(c, crt.reconstruct(digits, ms, scal.lmu, scal.lnu))
    assert torch.equal(c, ozmm(a, b, spec + "+core"))


def _edge_matrix(rng, k):
    """Rows of zeros, signed lognormal values, subnormals, values near 1e-300
    and 1e300, signed integers near 2^53, powers of two and the largest
    finite values, with per-row log2 scales that include 1074 and 1100
    (past ldexp_wide's single-factor range) and large negative ones."""
    a = _lognormal(rng, (12, k), 2.0)
    a[0] = 0.0
    a[1, : k // 2] *= -1.0
    a[2] = rng.choice([5e-324, -5e-324, 1e-310, -2.2250738585072014e-308, 0.0, -0.0], k)
    a[3] *= 1e-300
    a[4] *= 1e300
    a[5] = rng.integers(-2 ** 53, 2 ** 53, k).astype(np.float64)
    a[6] = np.ldexp(np.where(np.arange(k) % 2 == 0, 1.0, -1.0), rng.integers(0, 60, k))
    a[7] = (2.0 ** 53 - 1) * np.where(np.arange(k) % 2 == 0, 1.0, -1.0)
    a[8] = np.finfo(np.float64).max * (rng.random(k) - 0.5)
    a[9] = rng.choice([1e-320, -3e-315, 4.9e-324], k)
    a[10] *= 1e-305
    lscale = np.array([5, 40, 1074, 1000, -900, 0, 0, 1, -1020, 1100, 1050, 60],
                      dtype=np.int32)
    return torch.from_numpy(a).cuda(), torch.from_numpy(lscale).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [301, 304], ids=["odd-k", "k%4==0"])
@pytest.mark.parametrize("spec", ["ozaki2-fp8/fast", "ozaki2-karatsuba/fast",
                                  "ozaki2-int8/fast", "ozaki2-fp8/fast@20"])
def test_quant_residues_f64_edge_inputs_on_card(spec, k):
    """K6's f64 entry (and its frame entry on the same scaled operand) on the
    edge matrix, bit for bit against the plain versions, on the scalar
    (odd k) and the vector path."""
    from repro_torch import kernels as kn
    from repro_torch.core.plan import pow2_tables
    from repro_torch.core.quantize import scaled_int

    _need_card()
    ms = parse_policy(spec).moduli_set()
    a, lscale = _edge_matrix(np.random.default_rng(19), k)
    tables = pow2_tables(ms, a.device)
    want = kn.quant_residues_f64_plain(a, lscale, tables, ms=ms)
    got = kn.quant_residues_f64(a, lscale, tables, ms=ms)
    frame = kn.quant_residues(*kn.decompose_int(scaled_int(a, lscale, 0)), tables, ms=ms)
    for g, f, w in zip(*((x,) if ms.family == "int8" else x for x in (got, frame, want))):
        assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
        assert torch.equal(f.view(torch.uint8), w.view(torch.uint8))


@pytest.mark.cuda
def test_accurate_scaling_ignores_the_tf32_switch_on_card():
    """Accurate scaling's exponents at 1024^3 are the same with the global
    TF32 switch on and off (the bound GEMM pins f32 itself), and the
    caller's setting survives the call."""
    _need_card()
    rng = np.random.default_rng(20)
    a, b = _operands(rng, 1024, 1024, 1024, 0.5)
    ms = parse_policy("ozaki2-fp8/accurate").moduli_set()
    switch = torch.backends.cuda.matmul
    prev = switch.allow_tf32
    try:
        got = {}
        for on in (False, True):
            switch.allow_tf32 = on
            got[on] = compute_scaling(a, b, ms, "accurate")
            assert switch.allow_tf32 == on
    finally:
        switch.allow_tf32 = prev
    assert torch.equal(got[True].lmu, got[False].lmu)
    assert torch.equal(got[True].lnu, got[False].lnu)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["ozaki2-fp8/accurate", "ozaki2-int8/fast+unfused"])
def test_gradient_on_card_equals_core_cotangent_gemms(spec):
    """backend auto differentiates on the kernel route: the forward and both
    cotangent GEMMs launch the route's kernels (K1 once a GEMM; K6 twice, K4
    N times and K5 once a GEMM under '+unfused'), and A.grad / B.grad equal
    ozmm(G, B^T, '+core') / ozmm(A^T, G, '+core') bitwise; an explicit
    '+pallas' refuses the gradient."""
    _need_card()
    from repro_torch import kernels as kn

    n = parse_policy(spec).moduli_set().n
    per_gemm = ({kn.quant_residues_f64: 2, kn.int8_gemm: n, kn.requant_garner: 1}
                if spec.endswith("+unfused") else {fused.ozmm_fused_raw: 1})
    rng = np.random.default_rng(21)
    a, b = _operands(rng, 200, 300, 130, 0.5)
    g = torch.from_numpy(rng.standard_normal((200, 130))).cuda()
    ta, tb = a.clone().requires_grad_(), b.clone().requires_grad_()
    before = {f: f.launches for f in per_gemm}
    c = ozmm(ta, tb, spec)
    c.backward(g)
    assert {f: f.launches - before[f] for f in per_gemm} == {
        f: 3 * k for f, k in per_gemm.items()}
    core = spec.removesuffix("+unfused") + "+core"
    assert torch.equal(ta.grad, ozmm(g, b.T, core))
    assert torch.equal(tb.grad, ozmm(a.T, g, core))
    with pytest.raises(NotImplementedError, match="forward-only"):
        ozmm(ta, tb, spec.removesuffix("+unfused") + "+pallas").sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["accurate", "fast"])
def test_ozaki1_on_card_equals_cpu(mode):
    """Ozaki-I's slice products are exact f32 GEMMs and its scaling exact
    power-of-two multiplies, so the card gives the CPU's bits."""
    _need_card()
    rng = np.random.default_rng(22)
    a, b = _operands(rng, 96, 256, 80, 2.0)
    got = ozmm(a, b, f"ozaki1-fp8/{mode}@11")
    assert got.is_cuda
    assert torch.equal(got.cpu(), ozmm(a.cpu(), b.cpu(), f"ozaki1-fp8/{mode}@11",
                                       device="cpu"))


@pytest.mark.cuda
def test_bound_gemm_probe_on_card_equals_cpu(monkeypatch):
    """The obs probe runs its bound GEMM on the card unless asked for the
    CPU, and gives the CPU's result there: its f32 sums of e4m3 products are
    exact at this spread, so only log2 may differ, by an ulp."""
    _need_card()
    from repro_torch.core import numerics
    from repro_torch.obs import health

    devices, product = [], numerics.matmul_exact_fp8

    def record(x, y):
        devices.append(x.device.type)
        return product(x, y)

    monkeypatch.setattr(numerics, "matmul_exact_fp8", record)
    rng = np.random.default_rng(23)
    a, b = _lognormal(rng, (200, 300), 0.5), _lognormal(rng, (300, 130), 0.5)
    got = health.bound_gemm_probe(a, b)
    want = health.bound_gemm_probe(a, b, device="cpu")
    assert devices == ["cuda", "cpu"]
    assert abs(got - want) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 8])
def test_k2_on_cached_weight_at_decode_rows(m):
    """K2 on a cached (source-dropped) fast-mode weight plan at a decode
    batch's few rows, padded to the kernel's tile, against its plain
    version; and layers.matmul on that plan, auto (K2) against '+core'."""
    _need_card()
    from repro_torch.core.plan import quantize_matrix
    from repro_torch.kernels import stack_parts
    from repro_torch.models import layers

    rng = np.random.default_rng(30 + m)
    ms = parse_policy("ozaki2-fp8/fast").moduli_set()
    w = torch.from_numpy(rng.standard_normal((384, 520)) * 384 ** -0.5).cuda()
    qw = quantize_matrix(w, "rhs", ms, mode="fast").drop_source()
    x = torch.from_numpy(rng.standard_normal((m, 384))).cuda()
    qx = quantize_matrix(x, "lhs", ms, mode="fast")
    args = fused.fused_parts_args(stack_parts(qx.parts, ms), qx.lscale, stack_parts(qw.parts, ms),
                                  qw.lscale, ms, fused.KERNEL_TILE)
    launches = fused.ozmm_fused_parts.launches
    got = fused.ozmm_fused_parts(*args, ms=ms)
    assert fused.ozmm_fused_parts.launches == launches + 1
    assert torch.equal(got, fused.ozmm_fused_parts_ref(*args, ms=ms))
    xb = x.to(torch.bfloat16)
    assert torch.equal(layers.matmul(xb, qw, "ozaki2-fp8/fast"),
                       layers.matmul(xb, qw, "ozaki2-fp8/fast+core"))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["ozaki2-fp8/fast", "ozaki2-fp8/fast+unfused",
                                  "ozaki2-int8/fast+unfused"])
def test_smoke_engine_on_card_equals_core(spec):
    """The serving engine on the qwen2-7b smoke config on the card: the
    kernel route's tokens and every emitted logits row equal the '+core'
    route's, bitwise."""
    _need_card()
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import BatchingEngine

    model = Model(get_config("qwen2-7b", "smoke"), device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen)
    prompts = [[3, 14, 15, 92, 65], [35, 89, 79, 32, 38, 46, 26], [43, 38, 32, 79]]
    pol = parse_policy(spec)

    def run(policy):
        eng = BatchingEngine(model, params, max_len=12, max_slots=2, page_size=4, policy=policy)
        rows, emit = [], eng._emit
        eng._emit = lambda slot, row: (rows.append(row.clone()), emit(slot, row))[1]
        rids = [eng.submit(p, max_new_tokens=3) for p in prompts]
        res = eng.run()
        return [res[r].tokens for r in rids], rows

    toks, rows = run(pol)
    toks_c, rows_c = run(dataclasses.replace(pol, backend="core", fused=True))
    assert toks == toks_c and len(rows) == len(rows_c) == 9
    assert all(torch.equal(a, b) for a, b in zip(rows, rows_c))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-v3-671b"])
def test_moe_smoke_engine_on_card_equals_core(arch, monkeypatch):
    """The paged engine on a MoE smoke config (deepseek's with MLA's latent
    page pools) on the card under ozaki2-fp8/fast: every K2 call bitwise
    equal to its plain version on the same arguments, and the tokens and
    every emitted logits row equal to the '+core' route's, bitwise."""
    _need_card()
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.fused import ops
    from repro_torch.models import Model
    from repro_torch.serve import BatchingEngine

    model = Model(get_config(arch, "smoke"), device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    params = model.init(gen)
    prompts = [[3, 14, 15, 92, 65], [35, 89, 79, 32, 38, 46, 26], [43, 38, 32, 79]]
    pol = parse_policy("ozaki2-fp8/fast")
    k2, equal = ops.ozmm_fused_parts, []

    def checked(*a, **kw):
        out = k2(*a, **kw)
        equal.append(torch.equal(out, fused.ozmm_fused_parts_ref(*a, **kw)))
        return out

    def run(policy):
        eng = BatchingEngine(model, params, max_len=12, max_slots=2, page_size=4, policy=policy)
        rows, emit = [], eng._emit
        eng._emit = lambda slot, row: (rows.append(row.clone()), emit(slot, row))[1]
        rids = [eng.submit(p, max_new_tokens=3) for p in prompts]
        res = eng.run()
        return [res[r].tokens for r in rids], rows

    monkeypatch.setattr(ops, "ozmm_fused_parts", checked)
    launches = fused.ozmm_fused_parts.launches
    toks, rows = run(pol)
    monkeypatch.undo()
    assert fused.ozmm_fused_parts.launches - launches == len(equal) > 0 and all(equal)
    toks_c, rows_c = run(dataclasses.replace(pol, backend="core", fused=True))
    assert toks == toks_c and len(rows) == len(rows_c) == 9
    assert all(torch.equal(a, b) for a, b in zip(rows, rows_c))


def _train_step_on_card(spec: str):
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step

    cfg = get_config("qwen2-7b", "smoke", gemm=spec)
    init, step = make_train_step(Model(cfg, device="cuda"), AdamWConfig(lr=1e-2, warmup_steps=1),
                                 microbatches=2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    state = init(gen)
    state, metrics = step(state, synth_batch(DataConfig(batch=4, seq_len=8), cfg, 0))
    return state, metrics


@pytest.mark.cuda
def test_train_step_on_card_equals_core():
    """One make_train_step step (two microbatches) at qwen2-7b's smoke width:
    on backend auto (K1 for every GEMM and both cotangent GEMMs) the loss,
    the gradient norm and the new parameters and moments equal the '+core'
    route's bitwise."""
    _need_card()
    launches = fused.ozmm_fused_raw.launches
    state, metrics = _train_step_on_card("ozaki2-fp8/fast")
    assert fused.ozmm_fused_raw.launches > launches
    state_c, metrics_c = _train_step_on_card("ozaki2-fp8/fast+core")
    for k in ("loss", "grad_norm"):
        assert torch.equal(metrics[k], metrics_c[k]), k
    assert all(torch.equal(a, b) for a, b in zip(state.params.parameters(),
                                                 state_c.params.parameters()))
    assert all(torch.equal(state.opt.m[k], state_c.opt.m[k]) for k in state.opt.m)


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(tmp_path):
    """A train state on the card saved and restored into a fresh one: every
    leaf equal, on the card."""
    _need_card()
    from repro_torch.checkpoint import CheckpointManager

    state, _ = _train_step_on_card("ozaki2-fp8/fast")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    mgr.wait()
    fresh, _ = _train_step_on_card("ozaki2-fp8/fast")
    with torch.no_grad():
        for p in fresh.params.parameters():
            p.zero_()
    step, restored = mgr.restore(fresh)
    assert step == 1 and restored is fresh and int(fresh.opt.step) == 1
    for a, b in zip(fresh.params.parameters(), state.params.parameters()):
        assert a.device.type == "cuda" and torch.equal(a, b)
    assert all(torch.equal(fresh.opt.v[k], state.opt.v[k]) for k in state.opt.v)


@pytest.mark.cuda
@pytest.mark.parametrize("family,mode", [("fp8-hybrid", "fast"), ("fp8-hybrid", "accurate"),
                                         ("int8", "fast")])
def test_sharded_gemms_on_card(family, mode):
    """A 2 x 4 mesh of the card: every k shard's residue products on K6 +
    K3/K4 and every mn block on K2 / pair_exponents + K1 equal the core
    route's bitwise; fast k-sharding equals the single-device ozmm."""
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    from repro_torch.core import distributed as dist
    from repro_torch.core.moduli import DEFAULT_NUM_MODULI, make_moduli_set
    from repro_torch.launch import make_mesh

    rng = np.random.default_rng(5)
    a = torch.from_numpy(_lognormal(rng, (256, 1024), 1.0)).cuda()
    b = torch.from_numpy(_lognormal(rng, (1024, 256), 1.0)).cuda()
    mesh = make_mesh((2, 4), ("data", "model"), devices="cuda")
    ms = make_moduli_set(family, DEFAULT_NUM_MODULI[family])
    got = dist.ozmm_k_sharded(a, b, mesh, family=family, mode=mode)
    if mode == "fast":
        scheme = "ozaki2-int8" if family == "int8" else "ozaki2-fp8"
        assert torch.equal(got, ozmm(a, b, f"{scheme}/fast"))
    a_sh, b_sh = [a[:, s:s + 256] for s in range(0, 1024, 256)], list(b.split(256))
    lmu, lnu = dist.k_sharded_exponents(a_sh, b_sh, 1024, ms, mode, a.device)
    for xa, xb in zip(a_sh, b_sh):
        for kern, core in zip(dist.k_shard_residues(xa, xb, lmu, lnu, ms, "pallas"),
                              dist.k_shard_residues(xa, xb, lmu, lnu, ms, "core")):
            assert torch.equal(kern, core)
    got = dist.ozmm_mn_sharded(a, b, mesh, family=family, mode=mode)
    for rs in range(0, 256, 128):
        for cs in range(0, 256, 64):
            xa, xb = a[rs:rs + 128], b[:, cs:cs + 64]
            assert torch.equal(got[rs:rs + 128, cs:cs + 64],
                               dist.mn_shard(xa, xb, ms, mode, "core"))


@pytest.mark.cuda
def test_dist_lu_on_card_equals_single_device():
    """lu_factor_dist under ozaki2-fp8/fast on a 2 x 2 grid of the card (K2
    rank updates) is lu_factor's factorization bit for bit, both wires; the
    distributed solve is lu_solve's."""
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    from repro_torch import linalg
    from repro_torch.linalg import dist

    a, b = linalg.hpl_matrix(300, seed=4)
    lu_s, perm_s = linalg.lu_factor(a, "ozaki2-fp8/fast", block=64)
    x_s = linalg.lu_solve(lu_s, perm_s, b, "ozaki2-fp8/fast", block=64)
    for wire in ("plans", "f64"):
        lu, perm, stats = dist.lu_factor_dist(a, "ozaki2-fp8/fast", grid=(2, 2), block=64,
                                              panel_wire=wire)
        assert np.array_equal(perm, perm_s) and np.array_equal(lu.to_global(), lu_s)
        x, _ = dist.lu_solve_dist(lu, perm, b, "ozaki2-fp8/fast", panel_wire=wire)
        assert np.array_equal(x, x_s)
    res = dist.run_hpl_dist(300, "ozaki2-fp8/accurate", grid=(2, 2), block=64)
    assert res["passed"]
