"""K1/K2 past a contraction of 2^16 and their digit-stack mode, on the CPU
(the kernels' plain versions), against exact oracles and the JAX reference.

(a) The plain K2 at k = 2^17 + 128 on one 128 x 128 tile and the plain K1
there on the tile's first 8 rows and columns (its residue prologue over two
128-row operands of that k costs ~6-50 s a family on a CPU, by its threads;
the plain version takes any shape, and rows and columns are independent),
each fp8 family at its default moduli count, on adversarial operands (rows
of +16, of alternating +-16 and of +16 then +1 parts; K1's from integer
operands whose residues make such parts): bitwise equal to an exact oracle,
the f64 product of the operands' residues (exact: |r| <= 544 and
|sums| < 2^53) reduced mod p, then ``crt.garner_digits`` /
``crt.reconstruct``; and one f32 product over the whole k
(``core.plan.residue_products``) is shown to differ on the same operands.
(b) The port's fused GEMM at 8 x 66,048 x 8 (two chunks) bitwise equal to
the reference's Pallas kernel in interpret mode, fast and accurate.
(c) ``reconstruct="xla"``: the plain K1/K2 digit stacks bitwise equal to the
reference's kernel-level ``ozmm_fused_raw`` / ``ozmm_fused_parts`` in
interpret mode, and their C equal to "onchip"'s and the reference's.
(d) A toy model with a vocabulary of 2^16 + 128 (lm_head's input gradient
contracts over it) takes one training step on the kernel route at 10
moduli ((a) holds the long contraction at the default 12); its emulated f64
gradient is within 1e-12 of the native f64 one, the training tests'
FP64-grade gate. Tolerances: bitwise, but (d).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import crt as jax_crt
from repro.core.moduli import make_moduli_set as jax_make_moduli_set
from repro.kernels.fused.kernel import ozmm_fused_parts as jax_ozmm_fused_parts
from repro.kernels.fused.kernel import ozmm_fused_raw as jax_ozmm_fused_raw
from repro.kernels.fused.ops import ozmm_pallas_fused as jax_ozmm_pallas_fused
from repro.testing import lognormal_matrix
from repro_torch.configs import get_config
from repro_torch.core import crt, gemm, numerics
from repro_torch.core.moduli import DEFAULT_NUM_MODULI, make_moduli_set
from repro_torch.core.plan import residue_products
from repro_torch.data import DataConfig, synth_batch
from repro_torch.kernels import fused, stack_parts
from repro_torch.kernels.fp8_gemm import fp8_gemm, max_k
from repro_torch.kernels.fused import kernel as fused_kernel
from repro_torch.kernels.int8_gemm import int8_gemm
from repro_torch.models import Model
from repro_torch.models.convert import reference_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.train import loss_fn, make_train_step
from repro_torch.train import step as step_mod

# The plain versions run in cache-sized blocks, many small ops: one thread a
# module, as the suite runs a worker per core.
from _torch_models_parity import one_torch_thread  # noqa: F401

LONG_K = 2 ** 17 + 128
TILE = 128
K1_ROWS = 8  # of the tile, for the plain K1 (a)


def _patterns(k: int, big: int) -> np.ndarray:
    """The rows an operand's rows are drawn from: all ``big``, ``big``
    alternating in sign, and ``big`` for the first k/2 + 1 entries, then 1.
    With big = 16, a sum of products of two such last rows passes 2^24 and
    ends odd, so no f32 sum over the whole k, in any order, can hold it."""
    i = np.arange(k)
    return np.stack([np.full(k, big), np.where(i % 2 == 0, big, -big),
                     np.where(i <= k // 2, big, 1)])


def _draw(rng, rows: int) -> tuple[np.ndarray, np.ndarray]:
    """Each of ``rows`` rows: its pattern (cycling) and its sign (seeded)."""
    return np.arange(rows) % 3, rng.choice([-1, 1], rows)


def _oracle_digits(pat_a, rows_a, w_a, pat_b, rows_b, w_b, ms) -> torch.Tensor:
    """Exact Garner digits of A @ B where, per modulus l, row i of A is
    congruent mod p_l to w_a[l][i] * pat_a[l][rows_a[i]] and column j of B
    to w_b[l][j] * pat_b[l][rows_b[j]]: the patterns' f64 products (exact:
    |r| <= 544, |sums| < 2^53), scaled, reduced mod p."""
    cs = []
    for l, p in enumerate(ms.ps):
        g = pat_a[l].astype(np.float64) @ pat_b[l].astype(np.float64).T
        c = np.outer(w_a[l], w_b[l]) * g[np.ix_(rows_a, rows_b)]
        cs.append(numerics.centered_mod(torch.from_numpy(c).to(torch.int64), p))
    return crt.garner_digits(cs, ms)


def _e4m3_rows(pat: np.ndarray, rows, sign) -> torch.Tensor:
    """The (len(rows), k) e4m3 plane of integer rows sign[i] * pat[rows[i]]
    (|values| <= 16), through a table of their bytes."""
    table = torch.arange(-16, 17, dtype=torch.float32).to(numerics.E4M3).view(torch.uint8)
    idx = (pat[rows] * sign[:, None] + 16).astype(np.intp)
    return torch.from_numpy(table.numpy()[idx]).view(numerics.E4M3)


def _parts(ms, pat, rows, sign, operand: str):
    """Per modulus the part planes of an operand (B's transposed to (k, n))
    whose rows are sign * pattern: square moduli hi = lo = v, residue
    (s + 1) v; Karatsuba (hi, lo, hs) = (v, 0, v), residue 16 v. Returns the
    stacked parts and each modulus' row weights."""
    v = _e4m3_rows(pat, rows, sign)
    zero = torch.zeros_like(v.view(torch.uint8)).view(numerics.E4M3)
    if operand == "b":
        v, zero = v.t().contiguous(), zero.t().contiguous()
    parts = [(v, v) if sq else (v, zero, v) for sq in ms.is_square]
    return stack_parts(parts, ms), [sign * (s + 1 if sq else 16)
                                    for sq, s in zip(ms.is_square, ms.split_s)]


@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("family", ["fp8-hybrid", "fp8-karatsuba"])
def test_plain_long_k_exact_against_integer_oracle(kernel, family):
    ms = make_moduli_set(family, DEFAULT_NUM_MODULI[family])
    rng = np.random.default_rng(7)
    rows = TILE if kernel == "K2" else K1_ROWS
    lmu = torch.zeros((rows, 1), dtype=torch.int32)
    lnu = torch.zeros((1, rows), dtype=torch.int32)
    (rows_a, sign_a), (rows_b, sign_b) = _draw(rng, rows), _draw(rng, rows)
    if kernel == "K2":
        pat = _patterns(LONG_K, 16)
        sa, w_a = _parts(ms, pat, rows_a, sign_a, "a")
        sb, w_b = _parts(ms, pat, rows_b, sign_b, "b")
        pat_a = pat_b = [pat] * ms.n
        got = fused.ozmm_fused_parts(sa, sb, lmu, lnu, ms=ms)
        head_a = [tuple(x[:3] for x in pl) for pl in fused_kernel._unstack(sa, ms)]
        head_b = [tuple(x[:, :3] for x in pl) for pl in fused_kernel._unstack(sb, ms)]
    else:
        # integer operands (exact raw frames under zero pairing exponents)
        # whose residues are adversarial: a value with residue 544 mod 1089
        # (parts (16, 16)) and 496 mod 1024 ((16, -16)); the oracle takes
        # its residues
        big = next(v for v in range(496, 1089 * 1024, 1024) if v % 1089 == 544)
        pat = _patterns(LONG_K, big)
        a = torch.from_numpy((pat[rows_a] * sign_a[:, None]).astype(np.float64))
        b = torch.from_numpy((pat[rows_b] * sign_b[:, None]).T.astype(np.float64))
        pat_a = pat_b = [numerics.centered_mod(torch.from_numpy(pat), p).numpy() for p in ms.ps]
        w_a, w_b = [sign_a] * ms.n, [sign_b] * ms.n
        args = fused.fused_raw_args(a, lmu[:, 0], b, lnu[0], ms, (rows, rows, TILE))
        got = fused.ozmm_fused_raw_ref(*args, ms=ms)
        head = slice(0, 3)
        head_a = fused_kernel.raw_split_parts(args[0][head], args[1][head], args[2][head],
                                              args[8], ms=ms)
        head_b = fused_kernel.raw_split_parts(args[4][:, head], args[5][:, head],
                                              args[6][:, head], args[8], ms=ms)
    digits = _oracle_digits(pat_a, rows_a, w_a, pat_b, rows_b, w_b, ms)
    assert torch.equal(got, crt.reconstruct(digits, ms, lmu[:, 0], lnu[0]))
    # the teeth: one f32 product over the whole k leaves the exact sums
    whole = crt.garner_digits(residue_products(head_a, head_b, ms), ms)
    assert not torch.equal(whole, digits[:, :3, :3])


@pytest.mark.parametrize("mode", ["fast", "accurate"])
def test_fused_two_chunks_as_reference_interpreter(mode):
    """k = 66,048 (two chunks, the second of 512) on the kernel route's plain
    version, bitwise equal to the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(3)
    a = lognormal_matrix(rng, (8, 66048), 0.5)
    b = lognormal_matrix(rng, (66048, 8), 0.5)
    want = jax_ozmm_pallas_fused(jnp.asarray(a), jnp.asarray(b), family="fp8-hybrid",
                                 num_moduli=4, mode=mode, interpret=True,
                                 blocks=(8, 8, 66048 // 8))  # 8 k steps, int32 sums
    got = fused.ozmm_pallas_fused(torch.from_numpy(a), torch.from_numpy(b),
                                  family="fp8-hybrid", num_moduli=4, mode=mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_k4_takes_the_reference_limit():
    """K4 (int8) takes k = 2^17 (entries of 127: the s32 sum stays < 2^31)
    and raises past it; K3 keeps 2^16."""
    k4, k3 = max_k(torch.int8), max_k(numerics.E4M3)
    assert (k4, k3) == (2 ** 17, 2 ** 16)
    a = torch.full((1, k4), 127, dtype=torch.int8)
    b = torch.full((k4, 2), -127, dtype=torch.int8)
    assert torch.equal(int8_gemm(a, b), torch.full((1, 2), -127 * 127 * k4, dtype=torch.int32))
    pad = torch.zeros((1, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match=f"exceeds {k4}"):
        int8_gemm(torch.cat([a, pad], 1), torch.cat([b, pad.T.expand(128, 2)], 0))
    e4m3 = torch.zeros((2, k3 + 128), dtype=torch.uint8).view(numerics.E4M3)
    with pytest.raises(ValueError, match=f"exceeds {k3}"):
        fp8_gemm(e4m3[:1], e4m3.t())


@pytest.mark.parametrize("family,n", [("fp8-hybrid", 7), ("int8", 5)])
def test_digit_stack_as_reference_kernels(family, n):
    """reconstruct="xla": the plain K1 and K2 digit stacks equal the reference
    kernels' in interpret mode; the digits' C equals "onchip"'s and the
    reference's ``crt.reconstruct`` of its own digits."""
    m, k, nn = 40, 300, 56
    rng = np.random.default_rng(5)
    a, b = lognormal_matrix(rng, (m, k), 0.5), lognormal_matrix(rng, (k, nn), 0.5)
    ms, jms = make_moduli_set(family, n), jax_make_moduli_set(family, n)
    lmu = torch.from_numpy(rng.integers(30, 40, m).astype(np.int32))
    lnu = torch.from_numpy(rng.integers(30, 40, nn).astype(np.int32))
    tile = fused.KERNEL_TILE
    blocks = dict(bm=tile[0], bn=tile[1], bk=tile[2], interpret=True)
    raw = fused.fused_raw_args(torch.from_numpy(a), lmu, torch.from_numpy(b), lnu, ms, tile)
    # K2's stacks: A's (N, m, k) parts, B's swapped back from K-major
    sa = fused.raw_parts_plain(*raw[:4], raw[8], ms=ms, axis=0)
    sb = fused.transpose_parts_plain(fused.raw_parts_plain(*raw[4:8], raw[8], ms=ms, axis=1),
                                     ms=ms)

    def to_j(t):
        if t.dtype == numerics.E4M3:
            return jnp.asarray(t.view(torch.uint8).numpy().view(jnp.float8_e4m3fn))
        return jnp.asarray(t.numpy())

    cases = {
        "K1": (fused.ozmm_fused_raw, raw,
               lambda: jax_ozmm_fused_raw(*(to_j(t) for t in raw), ms=jms, reconstruct="xla",
                                          **blocks)),
        "K2": (fused.ozmm_fused_parts, (sa, sb, raw[3], raw[7]),
               lambda: jax_ozmm_fused_parts(
                   *(to_j(sa), to_j(sb)) if family == "int8" else
                   (tuple(map(to_j, sa)), tuple(map(to_j, sb))),
                   to_j(raw[3]), to_j(raw[7]), ms=jms, reconstruct="xla", **blocks)),
    }
    for name, (kern, args, ref) in cases.items():
        digits = kern(*args, ms=ms, reconstruct="xla")
        want = np.asarray(ref())
        np.testing.assert_array_equal(digits.numpy(), want, err_msg=name)
        onchip = kern(*args, ms=ms)
        c = crt.reconstruct(digits[:, :m, :nn], ms, lmu, lnu)
        assert torch.equal(c, onchip[:m, :nn]), name
        c_ref = jax_crt.reconstruct(jnp.asarray(want[:, :m, :nn]), jms, jnp.asarray(lmu.numpy()),
                                    jnp.asarray(lnu.numpy()))
        np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref), err_msg=name)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(fused.ozmm_pallas_fused(ta, tb, family=family, num_moduli=n,
                                               reconstruct="xla"),
                       fused.ozmm_pallas_fused(ta, tb, family=family, num_moduli=n))


def test_train_step_past_two_to_the_sixteen_vocabulary(monkeypatch):
    """A toy f64 model with 2^16 + 128 vocabulary rows takes one training
    step on the kernel route (K1's plain version; lm_head's input gradient
    contracts over the vocabulary in two chunks). The step's emulated
    gradient is within 1e-12 of the native f64 gradient per leaf."""
    monkeypatch.setattr(gemm, "_resolve_backend", lambda pol, dev: "pallas")
    cfg = dataclasses.replace(get_config("qwen2-7b", "smoke"), d_model=8, num_heads=2,
                              num_kv_heads=1, head_dim=4, d_ff=16, vocab_size=2 ** 16 + 128,
                              dtype="float64", param_dtype="float64",
                              gemm="ozaki2-fp8/fast@10")
    model = Model(cfg, device="cpu")
    init_state, step = make_train_step(model, AdamWConfig())
    gen = torch.Generator()
    gen.manual_seed(2)
    state = init_state(gen)
    before = {k: v.detach().clone() for k, v in reference_leaves(state.params).items()}
    batch = synth_batch(DataConfig(seed=4, batch=2, seq_len=8, vocab_size=cfg.vocab_size),
                        cfg, 0)
    seen, calls = {}, fused.ozmm_fused_raw_ref.calls
    real = step_mod.opt_update
    monkeypatch.setattr(step_mod, "opt_update",
                        lambda c, grads, *a: seen.update(grads) or real(c, grads, *a))
    state, metrics = step(state, batch)
    assert fused.ozmm_fused_raw_ref.calls > calls and np.isfinite(float(metrics["loss"]))
    native = Model(dataclasses.replace(cfg, gemm=None), device="cpu")
    params = native.init(torch.Generator()).requires_grad_(True)
    for name, leaf in reference_leaves(params).items():
        leaf.data.copy_(before[name])
    loss, _ = loss_fn(native, params, {k: torch.as_tensor(v) for k, v in batch.items()})
    leaves = reference_leaves(params)
    want = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    errs = {k: (torch.linalg.norm(seen[k] - w) / torch.linalg.norm(w)).item()
            for k, w in want.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-12, (worst, errs[worst])
    assert any(not torch.equal(v, before[k]) for k, v in reference_leaves(state.params).items())
