"""Registry of the real entry points the graph checker runs (the torch
counterpart of ``repro/analysis/registry.py``): the reference's nine
entries, with its names, policies, ``bitwise`` flags, shapes and numpy
seeds, so each entry can be fed the very arrays the reference's builds.

Each :class:`EntryPoint` builds, on a device, a callable plus its arguments
(policies chosen to cover the fp8 fast/accurate pipelines, the int8
family, prepared-plan execution, the fused path's oracle, CRT
reconstruction, the LU device steps, and paged decode). ``bitwise=True``
marks entries under a bitwise-equality contract (fused == core,
distributed == single-device, paged == dense); those also run the
nondeterministic-reduction check. ``inplace`` names the arguments the entry
updates in place (the reference's ``donate``).

The ``ozmm`` entries run the bare spec, which is the core executor on the
CPU and K1 on the H100 (``core.gemm._resolve_backend``); ``build(device,
"+pallas")`` runs the kernel route instead (K1's plain version on the CPU),
which ``chip_smoke.py`` phase 16 holds the card's trace against. The host
loops ``lu_factor``/``lu_solve`` register their *device step*: the
composition of the blocks each of their block steps runs
(``linalg.blocks.solve_tri_tensor``, ``quantize_matrix``,
``ozmm_prepared``).

Adding an entry point: append an ``EntryPoint`` whose ``build(device,
suffix)`` returns ``(fn, args)``, run ``python -m repro_torch.analysis
--graph-only --device cpu --update-baseline``, review the new baseline
entries, and write each one's note.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

#: Shared small-shape operating point, the reference's.
_M, _K, _N = 8, 16, 8
_NUM_MODULI = 4


def _device(device) -> torch.device:
    from repro_torch.core.gemm import resolve_device

    return resolve_device(device)


def _t(x, dev, dtype=torch.float64) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x)).to(device=dev, dtype=dtype)


def _rng_ops(dev):
    rng = np.random.default_rng(0)
    return (_t(rng.standard_normal((_M, _K)), dev), _t(rng.standard_normal((_K, _N)), dev))


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    name: str
    policy: str          # informational: the spec the entry runs under
    bitwise: bool
    #: (device, suffix) -> (fn, args); suffix goes after the ozmm specs
    build_fn: Callable
    inplace: tuple[int, ...] = ()

    def build(self, device=None, suffix: str = ""):
        """``(fn, args)`` on ``device`` (None: the card)."""
        return self.build_fn(_device(device), suffix)


def _build_ozmm(spec: str):
    def build(dev, suffix):
        from repro_torch.core import ozmm

        a, b = _rng_ops(dev)
        return (lambda a, b: ozmm(a, b, spec + suffix, device=dev)), (a, b)
    return build


def _plans(ms, a, b):
    from repro_torch.core.plan import quantize_matrix

    return (quantize_matrix(a, "lhs", ms, mode="fast"),
            quantize_matrix(b, "rhs", ms, mode="fast"))


def _build_ozmm_prepared(dev, suffix):
    from repro_torch.core.moduli import make_moduli_set
    from repro_torch.core.plan import ozmm_prepared

    ms = make_moduli_set("fp8-hybrid", _NUM_MODULI)
    qa, qb = _plans(ms, *_rng_ops(dev))
    return (lambda qa, qb: ozmm_prepared(qa, qb)), (qa, qb)


def _build_fused_ref(dev, suffix):
    from repro_torch.kernels import ozmm_fused_ref

    fn = lambda a, b: ozmm_fused_ref(  # noqa: E731
        a, b, family="fp8-hybrid", num_moduli=_NUM_MODULI, mode="fast")
    return fn, _rng_ops(dev)


def _build_crt_reconstruct(dev, suffix):
    from repro_torch.core import crt
    from repro_torch.core.moduli import make_moduli_set

    ms = make_moduli_set("fp8-hybrid", _NUM_MODULI)
    rng = np.random.default_rng(1)
    digits = _t(rng.integers(-100, 100, (_NUM_MODULI, _M, _N)), dev, torch.int32)
    lmu = _t(rng.integers(-60, 60, (_M,)), dev, torch.int32)
    lnu = _t(rng.integers(-60, 60, (_N,)), dev, torch.int32)
    return (lambda d, lmu, lnu: crt.reconstruct(d, ms, lmu, lnu)), (digits, lmu, lnu)


def _build_lu_factor_step(dev, suffix):
    """One blocked LU step's device math: U12 solve + emulated trailing
    update through prepared plans (what lu_factor runs per panel)."""
    from repro_torch.core.moduli import make_moduli_set
    from repro_torch.core.plan import ozmm_prepared
    from repro_torch.linalg.blocks import solve_tri_tensor

    ms = make_moduli_set("fp8-hybrid", _NUM_MODULI)
    rng = np.random.default_rng(2)
    nb, nt = 8, 16
    a11 = _t(np.tril(rng.standard_normal((nb, nb)), -1) + np.eye(nb), dev)
    a12 = _t(rng.standard_normal((nb, nt)), dev)
    a21 = _t(rng.standard_normal((nt, nb)), dev)
    a22 = _t(rng.standard_normal((nt, nt)), dev)

    def step(a11, a12, a21, a22):
        u12 = solve_tri_tensor(a11, a12, lower=True, unit_diag=True)
        return a22 - ozmm_prepared(*_plans(ms, a21, u12))

    return step, (a11, a12, a21, a22)


def _build_lu_solve_step(dev, suffix):
    """One forward-substitution block step of the TRSM behind lu_solve:
    elimination-order plan fold + on-device diagonal-block solve."""
    from repro_torch.core.moduli import make_moduli_set
    from repro_torch.core.plan import ozmm_prepared
    from repro_torch.linalg.blocks import solve_tri_tensor

    ms = make_moduli_set("fp8-hybrid", _NUM_MODULI)
    rng = np.random.default_rng(3)
    nb, nrhs = 8, 4
    lu_ii = _t(np.tril(rng.standard_normal((nb, nb)), -1) + np.eye(nb), dev)
    a_ij = _t(rng.standard_normal((nb, nb)), dev)
    x_j = _t(rng.standard_normal((nb, nrhs)), dev)
    b_i = _t(rng.standard_normal((nb, nrhs)), dev)

    def step(lu_ii, a_ij, x_j, b_i):
        acc = b_i - ozmm_prepared(*_plans(ms, a_ij, x_j))
        return solve_tri_tensor(lu_ii, acc, lower=True, unit_diag=True)

    return step, (lu_ii, a_ij, x_j, b_i)


def _build_decode_slots(dev, suffix):
    """Paged decode over the smoke dense model (the bitwise paged == dense
    contract); the KV cache is the buffer the engine updates in place."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    model = Model(get_config("qwen2-7b", "smoke"), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen)
    cache = model.init_paged_cache(num_pages=8, page_size=16)
    block_tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=dev)
    token = torch.zeros((2,), dtype=torch.int32, device=dev)
    positions = torch.zeros((2,), dtype=torch.int32, device=dev)

    def decode(params, token, positions, cache, block_tables):
        return model.decode_slots(params, token, positions, cache, block_tables)

    return decode, (params, token, positions, cache, block_tables)


ENTRY_POINTS: tuple[EntryPoint, ...] = (
    EntryPoint("ozmm[fp8-fast]", f"ozaki2-fp8/fast@{_NUM_MODULI}", True,
               _build_ozmm(f"ozaki2-fp8/fast@{_NUM_MODULI}")),
    EntryPoint("ozmm[fp8-accurate]", f"ozaki2-fp8/accurate@{_NUM_MODULI}",
               True, _build_ozmm(f"ozaki2-fp8/accurate@{_NUM_MODULI}")),
    EntryPoint("ozmm[int8-fast]", f"ozaki2-int8/fast@{_NUM_MODULI}", True,
               _build_ozmm(f"ozaki2-int8/fast@{_NUM_MODULI}")),
    EntryPoint("ozmm_prepared[fp8-fast]", f"ozaki2-fp8/fast@{_NUM_MODULI}",
               True, _build_ozmm_prepared),
    EntryPoint("ozmm_pallas_fused[ref]", f"ozaki2-fp8/fast@{_NUM_MODULI}",
               True, _build_fused_ref),
    EntryPoint("crt.reconstruct", "(family=fp8-hybrid)", True,
               _build_crt_reconstruct),
    EntryPoint("lu_factor[device-step]", f"ozaki2-fp8/fast@{_NUM_MODULI}",
               True, _build_lu_factor_step),
    EntryPoint("lu_solve[device-step]", f"ozaki2-fp8/fast@{_NUM_MODULI}",
               True, _build_lu_solve_step),
    EntryPoint("decode_slots[paged]", "native (paged == dense contract)",
               True, _build_decode_slots, inplace=(3,)),
)
