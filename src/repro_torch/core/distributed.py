"""Distributed emulated GEMM on a single-controller device mesh (the torch
counterpart of ``repro/core/distributed.py``).

Two sharding strategies, the paper's §IV-C blocking mapped onto a mesh
(``repro_torch.launch.mesh.Mesh``: axis names over an array of
``torch.device``s, which may repeat a device):

* ``ozmm_mn_sharded``: rank (i, j) holds a row block of A and a column block
  of B (k unsharded) and emulates its output block alone; no communication
  inside the GEMM. The blocks are stitched in mesh order.
* ``ozmm_k_sharded``: the contraction is sharded. Modular reduction is
  linear, so each rank computes the centred residue products of its k-slice,
  the int32 partials are summed over the ranks and re-reduced mod p, then
  the Garner digits and the f64 reconstruction run once. The reduction
  moves N int32 matrices (4N bytes an element), the price of exactness.
  ``k_sharded_product`` runs that on given slices: the tensor-parallel
  products (``models.tensor_parallel``) share it.

The scaling statistics are global: fast mode sums the squared norms and
takes the maximum of the abs-maxima over the ranks; accurate mode sums the
ranks' f32 bound-GEMM partials before the (1 + k 2^-24) inflation, with
the global k (the Rump bound holds for any summation order).

One process drives every rank: each rank's work runs on its rank's device,
and a psum or pmax is an explicit reduction of the ranks' tensors in
ascending rank order, on the output's device (the first rank's). The order
matters for the f32 bound partials; integer sums do not depend on it.
Ranks along a mesh axis that a strategy does not shard hold replicas, and
the replica at index 0 does the work.

Route (``shard_route``, as ``core.gemm._resolve_backend`` resolves
``backend="auto"``): on a compute-capability-9.0 card the Hopper kernels,
elsewhere the core torch ops. ``mn_shard`` and ``k_shard_residues`` take the
route as an argument, so one shard can run either (on CPU tensors the
kernel route runs the kernels' plain versions). mn shards run
``quantize_matrix`` and the prepared pairing: K2 in fast mode,
``pair_exponents`` + K1 in accurate mode (``ozmm_pallas_fused_prepared``).
k shards quantize their slice with K6's f64 entry and run their products
on K3 (fp8 families) or K4 (int8) (``kernels.pipeline.residue_gemms``);
the combine, the psum and the Garner steps stay the core's int32
arithmetic, because the psum sits between the products and the combine
(so K5 is not on this path).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.precision.policy import OZAKI2_FAMILY, PrecisionPolicy

from . import crt, numerics, quantize, scaling
from .collectives import collective, nbytes, reduce_ranks
from .moduli import DEFAULT_NUM_MODULI, ModuliSet, make_moduli_set
from .plan import (QuantizedMatrix, ozmm_prepared, plan_from_wire, plan_to_wire, pow2_tables,
                   quantize_matrix, residue_products, wire_bytes)

_FAMILY_SCHEME = {fam: sch for sch, fam in OZAKI2_FAMILY.items()}
_INT32_MAX = 2 ** 31 - 1


def shard_route(family: str, mode: str, num_moduli: int | None,
                device: torch.device) -> str:
    """``"core"`` or ``"pallas"`` (the kernel route): the route ``"auto"``
    takes for a shard on ``device``."""
    from .gemm import _resolve_backend  # gemm imports plan, not us

    pol = PrecisionPolicy(scheme=_FAMILY_SCHEME[family], mode=mode, num_moduli=num_moduli)
    return _resolve_backend(pol, torch.device(device))


def _split(n: int, parts: int, what: str) -> list[slice]:
    if n % parts:
        raise ValueError(f"{what} = {n} is not divisible by the mesh axis size {parts}")
    step = n // parts
    return [slice(r * step, (r + 1) * step) for r in range(parts)]


def _as_f64(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=torch.float64)


def mn_shard(a_loc: torch.Tensor, b_loc: torch.Tensor, ms: ModuliSet, mode: str,
             route: str) -> torch.Tensor:
    """One mn shard: both operands quantized on the shard's device, then the
    prepared pairing on ``route``."""
    qa = quantize_matrix(a_loc, "lhs", ms, mode=mode)
    qb = quantize_matrix(b_loc, "rhs", ms, mode=mode)
    if route == "core":
        return ozmm_prepared(qa, qb)
    from repro_torch.kernels import ozmm_pallas_fused_prepared  # lazy: core <- kernels

    return ozmm_pallas_fused_prepared(qa, qb)


def ozmm_mn_sharded(a, b, mesh, *, m_axis: str = "data", n_axis: str = "model",
                    family: str = "fp8-hybrid", num_moduli: int | None = None,
                    mode: str = "accurate") -> torch.Tensor:
    """Emulated GEMM with A row-sharded over ``m_axis`` and B column-sharded
    over ``n_axis``: rank (i, j) emulates output block (i, j) on its device;
    returns the stitched f64 product on the first rank's device."""
    num_moduli = num_moduli or DEFAULT_NUM_MODULI[family]
    ms = make_moduli_set(family, num_moduli)
    pm, pn = mesh.shape[m_axis], mesh.shape[n_axis]
    out_dev = mesh.devices.flat[0]
    a, b = _as_f64(a, out_dev), _as_f64(b, out_dev)
    rows = _split(a.shape[0], pm, "m")
    cols = _split(b.shape[1], pn, "n")
    out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.float64, device=out_dev)
    for i, rs in enumerate(rows):
        for j, cs in enumerate(cols):
            dev = mesh.axis_devices(m_axis, **{n_axis: j})[i]
            route = shard_route(family, mode, num_moduli, dev)
            out[rs, cs] = mn_shard(a[rs].to(dev), b[:, cs].to(dev), ms, mode, route).to(out_dev)
    return out


#: The longest contraction one residue product keeps exact: an FP8
#: product's f32 sum reaches k * 2^8 and must stay within 2^24 (K3's limit,
#: ``kernels.fp8_gemm.max_k``); a longer k shard runs in slices of it.
K_SLICE = 2 ** 16


def k_shard_residues(a_loc: torch.Tensor, b_loc: torch.Tensor, lmu: torch.Tensor,
                     lnu: torch.Tensor, ms: ModuliSet, route: str) -> list[torch.Tensor]:
    """One k shard's centred residue products C'_l (int32 (m, n) a modulus)
    of its slices under the global exponents: the core's quantization and
    products, or K6 (A's parts, and B's K-major from B^T) and the K3/K4
    schedule, then the core's combine. A shard longer than ``K_SLICE`` runs
    slice by slice and sums the slices' residues (exact: the residues are
    linear mod p)."""
    k = a_loc.shape[1]
    if k > K_SLICE:
        acc = None
        for s in range(0, k, K_SLICE):
            cs = k_shard_residues(a_loc[:, s:s + K_SLICE], b_loc[s:s + K_SLICE], lmu, lnu,
                                  ms, route)
            acc = cs if acc is None else [x + c for x, c in zip(acc, cs)]
        return [numerics.centered_mod(c, p) for c, p in zip(acc, ms.ps)]
    if route == "core":
        tables = pow2_tables(ms, a_loc.device)
        return residue_products(quantize.quantize_operand(a_loc, lmu, 0, ms, tables),
                                quantize.quantize_operand(b_loc, lnu, 1, ms, tables), ms)
    from repro_torch.kernels.common import k_major  # lazy: core <- kernels
    from repro_torch.kernels.pipeline import residue_gemms
    from repro_torch.kernels.quant_residues import quant_residues_op

    sa = quant_residues_op(a_loc, lmu, ms=ms, axis=0)
    sbt = quant_residues_op(k_major(b_loc), lnu, ms=ms, axis=0)  # (N, n, k)
    stacks = residue_gemms(sa, sbt, ms)
    del sa, sbt
    return [crt.combine_residue_product(tuple(c[l] for c in stacks), p, sq, s, ms.family)
            for l, (p, sq, s) in enumerate(zip(ms.ps, ms.is_square, ms.split_s))]


def k_sharded_exponents(a_sh: list[torch.Tensor], b_sh: list[torch.Tensor], k: int,
                        ms: ModuliSet, mode: str, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The global scale exponents (lmu, lnu) of a k-sharded pairing from the
    ranks' slices, on ``device``."""
    amax = reduce_ranks([x.abs().amax(dim=1) for x in a_sh], torch.maximum, device)
    bmax = reduce_ranks([x.abs().amax(dim=0) for x in b_sh], torch.maximum, device)
    if mode == "fast":
        sq_a = reduce_ranks([(x * x).sum(dim=1) for x in a_sh], torch.add, device)
        sq_b = reduce_ranks([(x * x).sum(dim=0) for x in b_sh], torch.add, device)
        return (scaling.fast_exponents(sq_a, amax, k, ms),
                scaling.fast_exponents(sq_b, bmax, k, ms))
    partials = []
    for xa, xb in zip(a_sh, b_sh):
        lmu2, abar = scaling.accurate_prescale(xa, 1, abs_max=amax.to(xa.device))
        lnu2, bbar = scaling.accurate_prescale(xb, 0, abs_max=bmax.to(xb.device))
        partials.append(numerics.matmul_exact_fp8(abar, bbar))
    cbar = scaling.bound_gemm_inflate(reduce_ranks(partials, torch.add, device), k)
    return (scaling.accurate_exponents(cbar.amax(dim=1), lmu2.to(device), amax, ms),
            scaling.accurate_exponents(cbar.amax(dim=0), lnu2.to(device), bmax, ms))


def k_sharded_product(a_sh: list[torch.Tensor], b_sh: list[torch.Tensor], ms: ModuliSet,
                      mode: str, routes: list[str], device, size: int | None = None,
                      k: int | None = None) -> torch.Tensor:
    """The exact product of a contraction split over ``size`` ranks (default
    ``len(a_sh)``), from the ranks' slices: rank r's columns ``a_sh[r]`` of
    A and rows ``b_sh[r]`` of B, on its device, its products on
    ``routes[r]``. The global exponents (``k_sharded_exponents``, ``k`` the
    whole contraction's length, default the slices' sum), each rank's int32
    residue partials, one psum of those planes (an all-reduce), then the
    centring, the Garner digits and the f64 reconstruction once, on
    ``device``. Fewer slices than ``size`` (some ranks' programs, for
    counting) give the partial sum of theirs."""
    k = k if k is not None else sum(x.shape[1] for x in a_sh)
    lmu, lnu = k_sharded_exponents(a_sh, b_sh, k, ms, mode, device)
    size = size if size is not None else len(a_sh)
    acc = None
    for i, (xa, xb, route) in enumerate(zip(a_sh, b_sh, routes)):  # ascending rank
        d = xa.device
        cs = k_shard_residues(xa, xb, lmu.to(d), lnu.to(d), ms, route)
        with collective("all-reduce") as done:  # the psum's adds, as each rank's arrive
            acc = ([c.to(device) for c in cs] if acc is None
                   else [x + c.to(device) for x, c in zip(acc, cs)])
            if i == len(a_sh) - 1 and size > 1:
                done(sum(nbytes(c) for c in acc))
        del cs
    cs = [numerics.centered_mod(c, p) for c, p in zip(acc, ms.ps)]
    return crt.reconstruct(crt.garner_digits(cs, ms), ms, lmu, lnu)


def ozmm_k_sharded(a, b, mesh, *, k_axis: str = "model", family: str = "fp8-hybrid",
                   num_moduli: int | None = None, mode: str = "fast") -> torch.Tensor:
    """Emulated GEMM with the contraction sharded over ``k_axis``, exact:
    the ranks' centred int32 residue partials are summed, then re-reduced
    mod p (``k_sharded_product``). Returns the f64 product on the first
    rank's device."""
    num_moduli = num_moduli or DEFAULT_NUM_MODULI[family]
    ms = make_moduli_set(family, num_moduli)
    devs = mesh.axis_devices(k_axis)
    out_dev = devs[0]
    a, b = _as_f64(a, out_dev), _as_f64(b, out_dev)
    k = a.shape[1]
    if b.shape[0] != k:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} @ {tuple(b.shape)}")
    ks = _split(k, len(devs), "k")
    return k_sharded_product([a[:, s].to(d) for s, d in zip(ks, devs)],
                             [b[s].to(d) for s, d in zip(ks, devs)], ms, mode,
                             [shard_route(family, mode, num_moduli, d) for d in devs], out_dev)


# ---------------------------------------------------------------------------
# Collectives of the block-cyclic factorizations (repro_torch.linalg.dist)
# ---------------------------------------------------------------------------

def argmax_allreduce(vals, idxs, mesh, axis: str) -> tuple[float, int]:
    """All-reduce argmax over one mesh axis, ties to the smallest index.

    Each rank along ``axis`` contributes its pivot candidate ``(value,
    global_index)`` as tensors on its device; they are gathered onto the
    first rank's device, and every rank gets the winner: the largest value,
    the smallest index among its ties (``np.argmax``'s first occurrence
    over the column in global row order, so distributed pivots equal the
    single-device factorization's)."""
    size = mesh.shape[axis]
    vals = np.asarray(vals, dtype=np.float64)
    idxs = np.asarray(idxs)
    if vals.shape != (size,) or idxs.shape != (size,):
        raise ValueError(f"expected one candidate per rank along {axis!r} "
                         f"({size}), got {vals.shape}/{idxs.shape}")
    devs = mesh.axis_devices(axis)
    root = devs[0]
    with collective("all-reduce") as done:
        v = torch.stack([torch.tensor(float(x), dtype=torch.float64, device=d).to(root)
                         for x, d in zip(vals, devs)])
        i = torch.stack([torch.tensor(int(x), dtype=torch.int64, device=d).to(root)
                         for x, d in zip(idxs, devs)])
        m = v.max()
        win = torch.where(v == m, i, torch.full_like(i, _INT32_MAX)).min()
        m, win = torch.stack((m, win.to(torch.float64))).tolist()
        done(v.element_size() + i.element_size())
    return float(m), int(win)


def argmax_allreduce_host(vals, idxs) -> tuple[float, int]:
    """The same collective on host values (the reference's fallback for
    grids larger than the distinct device count)."""
    vals = np.asarray(vals, dtype=float)
    idxs = np.asarray(idxs)
    m = vals.max()
    return float(m), int(idxs[vals == m].min())


def broadcast_plan(q: QuantizedMatrix, devices=()) -> tuple[list[QuantizedMatrix], int]:
    """One-to-many panel broadcast with residue plans as the wire format.

    The owner serializes once (``plan_to_wire``); each leaf goes ``.to``
    each receiver's device and is deserialized there into an execute-only
    plan (bitwise-equal pairing). Returns ``(received_plans,
    payload_bytes)``: a plan per device, and the size of ONE wire copy."""
    header, leaves = plan_to_wire(q)
    payload = wire_bytes(leaves)
    return [plan_from_wire(header, [leaf.to(d) for leaf in leaves]) for d in devices], payload


def broadcast_f64(x, devices=()) -> tuple[list[torch.Tensor], int]:
    """The baseline panel broadcast: the raw f64 block travels and every
    receiver re-quantizes locally. Returns ``(received, payload_bytes)``: a
    block per device, and the size of ONE copy."""
    x = torch.tensor(x, dtype=torch.float64) if isinstance(x, np.ndarray) else \
        x.to(torch.float64)
    payload = int(x.numel() * x.element_size())
    return [x.to(d) for d in devices], payload


def collective_bytes_per_output_elem(family: str, num_moduli: int, strategy: str) -> int:
    """Roofline helper: reduction bytes per output element inside the GEMM."""
    if strategy == "mn":
        return 0
    if strategy == "k":
        return 4 * num_moduli  # int32 psum per modulus
    raise ValueError(strategy)
