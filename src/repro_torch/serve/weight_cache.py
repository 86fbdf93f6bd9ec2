"""Weight-residue cache (the torch counterpart of
``repro/serve/weight_cache.py``): quantize model weights ONCE.

Under an emulated-GEMM backend, serving re-multiplies the same weight
matrices at every decode step, and an unprepared ``ozmm`` re-runs the whole
quantization pipeline (scaling + residue extraction) each time.
Decomposition is per operand (``core.plan``), so the engine swaps
matmul-weight leaves for prepared ``QuantizedMatrix`` plans once; decode
then quantizes only the (small) activation side.

Which leaves: matmul weights are identified by the parameter-leaf NAME, the
contract shared with ``repro_torch.models``, restricted to 2-D float
leaves. The port keeps one module per layer, so each layer's weight gets a
plan of its own where the reference vmaps the quantization over a stage's
stacked layer axis; plan i equals the reference's stacked plan at slice i.
Leaves consumed outside plain ``layers.matmul`` (embeddings used as lookup
tables, norms, biases) are left untouched.

The cache is keyed on ``(param path, role, policy)``: the frozen
``PrecisionPolicy`` is hashable, so its hash covers scheme, mode, modulus
count and every other knob at once, and repeated requests (several engines
sharing one cache) hit the same plan.
"""
from __future__ import annotations

import copy
import re
from typing import Any

import torch
from torch import nn

from repro_torch.core.plan import QuantizedMatrix, quantize_matrix
from repro_torch.obs import metrics as obs_metrics
from repro_torch.precision import (PrecisionPolicy, WeightSketch, operand_spread_log2,
                                   resolve_policy)

#: Parameter-leaf names that are plain ``layers.matmul`` right-hand sides
#: (the reference's set; MLA's w_uk/w_uv are consumed via reshape+einsum and
#: MUST NOT appear here).
MATMUL_WEIGHT_NAMES = frozenset({
    "wq", "wk", "wv", "wo", "w_dq", "w_uq", "w_q", "w_dkv",
    "w_up", "w_gate", "w_down", "in_proj", "out_proj",
    "lm_head", "frontend_proj", "proj", "router",
})


def _is_matmul_weight(path: str, leaf: torch.Tensor) -> bool:
    return (leaf.is_floating_point() and leaf.ndim == 2
            and path.rsplit(".", 1)[-1] in MATMUL_WEIGHT_NAMES)


def _matmul_weights(params: nn.Module):
    """(path, leaf) of every matmul weight, in parameter order."""
    return [(path, leaf) for path, leaf in params.named_parameters()
            if _is_matmul_weight(path, leaf)]


def plan_nbytes(plan: QuantizedMatrix) -> int:
    """Device bytes held by one plan: residue parts, scale-exponent frames,
    magnitude sketches and (accurate mode) the retained f64 source."""
    st = plan.stats
    leaves = [plan.x, plan.lscale, plan.lpre, plan.bar,
              *((st.row_sq, st.row_max, st.col_sq, st.col_max) if st is not None else ()),
              *(t for part in (plan.parts or ()) for t in part)]
    return sum(t.numel() * t.element_size() for t in leaves if t is not None)


class WeightResidueCache:
    """Maps ``(path, role, policy)`` -> prepared plan (the policy hash covers
    scheme/mode/num_moduli and the rest of the precision knobs)."""

    def __init__(self, policy):
        pol = resolve_policy(policy)
        if not pol.supports_plans:
            raise ValueError(
                f"scheme {pol.scheme!r} has no operand plans; the weight "
                "cache applies to Ozaki-II schemes only")
        self.policy: PrecisionPolicy = pol
        self._cache: dict[tuple, QuantizedMatrix] = {}
        self._nbytes: int | None = None  # memo; None = dirty

    def _key(self, path: str, role: str) -> tuple:
        return (path, role, self.policy)

    def get(self, path: str, leaf: torch.Tensor, role: str = "rhs") -> QuantizedMatrix:
        key = self._key(path, role)
        if key in self._cache:
            obs_metrics.inc("serve.weight_cache.hits", 1.0, policy=self.policy.spec)
            return self._cache[key]
        obs_metrics.inc("serve.weight_cache.misses", 1.0, policy=self.policy.spec)
        plan = _quantize_leaf(leaf, role, self.policy)
        self._cache[key] = plan
        self._nbytes = None  # mutation invalidates the byte memo
        return plan

    def __len__(self) -> int:
        return len(self._cache)

    def nbytes(self) -> int:
        """Device bytes held by the cached plans (``plan_nbytes``). Memoized:
        the walk reruns only after an insertion (``stats()`` polls this per
        engine step)."""
        if self._nbytes is None:
            self._nbytes = sum(plan_nbytes(p) for p in self._cache.values())
            obs_metrics.gauge("serve.weight_cache.nbytes", float(self._nbytes),
                              policy=self.policy.spec)
        return self._nbytes


#: A per-layer path "[<prefix>.]stages.<s>.<i>.<rest>" and its stage-level
#: path "[<prefix>.]stages.<s>.<rest>" (the reference's stacked leaf; the
#: prefix is "encoder" for the encoder-decoder's encoder).
_LAYER = re.compile(r"^((?:.+\.)?stages\.\d+)\.\d+\.(.+)$")


def collect_weight_sketches(params: nn.Module) -> tuple[WeightSketch, ...]:
    """Admission-time exponent-range sketches of every matmul-weight leaf.

    Collected from the RAW params (fast-mode cached plans drop their f64
    source, after which the spread can no longer be measured); the serving
    engine captures these once and feeds them to ``resolve_for_sketches``
    for each request's accuracy class. As in the reference, the layers of a
    stage are sketched together, one conservative summary per stage
    (path ``stages.<s>.<leaf path>``) rather than per layer."""
    groups: dict[str, list[torch.Tensor]] = {}
    for path, leaf in _matmul_weights(params):
        found = _LAYER.match(path)
        groups.setdefault(f"{found[1]}.{found[2]}" if found else path, []).append(leaf)
    return tuple(
        WeightSketch(path=path, contract_dim=int(leaves[0].shape[-2]),
                     spread_log2=operand_spread_log2(
                         torch.cat([w.detach().reshape(-1) for w in leaves])))
        for path, leaves in groups.items())


def _quantize_leaf(leaf: torch.Tensor, role: str, pol: PrecisionPolicy) -> QuantizedMatrix:
    plan = quantize_matrix(leaf.detach().to(torch.float64), role, pol.moduli_set(),
                           mode=pol.mode)
    # Fast-mode decode reads only the residue parts + scales; drop the f64
    # copy of the weight so the cache doesn't quadruple weight memory.
    return plan.drop_source() if pol.mode == "fast" else plan


def _with_plans(module: nn.Module, prefix: str, plans: dict) -> nn.Module:
    """A shallow copy of ``module``'s tree (sharing every tensor) in which
    the parameters named in ``plans`` (full path -> plan) are replaced by
    plain attributes holding the plans."""
    clone = copy.copy(module)
    clone._parameters = dict(module._parameters)
    clone._modules = {name: _with_plans(child, f"{prefix}{name}.", plans)
                      for name, child in module._modules.items()}
    for name in list(clone._parameters):
        if prefix + name in plans:
            del clone._parameters[name]
            object.__setattr__(clone, name, plans[prefix + name])
    return clone


def quantize_params(params: nn.Module, policy=None,
                    cache: WeightResidueCache | None = None) -> Any:
    """``params`` with its matmul-weight leaves replaced by prepared
    ``QuantizedMatrix`` plans: a shallow copy of the module tree, which the
    model functions consume directly (``layers.matmul`` recognizes prepared
    weights); ``params`` itself is unchanged.

    ``policy`` resolves per repro_torch.precision (policy | spec | None ->
    context). Under a policy without plans, ``params`` comes back as is.
    """
    pol = resolve_policy(policy)
    if not pol.supports_plans:
        return params
    if cache is None:  # NOT ``or``: an empty cache is falsy via __len__
        cache = WeightResidueCache(pol)
    plans = {path: cache.get(path, leaf, "rhs") for path, leaf in _matmul_weights(params)}
    return _with_plans(params, "", plans)
