"""The aligned-batch ``ServeEngine`` (the torch counterpart of
``repro/serve/engine.py``): prefill a batch of same-length prompts, then
greedy/temperature decode, as a thin wrapper over the continuous-batching
engine (``repro_torch.serve.batching.BatchingEngine``) that submits each
batch row as one request against a dense (non-paged) slot pool. New code
should drive :class:`BatchingEngine` directly.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models import Model
from repro_torch.precision import resolve_pinned_policy

from .batching.engine import BatchingEngine, fold_in
from .weight_cache import WeightResidueCache, quantize_params


def make_serve_fns(model: Model):
    """Returns (prefill_fn, decode_fn) over ``model``'s serving steps."""

    def prefill(params, batch, cache):
        return model.prefill(params, batch, cache)

    def decode(params, token, cache):
        return model.decode_step(params, token, cache)

    return prefill, decode


class ServeEngine:
    """Aligned-batch engine, a compatibility wrapper over
    :class:`~repro_torch.serve.batching.BatchingEngine`.

    Precision: the engine resolves its ``PrecisionPolicy`` ONCE at
    construction (per-arg ``policy=``, which must agree with an explicit
    ``cfg.gemm``; else the model config's ``gemm``; else the ambient
    context) and pins it for every call it makes, so a context change after
    construction cannot skew decode vs the weight cache.

    Under an Ozaki-II emulated backend the engine quantizes every matmul
    weight exactly once (``cache_weight_residues``, default on when the
    policy has plans enabled); decode steps reuse the cached residues.
    Results are numerically identical to the uncached path (bitwise in fast
    mode). The one :class:`WeightResidueCache` is shared with every inner
    engine, so switching batch sizes never re-quantizes.
    """

    def __init__(self, model: Model, params: Any, max_len: int,
                 cache_weight_residues: Optional[bool] = None,
                 policy=None):
        self.model = model
        self.params = params
        self.max_len = max_len
        pol = resolve_pinned_policy(model.cfg.gemm, policy)
        self.policy = pol
        if cache_weight_residues is None:
            cache_weight_residues = pol.plans_enabled
        self._cache_weight_residues = bool(cache_weight_residues)
        self.weight_cache = (WeightResidueCache(pol)
                             if cache_weight_residues and pol.plans_enabled
                             else None)
        if self.weight_cache is not None:
            # populate eagerly: the wrapper's contract is "quantize once at
            # construction"; inner engines then hit this warm cache.
            quantize_params(params, pol, self.weight_cache)
        self._engines: dict[int, BatchingEngine] = {}

    def _engine_for(self, batch_size: int) -> BatchingEngine:
        if batch_size not in self._engines:
            self._engines[batch_size] = BatchingEngine(
                self.model, self.params, max_len=self.max_len,
                max_slots=batch_size, paged=False, policy=self.policy,
                cache_weight_residues=self._cache_weight_residues,
                weight_cache=self.weight_cache)
        return self._engines[batch_size]

    def generate(self, batch: dict, steps: int, temperature: float = 0.0,
                 key: Optional[int] = None) -> torch.Tensor:
        """(B, S) prompt tokens -> (B, steps) int32 generated tokens, on the
        host. ``key`` is the int seed of temperature sampling; row i draws
        from the stream ``fold_in(key, i)``."""
        tokens = torch.as_tensor(batch["tokens"])
        b = tokens.shape[0]
        engine = self._engine_for(b)
        rids = [
            engine.submit([int(t) for t in tokens[i]], max_new_tokens=steps,
                          temperature=temperature,
                          key=None if key is None else fold_in(key, i))
            for i in range(b)
        ]
        results = engine.run()
        return torch.tensor([results[r].tokens for r in rids], dtype=torch.int32)
