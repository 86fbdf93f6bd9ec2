"""BatchingEngine: in-flight (continuous) batching over the serve substrate
(the torch counterpart of ``repro/serve/batching/engine.py``).

Architecture (the reference's docs/serving.md):

* Requests enter through a :class:`Scheduler` (FIFO or priority) and are
  admitted when their *policy group* has a free batch slot and, in paged
  mode, the page allocator can cover their full budget
  (``prompt + max_new_tokens``); requests whose budget can never fit are
  rejected outright, so admission never deadlocks.
* A **policy group** is the unit of adaptive precision: the engine resolves
  each request's accuracy class against the cached weight sketches
  (``resolve_for_sketches``) into a concrete ``num_moduli``, and requests
  that resolve to the same :class:`~repro_torch.precision.PrecisionPolicy`
  share one group: one set of quantized weights (its own
  :class:`~repro_torch.serve.weight_cache.WeightResidueCache`), one KV
  cache. Requests with ``accuracy=None`` ride the engine's base group.
* Within a group, prefill and decode are split: joins happen at step
  boundaries (paged mode batches the wave as one ragged right-padded
  prefill; the dense fallback prefills each request at its exact length
  and row-scatters the result into the slot pool), then all live slots
  decode one token per engine step.
* Batch shapes are **bucketed** as in the reference, so the kernels see
  the reference's shape set: paged decode pads the active-slot batch to the
  next power of two; paged prefill pads the join wave to power-of-two
  (batch, length) buckets; dense decode always runs the full ``max_slots``
  batch. Padded slots write through scratch (page 0 / a dead slot row) and
  their logits are discarded. The port has no jit: ``prefill_traces`` /
  ``decode_traces`` count the distinct bucket shapes a group has run, the
  number of traces the reference compiles for the same requests.
* KV pools are updated in place (the reference donates them to its jitted
  steps), so a step never copies the cache.

Bitwise guarantee (fast mode): per-row batch independence is exact for the
GQA paged path: each request's tokens and logits equal running it alone
through the aligned-batch ``ServeEngine``.

Clocks: ``first_token_time`` is read once the token is on the host (the
card runs asynchronously, so the time after the prefill call returns would
be that of its enqueue).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models import Model
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import span
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.precision import (PrecisionPolicy, resolve_for_sketches,
                                   resolve_pinned_policy, use_policy)

from ..weight_cache import WeightResidueCache, collect_weight_sketches, quantize_params
from .kv_pages import PageAllocator
from .request import Request, RequestResult, RequestStatus, resolve_accuracy_target
from .scheduler import ADMIT, DEFER, REJECT, Scheduler

#: Families whose serve caches are pure attention tensors -> pageable.
PAGED_FAMILIES = ("dense", "moe")


def fold_in(seed: int, i: int) -> int:
    """A seed for draw ``i`` of the stream ``seed`` (the role of
    ``jax.random.fold_in``; not its values)."""
    return (int(seed) * 1_000_003 + int(i)) % 2 ** 63


def sample_tokens(logits: torch.Tensor, temperature: float,
                  key: Optional[int], i: int) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 tokens. Greedy at temperature <= 0, as
    the reference; otherwise a Gumbel-max categorical draw from a
    ``torch.Generator`` seeded ``fold_in(key, i)``: reproducible for a given
    int seed ``key``, but not the reference's ``jax.random`` stream. Without
    a key the draws fall back to seed 0, with a warning."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if key is None:
        warnings.warn(
            "serve sampling: temperature > 0 but no key was given; "
            "defaulting to seed 0 (deterministic sampling). "
            "Pass key= for independent draws.", stacklevel=3)
        key = 0
    gen = torch.Generator(device=logits.device)
    gen.manual_seed(fold_in(key, i))
    u = torch.rand(logits.shape, generator=gen, device=logits.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits.to(torch.float32) / temperature + gumbel, dim=-1).to(torch.int32)


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@dataclasses.dataclass
class _Slot:
    req: Request
    pages: list  # paged mode; [] for dense slots
    pos: int  # cache positions written so far (prompt, then +1 per decode)
    generated: list
    last_token: int
    first_token_time: Optional[float] = None


class _Group:
    """One policy's sub-engine: quantized weights, KV cache, slots, and the
    bucket shapes it has run (``prefill_traces``/``decode_traces``)."""

    def __init__(self, engine: "BatchingEngine", policy: PrecisionPolicy,
                 weight_cache: Optional[WeightResidueCache] = None):
        self.policy = policy
        self.spec = policy.spec
        cfg = dataclasses.replace(engine.model.cfg, gemm=policy)
        self.model = model = Model(cfg, device=engine.model.device)
        use_cache = engine.cache_weight_residues and policy.plans_enabled
        self.weight_cache = None
        if use_cache:
            self.weight_cache = (weight_cache if weight_cache is not None
                                 else WeightResidueCache(policy))
        self.serve_params = (quantize_params(engine.params, policy, self.weight_cache)
                             if self.weight_cache is not None else engine.params)
        self.paged = engine.paged
        self.slots: list[Optional[_Slot]] = [None] * engine.max_slots
        self.prefill_shapes: set = set()
        self.decode_shapes: set = set()
        if self.paged:
            self.nb = engine.nb
            self.allocator = PageAllocator(engine.num_pages, engine.page_size)
            self.cache = model.init_paged_cache(engine.num_pages, engine.page_size)
            self.block_tables = np.tile(PageAllocator.scratch_row(self.nb),
                                        (engine.max_slots, 1))
        else:
            self.allocator = None
            self.cache = model.init_slot_cache(engine.max_slots, engine.max_len)

    @property
    def prefill_traces(self) -> int:
        return len(self.prefill_shapes)

    @property
    def decode_traces(self) -> int:
        return len(self.decode_shapes)

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)


class BatchingEngine:
    """Continuous-batching engine. ``submit()`` enqueues, ``step()`` runs one
    engine iteration (expire -> admit+prefill -> decode -> harvest),
    ``run()`` drives to completion and returns
    ``{request_id: RequestResult}``.

    ``paged=None`` auto-selects: page pools for pure-attention families,
    slot-pooled dense caches otherwise. ``max_len`` caps ``prompt +
    max_new_tokens`` per request; ``num_pages`` defaults to full
    provisioning (every slot can hold ``max_len``); set it lower to exercise
    page-pressure admission. The engine runs on ``model.device``.
    """

    def __init__(self, model: Model, params: Any, *, max_len: int,
                 max_slots: int = 8, page_size: int = 8,
                 num_pages: Optional[int] = None, policy=None,
                 scheduler: str = "fifo",
                 cache_weight_residues: Optional[bool] = None,
                 paged: Optional[bool] = None,
                 weight_cache: Optional[WeightResidueCache] = None):
        cfg = model.cfg
        if cfg.family == "encdec" or cfg.frontend:
            raise ValueError(
                "BatchingEngine serves token-only requests; encoder-decoder "
                "and frontend (vlm) configs need per-request side inputs the "
                "request abstraction does not carry yet")
        self.model = model
        self.params = params
        self.max_len = int(max_len)
        self.max_slots = int(max_slots)
        self.page_size = int(page_size)
        self.nb = -(-self.max_len // self.page_size)
        if paged is None:
            paged = cfg.family in PAGED_FAMILIES
        if paged and cfg.family not in PAGED_FAMILIES:
            raise ValueError(f"family {cfg.family!r} caches are not pageable")
        self.paged = bool(paged)
        self.num_pages = (int(num_pages) if num_pages is not None
                          else 1 + self.max_slots * self.nb)
        pol = resolve_pinned_policy(cfg.gemm, policy)
        self.policy = pol
        if cache_weight_residues is None:
            cache_weight_residues = pol.plans_enabled
        self.cache_weight_residues = bool(cache_weight_residues)
        self.scheduler = Scheduler(scheduler)
        self.results: dict[int, RequestResult] = {}
        self._submit_times: dict[int, float] = {}
        self._groups: dict[PrecisionPolicy, _Group] = {}
        self._sketches = None  # lazy: needed only for accuracy classes
        # Owned always-on registry: the ``stats()`` contract must hold with
        # global obs off. ``_metric`` mirrors into the global registry when
        # obs is enabled.
        self.metrics = MetricsRegistry()
        self._base_group = self._ensure_group(pol, weight_cache=weight_cache)

    def _metric(self, kind: str, name: str, value: float, **labels) -> None:
        getattr(self.metrics, kind)(name, value, **labels)
        getattr(obs_metrics, kind)(name, value, **labels)  # gated global

    # ------------------------------------------------------------- groups
    def _ensure_group(self, policy: PrecisionPolicy,
                      weight_cache: Optional[WeightResidueCache] = None) -> _Group:
        if policy not in self._groups:
            self._groups[policy] = _Group(self, policy, weight_cache)
        return self._groups[policy]

    def _weight_sketches(self):
        if self._sketches is None:
            self._sketches = collect_weight_sketches(self.params)
        return self._sketches

    def _group_for(self, req: Request) -> _Group:
        if req.accuracy is None:
            return self._base_group
        target = resolve_accuracy_target(req.accuracy)
        n = resolve_for_sketches(self.policy, self._weight_sketches(), target)
        return self._ensure_group(dataclasses.replace(self.policy, num_moduli=n))

    # ------------------------------------------------------------- submit
    def submit(self, tokens, *, max_new_tokens: int, accuracy=None,
               priority: int = 0, deadline: Optional[float] = None,
               temperature: float = 0.0, key: Optional[int] = None) -> int:
        """Enqueue a request; returns its id. ``deadline`` is seconds from
        now (converted to the engine's monotonic clock); ``key`` is the int
        seed of temperature sampling."""
        if accuracy is not None and not self.policy.supports_plans:
            raise ValueError(
                f"per-request accuracy classes require an Ozaki-II base "
                f"policy with modulus counts to adapt; base is "
                f"{self.policy.spec!r}")
        now = time.monotonic()
        req = Request(tokens=tuple(tokens), max_new_tokens=max_new_tokens,
                      accuracy=accuracy, priority=priority,
                      deadline=None if deadline is None else now + deadline,
                      temperature=temperature, key=key)
        self.scheduler.submit(req)
        self._submit_times[req.request_id] = now
        return req.request_id

    # ---------------------------------------------------------- admission
    def _can_admit(self, req: Request, group: Optional[_Group] = None,
                   reserved=(0, 0)) -> str:
        """``reserved`` = (slots, pages) already promised to earlier
        admissions in the same drain pass but not yet materialized."""
        if req.total_len > self.max_len:
            return REJECT
        if group is None:
            group = self._group_for(req)
        if self.paged:
            need = group.allocator.pages_needed(req.total_len)
            if need > self.num_pages - 1:  # permanently oversized for the pool
                return REJECT
            if need > group.allocator.num_free - reserved[1]:
                return DEFER
        if group.num_active + reserved[0] >= self.max_slots:
            return DEFER
        return ADMIT

    # -------------------------------------------------------------- steps
    def step(self) -> None:
        with span("serve.engine.step") as sp:
            self._step_inner()
        self._metric("inc", "serve.steps", 1.0)
        self._metric("observe", "serve.step_seconds", sp.elapsed)

    def _step_inner(self) -> None:
        now = time.monotonic()
        self._expire_running(now)
        reservations: dict[PrecisionPolicy, list] = {}

        def can_admit(req: Request) -> str:
            group = self._group_for(req)
            r = reservations.setdefault(group.policy, [0, 0])
            verdict = self._can_admit(req, group, r)
            if verdict == ADMIT:
                r[0] += 1
                if self.paged:
                    r[1] += group.allocator.pages_needed(req.total_len)
            self._metric("inc", "serve.admission", 1.0, verdict=verdict)
            return verdict

        admitted, expired, rejected = self.scheduler.drain(now, can_admit)
        for req in expired:
            self._finalize(req, RequestStatus.EXPIRED, [], None, now)
        for req in rejected:
            self._finalize(req, RequestStatus.REJECTED, [], None, now)
        if admitted:
            waves: dict[PrecisionPolicy, list[Request]] = {}
            for req in admitted:
                waves.setdefault(self._group_for(req).policy, []).append(req)
            for policy, reqs in waves.items():
                group = self._groups[policy]
                with span("serve.engine.prefill", policy=group.spec, wave=len(reqs)):
                    if self.paged:
                        self._join_paged(group, reqs)
                    else:
                        self._join_dense(group, reqs)
                self._harvest(group)
        for group in self._groups.values():
            if group.num_active:
                with span("serve.engine.decode", policy=group.spec,
                          active=group.num_active):
                    self._decode_group(group)
                self._harvest(group)

    def run(self, max_steps: Optional[int] = None) -> dict[int, RequestResult]:
        steps = 0
        while len(self.scheduler) or any(g.num_active for g in self._groups.values()):
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return dict(self.results)

    # --------------------------------------------------------------- join
    def _join_paged(self, group: _Group, reqs: list) -> None:
        wave = []
        for req in reqs:
            si = group.free_slot()
            pages = group.allocator.alloc(group.allocator.pages_needed(req.total_len))
            group.slots[si] = _Slot(req=req, pages=pages, pos=len(req.tokens),
                                    generated=[], last_token=0)
            group.block_tables[si] = group.allocator.block_table_row(pages, group.nb)
            wave.append(si)
        bb = _next_pow2(len(wave))
        sb = min(_next_pow2(max(len(group.slots[si].req.tokens) for si in wave)),
                 _next_pow2(self.max_len))
        toks = np.zeros((bb, sb), np.int32)
        lengths = np.ones((bb,), np.int32)  # padded rows: length 1, scratch pages
        bt = np.tile(PageAllocator.scratch_row(group.nb), (bb, 1))
        for j, si in enumerate(wave):
            prompt = group.slots[si].req.tokens
            toks[j, :len(prompt)] = prompt
            lengths[j] = len(prompt)
            bt[j] = group.block_tables[si]
        group.prefill_shapes.add(toks.shape)
        with use_policy(group.policy):
            logits, group.cache = group.model.prefill_slots(
                group.serve_params, toks, lengths, bt, group.cache)
        for j, si in enumerate(wave):
            self._emit(group.slots[si], logits[j])

    def _join_dense(self, group: _Group, reqs: list) -> None:
        # Exact-length B=1 prefill per request, row-scattered into the pool
        # (the reference's fallback for typed recurrent caches, which cannot
        # mask padded steps the way attention keys can).
        for req in reqs:
            si = group.free_slot()
            group.slots[si] = _Slot(req=req, pages=[], pos=len(req.tokens),
                                    generated=[], last_token=0)
            tokens = np.asarray([req.tokens], np.int32)
            group.prefill_shapes.add(tokens.shape)
            with use_policy(group.policy):
                row_cache = group.model.init_cache(group.serve_params, {"tokens": tokens},
                                                   self.max_len)
                logits, row_cache = group.model.prefill(group.serve_params,
                                                        {"tokens": tokens}, row_cache)
            for pool_stage, row_stage in zip(group.cache["stages"], row_cache["stages"]):
                for pool_layer, row_layer in zip(pool_stage, row_stage):
                    for name, t in row_layer.items():
                        pool_layer[name][si:si + 1] = t
            self._emit(group.slots[si], logits[0])

    # ------------------------------------------------------------- decode
    def _decode_group(self, group: _Group) -> None:
        active = [(i, s) for i, s in enumerate(group.slots) if s is not None]
        if self.paged:
            bb = _next_pow2(len(active))
            toks = np.zeros((bb,), np.int32)
            pos = np.zeros((bb,), np.int32)
            bt = np.tile(PageAllocator.scratch_row(group.nb), (bb, 1))
            for j, (i, s) in enumerate(active):
                toks[j], pos[j], bt[j] = s.last_token, s.pos, group.block_tables[i]
            group.decode_shapes.add(toks.shape)
            with use_policy(group.policy):
                logits, group.cache = group.model.decode_slots(
                    group.serve_params, toks, pos, group.cache, bt)
            rows = {j: s for j, (_, s) in enumerate(active)}
        else:
            # fixed full-slot batch: one decode shape
            toks = np.zeros((self.max_slots,), np.int32)
            pos = np.zeros((self.max_slots,), np.int32)
            for i, s in active:
                toks[i], pos[i] = s.last_token, s.pos
            group.decode_shapes.add(toks.shape)
            with use_policy(group.policy):
                logits, group.cache = group.model.decode_slots(
                    group.serve_params, toks, pos, group.cache)
            rows = {i: s for i, s in active}
        for row, slot in rows.items():
            slot.pos += 1
            self._emit(slot, logits[row])
        self._metric("inc", "serve.decode_tokens", float(len(rows)))

    def _emit(self, slot: _Slot, logits_row: torch.Tensor) -> None:
        i = len(slot.generated)
        tok = int(sample_tokens(logits_row[None, :], slot.req.temperature,
                                slot.req.key, i)[0])
        slot.generated.append(tok)
        slot.last_token = tok
        self._metric("inc", "serve.tokens.emitted", 1.0)
        if slot.first_token_time is None:
            slot.first_token_time = time.monotonic()

    # ------------------------------------------------------------ harvest
    def _harvest(self, group: _Group) -> None:
        now = time.monotonic()
        for i, slot in enumerate(group.slots):
            if slot is not None and len(slot.generated) >= slot.req.max_new_tokens:
                self._leave(group, i, RequestStatus.FINISHED, now)

    def _expire_running(self, now: float) -> None:
        for group in self._groups.values():
            for i, slot in enumerate(group.slots):
                if (slot is not None and slot.req.deadline is not None
                        and now > slot.req.deadline):
                    self._leave(group, i, RequestStatus.EXPIRED, now)

    def _leave(self, group: _Group, slot_idx: int, status: RequestStatus,
               now: float) -> None:
        slot = group.slots[slot_idx]
        group.slots[slot_idx] = None
        if self.paged:
            group.allocator.release(slot.pages)
            group.block_tables[slot_idx] = PageAllocator.scratch_row(group.nb)
        self._finalize(slot.req, status, slot.generated,
                       slot.first_token_time, now, group.spec)

    def _finalize(self, req: Request, status: RequestStatus, tokens: list,
                  first_t: Optional[float], now: float,
                  policy_spec: Optional[str] = None) -> None:
        submit_t = self._submit_times.pop(req.request_id, None)
        self.results[req.request_id] = RequestResult(
            request_id=req.request_id, status=status, tokens=list(tokens),
            policy_spec=policy_spec,
            submit_time=submit_t, first_token_time=first_t, finish_time=now)
        self._metric("inc", "serve.requests", 1.0, status=status.name.lower())
        self._metric("inc", "serve.tokens.finalized", float(len(tokens)),
                     status=status.name.lower())
        if submit_t is not None:
            self._metric("observe", "serve.latency_s", now - submit_t)
            if first_t is not None:
                self._metric("observe", "serve.ttft_s", first_t - submit_t)

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        groups = {}
        for g in self._groups.values():
            groups[g.spec] = {
                "active_slots": g.num_active,
                "prefill_traces": g.prefill_traces,
                "decode_traces": g.decode_traces,
                "weight_cache_entries": len(g.weight_cache) if g.weight_cache else 0,
                "weight_cache_nbytes": g.weight_cache.nbytes() if g.weight_cache else 0,
                "free_pages": g.allocator.num_free if self.paged else None,
            }
        return {
            "paged": self.paged,
            "max_slots": self.max_slots,
            "page_size": self.page_size,
            "num_pages": self.num_pages if self.paged else None,
            "steps": int(self.metrics.counter_value("serve.steps")),
            "queued": len(self.scheduler),
            "completed": len(self.results),
            "decode_tokens": int(self.metrics.counter_value("serve.decode_tokens")),
            "weight_cache_nbytes": sum(gr["weight_cache_nbytes"] for gr in groups.values()),
            "groups": groups,
            "registry": self.metrics.snapshot(),
        }
