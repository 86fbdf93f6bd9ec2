"""Model assembly (the torch counterpart of ``repro/models/model.py``): the
causal LM of the dense family, built from stages of per-layer blocks.

``Model`` holds the config and the device; the parameters are a separate
``CausalLM`` module tree (``init`` draws it, ``models.convert`` loads the
reference's), passed to every entry point as the reference passes its
params pytree, so the serve weight cache can hand the same functions a copy
whose matmul weights are prepared plans. Entry points:

  init(generator)                      -> params (CausalLM)
  init_cache(params, batch, max_len)   -> cache (serving, aligned batch)
  prefill(params, batch, cache)        -> (last-position logits, cache)
  decode_step(params, token, cache)    -> (logits, cache)
  init_slot_cache / init_paged_cache, prefill_slots / decode_slots
                                       -> the continuous-batching engine's

Caches are updated in place and returned. The model runs on the card unless
built with ``device="cpu"``. Families other than dense (and a vlm config
without a frontend), and ``forward_train``, are not ported yet (ROADMAP
Queue A item 5).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.core.gemm import resolve_device

from .attention import AttnTemporal
from .blocks import StageSpec, stage_apply, stage_init, stage_windows
from .config import ModelConfig, validate
from .layers import dtype_of, embed_init, frozen, matmul, rmsnorm, softcap, zeros

#: Families the port's model runs: the pure-attention token models.
PORTED_FAMILIES = ("dense", "vlm")


@dataclasses.dataclass(frozen=True)
class StageEntry:
    spec: StageSpec
    offset: int  # global layer offset (drives local/global alternation)


def build_stages(cfg: ModelConfig) -> tuple[StageEntry, ...]:
    if cfg.family not in PORTED_FAMILIES or cfg.frontend or cfg.use_mla:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (frontend {cfg.frontend!r}, "
            f"MLA {cfg.use_mla}) is not ported to repro_torch yet; the port "
            "runs dense GQA models. ROADMAP Queue A item 5 lists MLA, MoE, "
            "SSM/hybrid, encoder-decoder and vlm next")
    return (StageEntry(StageSpec("attn_mlp", cfg.num_layers), 0),)


class CausalLM(nn.Module):
    """The parameters of a dense causal LM: ``embed``, ``stages`` (one
    ``nn.ModuleList`` of blocks per stage), ``final_norm`` and, unless the
    embeddings are tied, ``lm_head`` (d_model, padded_vocab)."""

    def __init__(self, embed, stages: nn.ModuleList, final_norm, lm_head=None):
        super().__init__()
        self.embed = frozen(embed)
        self.stages = stages
        self.final_norm = frozen(final_norm)
        if lm_head is not None:
            self.lm_head = frozen(lm_head)


class Model:
    def __init__(self, cfg: ModelConfig, *, device=None):
        validate(cfg)
        self.cfg = cfg
        self.stages = build_stages(cfg)
        self.dtype = dtype_of(cfg.dtype)
        self.param_dtype = dtype_of(cfg.param_dtype)
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> CausalLM:
        """Parameters drawn from ``generator``, which lives on the model's
        device. The draws are not the reference's (``jax.random``)."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on {self.device}")
        cfg, pd = self.cfg, self.param_dtype
        embed = embed_init(generator, cfg.padded_vocab, cfg.d_model, pd)
        stages = nn.ModuleList(stage_init(generator, cfg, e.spec, pd) for e in self.stages)
        lm_head = None
        if not cfg.tie_embeddings:
            lm_head = (torch.randn((cfg.d_model, cfg.padded_vocab), generator=generator,
                                   device=generator.device) * cfg.d_model ** -0.5).to(pd)
        return CausalLM(embed, stages, zeros(cfg.d_model, pd, self.device), lm_head)

    # --------------------------------------------------------------- helpers
    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed_inputs(self, params: CausalLM, tokens) -> torch.Tensor:
        cfg = self.cfg
        tok = params.embed[self._tokens(tokens)].to(self.dtype)
        scale = cfg.d_model ** 0.5 if cfg.post_norms else 1.0
        return tok * torch.tensor(scale, dtype=self.dtype, device=tok.device)

    def _run_stages(self, params: CausalLM, x, t: AttnTemporal, cache_stages):
        new_caches = []
        for i, entry in enumerate(self.stages):
            cache_i = cache_stages[i] if cache_stages is not None else None
            windows = stage_windows(self.cfg, entry.spec, entry.offset)
            x, c_new, _ = stage_apply(params.stages[i], x, self.cfg, t, windows,
                                      cache_i, entry.spec.kind)
            new_caches.append(c_new)
        return x, new_caches

    def _logits(self, params: CausalLM, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rmsnorm(x, params.final_norm, cfg.norm_eps)
        head = params.embed.T if cfg.tie_embeddings else params.lm_head
        logits = matmul(x, head, cfg.gemm, out_dtype=torch.float32)
        logits = softcap(logits, cfg.final_softcap)
        if cfg.padded_vocab != cfg.vocab_size:  # mask the TP-padding tail
            pad_mask = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
            logits = torch.where(pad_mask, -1e30, logits)
        return logits

    def _positions(self, b: int, s: int) -> torch.Tensor:
        return torch.arange(s, dtype=torch.int32, device=self.device).expand(b, s)

    # ----------------------------------------------------------------- train
    def forward_train(self, params, batch):
        raise NotImplementedError(
            "forward_train is not ported to repro_torch yet; training "
            "(forward_train, train, optim) is ROADMAP Queue A item 5's second step")

    # ----------------------------------------------------------------- serve
    def _kv(self, lead: tuple) -> dict:
        cfg = self.cfg
        shape = lead + (cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device)}

    def _stage_caches(self, b: int, max_len: int) -> list:
        return [[self._kv((b, max_len)) for _ in range(e.spec.num_layers)]
                for e in self.stages]

    def init_cache(self, params: CausalLM, batch: dict, max_len: int) -> dict:
        b = batch["tokens"].shape[0]
        return {"stages": self._stage_caches(b, max_len), "pos": 0}

    def init_slot_cache(self, num_slots: int, max_len: int) -> dict:
        """Dense slot-pooled serving cache for the continuous-batching
        engine: ``num_slots`` independent rows managed host-side (per-slot
        positions travel through ``decode_slots``; ``cache['pos']`` is
        unused)."""
        return {"stages": self._stage_caches(num_slots, max_len), "pos": 0}

    def init_paged_cache(self, num_pages: int, page_size: int) -> dict:
        """Paged serving cache: shared page pools (``paged_kv``), one per
        layer, replace the per-slot dense length axis."""
        return {"stages": [[self._kv((num_pages, page_size)) for _ in range(e.spec.num_layers)]
                           for e in self.stages]}

    def prefill(self, params: CausalLM, batch: dict, cache: dict):
        x = self._embed_inputs(params, batch["tokens"])
        b, s = x.shape[:2]
        t = AttnTemporal(positions=self._positions(b, s), cache_len=s, pos=None)
        x, new_stages = self._run_stages(params, x, t, cache["stages"])
        logits = self._logits(params, x[:, -1:, :])
        return logits[:, 0], dict(cache, stages=new_stages, pos=s)

    def decode_step(self, params: CausalLM, token, cache: dict):
        """token (B,) -> (logits (B, V), cache)."""
        pos = int(cache["pos"])
        x = self._embed_inputs(params, self._tokens(token)[:, None])
        b = x.shape[0]
        t = AttnTemporal(positions=torch.full((b, 1), pos, dtype=torch.int32,
                                              device=self.device),
                         cache_len=None, pos=pos)
        x, new_stages = self._run_stages(params, x, t, cache["stages"])
        logits = self._logits(params, x)
        return logits[:, 0], dict(cache, stages=new_stages, pos=pos + 1)

    # ------------------------------------------------- serve (slot batching)
    def prefill_slots(self, params: CausalLM, tokens, lengths, block_tables, cache: dict):
        """Ragged right-padded paged prefill: ``tokens`` (B, S) with row i
        valid on [0, lengths[i]); rows write disjoint page sets through
        ``block_tables`` (B, nb). Returns each row's logits at its last valid
        position and the updated pool cache. Padded positions are
        key-masked, so valid rows equal an exact-length prefill."""
        x = self._embed_inputs(params, tokens)
        b, s = x.shape[:2]
        lengths = torch.as_tensor(lengths, device=self.device).to(torch.int32)
        t = AttnTemporal(positions=self._positions(b, s), cache_len=s, pos=None,
                         lengths=lengths,
                         block_tables=torch.as_tensor(block_tables, device=self.device))
        x, new_stages = self._run_stages(params, x, t, cache["stages"])
        last = x[torch.arange(b, device=x.device), lengths.long() - 1][:, None]
        logits = self._logits(params, last)
        return logits[:, 0], dict(cache, stages=new_stages)

    def decode_slots(self, params: CausalLM, token, positions, cache: dict,
                     block_tables: Optional[torch.Tensor] = None):
        """One decode step over independently-deep slots: ``token`` (B,) at
        per-slot ``positions`` (B,). With ``block_tables`` the caches are
        paged pools; otherwise dense slot pools updated by row scatter."""
        positions = torch.as_tensor(positions, device=self.device).to(torch.int32)
        x = self._embed_inputs(params, self._tokens(token)[:, None])
        if block_tables is not None:
            block_tables = torch.as_tensor(block_tables, device=self.device)
        t = AttnTemporal(positions=positions[:, None], cache_len=None, pos=positions,
                         block_tables=block_tables)
        x, new_stages = self._run_stages(params, x, t, cache["stages"])
        logits = self._logits(params, x)
        return logits[:, 0], dict(cache, stages=new_stages)
