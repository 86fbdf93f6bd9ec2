"""Model assembly (the torch counterpart of ``repro/models/model.py``): the
causal LM of every family (dense / MoE / SSM / hybrid / vlm) and the
encoder-decoder (audio), built from stages of per-layer blocks.

``Model`` holds the config and the device; the parameters are a separate
``CausalLM`` module tree (``init`` draws it, ``models.convert`` loads the
reference's), passed to every entry point as the reference passes its
params pytree, so the serve weight cache can hand the same functions a copy
whose matmul weights are prepared plans. Entry points:

  init(generator)                      -> params (CausalLM)
  forward_train(params, batch)         -> TrainOutput(logits, aux_loss, mtp_logits)
  init_cache(params, batch, max_len)   -> cache (serving, aligned batch;
                                          encodes batch["frames"] for encdec)
  prefill(params, batch, cache)        -> (last-position logits, cache)
  decode_step(params, token, cache)    -> (logits, cache)
  init_slot_cache / init_paged_cache, prefill_slots / decode_slots
                                       -> the continuous-batching engine's

Caches are updated in place (attention) or replaced (SSM state) and
returned. The model runs on the card unless built with ``device="cpu"``.
The parameters are frozen as ``init`` draws them (serving); the training
state (``repro_torch.train``) makes them require grad.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.core.gemm import resolve_device

from .attention import AttnTemporal
from .blocks import (GLOBAL_WINDOW, Block, StageSpec, block_apply, block_init, stage_apply,
                     stage_init, stage_windows)
from .config import ModelConfig, validate
from .layers import dtype_of, embed_init, frozen, matmul, rmsnorm, softcap, zeros
from .ssm import init_ssm_state


class TrainOutput(NamedTuple):
    logits: torch.Tensor
    aux_loss: torch.Tensor
    mtp_logits: Optional[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class StageEntry:
    spec: StageSpec
    offset: int  # global layer offset (drives local/global alternation)


def build_stages(cfg: ModelConfig) -> tuple[StageEntry, ...]:
    if cfg.family == "ssm":
        return (StageEntry(StageSpec("mamba", cfg.num_layers), 0),)
    if cfg.family == "hybrid":
        # (k mamba layers + the shared attention block) x full groups, + rem mamba
        k = cfg.shared_attn_every
        full, rem = divmod(cfg.num_layers, k)
        entries = []
        for g in range(full):
            entries.append(StageEntry(StageSpec("mamba", k), g * k))
            entries.append(StageEntry(StageSpec("attn_mlp", 1, scan=False, shared_attn=True),
                                      g * k))
        if rem:
            entries.append(StageEntry(StageSpec("mamba", rem), full * k))
        return tuple(entries)
    if cfg.family == "moe":
        entries = []
        if cfg.first_dense_layers:
            entries.append(StageEntry(StageSpec("attn_mlp", cfg.first_dense_layers), 0))
        entries.append(StageEntry(
            StageSpec("attn_moe", cfg.num_layers - cfg.first_dense_layers),
            cfg.first_dense_layers))
        return tuple(entries)
    if cfg.family == "encdec":
        return (StageEntry(StageSpec("decoder_cross", cfg.num_layers), 0),)
    # dense / vlm
    return (StageEntry(StageSpec("attn_mlp", cfg.num_layers), 0),)


class Encoder(nn.Module):
    """The encoder-decoder's encoder: ``stages`` (one stage of ``encoder``
    blocks) and ``final_norm``."""

    def __init__(self, stages: nn.ModuleList, final_norm):
        super().__init__()
        self.stages = stages
        self.final_norm = frozen(final_norm)


class MTP(nn.Module):
    """deepseek-v3's multi-token-prediction head (``proj``, ``block``,
    ``norm_h``, ``norm_e``), read only by ``forward_train``."""

    def __init__(self, proj, block: Block, norm_h, norm_e):
        super().__init__()
        self.proj = frozen(proj)
        self.block = block
        self.norm_h, self.norm_e = frozen(norm_h), frozen(norm_e)


class CausalLM(nn.Module):
    """The parameters of a model: ``embed``, ``stages`` (one
    ``nn.ModuleList`` of blocks per stage; empty for a zamba2 shared-block
    entry), ``final_norm``, ``lm_head`` (d_model, padded_vocab) unless the
    embeddings are tied, and as the family has them ``shared_attn``
    (zamba2), ``frontend_proj`` (frontend_dim, d_model), ``encoder`` and
    ``mtp``."""

    def __init__(self, embed, stages: nn.ModuleList, final_norm, lm_head=None, *,
                 shared_attn: Block | None = None, frontend_proj=None,
                 encoder: Encoder | None = None, mtp: MTP | None = None):
        super().__init__()
        self.embed = frozen(embed)
        self.stages = stages
        self.final_norm = frozen(final_norm)
        if lm_head is not None:
            self.lm_head = frozen(lm_head)
        if shared_attn is not None:
            self.shared_attn = shared_attn
        if frontend_proj is not None:
            self.frontend_proj = frozen(frontend_proj)
        if encoder is not None:
            self.encoder = encoder
        if mtp is not None:
            self.mtp = mtp


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
        cfg, pd, gen, dev = self.cfg, self.param_dtype, generator, self.device

        def normal(shape, scale):
            return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(pd)

        embed = embed_init(gen, cfg.padded_vocab, cfg.d_model, pd)
        stages = nn.ModuleList(stage_init(gen, cfg, e.spec, pd) for e in self.stages)
        extra = {}
        if any(e.spec.shared_attn for e in self.stages):
            extra["shared_attn"] = block_init(gen, cfg, "attn_mlp", pd)
        lm_head = (None if cfg.tie_embeddings
                   else normal((cfg.d_model, cfg.padded_vocab), cfg.d_model ** -0.5))
        if cfg.frontend:
            extra["frontend_proj"] = normal((cfg.frontend_dim, cfg.d_model),
                                            cfg.frontend_dim ** -0.5)
        if cfg.family == "encdec":
            enc_cfg = dataclasses.replace(cfg, use_mla=False)
            spec = StageSpec("encoder", cfg.num_encoder_layers)
            extra["encoder"] = Encoder(nn.ModuleList([stage_init(gen, enc_cfg, spec, pd)]),
                                       zeros(cfg.d_model, pd, dev))
        if cfg.mtp_depth:
            extra["mtp"] = MTP(normal((2 * cfg.d_model, cfg.d_model), (2 * cfg.d_model) ** -0.5),
                               block_init(gen, cfg, "attn_mlp", pd),
                               zeros(cfg.d_model, pd, dev), zeros(cfg.d_model, pd, dev))
        return CausalLM(embed, stages, zeros(cfg.d_model, pd, dev), lm_head, **extra)

    # --------------------------------------------------------------- helpers
    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed_inputs(self, params: CausalLM, tokens, patch_embeds=None) -> torch.Tensor:
        """Token embeddings, after the projected ``patch_embeds`` (B, P,
        frontend_dim) of a vit-stub frontend when given."""
        cfg = self.cfg
        tok = params.embed[self._tokens(tokens)].to(self.dtype)
        scale = cfg.d_model ** 0.5 if cfg.post_norms else 1.0
        tok = tok * torch.tensor(scale, dtype=self.dtype, device=tok.device)
        if cfg.frontend != "vit-stub" or patch_embeds is None:
            return tok
        patches = torch.as_tensor(patch_embeds, device=self.device).to(self.dtype)
        return torch.cat([matmul(patches, params.frontend_proj, cfg.gemm), tok], dim=1)

    def _encode(self, params: CausalLM, frames) -> torch.Tensor:
        """The encoder memory of audio-stub ``frames`` (B, F, frontend_dim)."""
        cfg = self.cfg
        frames = torch.as_tensor(frames, device=self.device).to(self.dtype)
        x = matmul(frames, params.frontend_proj, cfg.gemm)
        t = AttnTemporal(positions=self._positions(*x.shape[:2]), cache_len=None, pos=None)
        spec = StageSpec("encoder", cfg.num_encoder_layers)
        enc = params.encoder
        x, _, _ = stage_apply(enc.stages[0], x, cfg, t, stage_windows(cfg, spec, 0), None,
                              "encoder")
        return rmsnorm(x, enc.final_norm, cfg.norm_eps)

    def _run_stages(self, params: CausalLM, x, t: AttnTemporal, cache_stages,
                    enc_memory=None):
        """Returns (x, new stage caches, the stages' summed aux loss)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        new_caches = []
        for i, entry in enumerate(self.stages):
            spec = entry.spec
            cache_i = cache_stages[i] if cache_stages is not None else None
            if spec.shared_attn:  # zamba2's shared transformer block
                x, c_new, a = block_apply(params.shared_attn, x, cfg, t, GLOBAL_WINDOW,
                                          cache_i[0] if cache_i else {}, "attn_mlp")
                c_new = [c_new] if cache_i else []
            else:
                x, c_new, a = stage_apply(params.stages[i], x, cfg, t,
                                          stage_windows(cfg, spec, entry.offset), cache_i,
                                          spec.kind, enc_memory=enc_memory)
            aux = aux + a
            new_caches.append(c_new)
        return x, new_caches, aux

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
    def forward_train(self, params: CausalLM, batch: dict) -> TrainOutput:
        """Logits of every position of ``batch`` ({"tokens"}, plus "frames"
        for encdec and "patch_embeds" for a vit-stub frontend), the stages'
        aux loss and, with an MTP head, its logits (deepseek-v3: position t
        predicts token t+2 from h_t and the embedding of token t+1)."""
        cfg = self.cfg
        enc_memory = self._encode(params, batch["frames"]) if cfg.family == "encdec" else None
        x = self._embed_inputs(params, batch["tokens"], batch.get("patch_embeds"))
        b, s = x.shape[:2]
        t = AttnTemporal(positions=self._positions(b, s), cache_len=None, pos=None)
        x, _, aux = self._run_stages(params, x, t, None, enc_memory)
        logits = self._logits(params, x)

        mtp_logits = None
        if cfg.mtp_depth and hasattr(params, "mtp"):
            # h'_t = Block(W [norm(h_t); norm(emb(tok_{t+1}))])
            mtp = params.mtp
            toks = self._tokens(batch["tokens"])
            emb_next = params.embed[torch.roll(toks, -1, dims=1)].to(self.dtype)
            prefix = x[:, -toks.shape[1]:, :]  # text positions only (vlm-safe)
            cat = torch.cat([rmsnorm(prefix, mtp.norm_h, cfg.norm_eps),
                             rmsnorm(emb_next, mtp.norm_e, cfg.norm_eps)], dim=-1)
            h = matmul(cat, mtp.proj, cfg.gemm)
            tt = AttnTemporal(positions=self._positions(*h.shape[:2]), cache_len=None, pos=None)
            h, _, _ = block_apply(mtp.block, h, cfg, tt, GLOBAL_WINDOW, {}, "attn_mlp")
            mtp_logits = self._logits(params, h)
        return TrainOutput(logits, aux, mtp_logits)

    # ----------------------------------------------------------------- serve
    def _attn_cache(self, lead: tuple) -> dict:
        cfg = self.cfg
        z = lambda *tail: torch.zeros(lead + tail, dtype=self.dtype, device=self.device)
        if cfg.use_mla:
            return {"ckv": z(cfg.kv_lora_rank), "krope": z(cfg.qk_rope_dim)}
        return {"k": z(cfg.num_kv_heads, cfg.head_dim), "v": z(cfg.num_kv_heads, cfg.head_dim)}

    def _stage_caches(self, b: int, max_len: int) -> list:
        """One list of per-layer cache dicts a stage (a shared-block entry:
        one dict)."""
        ssm = lambda: init_ssm_state(self.cfg, b, self.dtype, self.device)._asdict()
        return [[ssm() if e.spec.kind == "mamba" else self._attn_cache((b, max_len))
                 for _ in range(e.spec.num_layers)]
                for e in self.stages]

    def init_cache(self, params: CausalLM, batch: dict, max_len: int) -> dict:
        b = batch["tokens"].shape[0]
        cache = {"stages": self._stage_caches(b, max_len), "pos": 0}
        if self.cfg.family == "encdec":
            cache["enc_memory"] = self._encode(params, batch["frames"])
        return cache

    def init_slot_cache(self, num_slots: int, max_len: int,
                        enc_len: Optional[int] = None) -> dict:
        """Dense slot-pooled serving cache for the continuous-batching
        engine: ``num_slots`` independent rows managed host-side (per-slot
        positions travel through ``decode_slots``; ``cache['pos']`` is
        unused). Works for every cache family; the typed (ssm/hybrid/encdec)
        fallback when paged KV does not apply."""
        cache = {"stages": self._stage_caches(num_slots, max_len), "pos": 0}
        if self.cfg.family == "encdec":
            if enc_len is None:
                raise ValueError("encdec slot cache needs enc_len for the "
                                 "encoder-memory slot pool")
            cache["enc_memory"] = torch.zeros((num_slots, enc_len, self.cfg.d_model),
                                              dtype=self.dtype, device=self.device)
        return cache

    def init_paged_cache(self, num_pages: int, page_size: int) -> dict:
        """Paged serving cache: shared page pools (``paged_kv``), one per
        layer, replace the per-slot dense length axis. Pure-attention token
        models only: typed caches (ssm/hybrid) and encoder memory are not
        pageable, and a frontend prepends non-token positions the ragged
        prefill does not model; those configs use ``init_slot_cache``."""
        cfg = self.cfg
        if cfg.family not in ("dense", "moe") or cfg.frontend:
            raise ValueError(
                f"paged KV requires a pure-attention token model; family "
                f"{cfg.family!r} / frontend {cfg.frontend!r} uses the dense "
                "slot-pool fallback (init_slot_cache)")
        return {"stages": [[self._attn_cache((num_pages, page_size))
                            for _ in range(e.spec.num_layers)] for e in self.stages]}

    def prefill(self, params: CausalLM, batch: dict, cache: dict):
        x = self._embed_inputs(params, batch["tokens"], batch.get("patch_embeds"))
        b, s = x.shape[:2]
        t = AttnTemporal(positions=self._positions(b, s), cache_len=s, pos=None)
        x, new_stages, _ = self._run_stages(params, x, t, cache["stages"],
                                            cache.get("enc_memory"))
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
        x, new_stages, _ = self._run_stages(params, x, t, cache["stages"],
                                            cache.get("enc_memory"))
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
        x, new_stages, _ = self._run_stages(params, x, t, cache["stages"])
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
        x, new_stages, _ = self._run_stages(params, x, t, cache["stages"],
                                            cache.get("enc_memory"))
        logits = self._logits(params, x)
        return logits[:, 0], dict(cache, stages=new_stages)
