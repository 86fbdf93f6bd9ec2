"""Assigned input shapes and meta-device input specs for the dry run (the
torch counterpart of ``repro/configs/shapes.py``).

LM transformer shapes are seq_len x global_batch; decode_*/long_* run
``decode_step`` (one new token against a KV cache of seq_len), not the
train step. long_500k requires sub-quadratic attention: it runs for the
ssm/hybrid families and is skipped for full-attention archs.

``input_specs`` returns tensors on the ``meta`` device in place of the
reference's ``jax.ShapeDtypeStruct``s: the same shapes and dtypes, and no
storage.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class LinalgShape:
    """Dense-factorization problem size for the linalg benchmarks/tests."""
    name: str
    n: int
    block: int


LINALG_SHAPES = {
    "lin_256": LinalgShape("lin_256", 256, 64),
    "lin_512": LinalgShape("lin_512", 512, 128),
    "lin_1024": LinalgShape("lin_1024", 1024, 128),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) per the assignment's skip rules."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "full-attention arch: 500k decode is quadratic-cost; skipped per assignment"
    return True, ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                batch_override: int | None = None) -> dict:
    """Meta-device stand-ins for every model input (no storage)."""
    b = batch_override or shape.global_batch
    s = shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind == "train":
        specs = {"tokens": _spec((b, s), i32), "labels": _spec((b, s), i32)}
        if cfg.frontend == "vit-stub":
            # visual prefix + text fill the budget: text = s - frontend_len
            specs["tokens"] = _spec((b, s - cfg.frontend_len), i32)
            specs["patch_embeds"] = _spec((b, cfg.frontend_len, cfg.frontend_dim), bf16)
        if cfg.family == "encdec":
            specs["frames"] = _spec((b, s, cfg.frontend_dim), bf16)
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": _spec((b, s), i32)}
        if cfg.frontend == "vit-stub":
            specs["tokens"] = _spec((b, s - cfg.frontend_len), i32)
            specs["patch_embeds"] = _spec((b, cfg.frontend_len, cfg.frontend_dim), bf16)
        if cfg.family == "encdec":
            specs["frames"] = _spec((b, s, cfg.frontend_dim), bf16)
        return specs
    # decode: one token against a cache of length seq_len (the cache's
    # specs come from the model; see launch/dryrun.py)
    return {"token": _spec((b,), i32)}
