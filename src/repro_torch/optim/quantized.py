"""Blockwise 8-bit optimizer states (the torch counterpart of
``repro/optim/quantized.py``; bitsandbytes-style): each tensor is flattened
and cut into blocks of BLOCK elements, each block scaled by its f32 absmax.
Signed int8 for first moments, unsigned (uint8) for the non-negative
second moments.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

BLOCK = 256


class Q8(NamedTuple):
    """A quantized tensor: ``q`` int8/uint8, flat and padded to a multiple
    of BLOCK; ``scale`` f32 (nblocks,); ``shape`` the tensor's."""

    q: torch.Tensor
    scale: torch.Tensor
    shape: tuple


def quantize(x: torch.Tensor, signed: bool = True) -> Q8:
    flat = x.to(torch.float32).reshape(-1)
    blocks = F.pad(flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)
    absmax = torch.amax(torch.abs(blocks), dim=1)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    if signed:
        q = torch.clamp(torch.round(blocks / scale[:, None] * 127.0), -127, 127).to(torch.int8)
    else:
        q = torch.clamp(torch.round(blocks / scale[:, None] * 255.0), 0, 255).to(torch.uint8)
    return Q8(q.reshape(-1), scale, tuple(x.shape))


def dequantize(qx: Q8, signed: bool = True) -> torch.Tensor:
    blocks = qx.q.reshape(-1, BLOCK).to(torch.float32)
    denom = 127.0 if signed else 255.0
    flat = blocks * (qx.scale[:, None] / denom)
    return flat.reshape(-1)[:math.prod(qx.shape)].reshape(qx.shape)
