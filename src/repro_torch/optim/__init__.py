"""The port's optimizer (the torch counterpart of ``repro.optim``): AdamW
with optional blockwise 8-bit moments, global-norm clipping and a
warmup-cosine schedule. The reference's compressed and exact-residue
gradient reductions over a mesh axis (``optim/compress.py``) wait for the
distributed slice."""
from .adamw import AdamWConfig, OptState, global_norm, init, schedule, update
from .quantized import BLOCK, Q8, dequantize, quantize

__all__ = ["AdamWConfig", "OptState", "global_norm", "init", "schedule", "update",
           "BLOCK", "Q8", "dequantize", "quantize"]
