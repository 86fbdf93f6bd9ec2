"""The port's optimizer (the torch counterpart of ``repro.optim``): AdamW
with optional blockwise 8-bit moments, global-norm clipping and a
warmup-cosine schedule; and the compressed (int8 + error feedback) and
exact fixed-point gradient reductions over replicas (``compress``)."""
from .adamw import AdamWConfig, OptState, global_norm, init, schedule, update
from .compress import EFState, compress_decompress, compressed_psum, ef_init, exact_residue_psum
from .quantized import BLOCK, Q8, dequantize, quantize

__all__ = ["AdamWConfig", "OptState", "global_norm", "init", "schedule", "update",
           "EFState", "compress_decompress", "compressed_psum", "ef_init",
           "exact_residue_psum", "BLOCK", "Q8", "dequantize", "quantize"]
