"""The port's models (the torch counterpart of ``repro.models``): the causal
LM of every family (dense, MoE, SSM, hybrid, vlm) and the encoder-decoder,
their layers, GQA and MLA attention with paged KV, and the interchange with
the reference's parameters."""
from .attention import AttnTemporal
from .config import ModelConfig, validate
from .convert import params_from_reference
from .model import CausalLM, Model

__all__ = ["AttnTemporal", "CausalLM", "Model", "ModelConfig", "params_from_reference",
           "validate"]
