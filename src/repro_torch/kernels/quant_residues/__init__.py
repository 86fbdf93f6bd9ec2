from .kernel import (quant_residues, quant_residues_f64, quant_residues_f64_plain,
                     quant_residues_plain)
from .ops import quant_residues_op
from .ref import decompose_int, quant_residues_ref

__all__ = ["quant_residues", "quant_residues_plain", "quant_residues_f64",
           "quant_residues_f64_plain", "quant_residues_op", "decompose_int",
           "quant_residues_ref"]
