"""repro_torch.serve: serving on the port (the torch counterpart of
``repro.serve``): the weight-residue cache, the continuous-batching engine
and the aligned-batch ``ServeEngine`` wrapper."""
from .batching import (ACCURACY_CLASSES, BatchingEngine, PageAllocator,
                       Request, RequestResult, RequestStatus, Scheduler, sample_tokens)
from .engine import ServeEngine, make_serve_fns
from .weight_cache import (MATMUL_WEIGHT_NAMES, WeightResidueCache,
                           collect_weight_sketches, quantize_params)

__all__ = ["ACCURACY_CLASSES", "BatchingEngine", "MATMUL_WEIGHT_NAMES",
           "PageAllocator", "Request", "RequestResult", "RequestStatus",
           "Scheduler", "ServeEngine", "WeightResidueCache",
           "collect_weight_sketches", "make_serve_fns", "quantize_params",
           "sample_tokens"]
