"""repro_torch.serve.batching: the continuous-batching serving engine (the
torch counterpart of ``repro.serve.batching``).

* :mod:`.request`: request/result dataclasses + named accuracy classes;
* :mod:`.scheduler`: FIFO/priority admission queue (pure data structure);
* :mod:`.kv_pages`: page allocator and block-table rows for the paged KV
  pools (the device-side scatter/gather lives in
  ``repro_torch.models.paged_kv``);
* :mod:`.engine`: :class:`BatchingEngine`: in-flight batching with a
  prefill/decode split, bucketed batch shapes, per-request adaptive
  precision (policy-grouped sub-batches over the weight-residue cache), and
  KV caches updated in place.
"""
from .engine import BatchingEngine, sample_tokens
from .kv_pages import SCRATCH_PAGE, PageAllocator
from .request import (ACCURACY_CLASSES, Request, RequestResult, RequestStatus,
                      resolve_accuracy_target)
from .scheduler import Scheduler

__all__ = [
    "ACCURACY_CLASSES", "BatchingEngine", "PageAllocator", "Request",
    "RequestResult", "RequestStatus", "SCRATCH_PAGE", "Scheduler",
    "resolve_accuracy_target", "sample_tokens",
]
