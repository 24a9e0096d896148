"""repro_torch.serving — continuous-batching LM inference on a paged KV cache.

The port's copy of ``repro.serving``; the public surface is:

* :class:`~repro_torch.serving.pages.PagePool` / :class:`~repro_torch.serving.pages.PagedKVCache`
* :class:`~repro_torch.serving.admission.AdmissionController`
* :class:`~repro_torch.serving.batcher.ContinuousBatcher`
* :func:`~repro_torch.serving.trace.heavy_tail_trace`
"""
from repro_torch.serving.admission import ADMIT, QUEUE, REJECT, AdmissionController, TokenBucket
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.pages import PageAllocError, PagedKVCache, PagePool
from repro_torch.serving.trace import Request, TraceConfig, heavy_tail_trace, trace_summary

__all__ = [
    "ADMIT", "QUEUE", "REJECT",
    "AdmissionController", "TokenBucket",
    "ContinuousBatcher",
    "PageAllocError", "PagedKVCache", "PagePool",
    "Request", "TraceConfig", "heavy_tail_trace", "trace_summary",
]
