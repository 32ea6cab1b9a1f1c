"""Disaggregated prefill/decode serving.

Port of `dynamo_tpu/disagg/` (SURVEY §3.3): a decode worker orchestrates
a remote prefill (decode-first), the KV pages move from the prefill
worker to the decode worker on the card in one process, through the CUDA
IPC plane between two processes on one card, or over the chunked host
wire, and the conditional `DisaggRouter` decides local or remote by the
uncached prefill length. The durable prefill-queue dispatch
(`prefill_queue.py`) is a later slice.
"""

from dynamo_tpu_torch.disagg.disagg_router import DisaggRouter
from dynamo_tpu_torch.disagg.handlers import (
    DecodeWorkerHandler,
    PrefillWorkerHandler,
    serve_kv_pull,
)

__all__ = ["DisaggRouter", "DecodeWorkerHandler", "PrefillWorkerHandler",
           "serve_kv_pull"]
