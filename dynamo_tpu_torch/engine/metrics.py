"""Engine latency and throughput metrics: the engine's one bookkeeping
path.

Port of `dynamo_tpu/engine/metrics.py` `EngineMetrics` (`:58`), cut to
what the port's engines count and what `ForwardPassMetrics` carries: the
queue-wait, TTFT, ITL and prefill-chunk histograms, the emitted-token, pipelined-
burst, mixed-step and decode-during-prefill counters, and the compile
tracker (`engine/compile_tracker.py`, as `metrics.compile`). The engine
observes into these objects and every consumer reads them: `/metrics`
and the worker's `_sys.stats` scrape (`register`), `_publish_metrics`
(`perf_view`), and the engine's own `tokens_emitted` /
`pipelined_bursts` / `compile_tracker` attributes; the disagg KV pull
series (`kv_pull*`), which the decode worker's handler observes; KVBM's
`admission_stall` (the blocking work inside an admission: inline
offloads, the onboard), `offload_drain` (one pipelined offload batch) and
`kvbm_stage` (each onboard's and offload read's time by stage).
The speculative decoding counters carry `SpecDecodeStats`' two fields
on the scrape (`spec_draft_tokens`, `spec_accepted_tokens`, under the
field names), beside the spec bursts dispatched. The step recorder's
series (`engine/profiler.py`, fed only while `DYN_STEP_PROFILE` arms it):
goodput and padded tokens by entry and the host gap between dispatches.
The ITL
histogram's edges and quantile come from `llm/perf.py`, as the
reference's do (`dynamo_tpu/engine/metrics.py:25`).

Metric names are fixed (`dynamo_engine_*`), not registry-prefixed: the
engine exists before (and without) any runtime.
"""

from __future__ import annotations

from dynamo_tpu_torch.engine.compile_tracker import CompileTracker
from dynamo_tpu_torch.llm.perf import ITL_BUCKET_EDGES_MS
from dynamo_tpu_torch.runtime.metrics import (
    Counter,
    Histogram,
    MetricsRegistry,
)

# the engine's ITL histogram, which the runtime's adaptive idle timeout
# reads (runtime/distributed.py `_adaptive_idle_timeout`)
ITL_HISTOGRAM = "dynamo_engine_itl_ms"


# second-scale stage latencies: sub-ms steps up to multi-second cold
# prefills (the reference's _STAGE_BUCKETS)
_STAGE_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                  0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                  30.0)
# host gap between consecutive dispatches (the reference's _GAP_BUCKETS)
_GAP_BUCKETS = (0.00001, 0.000025, 0.00005, 0.0001, 0.00025, 0.0005,
                0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                1.0)
# per-transfer KV pull bandwidth (bytes/s), the reference's _BW_BUCKETS
_BW_BUCKETS = (1e6, 3e6, 1e7, 3e7, 1e8, 3e8, 1e9, 3e9, 1e10, 3e10,
               1e11, 3e11)
# the wire histogram's edges, so the Prometheus view and the published
# percentiles agree; +Inf is implicit in Histogram
_ITL_BUCKETS_MS = tuple(e for e in ITL_BUCKET_EDGES_MS
                        if e != float("inf"))


class EngineMetrics:
    """Owned by one TorchEngine."""

    def __init__(self) -> None:
        h, c = Histogram, Counter
        self.queue_wait = h(
            "dynamo_engine_queue_wait_seconds",
            "enqueue -> admission wait per request", _STAGE_BUCKETS)
        self.admission_stall = h(
            "dynamo_engine_admission_stall_seconds",
            "blocking work (kvbm onboard/offload-drain) inside _admit",
            _STAGE_BUCKETS)
        self.offload_drain = h(
            "dynamo_engine_offload_drain_seconds",
            "one kvbm offload batch: device gather + tier demote",
            _STAGE_BUCKETS)
        # KVBM's transfers by stage: an onboard's host stack, copy to the
        # card and K3 launches; an offload read's gather (in block order),
        # copy to the host and host split. Device time on the card, host
        # time on the CPU (where the copies are none).
        self.kvbm_stage = {
            name: h(f"dynamo_engine_kvbm_{name}_seconds", f"kvbm {what}",
                    _STAGE_BUCKETS)
            for name, what in (
                ("onboard_stack", "onboard: blocks stacked on the host"),
                ("onboard_copy", "onboard: copy to the card"),
                ("onboard_write", "onboard: the page writes (K3)"),
                ("offload_gather", "offload: the pages gathered"),
                ("offload_copy", "offload: copy to the host"),
                ("offload_split", "offload: the batch split into blocks"))}
        self.prefill_chunk = h(
            "dynamo_engine_prefill_chunk_seconds",
            "one prefill chunk round (standalone, mixed, or ragged)",
            _STAGE_BUCKETS)
        self.ttft = h(
            "dynamo_engine_ttft_seconds",
            "enqueue -> first emitted token per request", _STAGE_BUCKETS)
        self.itl = h(
            ITL_HISTOGRAM,
            "inter-token gap at the emission boundary (ms)",
            _ITL_BUCKETS_MS)
        self.tokens_emitted = c(
            "dynamo_engine_tokens_emitted_total",
            "tokens emitted to consumers")
        self.pipelined_bursts = c(
            "dynamo_engine_pipelined_bursts_total",
            "speculatively-dispatched decode bursts")
        self.mixed_steps = c(
            "dynamo_engine_mixed_steps_total",
            "fused prefill-chunk + decode-burst steps")
        self.decode_steps_during_prefill = c(
            "dynamo_engine_decode_steps_during_prefill_total",
            "decode steps interleaved while requests were prefilling")
        # disaggregated KV transfer, on the decode worker
        # (disagg/handlers.py): pull latency, bytes and bandwidth by path
        # under the reference's names, and the port's count of pulls that
        # fell back from the path they tried to the next one
        self.kv_pull = h(
            "dynamo_engine_kv_pull_seconds",
            "disagg KV pull, prefill worker -> decode worker",
            _STAGE_BUCKETS)
        self.kv_pull_bytes = c(
            "dynamo_kv_pull_bytes_total",
            "disagg KV bytes pulled onto this decode worker, by "
            "transfer path (device/plane/wire)")
        self.kv_pull_bw = h(
            "dynamo_kv_pull_bandwidth_bytes_per_s",
            "per-transfer disagg KV pull bandwidth", _BW_BUCKETS)
        self.kv_import = h(
            "dynamo_engine_kv_import_seconds",
            "disagg KV import: the imported pages' write on this worker",
            _STAGE_BUCKETS)
        self.kv_pull_fallbacks = c(
            "dynamo_kv_pull_fallbacks_total",
            "disagg KV pulls that failed on one path (from) and went on "
            "to the next (to)")
        # speculative decoding: SpecDecodeStats' counters on the scrape
        self.spec_draft_tokens = c(
            "dynamo_engine_spec_num_draft_tokens_total",
            "tokens proposed by the draft model (consumed iterations)")
        self.spec_accepted_tokens = c(
            "dynamo_engine_spec_num_accepted_tokens_total",
            "draft tokens that survived target verification")
        self.spec_bursts = c(
            "dynamo_engine_spec_bursts_total",
            "speculative decoding bursts dispatched")
        # the step recorder's attribution (engine/profiler.py)
        self.goodput_tokens = c(
            "dynamo_engine_goodput_tokens_total",
            "real token-positions computed per dispatched entry (no "
            "padding)")
        self.padded_tokens = c(
            "dynamo_engine_padded_tokens_total",
            "padded token-positions computed per dispatched entry")
        self.dispatch_gap = h(
            "dynamo_engine_dispatch_gap_seconds",
            "host gap between consecutive dispatches", _GAP_BUCKETS)
        self.compile = CompileTracker()

    def register(self, registry: MetricsRegistry) -> None:
        """Adopt every metric into a runtime registry so one scrape
        renders them (idempotent; the first engine wins a name)."""
        for m in (self.queue_wait, self.admission_stall,
                  self.offload_drain,
                  self.prefill_chunk, self.ttft, self.itl,
                  self.tokens_emitted, self.pipelined_bursts,
                  self.mixed_steps, self.decode_steps_during_prefill,
                  self.kv_pull, self.kv_pull_bytes, self.kv_pull_bw,
                  self.kv_import, self.kv_pull_fallbacks,
                  self.spec_draft_tokens, self.spec_accepted_tokens,
                  self.spec_bursts, self.goodput_tokens,
                  self.padded_tokens, self.dispatch_gap,
                  *self.kvbm_stage.values()):
            registry.register(m)
        self.compile.register(registry)

    def perf_view(self) -> dict:
        """The reference's `engine.perf` keys that the port counts,
        derived from the metrics; `itl_hist` holds one count per
        `ITL_BUCKET_EDGES_MS` edge."""
        itl_counts, _, _ = self.itl.snapshot()
        return {
            "tokens_emitted": int(self.tokens_emitted.get()),
            "pipelined_bursts": int(self.pipelined_bursts.get()),
            "prefill_chunks": self.prefill_chunk.count,
            "decode_steps_during_prefill":
                int(self.decode_steps_during_prefill.get()),
            "mixed_steps": int(self.mixed_steps.get()),
            "itl_hist": itl_counts,
            "admission_stall_ms": self.admission_stall.sum * 1e3,
        }
