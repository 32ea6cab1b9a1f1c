"""Engine latency and throughput metrics: the engine's one bookkeeping
path.

Port of `dynamo_tpu/engine/metrics.py` `EngineMetrics` (`:58`), cut to
what the port's engine counts and what `ForwardPassMetrics` carries: the
TTFT, ITL and prefill-chunk histograms, the emitted-token, pipelined-
burst, mixed-step and decode-during-prefill counters, and the compile
tracker (`engine/compile_tracker.py`, as `metrics.compile`). The engine
observes into these objects and every consumer reads them: `/metrics`
and the worker's `_sys.stats` scrape (`register`), `_publish_metrics`
(`perf_view`), and the engine's own `tokens_emitted` /
`pipelined_bursts` / `compile_tracker` attributes; the disagg KV pull
series (`kv_pull*`), which the decode worker's handler observes. The
KVBM, spec and step-profiler series wait with their subsystems. The ITL
histogram's edges and quantile are the part of `dynamo_tpu/llm/perf.py`
(`:18-60`) the published metrics need.

Metric names are fixed (`dynamo_engine_*`), not registry-prefixed: the
engine exists before (and without) any runtime.
"""

from __future__ import annotations

from dynamo_tpu_torch.engine.compile_tracker import CompileTracker
from dynamo_tpu_torch.runtime.metrics import (
    Counter,
    Histogram,
    MetricsRegistry,
)

# Log-spaced upper edges in ms; the last bucket is open-ended. Fixed so
# engine counters, published snapshots and offline analysis agree on
# bucket meaning without shipping edges on the wire.
ITL_BUCKET_EDGES_MS: tuple[float, ...] = (
    1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
    1000.0, 2000.0, 5000.0, float("inf"))


def itl_percentile(hist: list[int], q: float) -> float | None:
    """Approximate q-quantile (0..1) from a bucket histogram (one count
    per edge): the upper edge of the bucket holding the q-th observation,
    None when empty; the open last bucket reports its lower edge."""
    total = sum(hist)
    if total == 0:
        return None
    rank = q * total
    seen = 0
    for i, n in enumerate(hist):
        seen += n
        if seen >= rank and n:
            edge = ITL_BUCKET_EDGES_MS[i]
            if edge == float("inf"):
                return ITL_BUCKET_EDGES_MS[i - 1]
            return edge
    return ITL_BUCKET_EDGES_MS[-2]


# second-scale stage latencies: sub-ms steps up to multi-second cold
# prefills (the reference's _STAGE_BUCKETS)
_STAGE_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                  0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                  30.0)
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
        self.prefill_chunk = h(
            "dynamo_engine_prefill_chunk_seconds",
            "one prefill chunk round (standalone, mixed, or ragged)",
            _STAGE_BUCKETS)
        self.ttft = h(
            "dynamo_engine_ttft_seconds",
            "enqueue -> first emitted token per request", _STAGE_BUCKETS)
        self.itl = h(
            "dynamo_engine_itl_ms",
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
        self.compile = CompileTracker()

    def register(self, registry: MetricsRegistry) -> None:
        """Adopt every metric into a runtime registry so one scrape
        renders them (idempotent; the first engine wins a name)."""
        for m in (self.prefill_chunk, self.ttft, self.itl,
                  self.tokens_emitted, self.pipelined_bursts,
                  self.mixed_steps, self.decode_steps_during_prefill,
                  self.kv_pull, self.kv_pull_bytes, self.kv_pull_bw,
                  self.kv_import, self.kv_pull_fallbacks):
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
        }
