"""Shared wire types: KV cache events, worker metrics, and the request/
response shapes of the engine contract.

Port of `dynamo_tpu/protocols.py` (the port keeps its own copy): the KV
events an engine's page pool publishes to the router's index
(`KvCacheEvent`, `:20-60`), the load it publishes per scheduler iteration
(`ForwardPassMetrics`, `:67-155`), `PreprocessedRequest` dicts in,
`EngineOutput` dicts out, the `FINISH_*` reasons. Plain dataclasses with
dict serialisation, identical on the wire to the reference's.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Optional

# ---------------------------------------------------------------------------
# KV cache events (engine → router index)
# ---------------------------------------------------------------------------

KV_STORED = "stored"
KV_REMOVED = "removed"
KV_CLEARED = "cleared"


@dataclass(frozen=True)
class StoredBlock:
    """One block that entered a worker's KV cache."""

    seq_hash: int     # chained prefix identity (tokens.py)
    local_hash: int   # content-only hash


@dataclass
class KvCacheEvent:
    """stored: blocks + parent linkage; removed: seq_hashes; cleared: all."""

    kind: str                       # KV_STORED | KV_REMOVED | KV_CLEARED
    worker_id: int
    dp_rank: int = 0
    event_id: int = 0
    parent_seq_hash: Optional[int] = None   # stored: parent of blocks[0]
    blocks: list[StoredBlock] = field(default_factory=list)
    seq_hashes: list[int] = field(default_factory=list)  # removed

    def to_dict(self) -> dict:
        return {
            "kind": self.kind, "worker_id": self.worker_id,
            "dp_rank": self.dp_rank, "event_id": self.event_id,
            "parent_seq_hash": self.parent_seq_hash,
            "blocks": [[b.seq_hash, b.local_hash] for b in self.blocks],
            "seq_hashes": self.seq_hashes,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "KvCacheEvent":
        return cls(
            kind=d["kind"], worker_id=d["worker_id"],
            dp_rank=d.get("dp_rank", 0), event_id=d.get("event_id", 0),
            parent_seq_hash=d.get("parent_seq_hash"),
            blocks=[StoredBlock(s, l) for s, l in d.get("blocks", [])],
            seq_hashes=list(d.get("seq_hashes", [])),
        )


# ---------------------------------------------------------------------------
# Worker load metrics (engine → router scheduler / planner)
# ---------------------------------------------------------------------------


@dataclass
class WorkerStats:
    request_active_slots: int = 0
    request_total_slots: int = 0
    num_requests_waiting: int = 0

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class KvStats:
    kv_active_blocks: int = 0
    kv_total_blocks: int = 0
    hbm_cache_usage: float = 0.0        # reference: gpu_cache_usage_perc
    host_cache_usage: float = 0.0
    prefix_cache_hit_rate: float = 0.0

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class SpecDecodeStats:
    """Speculative-decode counters (reference: SpecDecodeStats in the
    worker ForwardPassMetrics). Cumulative since engine start."""

    num_draft_tokens: int = 0           # proposed by the draft model
    num_accepted_tokens: int = 0        # survived target verification

    @property
    def acceptance_rate(self) -> float:
        return (self.num_accepted_tokens / self.num_draft_tokens
                if self.num_draft_tokens else 0.0)

    def to_dict(self) -> dict:
        d = asdict(self)
        d["acceptance_rate"] = round(self.acceptance_rate, 4)
        return d


@dataclass
class ForwardPassMetrics:
    """Published per scheduler iteration (reference publisher.rs:691)."""

    worker_id: int = 0
    dp_rank: int = 0
    worker_stats: WorkerStats = field(default_factory=WorkerStats)
    kv_stats: KvStats = field(default_factory=KvStats)
    spec_decode_stats: Optional["SpecDecodeStats"] = None
    # Scheduler stall/interleave counters (engine.perf snapshot:
    # prefill_chunks, decode_steps_during_prefill, itl_p50_ms/itl_p99_ms
    # from the ITL histogram). Plain dict so new counters don't need a
    # wire-schema change; absent on old publishers.
    scheduler_stats: Optional[dict] = None

    def to_dict(self) -> dict:
        d = {
            "worker_id": self.worker_id, "dp_rank": self.dp_rank,
            "worker_stats": self.worker_stats.to_dict(),
            "kv_stats": self.kv_stats.to_dict(),
        }
        if self.spec_decode_stats is not None:
            d["spec_decode_stats"] = self.spec_decode_stats.to_dict()
        if self.scheduler_stats is not None:
            d["scheduler_stats"] = self.scheduler_stats
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ForwardPassMetrics":
        def known(klass, dd):
            return {k: v for k, v in dd.items()
                    if k in klass.__dataclass_fields__}

        spec = d.get("spec_decode_stats")
        return cls(
            worker_id=d.get("worker_id", 0), dp_rank=d.get("dp_rank", 0),
            worker_stats=WorkerStats(**known(WorkerStats,
                                             d.get("worker_stats", {}))),
            kv_stats=KvStats(**known(KvStats, d.get("kv_stats", {}))),
            spec_decode_stats=(
                SpecDecodeStats(**known(SpecDecodeStats, spec))
                if spec is not None else None),
            scheduler_stats=d.get("scheduler_stats"),
        )


# ---------------------------------------------------------------------------
# Internal request/response shapes (frontend ↔ engine)
# ---------------------------------------------------------------------------

FINISH_STOP = "stop"
FINISH_LENGTH = "length"
FINISH_EOS = "eos"
FINISH_CANCELLED = "cancelled"
FINISH_ERROR = "error"

# The error of a request whose Context.deadline passed while it was
# queued: the engine drops it at admission, before any prefill, in band
# (a FINISH_ERROR output, not a lost stream), so no migration replays it.
DEADLINE_ADMIT_ERR = "request deadline exceeded before admission"


@dataclass
class SamplingOptions:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0                      # 0 = disabled
    min_p: float = 0.0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    repetition_penalty: float = 1.0
    seed: Optional[int] = None
    guided: Optional[dict] = None
    # top-k alternative logprobs per emitted token; 0 = chosen-token only
    top_logprobs: int = 0

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SamplingOptions":
        known = {k: v for k, v in d.items()
                 if k in cls.__dataclass_fields__ and v is not None}
        return cls(**known)


@dataclass
class StopConditions:
    max_tokens: Optional[int] = None
    stop: list[str] = field(default_factory=list)          # stop strings
    stop_token_ids: list[int] = field(default_factory=list)
    ignore_eos: bool = False
    min_tokens: int = 0

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "StopConditions":
        known = {k: v for k, v in d.items()
                 if k in cls.__dataclass_fields__ and v is not None}
        return cls(**known)


@dataclass
class PreprocessedRequest:
    """What leaves the preprocessor: pure token ids + options."""

    token_ids: list[int]
    model: str = ""
    sampling: SamplingOptions = field(default_factory=SamplingOptions)
    stop: StopConditions = field(default_factory=StopConditions)
    dp_rank: Optional[int] = None
    kv_transfer_params: Optional[dict] = None
    accumulated_tokens: list[int] = field(default_factory=list)
    extra: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "token_ids": self.token_ids, "model": self.model,
            "sampling": self.sampling.to_dict(), "stop": self.stop.to_dict(),
            "dp_rank": self.dp_rank,
            "kv_transfer_params": self.kv_transfer_params,
            "accumulated_tokens": self.accumulated_tokens,
            "extra": self.extra,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PreprocessedRequest":
        return cls(
            token_ids=list(d["token_ids"]), model=d.get("model", ""),
            sampling=SamplingOptions.from_dict(d.get("sampling", {})),
            stop=StopConditions.from_dict(d.get("stop", {})),
            dp_rank=d.get("dp_rank"),
            kv_transfer_params=d.get("kv_transfer_params"),
            accumulated_tokens=list(d.get("accumulated_tokens", [])),
            extra=d.get("extra", {}),
        )


@dataclass
class EngineOutput:
    """One streamed delta from an engine: new token ids (+ optional
    logprobs), finish reason on the last frame."""

    token_ids: list[int] = field(default_factory=list)
    finish_reason: Optional[str] = None
    cum_log_prob: Optional[float] = None
    log_probs: Optional[list[float]] = None
    # per emitted token: [[token_id, logprob], ...] top-k alternatives
    top_logprobs: Optional[list[list[list[float]]]] = None
    kv_transfer_params: Optional[dict] = None
    extra: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"token_ids": self.token_ids}
        if self.finish_reason is not None:
            d["finish_reason"] = self.finish_reason
        if self.cum_log_prob is not None:
            d["cum_log_prob"] = self.cum_log_prob
        if self.log_probs is not None:
            d["log_probs"] = self.log_probs
        if self.top_logprobs is not None:
            d["top_logprobs"] = self.top_logprobs
        if self.kv_transfer_params is not None:
            d["kv_transfer_params"] = self.kv_transfer_params
        if self.extra:
            d["extra"] = self.extra
        return d
