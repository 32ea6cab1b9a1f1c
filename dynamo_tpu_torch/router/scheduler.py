"""Worker selection: predicted-load tracking + cost function.

Port of `dynamo_tpu/router/scheduler.py` (the port keeps its own copy).
The selector takes its `random.Random` from the caller, and draws from it
exactly as the reference's does (one `choice` at temperature 0, one
`random` above), so seeded selections agree with the reference's.

Reference: `lib/llm/src/kv_router/{scheduler.rs,sequence.rs}` —
`ActiveSequences` (sequence.rs:54) predicts each worker's active prefill
tokens and decode blocks across the request lifecycle
(add → prefill-complete → free); `DefaultWorkerSelector` (scheduler.rs:462)
computes ``logit = overlap_weight * potential_prefill_blocks +
potential_decode_blocks`` (lower is better) and samples via softmax with
`router_temperature` (temperature 0 ⇒ argmin, ties broken randomly).
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Optional, Sequence

from dynamo_tpu_torch.protocols import ForwardPassMetrics

WorkerKey = tuple[int, int]


@dataclass
class _ActiveRequest:
    request_id: str
    prefill_tokens: int      # tokens this worker must actually prefill
    total_blocks: int        # prompt+output blocks held while active
    prefilling: bool = True


class ActiveSequences:
    """One worker's predicted load (sequence.rs:54)."""

    def __init__(self, block_size: int) -> None:
        self.block_size = block_size
        self._requests: dict[str, _ActiveRequest] = {}

    def add_request(self, request_id: str, prefill_tokens: int,
                    total_blocks: int) -> None:
        self._requests[request_id] = _ActiveRequest(
            request_id, prefill_tokens, total_blocks)

    def mark_prefill_completed(self, request_id: str) -> None:
        r = self._requests.get(request_id)
        if r is not None:
            r.prefilling = False

    def free(self, request_id: str) -> None:
        self._requests.pop(request_id, None)

    @property
    def active_prefill_tokens(self) -> int:
        return sum(r.prefill_tokens for r in self._requests.values()
                   if r.prefilling)

    @property
    def active_blocks(self) -> int:
        return sum(r.total_blocks for r in self._requests.values())

    @property
    def num_active(self) -> int:
        return len(self._requests)


class MultiWorkerSequences:
    """worker -> ActiveSequences, auto-created (sequence.rs:282)."""

    def __init__(self, block_size: int) -> None:
        self.block_size = block_size
        self._workers: dict[WorkerKey, ActiveSequences] = {}
        # request_id -> worker, so lifecycle updates need no worker arg
        self._owner: dict[str, WorkerKey] = {}

    def worker(self, w: WorkerKey) -> ActiveSequences:
        if w not in self._workers:
            self._workers[w] = ActiveSequences(self.block_size)
        return self._workers[w]

    def peek(self, w: WorkerKey) -> Optional[ActiveSequences]:
        """Like `worker` but without auto-creating: prediction-error
        sampling must not fabricate zero-load state for workers the
        router never routed to."""
        return self._workers.get(w)

    def add_request(self, request_id: str, w: WorkerKey,
                    prefill_tokens: int, total_blocks: int) -> None:
        self.worker(w).add_request(request_id, prefill_tokens, total_blocks)
        self._owner[request_id] = w

    def mark_prefill_completed(self, request_id: str) -> None:
        w = self._owner.get(request_id)
        if w is not None:
            self._workers[w].mark_prefill_completed(request_id)

    def free(self, request_id: str) -> None:
        w = self._owner.pop(request_id, None)
        if w is not None:
            self._workers[w].free(request_id)

    def remove_worker(self, w: WorkerKey) -> None:
        seqs = self._workers.pop(w, None)
        if seqs is not None:
            for rid in list(seqs._requests):
                self._owner.pop(rid, None)

    def workers(self) -> list[WorkerKey]:
        return sorted(self._workers)


@dataclass
class WorkerLoad:
    """Everything the selector knows about one candidate worker."""

    worker: WorkerKey
    overlap_blocks: int = 0
    active_prefill_tokens: int = 0
    active_decode_blocks: int = 0
    total_kv_blocks: int = 0            # from runtime config / metrics
    metrics: Optional[ForwardPassMetrics] = None


@dataclass
class SelectorConfig:
    overlap_weight: float = 1.0         # reference --kv-overlap-score-weight
    temperature: float = 0.0            # reference --router-temperature
    block_size: int = 16                # normalises token backlog to blocks


@dataclass
class SelectionResult:
    worker: WorkerKey
    overlap_blocks: int
    # Load-accounting numbers for this request, so router replicas apply the
    # exact same values (no re-derivation at call sites).
    prefill_tokens: int = 0
    total_blocks: int = 0
    logits: dict[WorkerKey, float] = field(default_factory=dict)
    # Decision explanation (router/decision_log.py): the cost-function
    # terms behind each logit, how close the call was (second-best minus
    # best logit; 0 with a single candidate), the tie count at the
    # argmin, and the softmax draw (None at temperature 0). Computed
    # unconditionally — recording must not perturb selection.
    potential_prefill: dict[WorkerKey, float] = field(default_factory=dict)
    potential_decode: dict[WorkerKey, float] = field(default_factory=dict)
    margin: float = 0.0
    ties: int = 1
    draw: Optional[float] = None


class DefaultWorkerSelector:
    """The reference cost function (scheduler.rs:462-560).

    ``potential_prefill_blocks`` = blocks this worker would still have to
    prefill for the request plus its current predicted prefill backlog;
    ``potential_decode_blocks`` = its predicted active blocks plus the
    request's blocks. ``logit = w·prefill + decode``; lower wins. With
    temperature t>0 pick via softmax over -logit/t; t==0 ⇒ argmin with
    random tie-break (scheduler.rs:389-458).
    """

    def __init__(self, config: Optional[SelectorConfig],
                 rng: random.Random) -> None:
        self.config = config or SelectorConfig()
        self.rng = rng

    def select(self, request_blocks: int,
               candidates: Sequence[WorkerLoad]) -> SelectionResult:
        if not candidates:
            raise ValueError("no candidate workers")
        cfg = self.config
        logits: dict[WorkerKey, float] = {}
        pot_prefill: dict[WorkerKey, float] = {}
        pot_decode: dict[WorkerKey, float] = {}
        for c in candidates:
            new_prefill = max(request_blocks - c.overlap_blocks, 0)
            backlog_blocks = c.active_prefill_tokens / max(1, cfg.block_size)
            potential_prefill = new_prefill + backlog_blocks
            potential_decode = c.active_decode_blocks + request_blocks
            pot_prefill[c.worker] = potential_prefill
            pot_decode[c.worker] = float(potential_decode)
            logits[c.worker] = (cfg.overlap_weight * potential_prefill
                                + potential_decode)
        worker, ties, draw = self._sample(logits)
        overlap = next(c.overlap_blocks for c in candidates
                       if c.worker == worker)
        ordered = sorted(logits.values())
        margin = ordered[1] - ordered[0] if len(ordered) > 1 else 0.0
        return SelectionResult(worker=worker, overlap_blocks=overlap,
                               logits=logits,
                               potential_prefill=pot_prefill,
                               potential_decode=pot_decode,
                               margin=margin, ties=ties, draw=draw)

    def _sample(self, logits: dict[WorkerKey, float]
                ) -> tuple[WorkerKey, int, Optional[float]]:
        """(worker, argmin tie count, softmax draw). The RNG is consumed
        as the reference consumes it — one `choice` at t==0, one `random`
        at t>0 — so seeded selections reproduce."""
        t = self.config.temperature
        if t <= 0.0:
            best = min(logits.values())
            ties = [w for w, v in logits.items() if v == best]
            return self.rng.choice(ties), len(ties), None
        # softmax over negated logits (lower logit ⇒ higher probability)
        mx = min(logits.values())
        weights = {w: math.exp(-(v - mx) / t) for w, v in logits.items()}
        total = sum(weights.values())
        u = self.rng.random()
        r = u * total
        acc = 0.0
        for w, p in weights.items():
            acc += p
            if r <= acc:
                return w, 1, u
        return next(iter(logits)), 1, u
