"""TorchEngine: continuous batching over a paged KV cache, in PyTorch.

Port of `dynamo_tpu/engine/engine.py` `TpuEngine`: the same engine
contract (`PreprocessedRequest` dicts in through `generate(request,
context)`, an async stream of `EngineOutput` dicts out, `engine.py:812`),
one background scheduler task (`:1025`), admission with PagePool prefix
reuse (`:1192`), prefill either all at once (prefill_chunk_budget=0,
`:1302`) or token-budgeted (`:1465`), first-token sampling from the chunk
logits (`_first_token_packed`, `:1356`; step 0, the request's seed), stop
ids, length, cancel, preemption, page release. Two device paths, chosen
by `TorchEngineConfig.attention_impl` as the reference chooses by
`DYN_ATTENTION_IMPL`:

- "phase" (the default, as in the reference): batched prefill chunk
  rounds grouped by page alignment (`_chunk_round_once`, `:2595`; models
  `prefill_batch`), fused k-step decode bursts with on-device sampling and
  one host sync each (`_decode_iter`, `:1807`; `decode_multi_step`),
  pipelined bursts (`pipeline_bursts`, `_pipeline_consume`, `:2934`) with
  deferred page releases, and the budgeted scheduler's mixed chunk+burst
  step (`_mixed_step`, `:1586`; `mixed_prefill_decode`);
- "ragged": every round is the flat-token ragged step (`_ragged_core`,
  `:2435`): chunk rows riding a fixed decode block of max_batch_size rows,
  one token per lane per round.

`TorchEngineConfig.quantize` ("int8" | "w8a8" | "int4") serves either path
with quantized weights, as the reference's quantize step (`:546-594`):
the engine quantizes the model it created in place, and a caller's model
into a new one that shares its other tensors (`owned_params`, `:377`).

Constrained sampling, as the reference serves it on both paths: guided
decoding (regex, choice, JSON mode and JSON schema through
`llm/guided.py`'s DFA tables, compiled on the bounded host pool
`runtime/compute.py`, cached per spec, `:2699-2911`), min_p and the
repetition / frequency / presence penalties. A batch with any such lane
runs the constrained burst `decode_multi_step_guided` ("decode_guided",
`:2003`) on either path — never pipelined, never mixed with a chunk round
— and the first token sees the same mask and penalties
(`_first_token_packed`). The host holds each lane's authoritative DFA
state and output counts and advances them per emitted token (`:3120`).
Unlike the reference's (G, S) padded stack, the port packs every
grammar's rows along one state axis (`_guided_layout`), so the resident
tables grow with the states in use, not with pow2(G) x pow2(S_max).

Device work runs in `asyncio.to_thread` under one device lock, with
`torch.inference_mode()` entered inside the thread (it is thread-local).
Every step entry is bucketed as in the reference and tracked per (entry,
bucket) in `compile_tracker` (the reference's `metrics.compile`, `:1406`,
`:2094`, `:2513`, `:2648`); on the card every fixed-shape entry —
"prefill" (bp, T, aligned), "mixed_step" (bp, T, k, aligned, tk),
"sample_first" (width, tk), "decode_burst", "decode_guided" and
"ragged_step" — replays one CUDA graph per bucket (`engine/graphs.py`),
the port's counterpart of the reference's jitted entries. No step reads
the card on the host: the phase path's chunk attention runs K1's kernel
on the card (`attention.prefill_attention`). A graph's outputs are
static and the graphs share one pool, so any replay may overwrite them:
what the engine keeps is copied right behind the replay that made it (a
chunk round's and a mixed step's last-token logits, a pipelined burst's
next input tokens and its host copy). The first
token's penalties and grammar mask run eagerly before its sampling
graph, as the reference keeps them outside its tracked entry. The
guided tables are not graph inputs: each row bucket has resident device
buffers that its graphs read and that a new grammar is written into in
place. A `BucketLadder` (`bucket_ladder`, None by default) refines the
prefill token buckets as in the reference (`:1050`, `:2388`).

Disaggregated serving, as the reference's engine serves it (the handlers
are `disagg/handlers.py`): a request with `kv_transfer_params.
do_remote_decode` pins, when it finishes, the pages holding its written
tokens and returns a `transfer_id` (`_export`, `:3141-3163`); the decode
worker pulls them (`read_kv_pages` / `read_kv_pages_device`, one gather
launch, `kernels.paged_kv_gather`) and the owner releases them
(`complete_transfer`) or reaps them after `transfer_ttl`. A request with
`kv_transfer_params.kv_data` (and `prefill_len`) imports that KV into
fresh pages before any chunk touches them (`write_kv_pages`, K3 per
layer) and prefills only what follows it.

What the router reads, as the reference publishes it: the page pool's
KV events (`event_sink`, stamped with `worker_id` / `dp_rank`, `:641`)
and one `ForwardPassMetrics` per scheduler iteration (`metrics_sink`,
`_publish_metrics`, `:1091`, `:3343`), both called on the event loop's
thread (`_on_loop`: a pool change inside a `to_thread` closure hops back
to the loop, since the runtime's event bus is not thread-safe). The
engine's counters live in `engine/metrics.py` `EngineMetrics`.

Not in this slice, and rejected per request where a request asks for
them: embeddings. Spec, pipeline/sequence parallelism, KVBM and
profilers are later slices (ROADMAP.md).
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable, Optional

import numpy as np
import torch

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine import kernels
from dynamo_tpu_torch.engine.bucketing import BucketLadder
from dynamo_tpu_torch.engine.graphs import StepGraphs
from dynamo_tpu_torch.engine.metrics import EngineMetrics, itl_percentile
from dynamo_tpu_torch.engine.pages import EventSink, PagePool
from dynamo_tpu_torch.engine.quant import (
    QUANTIZE_MODES,
    is_quantized,
    quantize_params,
    remark_act_bits,
)
from dynamo_tpu_torch.engine.sampling import apply_penalties, sample_tokens_lp
from dynamo_tpu_torch.llm.guided import compile_guided
from dynamo_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaModel,
    decode_multi_step,
    decode_multi_step_guided,
    init_cache,
    init_params,
    mixed_prefill_decode,
    prefill_batch,
    ragged_prefill_decode,
)
from dynamo_tpu_torch.protocols import (
    FINISH_CANCELLED,
    FINISH_ERROR,
    FINISH_LENGTH,
    FINISH_STOP,
    EngineOutput,
    ForwardPassMetrics,
    KvStats,
    PreprocessedRequest,
    WorkerStats,
)
from dynamo_tpu_torch.runtime.compute import run_cpu
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.tokens import TokenBlockSequence

logger = logging.getLogger(__name__)


def _topk_list(ids_vec, lps_vec, width: int) -> list:
    """[[token_id, logprob], ...] from parallel packed top-k vectors."""
    return [[int(ids_vec[j]), float(lps_vec[j])] for j in range(width)]


def _next_bucket(n: int, lo: int, hi: int, align: int = 1) -> int:
    """Smallest bucket >= n from {lo·2^k, lo·3·2^(k-1)}, clamped to
    [lo, hi]. Mid buckets that are not multiples of `align` (the page
    size, for prefill chunks) are skipped: a misaligned T would take the
    chunk off the whole-page K3 write."""
    b = lo
    while b < hi:
        if n <= b:
            return b
        mid = b + b // 2
        if n <= mid <= hi and mid % align == 0:
            return mid
        b *= 2
    return min(b, hi)


def _next_pow2(n: int, lo: int, hi: int) -> int:
    b = lo
    while b < n and b < hi:
        b *= 2
    return min(b, hi)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array → `device`. On CUDA through pinned memory with a
    non-blocking copy: a copy from pageable memory would synchronise the
    stream, so the host could not queue a burst behind one in flight."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _start_copy(packed: torch.Tensor):
    """Queue `packed`'s copy to the host on the current stream; `_land`
    waits for it. On CUDA the copy goes to pinned memory, non-blocking,
    with an event recorded right behind it: waiting on that event waits
    for this burst only, where a `.cpu()` issued later would also wait
    for every burst queued after it."""
    if packed.device.type != "cuda":
        return packed, None
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _land(handle) -> np.ndarray:
    """Block until a `_start_copy` has reached the host; its numpy."""
    host, done = handle
    if done is not None:
        done.synchronize()
    return host.numpy()


ATTENTION_IMPLS = ("phase", "ragged")


@dataclass
class TorchEngineConfig:
    model: LlamaConfig = field(default_factory=LlamaConfig.tiny)
    num_pages: int = 1024                 # incl. scratch page 0
    max_batch_size: int = 8
    prefill_chunk: int = 512              # max tokens per chunk per seq
    min_prefill_bucket: int = 16
    watermark: float = 0.95
    default_max_tokens: int = 1024
    rng_seed: int = 0
    # fused decode steps per burst (one host sync each) on the phase
    # path; on the ragged path, the pages a decode lane holds ahead of its
    # position (the reference's page-growth rule, kept on both paths)
    decode_steps_per_sync: int = 8
    # phase path: dispatch burst N+1 (its input tokens sliced on the
    # device from burst N's output) before burst N's results reach the
    # host, when nothing can change the batch; lanes that finish
    # mid-pipeline release their pages only after the in-flight burst
    # lands
    pipeline_bursts: bool = True
    # >0: each scheduler iteration spends at most this many prompt tokens
    # in ONE chunk round, so decode lanes emit between a long prompt's
    # chunks (fused with a decode burst where it can be); 0: every
    # admitted prompt is prefilled to completion first
    prefill_chunk_budget: int = 0
    # allowed prefill batch widths (ascending); None: every power of two
    # up to max_batch_size
    prefill_batch_widths: Optional[tuple] = None
    # "phase" (default) or "ragged" — the reference's DYN_ATTENTION_IMPL
    # choice (llm/entrypoint.py reads the variable)
    attention_impl: str = "phase"
    # None, or quantized serving: "int8" (W8A16), "w8a8" (K5), "int4"
    # (K6) — engine/quant.py
    quantize: Optional[str] = None
    device: str = "cuda"
    # stamped on every KV event and ForwardPassMetrics: the router keys
    # its index and load by (worker_id, dp_rank)
    worker_id: int = 0
    dp_rank: int = 0


@dataclass
class _Seq:
    req: PreprocessedRequest
    ctx: Context
    queue: asyncio.Queue
    token_seq: TokenBlockSequence         # tokens whose KV is on device
    prompt: list[int]                     # effective prompt (incl. replays)
    prompt_hashes: list[int] = field(default_factory=list)
    pages: list[int] = field(default_factory=list)
    cached_len: int = 0                   # prefix-cache hit length
    prefill_pos: int = 0                  # prompt positions < this on device
    last_emit_t: float = 0.0
    next_token: int = -1                  # sampled, KV not yet written
    generated: int = 0
    prefilled: bool = False
    finished: bool = False
    seed: int = 0
    arrival: int = 0
    t_enqueue: float = 0.0
    guided: Optional[Any] = None          # GuidedTables when constrained
    guided_state: int = 0                 # authoritative DFA state (host)
    out_counter: dict = field(default_factory=dict)  # token -> emit count
    _hist: Optional[tuple] = None         # (len(prompt), (V,) histogram)
    # disagg import: ((2, L, KVH, n, P, D) tensor, prefill_len) until the
    # pages land (`_stage_imports`); then how long the write took to
    # read at the first token (CUDA events, or host seconds on the CPU)
    import_kv: Optional[tuple] = None
    import_timing: Optional[tuple] = None

    @property
    def wants_topk(self) -> bool:
        return self.req.sampling.top_logprobs > 0

    @property
    def needs_constrained(self) -> bool:
        """True when this lane needs the constrained burst: a grammar,
        min_p or any sampling penalty."""
        return (self.guided is not None
                or self.req.sampling.min_p > 0.0 or self.has_penalties)

    @property
    def has_penalties(self) -> bool:
        sp = self.req.sampling
        return (sp.repetition_penalty != 1.0
                or sp.frequency_penalty != 0.0
                or sp.presence_penalty != 0.0)

    def prompt_hist(self, vocab: int) -> np.ndarray:
        """Cached (V,) prompt-token histogram for the penalties; the
        prompt changes only on preemption, when it grows, so its length
        keys the cache."""
        if self._hist is None or self._hist[0] != len(self.prompt):
            ids, cnts = np.unique(
                np.asarray(self.prompt, dtype=np.int64) % vocab,
                return_counts=True)
            arr = np.zeros(vocab, dtype=np.int32)
            arr[ids] = cnts
            self._hist = (len(self.prompt), arr)
        return self._hist[1]

    @property
    def pos(self) -> int:
        return len(self.token_seq)

    @property
    def max_tokens(self) -> int:
        return self.req.stop.max_tokens or 0


def _unsupported(req: PreprocessedRequest) -> Optional[str]:
    """Why this engine cannot serve `req` faithfully, or None."""
    if req.extra.get("embed"):
        return "embeddings"
    return None


class TorchEngine:
    """AsyncEngine over a PyTorch model with a paged KV cache."""

    # widest top-k alternatives per emitted token (protocol cap)
    TOPK_WIDTH = 8
    MAX_GUIDED_GRAMMARS = 32
    GUIDED_STOP_WIDTH = 8
    # ceiling on the resident guided tables: a few big JSON-schema
    # grammars on a 128k vocab fail the request, not the card
    GUIDED_TABLE_MAX_BYTES = 1 << 30
    # the tables' transitions are int16 row indices
    GUIDED_MAX_ROWS = 1 << 15

    def __init__(self, config: Optional[TorchEngineConfig] = None,
                 model: Optional[LlamaModel] = None,
                 token_bytes: Any = None, eos_token_id: int = 0,
                 event_sink: Optional[EventSink] = None,
                 metrics_sink: Optional[
                     Callable[[ForwardPassMetrics], None]] = None) -> None:
        """`token_bytes`: the serving tokenizer's per-token output bytes
        (`llm/guided.py` `token_bytes_of`), or a callable that builds them
        at the first guided request; None leaves guided decoding
        unavailable (such requests fail with an error output).
        `eos_token_id` stands in for a guided lane's stop tokens when its
        request names none. `event_sink` takes the page pool's KV events,
        `metrics_sink` one ForwardPassMetrics per scheduler iteration
        (`llm/entrypoint.py` `wire_engine_events` publishes both)."""
        self.config = config or TorchEngineConfig()
        cfg = self.config
        if cfg.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {cfg.attention_impl!r} is not "
                             f"one of {ATTENTION_IMPLS}")
        if cfg.quantize and cfg.quantize not in QUANTIZE_MODES:
            raise ValueError(f"unknown quantize mode {cfg.quantize!r}")
        self.model_cfg = cfg.model
        self.device = resolve_device(cfg.device)
        # quantization may replace weights in place only in a model the
        # engine created: a caller's model may serve other engines
        owned = model is None
        if model is None:
            model = init_params(self.model_cfg, cfg.rng_seed, self.device)
        elif model.cfg != self.model_cfg or model.device != self.device:
            raise ValueError(
                f"model ({model.device}) does not match the engine's config "
                f"and device ({self.device})")
        if cfg.quantize:
            # a pre-quantized model skips the pass; under w8a8 its 8-bit
            # layer weights are re-marked A8, or the mode would silently
            # serve W8A16 (the reference's remark_act_bits)
            if not is_quantized(model):
                model = quantize_params(model, mode=cfg.quantize,
                                        inplace=owned)
            elif cfg.quantize == "w8a8":
                model = remark_act_bits(model, inplace=owned)
        self.model = model
        self.k_cache, self.v_cache = init_cache(self.model_cfg,
                                                cfg.num_pages, self.device)
        # the scheduler loop's event loop and thread, set at first use
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread: Optional[int] = None
        self.pool = PagePool(cfg.num_pages, self.model_cfg.page_size,
                             cfg.worker_id, cfg.dp_rank)
        self.attach_sinks(event_sink, metrics_sink)
        self._waiting: list[_Seq] = []
        self._running: list[_Seq] = []
        self._arrivals = 0
        self._loop_task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self._stopped = False
        self._rng = np.random.RandomState(cfg.rng_seed)
        # serializes device access: steps write the caches in place
        self._device_lock = asyncio.Lock()
        # decode-burst pipeline (phase path, config.pipeline_bursts): the
        # in-flight burst awaiting its host copy, and — while one is in
        # flight — a redirect for page releases (pages a running burst
        # still writes must not go back to the pool)
        self._inflight: Optional[dict] = None
        self._defer_releases: Optional[list] = None
        # histograms, counters and the compile tracker (first dispatch
        # per (entry, bucket)); the raw per-request TTFT samples (s, from
        # enqueue) and the device dispatch count (chunk rounds, bursts,
        # mixed steps, ragged rounds) stay engine-local for benchmarks,
        # as the reference keeps its raw ITL samples
        self.metrics = EngineMetrics()
        self.ttft_s: list[float] = []
        self.rounds = 0
        # one CUDA graph per fixed-shape (entry, bucket) on the card
        self.graphs = StepGraphs(self.device)
        # extra prefill token-bucket rungs, swapped in at a safe point
        # of the scheduler loop; None keeps the static buckets
        self.bucket_ladder: Optional[BucketLadder] = None
        # guided decoding: the tokenizer's token-bytes map (or its lazy
        # provider) and the per-spec DFA tables; slot 0 is the trivial
        # grammar. Pending refs pin a grammar between its compile and its
        # request's admission, so a concurrent eviction cannot drop it.
        self._guided_vocab = token_bytes
        self._guided_eos = eos_token_id
        self._guided_vocab_lock: Optional[asyncio.Lock] = None
        self._guided_tables: dict[str, Any] = {}
        self._guided_slots: dict[str, int] = {}
        self._guided_pending: dict[str, int] = {}
        # resident tables per row bucket: rows -> (bits, next, eos_ok,
        # {key: first row written there}); none is ever freed, since a
        # graph captured on a bucket reads its buffers at every replay
        self._guided_buffers: dict[int, tuple] = {}
        # disagg: finished prefill-only sequences whose pages stay pinned
        # until the decode worker pulls them (transfer_id -> (pages, len,
        # deadline)); reaped by the scheduler loop after transfer_ttl
        self._transfers: dict[str, tuple[list[int], int, float]] = {}
        self.transfer_ttl = 60.0
        # the caches' base pointers on the card, for the KV gather
        self._cache_ptrs: Optional[torch.Tensor] = None

    @property
    def compile_tracker(self):
        return self.metrics.compile

    @property
    def tokens_emitted(self) -> int:
        return int(self.metrics.tokens_emitted.get())

    @property
    def pipelined_bursts(self) -> int:
        """Bursts dispatched behind one in flight."""
        return int(self.metrics.pipelined_bursts.get())

    @property
    def perf(self) -> dict:
        return self.metrics.perf_view()

    def attach_sinks(self, event_sink: Optional[EventSink],
                     metrics_sink: Optional[
                         Callable[[ForwardPassMetrics], None]]) -> None:
        """Set where the KV events and ForwardPassMetrics go. Attach
        before the engine serves: an event emitted with no sink is not
        kept."""
        self.pool.event_sink = (None if event_sink is None
                                else self._on_loop(event_sink))
        self.metrics_sink = metrics_sink

    def _on_loop(self, fn: Callable[[Any], None]) -> Callable[[Any], None]:
        """`fn`, called on the scheduler's event-loop thread: from another
        thread (a `to_thread` closure) the call hops to the loop."""
        def call(x) -> None:
            loop = self._loop
            if loop is None or threading.get_ident() == self._loop_thread:
                fn(x)
            else:
                loop.call_soon_threadsafe(fn, x)
        return call

    @property
    def ragged(self) -> bool:
        """True when every round is the flat-token ragged step."""
        return self.config.attention_impl == "ragged"

    @property
    def _burst_lookahead(self) -> int:
        """Positions past prompt+max_tokens the admission guard budgets:
        one burst of decode_steps_per_sync, two with pipelined bursts (one
        in flight) — the reference's rule on both paths, so both engines
        admit the same requests."""
        k = self.config.decode_steps_per_sync
        return 2 * k if self.config.pipeline_bursts else k

    # -- engine contract ----------------------------------------------------

    async def generate(self, request: dict, context: Context
                       ) -> AsyncIterator[dict]:
        req = PreprocessedRequest.from_dict(request)
        if req.stop.max_tokens is None:
            req.stop.max_tokens = self.config.default_max_tokens
        mcfg = self.model_cfg

        def error(msg: str) -> dict:
            return EngineOutput(token_ids=[], finish_reason=FINISH_ERROR,
                                extra={"error": msg}).to_dict()

        if self._stopped:
            yield error("engine closed")
            return
        if not req.token_ids:
            yield error("empty prompt")
            return
        guided_tables = None
        guided_key = None
        if req.sampling.guided:
            if len(req.stop.stop_token_ids or []) > self.GUIDED_STOP_WIDTH:
                yield error(f"guided decoding supports at most "
                            f"{self.GUIDED_STOP_WIDTH} stop token ids")
                return
            guided_key = self._guided_key(req.sampling.guided)
            # a pending ref across the compile's await: released in the
            # finally below, on every exit (CancelledError included)
            self._guided_pending[guided_key] = \
                self._guided_pending.get(guided_key, 0) + 1
        try:
            if guided_key is not None:
                try:
                    guided_tables = await self._compile_guided(
                        req.sampling.guided)
                except Exception as e:
                    yield error(f"guided decoding: {e}")
                    return
            why = _unsupported(req)
            if why is not None:
                yield error(f"{why} is not supported by dynamo_tpu_torch "
                            f"yet")
                return
            lookahead = self._burst_lookahead
            max_len = mcfg.page_size * mcfg.max_pages_per_seq - lookahead
            need_pages = (len(req.token_ids) + req.stop.max_tokens
                          + lookahead + mcfg.page_size - 1) // mcfg.page_size
            if len(req.token_ids) + req.stop.max_tokens > max_len \
                    or need_pages > self.pool.capacity:
                yield error(f"prompt+max_tokens exceeds capacity (context "
                            f"{max_len}, pages {self.pool.capacity})")
                return
            import_kv = None
            ktp = req.kv_transfer_params or {}
            if ktp.get("kv_data") is not None:
                import_kv = self._check_import(ktp, len(req.token_ids))
                if isinstance(import_kv, str):
                    # a malformed import fails this request only
                    yield error(import_kv)
                    return
            seq = _Seq(
                req=req, ctx=context, queue=asyncio.Queue(),
                token_seq=TokenBlockSequence(mcfg.page_size),
                prompt=list(req.token_ids),
                prompt_hashes=TokenBlockSequence(
                    mcfg.page_size, req.token_ids).seq_hashes(),
                guided=guided_tables,
                seed=(req.sampling.seed if req.sampling.seed is not None
                      else int(self._rng.randint(0, 2**31 - 1))),
                arrival=self._arrivals,
                t_enqueue=time.perf_counter(),
                import_kv=import_kv,
            )
            self._arrivals += 1
            self._ensure_loop()
            self._waiting.append(seq)
            self._wake.set()
            while True:
                out = await seq.queue.get()
                if out is None:
                    return
                yield out
                if out.get("finish_reason"):
                    return
        finally:
            # once the seq is queued the active-set scan covers it too
            if guided_key is not None:
                self._guided_unpend(guided_key)

    def clear_kv_blocks(self) -> int:
        """Drop the reusable prefix cache. Returns pages freed."""
        return self.pool.clear_inactive()

    async def close(self) -> None:
        self._stopped = True
        self._wake.set()
        if self._loop_task is not None:
            self._loop_task.cancel()
            try:
                await self._loop_task
            except asyncio.CancelledError:
                pass
        self._drain_inflight_sync()
        for s in self._running + self._waiting:
            s.queue.put_nowait(EngineOutput(
                token_ids=[], finish_reason=FINISH_CANCELLED).to_dict())
            s.queue.put_nowait(None)
            self.pool.release_sequence(s.pages)
        self._running.clear()
        self._waiting.clear()

    # -- scheduler loop -----------------------------------------------------

    def _ensure_loop(self) -> None:
        if self._loop_task is None or self._loop_task.done():
            self._loop = asyncio.get_running_loop()
            self._loop_thread = threading.get_ident()
            self._loop_task = self._loop.create_task(
                self._scheduler_loop())

    async def _scheduler_loop(self) -> None:
        while not self._stopped:
            if not self._waiting and not self._running:
                if self._inflight is not None:
                    # the last lane finished while a pipelined burst was
                    # in flight: land it now, or its deferred pages stay
                    # out of the pool while the engine idles
                    await asyncio.to_thread(self._drain_inflight_sync)
                    continue
                self._wake.clear()
                if self._transfers:
                    # stay reapable: pinned transfers expire even when no
                    # request is in flight
                    try:
                        await asyncio.wait_for(self._wake.wait(), 1.0)
                    except asyncio.TimeoutError:
                        pass
                    self._reap_transfers()
                else:
                    await self._wake.wait()
                continue
            try:
                if self.bucket_ladder is not None:
                    # safe point: between dispatches, before this
                    # iteration picks its batch shapes
                    self.bucket_ladder.maybe_apply()
                self._reap_transfers()
                self._admit()
                if self.config.prefill_chunk_budget > 0:
                    progressed = await self._prefill_budgeted()
                else:
                    progressed = await self._prefill_pending()
                progressed |= await self._decode_iter()
                self._publish_metrics()
                if not progressed:
                    await asyncio.sleep(0.001)
            except Exception:
                logger.exception("engine scheduler iteration failed")
                self._fail_all()

    def _drain_inflight_sync(self) -> None:
        """Tear down the burst pipeline: block until the in-flight burst
        has landed (its writes reach pages that must not be handed out
        before), then free the pages deferred behind it. Close and error
        paths only."""
        inf, self._inflight = self._inflight, None
        if inf is None:
            return
        try:
            _land(inf["handle"])
        except Exception:
            pass  # the burst itself failed; nothing is writing anymore
        for pages in inf["deferred"]:
            self.pool.release_sequence(pages)

    def _fail_all(self) -> None:
        self._drain_inflight_sync()
        for s in self._running + self._waiting:
            s.queue.put_nowait(EngineOutput(
                token_ids=[], finish_reason=FINISH_ERROR,
                extra={"error": "engine step failed"}).to_dict())
            s.queue.put_nowait(None)
            self.pool.release_sequence(s.pages)
        self._running.clear()
        self._waiting.clear()

    # -- admission ----------------------------------------------------------

    def _admit_one(self) -> bool:
        """One admission attempt on the FIFO head; True when the caller
        should keep going (admitted, or a dead entry was reaped)."""
        cand = self._waiting[0]
        if cand.ctx.is_cancelled():
            self._waiting.pop(0)
            self._finish(cand, FINISH_CANCELLED)
            return True
        page_size = self.model_cfg.page_size
        need_pages = (len(cand.prompt) + page_size - 1) // page_size
        if (self.pool.active_pages + need_pages
                > self.config.watermark * self.pool.capacity
                and self._running):
            return False
        if cand.import_kv is not None:
            # disagg import: fresh pages only (the imported KV overwrites
            # them); the cached length comes from the transfer
            alloc = self.pool.allocate_sequence([], len(cand.prompt))
            if alloc is None:
                return False
            cand.pages, cand.cached_len = alloc[0], cand.import_kv[1]
        else:
            alloc = self.pool.allocate_sequence(cand.prompt_hashes,
                                                len(cand.prompt))
            if alloc is None:
                return False
            cand.pages, cand.cached_len = alloc
        cand.prefill_pos = cand.cached_len
        self._waiting.pop(0)
        self._running.append(cand)
        return True

    def _admit(self) -> None:
        while self._waiting and \
                len(self._running) < self.config.max_batch_size:
            if not self._admit_one():
                break

    # -- prefill ------------------------------------------------------------

    async def _prefill_pending(self) -> bool:
        """Prefill every admitted-but-unprefilled sequence with batched
        chunk rounds (`_chunk_rounds`), then sample all their first tokens
        in one call and one host sync."""
        pending = [s for s in self._running if not s.prefilled]
        if not pending:
            return False
        await self._stage_imports(pending)

        def prefill_all():
            with torch.inference_mode():
                offsets = {id(s): s.cached_len for s in pending}
                return self._first_token_packed(
                    pending, self._chunk_rounds(pending, offsets))

        async with self._device_lock:
            packed, tk = await asyncio.to_thread(prefill_all)
        self._emit_first_tokens(pending, packed, tk)
        return True

    def _chunk_rounds(self, seqs: list[_Seq], offsets) -> dict[int, Any]:
        """Chunk rounds over `seqs` until every prompt is on the device;
        returns each sequence's last-round logits by id. Device-blocking."""
        last_logits: dict[int, Any] = {}
        while True:
            ready = [s for s in seqs if offsets[id(s)] < len(s.prompt)]
            if not ready:
                return last_logits
            last_logits.update(self._chunk_round_once(ready, offsets))

    def _prefill_width(self, n: int) -> int:
        """Prefill batch width for an n-sequence round: the next power of
        two up to max_batch_size, or the configured prefill_batch_widths
        ladder."""
        cfg = self.config
        if cfg.prefill_batch_widths:
            bp = next((w for w in cfg.prefill_batch_widths if w >= n),
                      cfg.prefill_batch_widths[-1])
            return min(bp, cfg.max_batch_size)
        return _next_pow2(n, 1, cfg.max_batch_size)

    def _token_bucket(self, n: int) -> int:
        """Prefill token bucket T for an n-token chunk: the
        {lo·2^k, lo·3·2^(k-1)} ladder between min_prefill_bucket and
        prefill_chunk, page-aligned, refined by any rungs `bucket_ladder`
        has applied. Unarmed (the default) this is exactly
        `_next_bucket`."""
        cfg, page = self.config, self.model_cfg.page_size
        base = _next_bucket(n, cfg.min_prefill_bucket, cfg.prefill_chunk,
                            align=page)
        if self.bucket_ladder is not None:
            return self.bucket_ladder.bucket_for(
                n, base, lo=cfg.min_prefill_bucket, align=page)
        return base

    def _chunk_round_once(self, ready: list[_Seq], offsets,
                          caps=None) -> dict[int, Any]:
        """ONE chunk round; advances `offsets`. `caps` ({id(s): tokens})
        bounds each chunk below prefill_chunk (the budgeted scheduler's
        token budget). Returns {id(s): last-token logits} for the
        sequences whose prompt this round completed. Device-blocking.

        Phase path: the round takes the sequences whose cursor is
        page-aligned (or, when none is, the unaligned ones), as many as
        the prefill width allows, padded to (width, token bucket), through
        `prefill_batch` — aligned rounds store whole pages (K3). Ragged
        path: up to max_batch_size chunks as flat rows."""
        cfg = self.config
        if self.ragged:
            active = ready[:cfg.max_batch_size]
            chunk_lens = self._chunk_lens(active, offsets, caps)
            _, logits = self._ragged_core(active, offsets, chunk_lens, [],
                                          0)
        else:
            # mid-page cursors need the row write; batching them with
            # aligned ones would drag everyone onto it
            P = self.model_cfg.page_size
            aligned_s = [s for s in ready if offsets[id(s)] % P == 0]
            active = aligned_s or ready
            bp = self._prefill_width(len(active))
            active = active[:bp]
            chunk_lens = self._chunk_lens(active, offsets, caps)
            chunk = self._chunk_arrays(active, offsets, chunk_lens, bp)
            aligned = bool(aligned_s)

            def step(*a):
                return prefill_batch(self.model, self.k_cache, self.v_cache,
                                     *a, aligned=aligned)
            logits = self._graphed(
                "prefill", (bp, chunk[0].shape[1], int(aligned)), step,
                chunk, hist=self.metrics.prefill_chunk)
            self.rounds += 1
        done: dict[int, Any] = {}
        for i, s in enumerate(active):
            offsets[id(s)] += chunk_lens[i]
            if offsets[id(s)] >= len(s.prompt):
                done[id(s)] = i
        if done and not self.ragged:
            # the graph's logits are static: the next replay of this
            # (bp, T, aligned) key overwrites them, while these sequences
            # are sampled after later rounds
            logits = logits.clone()
        return {k: logits[i] for k, i in done.items()}

    def _chunk_lens(self, active: list[_Seq], offsets, caps) -> list[int]:
        cfg = self.config
        return [min(len(s.prompt) - offsets[id(s)], cfg.prefill_chunk,
                    caps[id(s)] if caps else cfg.prefill_chunk)
                for s in active]

    def _chunk_arrays(self, active: list[_Seq], offsets,
                      chunk_lens: list[int], bp: int):
        """(tokens (bp, T bucket), tables (bp, max_pages), cached (bp,),
        seq_lens (bp,)) int32 host arrays of a phase chunk sub-batch, in
        `prefill_batch`'s argument order; padding lanes have seq_len ==
        cached_len == 0."""
        mcfg = self.model_cfg
        t_bucket = self._token_bucket(max(chunk_lens))
        toks = np.zeros((bp, t_bucket), dtype=np.int32)
        tables = np.zeros((bp, mcfg.max_pages_per_seq), dtype=np.int32)
        cached = np.zeros(bp, dtype=np.int32)
        seq_lens = np.zeros(bp, dtype=np.int32)
        for i, s in enumerate(active):
            off, n = offsets[id(s)], chunk_lens[i]
            toks[i, :n] = s.prompt[off:off + n]
            tables[i, :len(s.pages)] = s.pages
            cached[i] = off
            seq_lens[i] = off + n
        return toks, tables, cached, seq_lens

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return _to_device(a, self.device)

    def _first_token_packed(self, pending: list[_Seq], last_logits):
        """Sample every just-prefilled sequence's FIRST token in one call:
        logits padded to the fixed max_batch_size width, the penalties and
        the grammar masks applied (the first token obeys them as every
        burst token does), step 0 of each request's seed. Returns (packed
        np (2 + 2*tk, width), tk). Device-blocking."""
        width = self.config.max_batch_size
        stack = [last_logits[id(s)] for s in pending]
        while len(stack) < width:
            stack.append(stack[0])
        guided_mask = None
        if any(s.guided is not None for s in pending):
            V = self.model_cfg.vocab_size
            guided_mask = np.zeros((width, V), dtype=np.float32)
            for i, s in enumerate(pending):
                if s.guided is not None:
                    ok = self._guided_allowed_row(s.guided, s, V)
                    guided_mask[i, ~ok] = -1e30
        penalty_args = None
        if any(s.has_penalties for s in pending):
            penalty_args = self._penalty_arrays(pending, width)

        def arr(fn, dtype):
            vals = [fn(s) for s in pending]
            vals += [vals[0]] * (width - len(pending))
            return np.asarray(vals, dtype=dtype)

        # the penalties and the grammar mask stay eager, before the graph
        # (the reference keeps them outside its tracked entry); only the
        # sampling is captured
        logits = torch.stack(stack)
        if penalty_args is not None:
            rep_a, freq_a, pres_a, pc, oc = map(self._dev, penalty_args)
            logits = apply_penalties(logits, pc, oc, rep_a, freq_a, pres_a)
        if guided_mask is not None:
            logits = logits + self._dev(guided_mask)
        tk = self.TOPK_WIDTH if any(s.wants_topk for s in pending) else 0
        inputs = (logits,
                  arr(lambda s: s.seed & 0xFFFFFFFF, np.int64),
                  arr(lambda s: s.generated, np.int64),
                  arr(lambda s: s.req.sampling.temperature, np.float32),
                  arr(lambda s: s.req.sampling.top_p, np.float32),
                  arr(lambda s: s.req.sampling.top_k, np.int64),
                  arr(lambda s: s.req.sampling.min_p, np.float32))
        packed = self._graphed(
            "sample_first", (width, tk),
            lambda *a: sample_tokens_lp(*a, topk_lp=tk), inputs)
        return packed.cpu().numpy(), tk

    def _emit_first_tokens(self, pending: list[_Seq], packed: np.ndarray,
                           tk: int) -> None:
        """Flip just-prefilled sequences to decodable, register their
        complete prompt blocks and emit their first tokens."""
        page_size = self.model_cfg.page_size
        tokens = packed[0].astype(np.int32)
        logprobs = packed[1]
        for seq in pending:
            if seq.import_timing is not None:
                self._observe_import(seq)
        for i, (seq, token, lp) in enumerate(zip(pending, tokens,
                                                 logprobs)):
            seq.token_seq = TokenBlockSequence(page_size, seq.prompt)
            for block in seq.token_seq.blocks:
                self.pool.register_page(
                    seq.pages[block.block_index], block.seq_hash,
                    block.local_hash, block.parent_seq_hash)
            seq.prefilled = True
            seq.prefill_pos = len(seq.prompt)
            topk_fn = None
            if tk and seq.wants_topk:
                def topk_fn(_k, _i=i, _s=seq):
                    return _topk_list(
                        packed[2:2 + tk, _i], packed[2 + tk:2 + 2 * tk, _i],
                        min(_s.req.sampling.top_logprobs, tk))

            self._emit_lane(seq, np.asarray([token]), [float(lp)],
                            topk_fn, append_inputs=False)

    async def _prefill_budgeted(self) -> bool:
        """Token-budgeted prefill step: advance pending sequences' chunk
        cursors by at most prefill_chunk_budget prompt tokens in ONE
        round. When decode lanes are running and no burst is in flight,
        the round carries them (`_mixed_step`); otherwise the chunk round
        runs alone and `_decode_iter` interleaves between iterations."""
        pending = [s for s in self._running if not s.prefilled]
        if not pending:
            return False
        cfg, page_size = self.config, self.model_cfg.page_size
        for s in list(pending):
            if s.ctx.is_cancelled():
                self._finish(s, FINISH_CANCELLED)
                pending.remove(s)
        if not pending:
            return True
        await self._stage_imports(pending)
        for s in pending:
            s.prefill_pos = max(s.prefill_pos, s.cached_len)
        offsets = {id(s): s.prefill_pos for s in pending}
        # picks in arrival order up to the budget, page-aligned cursors
        # first (mirrors _chunk_round_once's grouping, so the picks ARE
        # the round's active set)
        aligned_s = [s for s in pending if offsets[id(s)] % page_size == 0]
        aligned = bool(aligned_s)
        picks: list[_Seq] = []
        caps: dict[int, int] = {}
        rem = cfg.prefill_chunk_budget
        for s in aligned_s or pending:
            if rem <= 0 or len(picks) >= cfg.max_batch_size:
                break
            take = min(len(s.prompt) - offsets[id(s)], cfg.prefill_chunk,
                       rem)
            if take <= 0:
                continue
            picks.append(s)
            caps[id(s)] = take
            rem -= take
        if not picks:
            return False
        picks = picks[:self._prefill_width(len(picks))]
        runnable = [s for s in self._running if s.prefilled]
        batch: list[_Seq] = []
        if runnable and self._inflight is None:
            self._prep_decode_lanes(runnable, cfg.decode_steps_per_sync)
            batch = runnable[:cfg.max_batch_size]
            # constrained lanes need their own burst: the round runs
            # alone and _decode_iter interleaves
            if any(s.needs_constrained for s in batch):
                batch = []
        if batch:
            return await self._mixed_step(picks, offsets, caps, batch,
                                          aligned)

        def round_():
            with torch.inference_mode():
                return self._chunk_round_once(picks, offsets, caps)

        async with self._device_lock:
            done_logits = await asyncio.to_thread(round_)
        for s in picks:
            s.prefill_pos = offsets[id(s)]
        await self._finish_first_tokens(picks, done_logits)
        return True

    async def _mixed_step(self, picks: list[_Seq], offsets, caps,
                          batch: list[_Seq], aligned: bool) -> bool:
        """ONE device step carrying the picks' chunks and the decode
        lanes. Phase path: `mixed_prefill_decode` — the chunk sub-batch
        shares step 0 of a full k-step burst; ragged path: chunk rows and
        the fixed decode block in one flat round. Decode lanes' tokens
        emit as a plain burst's would."""
        chunk_lens = [caps[id(s)] for s in picks]
        tk = self.TOPK_WIDTH if any(s.wants_topk for s in batch) else 0
        if self.ragged:
            def dispatch():
                with torch.inference_mode():
                    return self._ragged_core(picks, offsets, chunk_lens,
                                             batch, tk)
        else:
            k = self.config.decode_steps_per_sync
            bp = self._prefill_width(len(picks))
            ch = self._chunk_arrays(picks, offsets, chunk_lens, bp)
            d = self._burst_arrays(batch)

            def step(*a):
                return mixed_prefill_decode(
                    self.model, self.k_cache, self.v_cache, *a, num_steps=k,
                    aligned=aligned, topk_lp=tk)

            def dispatch():
                with torch.inference_mode():
                    packed, ch_logits = self._graphed(
                        "mixed_step", (bp, ch[0].shape[1], k, int(aligned),
                                       tk), step, (*ch, *d),
                        hist=self.metrics.prefill_chunk)
                    self.rounds += 1
                    # the graph's outputs are static: the chunk logits
                    # outlive this replay (sampled after the lock is
                    # released), so they are copied before the one sync
                    ch_logits = ch_logits.clone()
                    return packed.cpu().numpy(), ch_logits   # ONE sync

        async with self._device_lock:
            packed, ch_logits = await asyncio.to_thread(dispatch)
        self.metrics.mixed_steps.inc()
        self.metrics.decode_steps_during_prefill.inc(
            1 if self.ragged else self.config.decode_steps_per_sync)
        done_logits: dict[int, Any] = {}
        for i, s in enumerate(picks):
            offsets[id(s)] += chunk_lens[i]
            s.prefill_pos = offsets[id(s)]
            if s.prefill_pos >= len(s.prompt):
                done_logits[id(s)] = ch_logits[i]
        self._emit_burst(batch, packed, tk)
        await self._finish_first_tokens(picks, done_logits)
        return True

    async def _finish_first_tokens(self, picks: list[_Seq],
                                   done_logits: dict[int, Any]) -> None:
        completed = [s for s in picks if id(s) in done_logits]
        if not completed:
            return

        def sample():
            with torch.inference_mode():
                return self._first_token_packed(completed, done_logits)

        async with self._device_lock:
            packed, tk = await asyncio.to_thread(sample)
        self._emit_first_tokens(completed, packed, tk)

    # -- decode -------------------------------------------------------------

    def _prep_decode_lanes(self, runnable: list[_Seq],
                           k_steps: int) -> None:
        """Drop cancelled lanes from `runnable` (in place) and grow every
        lane's pages to cover pos .. pos+k_steps-1, preempting victims
        when the pool runs dry."""
        page_size = self.model_cfg.page_size
        for s in list(runnable):
            if s not in runnable:
                continue      # preempted as an earlier lane's victim
            if s.ctx.is_cancelled():
                self._finish(s, FINISH_CANCELLED)
                runnable.remove(s)
                continue
            need = (s.pos + k_steps - 1) // page_size + 1
            while len(s.pages) < need:
                pid = self.pool.allocate_page()
                if pid is None:
                    victim = self._pick_victim(exclude=s)
                    if victim is not None and victim in runnable:
                        runnable.remove(victim)
                    pid = self.pool.allocate_page()
                if pid is None:
                    self._preempt(s)
                    runnable.remove(s)
                    break
                s.pages.append(pid)

    def _burst_arrays(self, batch: list[_Seq]) -> tuple:
        """Host arrays of a phase burst over the fixed max_batch_size
        width: (tokens, positions, page_tables, valid, seeds, steps,
        temperature, top_p, top_k); empty lanes are invalid (length 0,
        writes to scratch page 0)."""
        b = self.config.max_batch_size
        tokens = np.zeros(b, dtype=np.int32)
        positions = np.zeros(b, dtype=np.int32)
        tables = np.zeros((b, self.model_cfg.max_pages_per_seq),
                          dtype=np.int32)
        valid = np.zeros(b, dtype=bool)
        seeds = np.zeros(b, dtype=np.int64)
        steps = np.zeros(b, dtype=np.int64)
        temps = np.zeros(b, dtype=np.float32)
        top_ps = np.ones(b, dtype=np.float32)
        top_ks = np.zeros(b, dtype=np.int64)
        for i, s in enumerate(batch):
            tokens[i] = s.next_token
            positions[i] = s.pos
            tables[i, :len(s.pages)] = s.pages
            valid[i] = True
            seeds[i] = s.seed & 0xFFFFFFFF
            steps[i] = s.generated
            temps[i] = s.req.sampling.temperature
            top_ps[i] = s.req.sampling.top_p
            top_ks[i] = s.req.sampling.top_k
        return (tokens, positions, tables, valid, seeds, steps, temps,
                top_ps, top_ks)

    async def _decode_iter(self) -> bool:
        if self._inflight is not None:
            return await self._pipeline_consume()
        runnable = [s for s in self._running if s.prefilled]
        if not runnable:
            return False
        k = self.config.decode_steps_per_sync
        self._prep_decode_lanes(runnable, k)
        if not runnable:
            return False
        batch = runnable[:self.config.max_batch_size]
        # register every guided lane's grammar before any lane arrays are
        # built (a re-registration may renumber the slots); a lane whose
        # grammar no longer fits fails alone
        for s in [x for x in batch if x.guided is not None]:
            try:
                self._guided_slot_of(s)
            except ValueError as e:
                s.queue.put_nowait(EngineOutput(
                    token_ids=[], finish_reason=FINISH_ERROR,
                    extra={"error": f"guided decoding: {e}"}).to_dict())
                self._finish(s, FINISH_ERROR, emit=False)
                batch.remove(s)
        if not batch:
            return True
        tk = self.TOPK_WIDTH if any(s.wants_topk for s in batch) else 0
        constrained = any(s.needs_constrained for s in batch)
        if any(not s.prefilled for s in self._running):
            # decode progressed while a prompt is mid-prefill: the
            # interleaving the budgeted scheduler exists to create
            self.metrics.decode_steps_during_prefill.inc(
                1 if self.ragged and not constrained else k)
        if constrained:
            return await self._constrained_burst(batch, k, tk)
        if self.ragged:
            def dispatch():
                with torch.inference_mode():
                    return self._ragged_core([], {}, [], batch, tk)[0]

            async with self._device_lock:
                packed = await asyncio.to_thread(dispatch)
            self._emit_burst(batch, packed, tk)
            return True

        arrays = self._burst_arrays(batch)
        pipelined = self.config.pipeline_bursts

        def dispatch():
            with torch.inference_mode():
                if pipelined:
                    return self._pipelined_burst(k, tk, arrays)
                packed = self._burst(k, tk, arrays)
                self.rounds += 1
                return packed.cpu().numpy()               # ONE host sync

        async with self._device_lock:
            out = await asyncio.to_thread(dispatch)
        if not pipelined:
            self._emit_burst(batch, out, tk)
            return True
        self._inflight = {"k": k, "batch": batch, "arrays": arrays,
                          "tk": tk, "next_tokens": out[0],
                          "handle": out[1], "deferred": []}
        return await self._pipeline_consume()

    def _pipelined_burst(self, k: int, tk: int, inputs):
        """One burst whose results land later: (its last step's tokens,
        the next burst's input, on the device; the handle of its packed
        output's host copy). Both copies are queued right behind the burst:
        on the card its packed output is a graph's static one, which a
        later replay of any graph sharing the pool may overwrite (a chunk
        round or a first-token sampling runs before the next burst)."""
        packed = self._burst(k, tk, inputs)
        self.rounds += 1
        return packed[0, k - 1].to(torch.int32), _start_copy(packed)

    async def _pipeline_consume(self) -> bool:
        """Land the in-flight burst. First, when nothing can change the
        batch, dispatch the NEXT burst, its input tokens sliced on the
        device from the in-flight one's output (the host would compute the
        same inputs); then wait for the in-flight burst's host copy, emit,
        and release the pages deferred behind it."""
        cfg, mcfg = self.config, self.model_cfg
        inf = self._inflight
        k, batch, tk = inf["k"], inf["batch"], inf["tk"]
        nxt = None
        # "nothing can change the batch": the slots are full (arrivals
        # queue), or nothing waits and every running lane is in this
        # burst; every lane alive; and some lane still needs tokens past
        # this burst (else the next one is all overshoot)
        can_spec = ((len(self._running) >= cfg.max_batch_size
                     or (not self._waiting
                         and len(self._running) == len(batch)))
                    and all(s in self._running and not s.ctx.is_cancelled()
                            and not s.needs_constrained for s in batch)
                    and any(s.max_tokens - s.generated > k for s in batch))
        if can_spec:
            ok = True
            for s in batch:
                need = (s.pos + 2 * k - 1) // mcfg.page_size + 1
                if need > mcfg.max_pages_per_seq:
                    ok = False
                    break
                while len(s.pages) < need:
                    pid = self.pool.allocate_page()
                    if pid is None:
                        ok = False      # pages stay attached; no leak
                        break
                    s.pages.append(pid)
                if not ok:
                    break
            if ok:
                (_, positions, _, valid, seeds, steps, temps, top_ps,
                 top_ks) = inf["arrays"]
                tables = np.zeros((cfg.max_batch_size,
                                   mcfg.max_pages_per_seq), dtype=np.int32)
                for i, s in enumerate(batch):
                    tables[i, :len(s.pages)] = s.pages
                arrays = (None, positions + k, tables, valid, seeds,
                          steps + k, temps, top_ps, top_ks)

                def dispatch2():
                    with torch.inference_mode():
                        return self._pipelined_burst(
                            k, tk, (inf["next_tokens"], *arrays[1:]))

                async with self._device_lock:
                    tokens2, handle2 = await asyncio.to_thread(dispatch2)
                self.metrics.pipelined_bursts.inc()
                nxt = {"k": k, "batch": batch, "arrays": arrays, "tk": tk,
                       "next_tokens": tokens2, "handle": handle2,
                       "deferred": []}
        packed = await asyncio.to_thread(_land, inf["handle"])
        # while the next burst runs, finished lanes' pages must not return
        # to the pool (it still writes to them)
        self._defer_releases = nxt["deferred"] if nxt is not None else None
        try:
            self._emit_burst(batch, packed, tk)
        finally:
            self._defer_releases = None
        for pages in inf["deferred"]:
            self.pool.release_sequence(pages)
        self._inflight = nxt
        return True

    def _burst(self, k: int, tk: int, inputs) -> torch.Tensor:
        """One fused k-step burst over the fixed max_batch_size width
        ("decode_burst"; `_burst_arrays`' order, the tokens a host array
        or a device tensor): its packed output, the graph's static one on
        the card (consume it before the next burst)."""
        def step(*a):
            return decode_multi_step(self.model, self.k_cache, self.v_cache,
                                     *a, num_steps=k, topk_lp=tk)
        return self._graphed("decode_burst",
                             (self.config.max_batch_size, k, tk), step,
                             inputs)

    async def _constrained_burst(self, batch: list[_Seq], k: int,
                                 tk: int) -> bool:
        """ONE constrained k-step burst ("decode_guided",
        `decode_multi_step_guided`) over the fixed max_batch_size width, on
        either path: the grammar masks, min_p and the penalties applied on
        the device. Not pipelined: the next burst starts from the DFA
        states and output counts the host advances at emission. The host
        arrays are built here, on the loop's thread; the tables are
        written and the burst runs under the device lock."""
        b = self.config.max_batch_size
        arrays = self._burst_arrays(batch)
        g_ids, g_states, stop_ids = self._guided_lane_arrays(batch, b)
        rep_p, freq_p, pres_p, p_cnt, o_cnt = self._penalty_arrays(batch, b)
        min_ps = np.zeros(b, dtype=np.float32)
        for i, s in enumerate(batch):
            min_ps[i] = s.req.sampling.min_p
        layout = self._guided_layout()
        bucket, _, first_row = layout
        # one state axis for every grammar: a lane's row is its grammar's
        # first row plus its state, read through grammar index 0
        rows = (first_row[g_ids] + g_states).astype(np.int32)
        inputs = (*arrays, min_ps, rep_p, freq_p, pres_p, p_cnt, o_cnt,
                  np.zeros(b, dtype=np.int32), rows, stop_ids)

        def dispatch():
            with torch.inference_mode():
                g_bits, g_next, g_eos_ok = self._guided_device_stack(layout)

                def step(*a):
                    return decode_multi_step_guided(
                        self.model, self.k_cache, self.v_cache, *a[:15],
                        g_bits, g_next, g_eos_ok, *a[15:], num_steps=k,
                        topk_lp=tk)
                packed = self._graphed("decode_guided", (b, k, tk), step,
                                       inputs, bucket=(bucket,))
                self.rounds += 1
                return packed.cpu().numpy()               # ONE host sync

        async with self._device_lock:
            packed = await asyncio.to_thread(dispatch)
        self._emit_burst(batch, packed, tk)
        return True

    def _graphed(self, entry: str, shape: tuple, fn, inputs,
                 bucket: tuple = (), hist=None):
        """One dispatch of a fixed-shape entry: tracked under (entry,
        shape) and, on the card, replayed from the CUDA graph of (entry,
        shape + bucket) (captured at first use, `engine/graphs.py`);
        `bucket` keys what the step closes over, not an input (the
        guided tables' row bucket). `hist` observes the dispatch's
        seconds. The outputs are the graph's static ones on the card:
        copy what outlives the next replay of the key."""
        trk = self.compile_tracker.track(entry, shape)
        with trk:
            out = self.graphs.run((entry, shape + bucket), fn, inputs)
        if hist is not None:
            hist.observe(trk.elapsed_s)
        return out

    def _ragged_bucket(self, n: int) -> int:
        """Total-token bucket of a round: pow2 below min_prefill_bucket,
        then the {lo·2^k, lo·3·2^(k-1)} ladder, not page-aligned and not
        capped at prefill_chunk (the round may also carry the decode
        block). The ladder does not refine it, as in the reference.
        Padding rows are masked and write only page 0."""
        lo = self.config.min_prefill_bucket
        if n < lo:
            return _next_pow2(n, 1, lo)
        return _next_bucket(n, lo, 1 << 30)

    def _ragged_core(self, picks: list[_Seq], offsets,
                     chunk_lens: list[int], batch: list[_Seq], tk: int):
        """Build + run ONE flat-token ragged round (device-blocking): each
        pick's capped chunk becomes `chunk_lens[i]` rows; decode lanes, when
        present, occupy a FIXED block of max_batch_size rows (invalid rows
        mark empty lanes); padding rows fill to the total-token bucket.
        Returns (packed np (2+2tk, 1, bmax), ch_logits (device, row i =
        pick i's last chunk token)). On the card the round replays the
        graph of its (tb, tk) bucket; `ch_logits` outlives it (its picks
        are sampled after later rounds), so it is cloned."""
        cfg, mcfg = self.config, self.model_cfg
        P = mcfg.page_size
        bmax = cfg.max_batch_size
        total = sum(chunk_lens) + (bmax if batch else 0)
        tb = self._ragged_bucket(total)
        toks = np.zeros(tb, dtype=np.int32)
        poss = np.zeros(tb, dtype=np.int32)
        pages = np.zeros(tb, dtype=np.int32)
        offs = np.zeros(tb, dtype=np.int32)
        valid = np.zeros(tb, dtype=bool)
        lanes = np.zeros(tb, dtype=np.int32)
        # lane-table rows 0..bmax-1 = chunk picks, bmax..2*bmax-1 = decode
        lane_tables = np.zeros((2 * bmax, mcfg.max_pages_per_seq),
                               dtype=np.int32)
        ch_rows = np.zeros(bmax, dtype=np.int32)
        d_rows = np.zeros(bmax, dtype=np.int32)
        seeds = np.zeros(bmax, dtype=np.int64)
        steps = np.zeros(bmax, dtype=np.int64)
        temps = np.zeros(bmax, dtype=np.float32)
        top_ps = np.ones(bmax, dtype=np.float32)
        top_ks = np.zeros(bmax, dtype=np.int64)
        r = 0
        for i, s in enumerate(picks):
            off, n = offsets[id(s)], chunk_lens[i]
            seq_pages = np.asarray(s.pages, dtype=np.int32)
            lane_tables[i, :len(s.pages)] = seq_pages
            p_arr = np.arange(off, off + n, dtype=np.int32)
            toks[r:r + n] = s.prompt[off:off + n]
            poss[r:r + n] = p_arr
            pages[r:r + n] = seq_pages[p_arr // P]
            offs[r:r + n] = p_arr % P
            valid[r:r + n] = True
            lanes[r:r + n] = i
            r += n
            ch_rows[i] = r - 1
        if batch:
            # row r+j is lane j; empty slots' d_rows point at their own
            # masked, zero-output padding row
            d_rows[:] = r + np.arange(bmax, dtype=np.int32)
        for j, s in enumerate(batch):
            li, rj = bmax + j, r + j
            lane_tables[li, :len(s.pages)] = s.pages
            toks[rj] = s.next_token
            poss[rj] = s.pos
            pages[rj] = s.pages[s.pos // P]
            offs[rj] = s.pos % P
            valid[rj] = True
            lanes[rj] = li
            seeds[j] = s.seed & 0xFFFFFFFF
            steps[j] = s.generated
            temps[j] = s.req.sampling.temperature
            top_ps[j] = s.req.sampling.top_p
            top_ks[j] = s.req.sampling.top_k

        def step(*a):
            return ragged_prefill_decode(self.model, self.k_cache,
                                         self.v_cache, *a, topk_lp=tk)

        trk = self.compile_tracker.track("ragged_step", (tb, tk))
        with trk:
            packed, ch_logits = self.graphs.run(
                ("ragged_step", (tb, tk)), step,
                (toks, poss, pages, offs, valid, lanes, lane_tables,
                 ch_rows, d_rows, seeds, steps, temps, top_ps, top_ks))
        if picks:
            self.metrics.prefill_chunk.observe(trk.elapsed_s)
        self.rounds += 1
        if picks:
            ch_logits = ch_logits.clone()
        return packed.cpu().numpy(), ch_logits      # ONE host sync

    # -- guided decoding ----------------------------------------------------

    async def _compile_guided(self, spec: dict) -> Any:
        """The DFA tables of a guided spec, compiled on the bounded host
        pool (`runtime/compute.py`) and cached by the spec's canonical
        JSON (the tables hold no stop tokens, so the spec alone keys
        them). The token-bytes map is built at the first guided request,
        once."""
        if callable(self._guided_vocab):
            if self._guided_vocab_lock is None:
                self._guided_vocab_lock = asyncio.Lock()
            async with self._guided_vocab_lock:
                if callable(self._guided_vocab):
                    self._guided_vocab = await run_cpu(self._guided_vocab)
        if self._guided_vocab is None:
            raise ValueError(
                "engine has no tokenizer vocabulary (token_bytes) — "
                "guided decoding unavailable")
        key = self._guided_key(spec)
        tables = self._guided_tables.get(key)
        if tables is not None:
            return tables
        tables = await run_cpu(compile_guided, spec, self._guided_vocab)
        # a concurrent compile of the same spec may have registered it
        # while this one ran
        if key not in self._guided_tables:
            if (len(self._guided_tables) >= self.MAX_GUIDED_GRAMMARS
                    or self._guided_overflow(tables)):
                self._evict_guided_unused()
            if len(self._guided_tables) >= self.MAX_GUIDED_GRAMMARS:
                raise ValueError(
                    "too many distinct guided grammars in flight")
            why = self._guided_overflow(tables)
            if why:
                raise ValueError(why)
            self._guided_tables[key] = tables
            self._guided_slots[key] = len(self._guided_slots) + 1
        return self._guided_tables[key]

    def _guided_stack_bytes(self, extra=None) -> tuple[int, int]:
        """(rows, device bytes) of the resident tables if `extra` joins
        the cache: row 0 (the trivial grammar) and every grammar's
        states, padded to a power of two."""
        V = self.model_cfg.vocab_size
        rows = 1 + sum(t.num_states for t in self._guided_tables.values()) \
            + (extra.num_states if extra is not None else 0)
        return rows, _next_pow2(rows, 1, 1 << 30) * (2 * V + (V + 7) // 8
                                                     + 1)

    def _guided_overflow(self, extra=None) -> Optional[str]:
        """Why the resident tables could not take `extra`, or None."""
        rows, nbytes = self._guided_stack_bytes(extra)
        if nbytes > self.GUIDED_TABLE_MAX_BYTES \
                or rows > self.GUIDED_MAX_ROWS:
            return (f"guided grammar tables would exceed "
                    f"{self.GUIDED_TABLE_MAX_BYTES >> 20} MiB or "
                    f"{self.GUIDED_MAX_ROWS} states on device")
        return None

    @staticmethod
    def _guided_key(spec: dict) -> str:
        """Canonical cache key of a guided spec; the pending refs, the
        eviction and the slots all key on it."""
        return json.dumps(spec, sort_keys=True)

    def _penalty_arrays(self, lanes: list, width: int):
        """(rep, freq, pres (width,) f32, prompt_counts, out_counts
        (width, V) i32) of a batch's lanes — the one packing the first
        token and the constrained burst both use. Lanes without penalties
        get exact no-op values (rep 1, freq/pres 0, zero counts)."""
        V = self.model_cfg.vocab_size
        rep = np.ones(width, dtype=np.float32)
        freq = np.zeros(width, dtype=np.float32)
        pres = np.zeros(width, dtype=np.float32)
        pc = np.zeros((width, V), dtype=np.int32)
        oc = np.zeros((width, V), dtype=np.int32)
        for i, s in enumerate(lanes):
            sp = s.req.sampling
            rep[i] = sp.repetition_penalty
            freq[i] = sp.frequency_penalty
            pres[i] = sp.presence_penalty
            if s.has_penalties:
                pc[i] = s.prompt_hist(V)
                for t, c in s.out_counter.items():
                    if 0 <= t < V:
                        oc[i, t] = c
        return rep, freq, pres, pc, oc

    def _guided_lane_arrays(self, batch: list, b: int):
        """(g_ids, g_states, stop_ids) of a burst's lanes: each lane's
        grammar slot (0: none), its DFA state and its stop ids (-1
        padded). The slots must already be settled for the batch."""
        g_ids = np.zeros(b, dtype=np.int32)
        g_states = np.zeros(b, dtype=np.int32)
        stop_ids = np.full((b, self.GUIDED_STOP_WIDTH), -1, dtype=np.int32)
        for i, s in enumerate(batch):
            g_ids[i] = self._guided_slot_of(s)
            g_states[i] = s.guided_state
            for j, t in enumerate(self._guided_stop_ids(s)):
                stop_ids[i, j] = t
        return g_ids, g_states, stop_ids

    def _guided_unpend(self, key: str) -> None:
        """Release one pending ref taken in generate()."""
        n = self._guided_pending.get(key, 0) - 1
        if n <= 0:
            self._guided_pending.pop(key, None)
        else:
            self._guided_pending[key] = n

    def _evict_guided_unused(self) -> None:
        """Drop the cached grammars no live or pending request uses and
        renumber the slots compactly (their rows move at the next
        constrained burst)."""
        active = {self._guided_key(s.req.sampling.guided)
                  for s in self._running + self._waiting
                  if s.guided is not None}
        active |= set(self._guided_pending)
        self._guided_tables = {k: v for k, v in self._guided_tables.items()
                               if k in active}
        self._guided_slots = {k: i + 1 for i, k in
                              enumerate(self._guided_tables)}

    def _guided_layout(self):
        """Where the cached grammars sit in the resident tables: (row
        bucket, [(key, first row, tables)], first row by slot). Row 0 is
        the trivial all-allowed grammar of slot 0; the grammars follow in
        slot order, their states contiguous; the bucket is the next power
        of two of the rows used."""
        order = sorted(self._guided_tables.items(),
                       key=lambda kv: self._guided_slots[kv[0]])
        first_row = np.zeros(len(order) + 1, dtype=np.int32)
        placed, row = [], 1
        for key, t in order:
            first_row[self._guided_slots[key]] = row
            placed.append((key, row, t))
            row += t.num_states
        return _next_pow2(row, 1, 1 << 30), placed, first_row

    def _guided_device_stack(self, layout):
        """The resident (bits (1, R, ceil(V/8)) u8, next (1, R, V) i16,
        eos_ok (1, R) bool) tables of `layout`'s row bucket R, with every
        grammar written at its rows: a grammar already there is not
        written again, one that is new there (registered, or moved by a
        renumbering) is written in place on the current stream. The
        transitions hold row indices (a grammar's first row plus its
        state), so the constrained burst reads every lane through grammar
        index 0. A bucket's buffers are made once and kept."""
        rows, placed, _ = layout
        V = self.model_cfg.vocab_size
        bv = (V + 7) // 8
        buf = self._guided_buffers.get(rows)
        if buf is None:
            dev = self.device
            bits = torch.zeros((1, rows, bv), dtype=torch.uint8, device=dev)
            bits[0, 0] = 0xFF                # the trivial grammar: all
            buf = self._guided_buffers[rows] = (
                bits, torch.zeros((1, rows, V), dtype=torch.int16,
                                  device=dev),
                torch.zeros((1, rows), dtype=torch.bool, device=dev), {})
        bits, nxt, eos_ok, resident = buf
        for key, row, t in placed:
            if resident.get(key) == row:
                continue
            n = t.num_states
            bits[0, row:row + n] = torch.from_numpy(t.allowed_bits[:, :bv])
            nxt[0, row:row + n] = torch.from_numpy(
                (t.next_state[:, :V].astype(np.int32) + row)
                .astype(np.int16))
            eos_ok[0, row:row + n] = torch.from_numpy(t.eos_ok)
            resident[key] = row
        # rows written over since are no longer a grammar's
        now = {key: row for key, row, _ in placed}
        for key in [k for k, r in resident.items() if now.get(k) != r]:
            del resident[key]
        return bits, nxt, eos_ok

    def _guided_slot_of(self, seq: _Seq) -> int:
        if seq.guided is None:
            return 0
        key = self._guided_key(seq.req.sampling.guided)
        slot = self._guided_slots.get(key)
        if slot is None:
            # backstop: the grammar was evicted after this seq's compile
            # (the pending refs should prevent it); the seq still holds
            # its tables, so register them again after evicting what no
            # request uses, re-checking the size cap (a ValueError fails
            # only this lane)
            self._evict_guided_unused()
            why = self._guided_overflow(seq.guided)
            if why:
                raise ValueError(f"{why} (re-registration after eviction)")
            self._guided_tables[key] = seq.guided
            self._guided_slots[key] = slot = len(self._guided_slots) + 1
            logger.warning("guided grammar re-registered after eviction "
                           "(slot %d)", slot)
        return slot

    def _guided_stop_ids(self, seq: _Seq) -> list[int]:
        ids = list(seq.req.stop.stop_token_ids or [])[
            :self.GUIDED_STOP_WIDTH]
        return ids or [self._guided_eos]

    def _guided_allowed_row(self, tables, seq: _Seq,
                            vocab: int) -> np.ndarray:
        """(V,) bool: the tokens `seq`'s grammar allows in its state, its
        stop tokens included where the grammar may end."""
        bits = np.unpackbits(tables.allowed_bits[seq.guided_state],
                             bitorder="little")
        row = bits[:vocab].astype(bool)
        if tables.eos_ok[seq.guided_state]:
            for t in self._guided_stop_ids(seq):
                if 0 <= t < vocab:
                    row[t] = True
        return row

    # -- emission -----------------------------------------------------------

    def _emit_burst(self, batch: list[_Seq], packed: np.ndarray,
                    tk: int = 0) -> None:
        """Emit a burst's or round's tokens: packed (2 + 2*tk, K, B) — K
        steps of a phase burst, 1 for a ragged round. A lane's tokens past
        its finish are overshoot and dropped; one EngineOutput per lane."""
        sampled = packed[0].astype(np.int32)     # (K, B)
        logprobs = packed[1]
        tk_ids = tk_lps = None
        if tk:
            tk_ids = packed[2:2 + tk].astype(np.int32)   # (tk, K, B)
            tk_lps = packed[2 + tk:2 + 2 * tk]
        for i, s in enumerate(batch):
            if s.finished or s not in self._running:
                continue
            topk_fn = None
            if tk and s.wants_topk:
                w = min(s.req.sampling.top_logprobs, tk)

                def topk_fn(k, _i=i, _w=w):
                    return _topk_list(tk_ids[:, k, _i], tk_lps[:, k, _i],
                                      _w)

            self._emit_lane(s, sampled[:, i], logprobs[:, i], topk_fn)

    def _emit_lane(self, seq: _Seq, toks, lps,
                   topk_fn: Optional[Callable[[int], list]] = None,
                   append_inputs: bool = True) -> int:
        """Emit up to len(toks) tokens for ONE lane as ONE EngineOutput,
        applying stop ids (after min_tokens) and max_tokens; registers
        every block the lane's input tokens complete. append_inputs=False
        for the first token (no prior input's KV to attribute)."""
        limit = min(len(toks), max(seq.max_tokens - seq.generated, 0))
        n_emit = limit
        finish = None
        stop_set = seq.req.stop.stop_token_ids
        if stop_set:
            hits = np.flatnonzero(np.isin(toks[:limit], list(stop_set)))
            for j in hits:
                if seq.generated + int(j) + 1 >= seq.req.stop.min_tokens:
                    n_emit = int(j) + 1
                    finish = FINISH_STOP
                    break
        if finish is None and seq.generated + n_emit >= seq.max_tokens:
            finish = FINISH_LENGTH
        if n_emit <= 0:
            if finish is not None:
                self._finish(seq, finish)
            return 0
        now = time.monotonic()
        if seq.last_emit_t:
            # inter-token gap at the emission boundary, as the consumer
            # sees it (prefill rounds between bursts included)
            self.metrics.itl.observe((now - seq.last_emit_t) * 1000.0)
        elif seq.generated == 0:
            ttft = max(time.perf_counter() - seq.t_enqueue, 0.0)
            self.ttft_s.append(ttft)
            self.metrics.ttft.observe(ttft)
        seq.last_emit_t = now
        emit_toks = [int(t) for t in toks[:n_emit]]
        guided = seq.guided
        count = seq.has_penalties
        for t in emit_toks:
            if append_inputs:
                block = seq.token_seq.append(seq.next_token)
                if block is not None:
                    self.pool.register_page(
                        seq.pages[block.block_index], block.seq_hash,
                        block.local_hash, block.parent_seq_hash)
            if guided is not None:
                # the authoritative DFA state: each burst starts from it,
                # so overshoot and preemption replays cannot desync it
                seq.guided_state = int(
                    guided.next_state[seq.guided_state, t])
            if count:
                seq.out_counter[t] = seq.out_counter.get(t, 0) + 1
            seq.next_token = t
        seq.generated += n_emit
        self.metrics.tokens_emitted.inc(n_emit)
        out = EngineOutput(token_ids=emit_toks, finish_reason=finish)
        if lps is not None:
            out.log_probs = [float(x) for x in lps[:n_emit]]
        if topk_fn is not None:
            out.top_logprobs = [topk_fn(k) for k in range(n_emit)]
        exported = finish is not None and bool(
            (seq.req.kv_transfer_params or {}).get("do_remote_decode"))
        if exported:
            out.kv_transfer_params = self._export(seq)
        seq.queue.put_nowait(out.to_dict())
        if finish is not None:
            self._finish(seq, finish, emit=False,
                         release_pages=not exported)
        return n_emit

    def _release(self, pages: list[int]) -> None:
        if self._defer_releases is not None:
            # an in-flight burst still writes these pages
            self._defer_releases.append(list(pages))
        else:
            self.pool.release_sequence(pages)

    def _finish(self, seq: _Seq, reason: str, emit: bool = True,
                release_pages: bool = True) -> None:
        seq.finished = True
        if seq in self._running:
            self._running.remove(seq)
        if seq in self._waiting:
            self._waiting.remove(seq)
        if release_pages:
            self._release(seq.pages)
        seq.pages = []
        if emit:
            seq.queue.put_nowait(EngineOutput(
                token_ids=[], finish_reason=reason).to_dict())
        seq.queue.put_nowait(None)

    # -- disaggregated KV transfer ------------------------------------------

    def _check_import(self, ktp: dict, n_tokens: int):
        """(data, prefill_len) of a request's `kv_transfer_params` import
        (`kv_data` a (2, L, KVH, n, P, D) tensor or array, `prefill_len`
        the tokens it holds), or why it is malformed (the reference's
        check, `dynamo_tpu/engine/engine.py:882-900`)."""
        mcfg = self.model_cfg
        data = ktp["kv_data"]
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.asarray(data))
        plen = int(ktp.get("prefill_len") or 0)
        n_pages = (plen + mcfg.page_size - 1) // mcfg.page_size
        want = (2, mcfg.num_layers, mcfg.num_kv_heads, n_pages,
                mcfg.page_size, mcfg.head_dim)
        if not (0 < plen < n_tokens) or tuple(data.shape) != want:
            return (f"bad kv import: prefill_len={plen}, "
                    f"shape={tuple(data.shape)} != {want}")
        return data, plen

    async def _stage_imports(self, pending: list[_Seq]) -> None:
        """Write the admitted imports' KV into their fresh pages, before
        any chunk round touches those pages."""
        imports = [s for s in pending if s.import_kv is not None]
        if not imports:
            return
        page = self.model_cfg.page_size

        def stage():
            with torch.inference_mode():
                for s in imports:
                    data, n_tok = s.import_kv
                    events = None
                    if self.device.type == "cuda":
                        events = (torch.cuda.Event(enable_timing=True),
                                  torch.cuda.Event(enable_timing=True))
                        events[0].record()
                    t0 = time.perf_counter()
                    self.write_kv_pages(s.pages[:-(-n_tok // page)], data)
                    if events is not None:
                        events[1].record()
                    s.import_timing = (events, time.perf_counter() - t0,
                                       n_tok, data.numel()
                                       * data.element_size())
                    s.import_kv = None

        async with self._device_lock:
            await asyncio.to_thread(stage)

    def _observe_import(self, seq: _Seq) -> None:
        """An import's write time, read once its first token has reached
        the host (the stream has passed the write): the device time of its
        K3 launches on the card, host seconds on the CPU."""
        events, host_s, n_tok, nbytes = seq.import_timing
        seq.import_timing = None
        secs = (events[0].elapsed_time(events[1]) / 1e3
                if events is not None else host_s)
        self.metrics.kv_import.observe(secs)
        logger.info("kv import: %d tokens, %d bytes written in %.6f s (%s)",
                    n_tok, nbytes, secs,
                    "device time" if events is not None else "host time")

    def _export(self, seq: _Seq) -> dict:
        """A do_remote_decode sequence finishes: pin the pages that hold
        its `seq.pos` written tokens for the decode worker's pull, release
        the lookahead pages (the importer's shapes cover only the former)
        and return the transfer's `kv_transfer_params`."""
        n_pages = -(-seq.pos // self.model_cfg.page_size)
        self._release(seq.pages[n_pages:])
        tid = uuid.uuid4().hex
        self._transfers[tid] = (seq.pages[:n_pages], seq.pos,
                                time.monotonic() + self.transfer_ttl)
        return {"transfer_id": tid, "prefill_len": seq.pos,
                "worker_id": self.config.worker_id}

    def take_transfer(self, transfer_id: str) -> tuple[list[int], int]:
        """(pages, prefill_len) of a pinned transfer; KeyError if unknown
        or reaped. Refreshes its deadline: a chunked pull has many await
        points, and a reaper releasing the pages mid-pull (then a new
        prefill reusing them) would ship another sequence's KV."""
        pages, plen, _ = self._transfers[transfer_id]
        self._transfers[transfer_id] = (
            pages, plen, time.monotonic() + self.transfer_ttl)
        return pages, plen

    def complete_transfer(self, transfer_id: str) -> None:
        """Release a transfer's pinned pages; idempotent."""
        entry = self._transfers.pop(transfer_id, None)
        if entry is not None:
            self.pool.release_sequence(entry[0])

    def _reap_transfers(self) -> None:
        now = time.monotonic()
        for tid in [t for t, (_, _, dl) in self._transfers.items()
                    if dl <= now]:
            logger.warning("disagg transfer %s expired unpulled", tid)
            self.complete_transfer(tid)

    def _gather_kv_pages(self, page_ids: list[int]) -> torch.Tensor:
        """The one gather both transfer paths use: the pages of every
        layer's K and V caches as a (2, L, KVH, n, P, D) tensor on the
        engine's device, in one launch of the gather kernel on the card
        (`kernels.paged_kv_gather`), queued on the engine's stream behind
        the step that wrote them."""
        if self._cache_ptrs is None and self.device.type == "cuda":
            self._cache_ptrs = kernels.cache_pointers(self.k_cache,
                                                      self.v_cache)
        ids = self._dev(np.asarray(page_ids, dtype=np.int32))
        with self.compile_tracker.track("gather_kv", (len(page_ids),)):
            return kernels.paged_kv_gather(self.k_cache, self.v_cache, ids,
                                           self._cache_ptrs)

    async def read_kv_pages(self, page_ids: list[int]) -> torch.Tensor:
        """The pages as a host tensor (2, L, KVH, n, P, D) [k; v], the
        wire format. Under the device lock, so no step writes the caches
        meanwhile."""
        def read():
            with torch.inference_mode():
                return self._gather_kv_pages(page_ids).cpu()

        async with self._device_lock:
            return await asyncio.to_thread(read)

    async def read_kv_pages_device(self, page_ids: list[int]
                                   ) -> torch.Tensor:
        """The pages as a (2, L, KVH, n, P, D) tensor on the engine's
        device, no host copy: the same-process and CUDA IPC transfer
        paths. The gather is queued on the engine's stream; the call
        returns once it has completed."""
        def read():
            with torch.inference_mode():
                got = self._gather_kv_pages(page_ids)
                if got.device.type == "cuda":
                    torch.cuda.current_stream(got.device).synchronize()
                return got

        async with self._device_lock:
            return await asyncio.to_thread(read)

    def write_kv_pages(self, page_ids: list[int], data) -> None:
        """Store imported (2, L, KVH, n, P, D) KV as pages `page_ids` of
        every layer: K3 `paged_kv_write_pages`, one launch per layer for K
        and V, reading `data[0, l]` and `data[1, l]` as (n, KVH, P, D)
        blocks by their strides, without a copy. Call from inside the
        engine's device-locked work (`_stage_imports`)."""
        dtype = self.k_cache[0].dtype
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(np.asarray(data))
        if data.device != self.device:
            data = (data.pin_memory().to(self.device, non_blocking=True)
                    if self.device.type == "cuda" and data.device.type == "cpu"
                    else data.to(self.device))
        data = data.to(dtype)
        ids = self._dev(np.asarray(page_ids, dtype=np.int32))
        with self.compile_tracker.track("write_kv", (len(page_ids),)):
            for l in range(self.model_cfg.num_layers):
                kernels.paged_kv_write_pages(
                    self.k_cache[l], self.v_cache[l],
                    data[0, l].permute(1, 0, 2, 3),
                    data[1, l].permute(1, 0, 2, 3), ids)

    def _publish_metrics(self) -> None:
        """One ForwardPassMetrics to `metrics_sink` (the reference's
        `_publish_metrics`, `:3343`): slots, queue depth and KV blocks for
        the router's load view, the scheduler counters for the planner."""
        if self.metrics_sink is None:
            return
        perf = self.perf
        self.metrics_sink(ForwardPassMetrics(
            worker_id=self.config.worker_id, dp_rank=self.config.dp_rank,
            worker_stats=WorkerStats(
                request_active_slots=len(self._running),
                request_total_slots=self.config.max_batch_size,
                num_requests_waiting=len(self._waiting)),
            kv_stats=KvStats(
                kv_active_blocks=self.pool.active_pages,
                kv_total_blocks=self.pool.capacity,
                hbm_cache_usage=self.pool.usage()),
            scheduler_stats={
                "prefill_chunks": perf["prefill_chunks"],
                "decode_steps_during_prefill":
                    perf["decode_steps_during_prefill"],
                "mixed_steps": perf["mixed_steps"],
                "itl_p50_ms": itl_percentile(perf["itl_hist"], 0.5),
                "itl_p99_ms": itl_percentile(perf["itl_hist"], 0.99),
                # no blocking work runs inside the port's admission (the
                # reference's is KVBM's onboard and drain)
                "admission_stall_ms": 0.0,
                "compiles": self.compile_tracker.total,
            }))

    def _pick_victim(self, exclude: _Seq) -> Optional[_Seq]:
        cands = [s for s in self._running
                 if s is not exclude and s.prefilled]
        if not cands:
            return None
        victim = max(cands, key=lambda s: s.arrival)
        self._preempt(victim)
        return victim

    def _preempt(self, seq: _Seq) -> None:
        """Release pages, fold generated tokens into the prompt, requeue
        at the head (re-prefilled later)."""
        if seq in self._running:
            self._running.remove(seq)
        self.pool.release_sequence(seq.pages)
        seq.pages = []
        seq.prompt = seq.token_seq.tokens + [seq.next_token]
        seq.prompt_hashes = TokenBlockSequence(
            self.model_cfg.page_size, seq.prompt).seq_hashes()
        seq.token_seq = TokenBlockSequence(self.model_cfg.page_size)
        seq.cached_len = 0
        seq.prefill_pos = 0
        seq.prefilled = False
        self._waiting.insert(0, seq)
