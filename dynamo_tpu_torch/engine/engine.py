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
"prefill" (bp, T, aligned), "prefill_draft" (likewise, the draft's
rounds), "mixed_step" (bp, T, k, aligned, tk), "sample_first" (width, tk),
"decode_burst", "decode_guided", "spec_decode" and "ragged_step" —
replays one CUDA graph per bucket (`engine/graphs.py`),
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

KVBM, as the reference's engine hooks it (`kvbm/manager.py` attaches
itself as `self.kvbm`): an evicted registered page is offloaded to the
host tier through the KV gather (`_read_kv_pages_sync`: one launch, one
copy to a reused pinned buffer), inline or by the pipelined offload
worker, which pins the page until its gather lands (the admission
watermark nets pinned pages out, and `_alloc_admission` drains the queue
inline when allocation keeps failing behind pins); at admission the
prompt's blocks past the device prefix hit are onboarded from the tiers
(`write_kv_blocks`: stacked into a reused pinned buffer, one copy to the
card, K3 per layer) and prefill starts after them; the scheduler loop
prefetches waiting requests' tier blocks (the router's `kv_hints` too)
and continues admitted prompts from peer workers' tiers
(`onboard_remote`). `admission_stall` times, with KVBM attached, the
blocking part of each admitted request's admission (0 without KVBM). The KV lifecycle recorder (`kv_lifecycle`) is None unless
`DYN_KV_LIFECYCLE` arms it.

Speculative decoding, as the reference serves it (`:207-219`, `:509-541`,
`:1825-2001`): with `TorchEngineConfig.draft_model` the engine holds a
draft model (the caller's `draft=` weights, or a random init from
`rng_seed + 1`) and its own caches at the target's page geometry. The
draft prefills every prompt in full after the target (never trusting a
cached prefix, whose pages may hold target KV only: KVBM onboards, disagg
imports, bursts that did not speculate); on the budgeted path it starts
at 0 and `_draft_catchup` replays what it lacks before a spec burst. Every
decode burst of a draft engine is a spec burst (`engine/spec.py`
`spec_decode_multi_step`, "spec_decode": one CUDA graph per bucket on the
card), whatever its lanes' sampling: grammars, min_p and penalties ride
it. A draft engine runs no pipelined burst, no mixed step and no ragged
round. `SpecDecodeStats` counts over the iterations a lane consumed.

Embeddings (`extra.embed`, `:855-866`, `:961`): a dense cache-free
forward (`models/llama.py` `embed_batch`) of the prompt padded to a
power-of-two bucket, refused above the context length before it runs. A
queued request whose `Context.deadline` has passed is dropped at
admission with `DEADLINE_ADMIT_ERR` and no prefill (`:1203-1215`).

MoE models (a `models/mixtral.py` `MoeConfig`) serve through the same
paths: every forward reaches its FFN through `models/llama.py` `_mlp`.
As in the reference on one device (`:379-408`), they take quantize None
or "int8" (weight-only expert stacks) and refuse w8a8 and int4; the
target of a spec engine may be MoE beside a dense draft.

Flight recorders, as the reference's engine carries them: the step
recorder (`engine/profiler.py`, `step_recorder`, armed by
`DYN_STEP_PROFILE`) records every dispatch (`_tracked`: the graphed
entries, the ragged round, the KV gather and page writes; the pipelined
burst's landing as "burst_sync") with its good and padded tokens, host
seconds and gap; the memory ledger (`engine/memory.py`, `memory_ledger`,
armed by `DYN_MEM_LEDGER`) books the weights and the KV pool, marks each
dispatch before it runs and attributes first-call workspace by the
device delta; an out-of-memory error in a scheduler iteration dumps its
forensics (`record_oom`) before the in-flight requests fail. Both are
None unless armed. The fault injector's `on_dispatch` (`DYN_FAULTS`
kind=oom / dispatch_wedge) is consulted once per scheduler iteration.
The tenancy plane (`DYN_TENANCY`, `tenancy/`) and the serving-class
plane (`DYN_CLASSES`, `serving_classes/`) arm at construction as the
reference's (`:718-745`): with tenancy, each admission round tries one
candidate per tenant, its FIFO head, least weighted service first
(`FairScheduler`), a tenant at its `kv_block_budget` is skipped while
others admit, and the `dynamo_tenant_*` goodput, queue-wait and KV-page
series attribute by the `x-dyn-tenant` header the frontend stamps; with
classes too, the class weight divides each admission's charge.
`admit_lookahead` > 0 without tenancy tries the head and up to that many
requests behind it; 0 with nothing armed is the head-only order, bit for
bit. `spec_shrink` is the brownout's stage-3 actuator. The mesh recorder
(`DYN_MESH_RECORDER`) is refused at construction (`runtime/planes.py`).

Request tracing, as the reference's engine emits it (`:917-938`,
`:1277-1283`, `:1695-1701`, `:2215`, `:3102-3176`): with the process
tracer on (`runtime/tracing.py`, `DYN_TRACE`), `generate` begins an
`engine.request` root in the request's own task (so the transport's
serve span is its parent), and the scheduler, which runs outside that
task, emits its stages with explicit host timestamps: `engine.queue_wait`
at admission, one `engine.prefill.chunk` per dispatch that carried the
request's chunk (its duration is the dispatch's host seconds from the
compile tracker), `engine.prefill` to the first token and
`engine.decode` to the finish, with the `enqueued`, `admitted`,
`compile`, `first_token` and `preempted` events on the root. Off, each
sequence's `trace` is None and every site is one `is not None` test.
No span waits on the card, reads a tensor or holds one.

Pipeline/sequence parallelism is a later slice (ROADMAP.md).
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
from dynamo_tpu_torch.engine.memory import (
    MemoryMetrics,
    is_resource_exhausted,
    ledger_from_env,
    record_oom,
)
from dynamo_tpu_torch.engine.metrics import EngineMetrics
from dynamo_tpu_torch.engine.pages import EventSink, PagePool
from dynamo_tpu_torch.engine.profiler import (
    recorder_from_env as step_recorder_from_env,
)
from dynamo_tpu_torch.engine.quant import (
    MOE_QUANT_ERROR,
    QUANTIZE_MODES,
    is_quantized,
    quantize_params,
    remark_act_bits,
)
from dynamo_tpu_torch.engine.sampling import apply_penalties, sample_tokens_lp
from dynamo_tpu_torch.engine.spec import spec_decode_multi_step
from dynamo_tpu_torch.kvbm.lifecycle import KvbmMetrics, recorder_from_env
from dynamo_tpu_torch.llm.guided import compile_guided
from dynamo_tpu_torch.llm.perf import itl_percentile
from dynamo_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaModel,
    decode_multi_step,
    decode_multi_step_guided,
    embed_batch,
    init_cache,
    init_params,
    mixed_prefill_decode,
    prefill_batch,
    ragged_prefill_decode,
)
from dynamo_tpu_torch.models.loader import params_footprint
from dynamo_tpu_torch.protocols import (
    DEADLINE_ADMIT_ERR,
    FINISH_CANCELLED,
    FINISH_ERROR,
    FINISH_LENGTH,
    FINISH_STOP,
    EngineOutput,
    ForwardPassMetrics,
    KvStats,
    PreprocessedRequest,
    SpecDecodeStats,
    WorkerStats,
)
from dynamo_tpu_torch.runtime.compute import run_cpu
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.faults import OOM_ERROR, FaultInjector
from dynamo_tpu_torch.runtime.planes import refuse_unported_planes
from dynamo_tpu_torch.runtime.tracing import RequestTrace
from dynamo_tpu_torch.serving_classes import classes_from_env
from dynamo_tpu_torch.tenancy import (
    FairScheduler,
    TenantMetrics,
    tenancy_from_env,
)
from dynamo_tpu_torch.tokens import TokenBlockSequence

logger = logging.getLogger(__name__)


def _topk_list(ids_vec, lps_vec, width: int) -> list:
    """[[token_id, logprob], ...] from parallel packed top-k vectors."""
    return [[int(ids_vec[j]), float(lps_vec[j])] for j in range(width)]


def _prompt(s) -> list[int]:
    return s.prompt


def _prompt_len(s) -> int:
    return len(s.prompt)


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


def _host(packed: torch.Tensor) -> np.ndarray:
    """A step's packed output on the host: the host read (one sync) that
    ends a dispatch."""
    return packed.cpu().numpy()


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
    # speculative decoding: a draft model (same page_size and
    # max_pages_per_seq as the target: one page table serves both caches)
    # proposes spec_gamma tokens per iteration, the target verifies them
    # in one forward; spec_iters_per_sync iterations per burst
    draft_model: Optional[LlamaConfig] = None
    spec_gamma: int = 4
    spec_iters_per_sync: int = 8
    # bounded admission skip-ahead without tenancy: when the waiting
    # head cannot get pages, try up to this many requests behind it
    # before the round gives up, so a page-starved giant does not park
    # smaller admissible work; 0 is the head-only order, bit for bit.
    # Ignored when DYN_TENANCY arms the fair scheduler (tenant heads)
    admit_lookahead: int = 0


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
    draft_pos: int = 0                    # draft-cache-valid positions < this
    seed: int = 0
    arrival: int = 0
    t_enqueue: float = 0.0
    # span boundaries (time_ns) and the request's trace handle: `trace`
    # is None unless DYN_TRACE is on, and every scheduler touch is `if
    # seq.trace is not None`, so untraced serving allocates nothing
    t_enqueue_ns: int = 0
    t_admit_ns: int = 0
    t_first_ns: int = 0
    trace: Optional[RequestTrace] = None
    decode_compiled: bool = False         # a decode dispatch compiled
    guided: Optional[Any] = None          # GuidedTables when constrained
    guided_state: int = 0                 # authoritative DFA state (host)
    out_counter: dict = field(default_factory=dict)  # token -> emit count
    _hist: Optional[tuple] = None         # (len(prompt), (V,) histogram)
    # disagg import: ((2, L, KVH, n, P, D) tensor, prefill_len) until the
    # pages land (`_stage_imports`); then how long the write took to
    # read at the first token (CUDA events, or host seconds on the CPU)
    import_kv: Optional[tuple] = None
    import_timing: Optional[tuple] = None
    # KVBM: blocking seconds spent in this request's failed admission
    # attempts, observed with the one that admits it
    stall_s: float = 0.0
    # the resolved tenant (DYN_TENANCY) and serving class (DYN_CLASSES)
    # names; None when the plane is unarmed, and no unarmed path reads
    # them
    tenant: Optional[str] = None
    cls: Optional[str] = None

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
                     Callable[[ForwardPassMetrics], None]] = None,
                 draft: Optional[LlamaModel] = None) -> None:
        """`token_bytes`: the serving tokenizer's per-token output bytes
        (`llm/guided.py` `token_bytes_of`), or a callable that builds them
        at the first guided request; None leaves guided decoding
        unavailable (such requests fail with an error output).
        `eos_token_id` stands in for a guided lane's stop tokens when its
        request names none. `event_sink` takes the page pool's KV events,
        `metrics_sink` one ForwardPassMetrics per scheduler iteration
        (`llm/entrypoint.py` `wire_engine_events` publishes both).
        `draft`: the draft model's weights when `config.draft_model` is
        set (None draws them from `rng_seed + 1`); it may be `model`
        itself (a self-draft), and keeps caches of its own either way."""
        refuse_unported_planes("TorchEngine")
        self.config = config or TorchEngineConfig()
        # the tenancy and serving-class planes: None unless DYN_TENANCY /
        # DYN_CLASSES; with tenancy the admission round drains tenant
        # heads by weighted deficit (`_admission_order`), and with both
        # the class weight scales each admission's charge
        self.tenancy = tenancy_from_env()
        self.fair: Optional[FairScheduler] = None
        self.tenant_metrics: Optional[TenantMetrics] = None
        if self.tenancy is not None:
            self.fair = FairScheduler(self.tenancy)
            self.tenant_metrics = TenantMetrics()
        self.classes = classes_from_env()
        if self.classes is not None and self.fair is not None:
            self.fair.classes = self.classes
        cfg = self.config
        if cfg.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {cfg.attention_impl!r} is not "
                             f"one of {ATTENTION_IMPLS}")
        if cfg.quantize and cfg.quantize not in QUANTIZE_MODES:
            raise ValueError(f"unknown quantize mode {cfg.quantize!r}")
        self.model_cfg = cfg.model
        if getattr(self.model_cfg, "num_experts", 0) and cfg.quantize \
                and cfg.quantize != "int8":
            # the reference's MoE guard (`:379-408`) on one device
            raise ValueError(MOE_QUANT_ERROR)
        self.device = resolve_device(cfg.device)
        if model is None:
            # a model the engine creates is quantized as it is drawn (an
            # MoE model one expert at a time: Mixtral-8x7B's bf16 experts
            # would not fit the card)
            model = init_params(self.model_cfg, cfg.rng_seed, self.device,
                                quantize=cfg.quantize)
        elif model.cfg != self.model_cfg or model.device != self.device:
            raise ValueError(
                f"model ({model.device}) does not match the engine's config "
                f"and device ({self.device})")
        elif cfg.quantize:
            # a caller's model may serve other engines: quantized into a
            # new model sharing its other tensors. A pre-quantized model
            # skips the pass; under w8a8 its 8-bit layer weights are
            # re-marked A8, or the mode would silently serve W8A16 (the
            # reference's remark_act_bits)
            if not is_quantized(model):
                model = quantize_params(model, mode=cfg.quantize)
            elif cfg.quantize == "w8a8":
                model = remark_act_bits(model)
        self.model = model
        self.k_cache, self.v_cache = init_cache(self.model_cfg,
                                                cfg.num_pages, self.device)
        self.draft = self._build_draft(draft)
        # the brownout's stage-3 actuator (serving_classes/brownout.py):
        # True serves a draft engine's bursts without speculating
        self.spec_shrink = False
        # the scheduler loop's event loop and thread, set at first use
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread: Optional[int] = None
        self.pool = PagePool(cfg.num_pages, self.model_cfg.page_size,
                             cfg.worker_id, cfg.dp_rank)
        self.kvbm = None   # set by kvbm.KvbmManager when attached
        # KV lifecycle recorder: None unless DYN_KV_LIFECYCLE, its
        # metrics always on; the pool shares it, and KvbmManager hands it
        # to the tier store when attached
        self.kv_metrics = KvbmMetrics()
        self.kv_lifecycle = recorder_from_env(self.kv_metrics)
        self.pool.lifecycle = self.kv_lifecycle
        self.attach_sinks(event_sink, metrics_sink)
        self._waiting: list[_Seq] = []
        self._running: list[_Seq] = []
        # scheduler forward-progress token, read by the canary and the
        # dispatch watchdog from other threads without any lock
        self._progress = 0
        # the compile tracker of each thread's last dispatch (`_tracked`),
        # which the trace sites right behind it read
        self._dispatch = threading.local()
        self._arrivals = 0
        self._loop_task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self._stopped = False
        self._rng = np.random.RandomState(cfg.rng_seed)
        # serializes device access: steps write the caches in place
        self._device_lock = asyncio.Lock()
        # the asyncio lock cannot exclude SYNCHRONOUS loop-thread code:
        # an admission's onboard (write_kv_blocks) runs with no await
        # while the KVBM offload worker gathers in a thread under the
        # device lock, and both use the engine's pinned staging buffers.
        # This thread lock covers only the synchronous cache entry points
        # (the gather, write_kv_pages, write_kv_blocks); holders never
        # await, so it cannot deadlock.
        self._kv_buffer_lock = threading.RLock()
        # KVBM's reused pinned host buffers ("offload": a gathered batch
        # on its way to the tiers; "onboard": blocks on their way to the
        # card) and the onboard's reused device buffer, grown when a
        # batch outgrows them; the events around the last onboard's
        # host-to-device copy and K3 launches (the host buffer is free
        # once the copy's fires; `_settle_onboard` observes both stages)
        self._kv_staging: dict[str, torch.Tensor] = {}
        self._onboard_events: Optional[list] = None
        # first failed admission with offload pins outstanding
        self._admit_fail_since: Optional[float] = None
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
        # the step recorder (engine/profiler.py) and the memory ledger
        # (engine/memory.py): None unless DYN_STEP_PROFILE /
        # DYN_MEM_LEDGER arm them, and every dispatch site's touch is one
        # `is not None`, so unarmed serving allocates nothing for them and
        # dispatches the same; the dynamo_memory_* gauges always exist
        self.step_recorder = step_recorder_from_env(self.metrics)
        self.memory_metrics = MemoryMetrics()
        self.memory_ledger = ledger_from_env(self.memory_metrics,
                                             device=self.device)
        self._oom = False
        if self.memory_ledger is not None:
            self.memory_ledger.set_class(
                "weights", params_footprint(self.model),
                source="models/loader params_footprint")
            self.memory_ledger.provider(
                "kv_pool",
                lambda: sum(t.numel() * t.element_size()
                            for t in (*self.k_cache, *self.v_cache)),
                source="the K/V cache tensors (PagePool reservation)")
        # chaos hook (runtime/faults.py on_dispatch), read from DYN_FAULTS
        self.faults = FaultInjector.from_env()
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

    def _build_draft(self, draft: Optional[LlamaModel]
                     ) -> Optional[LlamaModel]:
        """The draft model (quantized as the target is) and its caches, or
        None without `config.draft_model`; raises on a page geometry that
        differs from the target's or on gamma / iterations below 1 (the
        reference's checks, `dynamo_tpu/engine/engine.py:509-518`)."""
        cfg, mcfg = self.config, self.model_cfg
        self.dk_cache = self.dv_cache = None
        dm = cfg.draft_model
        if dm is None:
            return None
        if (dm.page_size != mcfg.page_size
                or dm.max_pages_per_seq != mcfg.max_pages_per_seq):
            raise ValueError(
                "draft model must share the target's page geometry")
        if cfg.spec_gamma < 1 or cfg.spec_iters_per_sync < 1:
            raise ValueError(
                "spec_gamma and spec_iters_per_sync must be >= 1")
        owned = draft is None
        if draft is None:
            draft = init_params(dm, cfg.rng_seed + 1, self.device)
        elif draft.cfg != dm or draft.device != self.device:
            raise ValueError(
                f"draft ({draft.device}) does not match the engine's "
                f"draft_model and device ({self.device})")
        if cfg.quantize:
            if not is_quantized(draft):
                draft = quantize_params(draft, mode=cfg.quantize,
                                        inplace=owned)
            elif cfg.quantize == "w8a8":
                draft = remark_act_bits(draft, inplace=owned)
        self.dk_cache, self.dv_cache = init_cache(dm, cfg.num_pages,
                                                  self.device)
        return draft

    @property
    def _spec_stats(self) -> Optional[SpecDecodeStats]:
        """A draft engine's speculative-decoding counters as the
        reference's `SpecDecodeStats` (read from `metrics`, their one
        record); None without a draft."""
        if self.draft is None:
            return None
        m = self.metrics
        return SpecDecodeStats(int(m.spec_draft_tokens.get()),
                               int(m.spec_accepted_tokens.get()))

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
        """True when every round is the flat-token ragged step. A draft
        engine keeps the phase path, as the reference's (its bursts are
        spec bursts)."""
        return self.config.attention_impl == "ragged" and self.draft is None

    @property
    def ragged_active(self) -> bool:
        """The controller-facing name of `ragged` (the reference's
        `ragged_active`): the bucket autotuner leaves a ragged engine's
        ladder alone, since its flat-token step buckets on total tokens
        and has no per-lane padding to tune."""
        return self.ragged

    @property
    def _burst_lookahead(self) -> int:
        """Positions past prompt+max_tokens the admission guard budgets:
        one burst of decode_steps_per_sync, two with pipelined bursts (one
        in flight), at least one spec burst's iterations x (gamma + 1)
        with a draft — the reference's rule on both paths, so both
        engines admit the same requests."""
        cfg = self.config
        k = cfg.decode_steps_per_sync
        la = 2 * k if cfg.pipeline_bursts else k
        if cfg.draft_model is not None:
            la = max(la, cfg.spec_iters_per_sync * (cfg.spec_gamma + 1))
        return la

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
            if req.extra.get("embed"):
                max_ctx = mcfg.page_size * mcfg.max_pages_per_seq
                if len(req.token_ids) > max_ctx:
                    # refused before the dense T^2 forward, which an
                    # unbounded prompt would run under the device lock
                    yield error(f"embed input ({len(req.token_ids)} "
                                f"tokens) exceeds context {max_ctx}")
                    return
                yield await self._embed_one(req)
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
            # trace root parented to the transport's serve span (or the
            # caller task's current span in process; the traceparent
            # header otherwise); None when DYN_TRACE is off
            headers = getattr(context, "headers", None)
            attrs = {"request.id": context.request_id,
                     "engine.worker_id": self.config.worker_id}
            tenant = cls = None
            if self.tenancy is not None:
                tenant = self.tenancy.tenant_of(headers)
                attrs["tenant"] = tenant
            if self.classes is not None:
                cls = self.classes.class_of(headers)
                attrs["class"] = cls
            trace = RequestTrace.begin("engine.request", headers, attrs)
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
                t_enqueue_ns=time.time_ns(),
                trace=trace,
                import_kv=import_kv,
                tenant=tenant,
                cls=cls,
            )
            if trace is not None:
                trace.event("enqueued", waiting=len(self._waiting),
                            running=len(self._running),
                            prompt_tokens=len(req.token_ids))
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

    async def _embed_one(self, req: PreprocessedRequest) -> dict:
        """The prompt's mean-pooled embedding (`embed_batch`): a dense
        cache-free forward of the prompt padded to a power-of-two length
        bucket, under the device lock like every device step."""
        ids = req.token_ids
        t_bucket = _next_pow2(len(ids), self.config.min_prefill_bucket,
                              1 << 30)
        toks = np.zeros((1, t_bucket), dtype=np.int32)
        toks[0, :len(ids)] = ids
        lengths = np.asarray([len(ids)], dtype=np.int32)

        def run():
            with torch.inference_mode():
                vec = embed_batch(self.model, self._dev(toks),
                                  self._dev(lengths))
                return vec[0].cpu().numpy()

        async with self._device_lock:
            vec = await asyncio.to_thread(run)
        return {"embedding": [float(x) for x in vec], "token_ids": [],
                "finish_reason": FINISH_STOP}

    def clear_kv_blocks(self) -> int:
        """Drop the reusable prefix cache. Returns pages freed."""
        return self.pool.clear_inactive()

    def progress_token(self) -> int:
        """Monotonic scheduler forward-progress marker: one more per
        scheduler iteration that dispatched work. The canary uses it to
        tell saturated (the token advances while the probe waits) from
        wedged (frozen); the dispatch watchdog samples it."""
        return self._progress

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
        if self.kvbm is not None:
            # stop the offload/prefetch pipeline and release any pending
            # offload pins before the sequences below free their pages
            await self.kvbm.close()
        self._settle_onboard()
        for s in self._running + self._waiting:
            if s.trace is not None:
                s.trace.end(status="ERROR", finish_reason=FINISH_CANCELLED)
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
                if self.faults is not None:
                    await self._dispatch_fault()
                if self.bucket_ladder is not None:
                    # safe point: between dispatches, before this
                    # iteration picks its batch shapes
                    self.bucket_ladder.maybe_apply()
                self._reap_transfers()
                if self.kvbm is not None:
                    # a failed device read of the offload worker fails
                    # this iteration's requests
                    self.kvbm.raise_device_error()
                self._admit()
                if self.kvbm is not None and self._waiting:
                    # stage tier blocks for still-queued requests so their
                    # admission onboard is one device write (no-op unless
                    # prefetch_blocks > 0); the router's prefix hints
                    # (request extra.kv_hints) ride along
                    hints = [s.req.extra.get("kv_hints")
                             for s in self._waiting]
                    self.kvbm.prefetch_waiting(
                        self._waiting, hints=[h for h in hints if h] or None)
                if self.kvbm is not None and self.kvbm.remote is not None:
                    # G4: continue freshly admitted prompts' block chains
                    # from peer workers' tiers before prefill, all at once
                    # (the worst stall is one fetch timeout per wave);
                    # a failed fetch is a miss, a failed device write
                    # raises
                    fresh = [s for s in self._running
                             if not s.prefilled and s.import_kv is None
                             and s.prefill_pos <= s.cached_len]
                    if fresh:
                        await asyncio.gather(
                            *(self.kvbm.onboard_remote(s) for s in fresh))
                if self.config.prefill_chunk_budget > 0:
                    progressed = await self._prefill_budgeted()
                else:
                    progressed = await self._prefill_pending()
                progressed |= await self._decode_iter()
                self._publish_metrics()
                if progressed:
                    self._progress += 1
                else:
                    await asyncio.sleep(0.001)
            except Exception as exc:
                if self.memory_ledger is not None \
                        and is_resource_exhausted(exc):
                    # OOM forensics (engine/memory.py): the ledger ring,
                    # the step recorder's tail and the triggering
                    # dispatch to a crash file; rc 45 with DYN_OOM_EXIT
                    record_oom(self, exc)
                logger.exception("engine scheduler iteration failed")
                self._fail_all()

    async def _dispatch_fault(self) -> None:
        """The fault injector's per-iteration dispatch hook
        (`DYN_FAULTS` kind=oom / dispatch_wedge): raise the synthetic
        OOM, or park with the work pending, as a wedged dispatch would —
        only `close()` (a cancel) frees it, so recovery must come from
        the dispatch watchdog."""
        action = self.faults.on_dispatch(
            f"dispatch.{self.config.worker_id}")
        if action == ("oom",):
            raise RuntimeError(OOM_ERROR)
        if action is not None:
            logger.error("[fault] dispatch wedge: scheduler parked with %d "
                         "running / %d waiting", len(self._running),
                         len(self._waiting))
            await asyncio.Event().wait()

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
            if s.trace is not None:
                s.trace.end(status="ERROR", finish_reason=FINISH_ERROR)
            s.queue.put_nowait(EngineOutput(
                token_ids=[], finish_reason=FINISH_ERROR,
                extra={"error": "engine step failed"}).to_dict())
            s.queue.put_nowait(None)
            self.pool.release_sequence(s.pages)
        self._running.clear()
        self._waiting.clear()

    # -- admission ----------------------------------------------------------

    # how long allocation may keep failing behind offload pins before the
    # queued offloads drain inline: the worker's gather lands in a few
    # scheduler iterations, and an early flush would turn every deficit
    # eviction into the inline copy
    _ADMIT_FLUSH_GRACE_S = 0.25

    def _alloc_admission(self, hashes, prompt_len: int):
        """allocate_sequence with the pinned-page escape hatch. With the
        KVBM pipeline on, a failed allocation behind offload pins is
        normal (the victims stay pinned until the worker's gather lands)
        and the caller retries next iteration; failing past the grace
        period (a slow or stuck worker) drains the queued batches
        inline, so their pins recycle, and allocates again."""
        alloc = self.pool.allocate_sequence(hashes, prompt_len)
        if alloc is not None:
            self._admit_fail_since = None
            return alloc
        if self.kvbm is not None and self.pool.pending_offload_pages:
            now = time.monotonic()
            if self._admit_fail_since is None:
                self._admit_fail_since = now
            elif (now - self._admit_fail_since >= self._ADMIT_FLUSH_GRACE_S
                    and self.kvbm.flush_queued_offloads()):
                self._admit_fail_since = None
                alloc = self.pool.allocate_sequence(hashes, prompt_len)
        return alloc

    def _admission_order(self) -> list[int]:
        """Candidate indexes into `_waiting` for one admission round: the
        head only when nothing is armed (the FIFO order, bit for bit);
        the head and up to `admit_lookahead` requests behind it; or, with
        the fair scheduler armed, one index per backlogged tenant (its
        FIFO head), least weighted service first."""
        if self.fair is not None:
            return self.fair.candidate_indexes(
                [s.tenant for s in self._waiting])
        la = self.config.admit_lookahead
        if la > 0:
            return list(range(min(la + 1, len(self._waiting))))
        return [0]

    def _tenant_pages(self, tenant: Optional[str]) -> int:
        """KV pages the tenant's running sequences hold."""
        return sum(len(s.pages) for s in self._running
                   if s.tenant == tenant)

    def _admit_one(self) -> bool:
        """One admission round over the candidate order; True when the
        caller should keep going (admitted, or a dead entry was reaped),
        False when no candidate is admissible. A candidate passed over
        holds nothing: every check before its allocation only reads, and
        a failed allocation takes no page."""
        page_size = self.model_cfg.page_size
        for idx in self._admission_order():
            cand = self._waiting[idx]
            if cand.ctx.is_cancelled():
                self._waiting.pop(idx)
                self._finish(cand, FINISH_CANCELLED)
                return True
            deadline = cand.ctx.deadline
            if deadline is not None \
                    and asyncio.get_running_loop().time() >= deadline:
                # its deadline passed while it was queued: drop it before
                # any prefill, with an in-band error (the request failed;
                # the worker did not, so nothing migrates or replays it)
                self._waiting.pop(idx)
                cand.queue.put_nowait(EngineOutput(
                    token_ids=[], finish_reason=FINISH_ERROR,
                    extra={"error": DEADLINE_ADMIT_ERR}).to_dict())
                self._finish(cand, FINISH_ERROR, emit=False)
                return True
            need_pages = (len(cand.prompt) + page_size - 1) // page_size
            if self.fair is not None:
                # a tenant at its page budget is not admissible this
                # round; other tenants' heads still are (an empty batch
                # admits anything, so a request over its own budget
                # cannot starve)
                budget = self.tenancy.get(cand.tenant).kv_block_budget
                if (budget > 0 and self._running
                        and self._tenant_pages(cand.tenant) + need_pages
                        > budget):
                    continue
            # pinned pages are taken but free themselves without any
            # sequence finishing (the offload worker's gather lands): net
            # them out
            occupied = (self.pool.active_pages
                        - self.pool.pending_offload_pages)
            if (occupied + need_pages
                    > self.config.watermark * self.pool.capacity
                    and self._running):
                continue
            t_adm = time.perf_counter()
            if cand.import_kv is not None:
                # disagg import: fresh pages only (the imported KV
                # overwrites them); the cached length comes from the
                # transfer
                alloc = self._alloc_admission([], len(cand.prompt))
                if alloc is None:
                    cand.stall_s += time.perf_counter() - t_adm
                    continue
                cand.pages, cand.cached_len = alloc[0], cand.import_kv[1]
            else:
                alloc = self._alloc_admission(cand.prompt_hashes,
                                              len(cand.prompt))
                if alloc is None:
                    cand.stall_s += time.perf_counter() - t_adm
                    continue
                cand.pages, cand.cached_len = alloc
                if self.kvbm is not None:
                    # blocks past the device prefix hit that the
                    # host/disk tiers hold are written into the fresh
                    # pages, so prefill skips them
                    cand.cached_len = self.kvbm.onboard(cand)
            if self.kvbm is not None:
                # one sample per admitted request: the blocking work of
                # all its attempts (inline eviction gathers, a flush of
                # queued offloads, the onboard's tier reads and device
                # write), not the wait between them, which is queue wait
                self.metrics.admission_stall.observe(
                    cand.stall_s + time.perf_counter() - t_adm)
            wait_s = max(time.perf_counter() - cand.t_enqueue, 0.0)
            self.metrics.queue_wait.observe(wait_s)
            if self.fair is not None:
                self.fair.on_admit(
                    cand.tenant, len(cand.prompt) + cand.max_tokens,
                    cls=cand.cls)
                tm = self.tenant_metrics
                if cand.tenant is not None:
                    tm.observe_queue_wait(cand.tenant, wait_s)
                    tm.kv_blocks.set(
                        self._tenant_pages(cand.tenant) + len(cand.pages),
                        tenant=cand.tenant)
            if cand.trace is not None:
                now_ns = time.time_ns()
                cand.trace.stage(
                    "engine.queue_wait", cand.t_enqueue_ns, now_ns,
                    cached_len=cand.cached_len,
                    prompt_tokens=len(cand.prompt))
                cand.trace.event("admitted",
                                 running=len(self._running) + 1)
                cand.t_admit_ns = now_ns
            cand.prefill_pos = cand.cached_len
            self._waiting.pop(idx)
            self._running.append(cand)
            return True
        return False

    def _admit(self) -> None:
        while self._waiting and \
                len(self._running) < self.config.max_batch_size:
            if not self._admit_one():
                break

    # -- prefill ------------------------------------------------------------

    async def _prefill_pending(self) -> bool:
        """Prefill every admitted-but-unprefilled sequence with batched
        chunk rounds (`_chunk_rounds`), then sample all their first tokens
        in one call and one host sync. A draft engine then prefills the
        draft over every FULL prompt (offset 0, whatever prefix was
        cached: prefix pages may hold target KV only)."""
        pending = [s for s in self._running if not s.prefilled]
        if not pending:
            return False
        await self._stage_imports(pending)

        def prefill_all():
            with torch.inference_mode():
                offsets = {id(s): s.cached_len for s in pending}
                last = self._chunk_rounds(self.model, self.k_cache,
                                          self.v_cache, pending, offsets)
                if self.draft is not None:
                    self._chunk_rounds(self.draft, self.dk_cache,
                                       self.dv_cache, pending,
                                       {id(s): 0 for s in pending})
                return self._first_token_packed(pending, last)

        async with self._device_lock:
            packed, tk = await asyncio.to_thread(prefill_all)
        self._emit_first_tokens(pending, packed, tk, draft_done=True)
        return True

    def _chunk_rounds(self, model: LlamaModel, kc: list, vc: list,
                      seqs: list[_Seq], offsets,
                      tokens_of: Callable[[_Seq], list] = _prompt,
                      target_len_of: Callable[[_Seq], int] = _prompt_len
                      ) -> dict[int, Any]:
        """Chunk rounds of `model` into (kc, vc) over `seqs` until every
        offset reaches target_len_of(s) (default: the prompt's length),
        the tokens read from tokens_of(s) (default: the prompt); returns
        each sequence's last-round logits by id. Shared by the prompt
        prefill of target and draft and the draft's catch-up, so their
        buckets cannot part. Device-blocking."""
        last_logits: dict[int, Any] = {}
        while True:
            ready = [s for s in seqs if offsets[id(s)] < target_len_of(s)]
            if not ready:
                return last_logits
            last_logits.update(self._chunk_round_once(
                model, kc, vc, ready, offsets, tokens_of=tokens_of,
                target_len_of=target_len_of))

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

    def _chunk_round_once(self, model: LlamaModel, kc: list, vc: list,
                          ready: list[_Seq], offsets, caps=None,
                          tokens_of: Callable[[_Seq], list] = _prompt,
                          target_len_of: Callable[[_Seq], int] = _prompt_len
                          ) -> dict[int, Any]:
        """ONE chunk round of `model` into (kc, vc); advances `offsets`.
        `caps` ({id(s): tokens}) bounds each chunk below prefill_chunk
        (the budgeted scheduler's token budget); tokens_of /
        target_len_of as `_chunk_rounds`. Returns {id(s): last-token
        logits} for the sequences this round brought to their target.
        Device-blocking.

        Phase path: the round takes the sequences whose cursor is
        page-aligned (or, when none is, the unaligned ones), as many as
        the prefill width allows, padded to (width, token bucket), through
        `prefill_batch` — aligned rounds store whole pages (K3). Its graph
        entry is "prefill", or "prefill_draft" for rounds that write the
        draft's caches (keyed by the caches, not the weights: a self-draft
        shares the target's). Ragged path (target only): up to
        max_batch_size chunks as flat rows."""
        cfg = self.config
        if self.ragged:
            active = ready[:cfg.max_batch_size]
            chunk_lens = self._chunk_lens(active, offsets, caps,
                                          target_len_of)
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
            chunk_lens = self._chunk_lens(active, offsets, caps,
                                          target_len_of)
            chunk = self._chunk_arrays(active, offsets, chunk_lens, bp,
                                       tokens_of)
            aligned = bool(aligned_s)

            def step(*a):
                return prefill_batch(model, kc, vc, *a, aligned=aligned)
            entry = "prefill_draft" if kc is self.dk_cache else "prefill"
            t_bucket = chunk[0].shape[1]
            logits = self._graphed(
                entry, (bp, t_bucket, int(aligned)), step, chunk,
                (sum(chunk_lens), bp * t_bucket, len(active), bp, 0),
                hist=self.metrics.prefill_chunk)
            self.rounds += 1
            if entry == "prefill":
                self._trace_chunk(active, chunk_lens)
        done: dict[int, Any] = {}
        for i, s in enumerate(active):
            offsets[id(s)] += chunk_lens[i]
            if offsets[id(s)] >= target_len_of(s):
                done[id(s)] = i
        if done and not self.ragged:
            # the graph's logits are static: the next replay of this
            # (bp, T, aligned) key overwrites them, while these sequences
            # are sampled after later rounds
            logits = logits.clone()
        return {k: logits[i] for k, i in done.items()}

    def _chunk_lens(self, active: list[_Seq], offsets, caps,
                    target_len_of=_prompt_len) -> list[int]:
        cfg = self.config
        return [min(target_len_of(s) - offsets[id(s)], cfg.prefill_chunk,
                    caps[id(s)] if caps else cfg.prefill_chunk)
                for s in active]

    def _chunk_arrays(self, active: list[_Seq], offsets,
                      chunk_lens: list[int], bp: int, tokens_of=_prompt):
        """(tokens (bp, T bucket), tables (bp, max_pages), cached (bp,),
        seq_lens (bp,)) int32 host arrays of a phase chunk sub-batch, in
        `prefill_batch`'s argument order, the tokens from tokens_of(s)
        (default: the prompt); padding lanes have seq_len == cached_len
        == 0."""
        mcfg = self.model_cfg
        t_bucket = self._token_bucket(max(chunk_lens))
        toks = np.zeros((bp, t_bucket), dtype=np.int32)
        tables = np.zeros((bp, mcfg.max_pages_per_seq), dtype=np.int32)
        cached = np.zeros(bp, dtype=np.int32)
        seq_lens = np.zeros(bp, dtype=np.int32)
        for i, s in enumerate(active):
            off, n = offsets[id(s)], chunk_lens[i]
            toks[i, :n] = tokens_of(s)[off:off + n]
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
        n = len(pending)
        packed = self._graphed(
            "sample_first", (width, tk),
            lambda *a: sample_tokens_lp(*a, topk_lp=tk), inputs,
            (n, width, n, width, n), land=_host)
        return packed, tk

    def _emit_first_tokens(self, pending: list[_Seq], packed: np.ndarray,
                           tk: int, draft_done: bool) -> None:
        """Flip just-prefilled sequences to decodable, register their
        complete prompt blocks and emit their first tokens. draft_done:
        the draft's caches hold the prompts too; False (the budgeted
        path) leaves draft_pos at 0, and `_draft_catchup` replays the
        prompt before the first spec burst."""
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
            seq.draft_pos = len(seq.prompt) if draft_done else 0
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
        # a draft engine's bursts are spec bursts: its round runs alone
        if runnable and self._inflight is None and self.draft is None:
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
                return self._chunk_round_once(self.model, self.k_cache,
                                              self.v_cache, picks, offsets,
                                              caps)

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
            b = self.config.max_batch_size
            bp = self._prefill_width(len(picks))
            ch = self._chunk_arrays(picks, offsets, chunk_lens, bp)
            d = self._burst_arrays(batch)
            t_bucket = ch[0].shape[1]

            def step(*a):
                return mixed_prefill_decode(
                    self.model, self.k_cache, self.v_cache, *a, num_steps=k,
                    aligned=aligned, topk_lp=tk)

            def land(out):
                packed, ch_logits = out
                # the graph's outputs are static: the chunk logits
                # outlive this replay (sampled after the lock is
                # released), so they are copied before the one sync
                ch_logits = ch_logits.clone()
                return _host(packed), ch_logits              # ONE sync

            def dispatch():
                with torch.inference_mode():
                    out = self._graphed(
                        "mixed_step", (bp, t_bucket, k, int(aligned), tk),
                        step, (*ch, *d),
                        (sum(chunk_lens) + len(batch) * k,
                         bp * t_bucket + b * k, len(picks) + len(batch),
                         bp + b, len(batch) * k),
                        hist=self.metrics.prefill_chunk, land=land)
                    self.rounds += 1
                    self._trace_chunk(picks, chunk_lens, mixed=True)
                    self._mark_decode_compile(batch)
                    return out

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
        self._emit_first_tokens(completed, packed, tk, draft_done=False)

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
        cfg = self.config
        # a draft engine speculates on every burst, whatever its lanes'
        # sampling (`spec_shrink` serves plain bursts instead)
        use_spec = self.draft is not None and not self.spec_shrink
        k = (cfg.spec_iters_per_sync * (cfg.spec_gamma + 1) if use_spec
             else cfg.decode_steps_per_sync)
        self._prep_decode_lanes(runnable, k)
        if not runnable:
            return False
        batch = runnable[:cfg.max_batch_size]
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
        if use_spec:
            return await self._spec_burst(batch, tk)
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
                    out = self._pipelined_burst(k, tk, arrays, len(batch))
                    self._mark_decode_compile(batch)
                    return out
                packed = self._burst(k, tk, arrays, len(batch),
                                     land=_host)          # ONE host sync
                self.rounds += 1
                self._mark_decode_compile(batch)
                return packed

        async with self._device_lock:
            out = await asyncio.to_thread(dispatch)
        if not pipelined:
            self._emit_burst(batch, out, tk)
            return True
        self._inflight = {"k": k, "batch": batch, "arrays": arrays,
                          "tk": tk, "next_tokens": out[0],
                          "handle": out[1], "deferred": []}
        return await self._pipeline_consume()

    def _pipelined_burst(self, k: int, tk: int, inputs, lanes: int):
        """One burst whose results land later: (its last step's tokens,
        the next burst's input, on the device; the handle of its packed
        output's host copy). Both copies are queued right behind the burst:
        on the card its packed output is a graph's static one, which a
        later replay of any graph sharing the pool may overwrite (a chunk
        round or a first-token sampling runs before the next burst)."""
        packed = self._burst(k, tk, inputs, lanes)
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
                    and self.draft is None
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
                        out = self._pipelined_burst(
                            k, tk, (inf["next_tokens"], *arrays[1:]),
                            len(batch))
                        self._mark_decode_compile(batch)
                        return out

                async with self._device_lock:
                    tokens2, handle2 = await asyncio.to_thread(dispatch2)
                self.metrics.pipelined_bursts.inc()
                nxt = {"k": k, "batch": batch, "arrays": arrays, "tk": tk,
                       "next_tokens": tokens2, "handle": handle2,
                       "deferred": []}
        rec = self.step_recorder
        t_sync = time.perf_counter() if rec is not None else 0.0
        packed = await asyncio.to_thread(_land, inf["handle"])
        if rec is not None:
            # the pipelined burst's device wait, where its results reach
            # the host; its tokens were attributed at dispatch
            rec.record("burst_sync", (len(batch), k),
                       time.perf_counter() - t_sync, lanes=len(batch),
                       width=cfg.max_batch_size)
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

    def _burst(self, k: int, tk: int, inputs, lanes: int, land=None):
        """One fused k-step burst of `lanes` lanes over the fixed
        max_batch_size width ("decode_burst"; `_burst_arrays`' order, the
        tokens a host array or a device tensor): its packed output, the
        graph's static one on the card (consume it before the next burst),
        or `land` of it."""
        def step(*a):
            return decode_multi_step(self.model, self.k_cache, self.v_cache,
                                     *a, num_steps=k, topk_lp=tk)
        b = self.config.max_batch_size
        return self._graphed("decode_burst", (b, k, tk), step, inputs,
                             (lanes * k, b * k, lanes, b, lanes * k),
                             land=land)

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
                n = len(batch)
                packed = self._graphed("decode_guided", (b, k, tk), step,
                                       inputs, (n * k, b * k, n, b, n * k),
                                       bucket=(bucket,),
                                       land=_host)        # ONE host sync
                self.rounds += 1
                self._mark_decode_compile(batch)
                return packed

        async with self._device_lock:
            packed = await asyncio.to_thread(dispatch)
        self._emit_burst(batch, packed, tk)
        return True

    async def _draft_catchup(self, lanes: list[_Seq]) -> None:
        """Replay through the draft the positions its caches lack
        (draft_pos .. pos - 1: a budgeted prefill, or bursts that did not
        speculate), as "prefill_draft" rounds over the tokens on the
        device."""
        def rounds():
            with torch.inference_mode():
                self._chunk_rounds(
                    self.draft, self.dk_cache, self.dv_cache, lanes,
                    {id(s): s.draft_pos for s in lanes},
                    tokens_of=lambda s: s.token_seq.tokens,
                    target_len_of=lambda s: s.pos)

        async with self._device_lock:
            await asyncio.to_thread(rounds)
        for s in lanes:
            s.draft_pos = s.pos

    async def _spec_burst(self, batch: list[_Seq], tk: int) -> bool:
        """ONE spec burst ("spec_decode", `spec_decode_multi_step`) over
        the fixed max_batch_size width: spec_iters_per_sync draft → verify
        → accept iterations, one host sync. Lanes whose draft caches lag
        catch up first. The extras are the reference's (`:1895-1921`):
        the guided tables and lane rows, min_p, the penalty arrays; the
        graph key names them as the reference's compile key does. The
        packed output is copied to the host right behind its replay
        (graphs share one pool). Emission takes each lane's emitted
        prefix per iteration; `SpecDecodeStats` counts the iterations a
        lane consumed, not its overshoot."""
        cfg = self.config
        b, gamma, iters = (cfg.max_batch_size, cfg.spec_gamma,
                           cfg.spec_iters_per_sync)
        stale = [s for s in batch if s.draft_pos < s.pos]
        if stale:
            await self._draft_catchup(stale)
        inputs = list(self._burst_arrays(batch))
        extras: list[str] = []
        bucket: tuple = ()
        layout = None
        if any(s.guided is not None for s in batch):
            g_ids, g_states, stop_ids = self._guided_lane_arrays(batch, b)
            layout = self._guided_layout()
            bucket = (layout[0],)
            # one state axis: a lane's row, read through grammar index 0
            rows = (layout[2][g_ids] + g_states).astype(np.int32)
            inputs += [np.zeros(b, dtype=np.int32), rows, stop_ids]
            extras += ["use_guided", "g_bits", "g_next", "g_eos_ok",
                       "g_ids", "g_states", "stop_ids"]
        use_min_p = any(s.req.sampling.min_p > 0.0 for s in batch)
        if use_min_p:
            inputs.append(np.asarray(
                [s.req.sampling.min_p for s in batch]
                + [0.0] * (b - len(batch)), dtype=np.float32))
            extras.append("min_p")
        use_pen = any(s.has_penalties for s in batch)
        if use_pen:
            inputs += list(self._penalty_arrays(batch, b))
            extras += ["use_penalties", "rep_pen", "freq_pen", "pres_pen",
                       "prompt_counts", "out_counts"]
        n_guided = 3 if layout is not None else 0

        def dispatch():
            with torch.inference_mode():
                tables = (self._guided_device_stack(layout)
                          if layout is not None else None)

                def step(*a):
                    rest = list(a[9:])
                    guided = None
                    if tables is not None:
                        guided = (*tables, *rest[:n_guided])
                    rest = rest[n_guided:]
                    min_p = rest.pop(0) if use_min_p else None
                    pen = tuple(rest) if use_pen else None
                    return spec_decode_multi_step(
                        self.model, self.draft, self.k_cache, self.v_cache,
                        self.dk_cache, self.dv_cache, *a[:9], gamma=gamma,
                        num_iters=iters, topk_lp=tk, min_p=min_p,
                        guided=guided, penalties=pen)[0]

                # good: the real lanes' draft + verify positions
                # (rejected proposals are computed work too; acceptance
                # is SpecDecodeStats')
                n, k = len(batch), iters * (gamma + 1)
                packed = self._graphed(
                    "spec_decode", (b, gamma, iters, tk, *sorted(extras)),
                    step, inputs, (n * k, b * k, n, b, 0), bucket=bucket,
                    land=_host)                           # ONE host sync
                self.rounds += 1
                self.metrics.spec_bursts.inc()
                self._mark_decode_compile(batch)
                return packed

        async with self._device_lock:
            packed = await asyncio.to_thread(dispatch)
        self._emit_spec(batch, packed, tk)
        return True

    def _emit_spec(self, batch: list[_Seq], packed: np.ndarray,
                   tk: int) -> None:
        """Emit a spec burst: packed (3 + 2·tk, iters, gamma+1, B); each
        lane's tokens are its emitted prefixes, iteration after
        iteration."""
        cfg = self.config
        gamma, iters = cfg.spec_gamma, cfg.spec_iters_per_sync
        toks_out = packed[0].astype(np.int32)            # (S, G1, B)
        lps_out = packed[1]
        counts = packed[2, :, 0, :].astype(np.int32)     # (S, B)
        stk_ids = stk_lps = None
        if tk:
            stk_ids = packed[3:3 + tk].astype(np.int32)
            stk_lps = packed[3 + tk:3 + 2 * tk]
        slot_grid = np.arange(gamma + 1)[None, :]
        for i, s in enumerate(batch):
            if s.finished or s not in self._running:
                continue
            cnts = counts[:, i]
            emit_mask = slot_grid < cnts[:, None]        # (S, G1)
            topk_fn = None
            if tk and s.wants_topk:
                its, slots = np.nonzero(emit_mask)
                w = min(s.req.sampling.top_logprobs, tk)

                def topk_fn(k, _i=i, _w=w, _its=its, _slots=slots):
                    return _topk_list(stk_ids[:, _its[k], _slots[k], _i],
                                      stk_lps[:, _its[k], _slots[k], _i],
                                      _w)

            n_emitted = self._emit_lane(s, toks_out[:, :, i][emit_mask],
                                        lps_out[:, :, i][emit_mask],
                                        topk_fn)
            # the iteration that finishes the lane counts; later ones are
            # overshoot
            consumed = 0 if n_emitted == 0 else min(
                int(np.searchsorted(np.cumsum(cnts), n_emitted,
                                    side="left")) + 1, iters)
            self.metrics.spec_draft_tokens.inc(gamma * consumed)
            self.metrics.spec_accepted_tokens.inc(
                int((cnts[:consumed] - 1).sum()))
            s.draft_pos = s.pos

    def _graphed(self, entry: str, shape: tuple, fn, inputs, work: tuple,
                 bucket: tuple = (), hist=None, land=None):
        """One dispatch of a fixed-shape entry (`_tracked`), on the card
        replayed from the CUDA graph of (entry, shape + bucket) (captured
        at first use, `engine/graphs.py`); `bucket` keys what the step
        closes over, not an input (the guided tables' row bucket). The
        outputs are the graph's static ones on the card: copy what
        outlives the next replay of the key (in `land`, or right after)."""
        return self._tracked(
            entry, shape,
            lambda: self.graphs.run((entry, shape + bucket), fn, inputs),
            work, hist=hist, land=land)

    def _tracked(self, entry: str, shape: tuple, run: Callable[[], Any],
                 work: tuple, hist=None, land=None):
        """One dispatch, `run()`: tracked under (entry, shape) by the
        compile tracker, marked on the memory ledger before it runs (an
        OOM inside is attributed to it), and recorded after by the step
        recorder (`work`: its good and work tokens, lanes, width and
        tokens emitted). `land(outputs)`, when given, is the host read
        that ends the dispatch: it runs inside the timed window, its
        result is returned, and the record is `synced`. `hist` observes
        the dispatch's seconds."""
        trk = self.compile_tracker.track(entry, shape)
        self._dispatch.trk = trk
        led = self.memory_ledger
        if led is not None:
            led.on_dispatch(entry, trk.shape, compiled=trk.compiled)
        with trk:
            out = run()
            if land is not None:
                out = land(out)
        if hist is not None:
            hist.observe(trk.elapsed_s)
        rec = self.step_recorder
        if rec is not None:
            good, total, lanes, width, tokens = work
            rec.record(entry, trk.shape, trk.elapsed_s, good_tokens=good,
                       work_tokens=total, lanes=lanes, width=width,
                       tokens=tokens, compiled=trk.compiled,
                       synced=land is not None)
        return out

    def _trace_chunk(self, picks: list[_Seq], chunk_lens: list[int],
                     mixed: bool = False) -> None:
        """Per-traced-pick `engine.prefill.chunk` stage of this thread's
        last dispatch, spanning its host seconds (and its `compile` event
        when the dispatch was a first call). With tracing off every
        pick's trace is None: the scan allocates nothing."""
        if all(s.trace is None for s in picks):
            return
        trk = self._dispatch.trk
        end_ns = time.time_ns()
        start_ns = end_ns - int(trk.elapsed_s * 1e9)
        for i, s in enumerate(picks):
            if s.trace is not None:
                s.trace.stage(
                    "engine.prefill.chunk", start_ns, end_ns,
                    tokens=int(chunk_lens[i]), entry=trk.entry,
                    mixed=mixed, compiled=trk.compiled)
                if trk.compiled:
                    self._compile_event(s, trk)

    def _mark_decode_compile(self, batch: list[_Seq]) -> None:
        """Flag the lanes of this thread's last dispatch when it was a
        first call (graph capture included): their `engine.decode` span
        gets `compiled=true` and each traced lane a `compile` event, so
        the ITL outlier is attributable."""
        trk = self._dispatch.trk
        if not trk.compiled:
            return
        for s in batch:
            s.decode_compiled = True
            if s.trace is not None:
                self._compile_event(s, trk)

    @staticmethod
    def _compile_event(s: _Seq, trk) -> None:
        s.trace.event("compile", entry=trk.entry,
                      shape="x".join(str(x) for x in trk.shape),
                      seconds=round(trk.elapsed_s, 4))

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

        def land(out):
            packed, ch_logits = out
            if picks:
                ch_logits = ch_logits.clone()
            return _host(packed), ch_logits             # ONE host sync

        # work is the total-token bucket: padding is the bucket's tail
        # plus the decode block's empty slots
        out = self._graphed(
            "ragged_step", (tb, tk), step,
            (toks, poss, pages, offs, valid, lanes, lane_tables, ch_rows,
             d_rows, seeds, steps, temps, top_ps, top_ks),
            (sum(chunk_lens) + len(batch), tb, len(picks) + len(batch),
             len(batch), len(batch)),
            hist=self.metrics.prefill_chunk if picks else None, land=land)
        self.rounds += 1
        self._trace_chunk(picks, chunk_lens, mixed=bool(batch))
        self._mark_decode_compile(batch)
        return out

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
            if seq.trace is not None:
                seq.t_first_ns = time.time_ns()
                if seq.t_admit_ns:
                    seq.trace.stage("engine.prefill", seq.t_admit_ns,
                                    seq.t_first_ns,
                                    prompt_tokens=len(seq.prompt),
                                    cached_len=seq.cached_len)
                seq.trace.event("first_token")
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
        if self.tenant_metrics is not None and seq.tenant is not None:
            self.tenant_metrics.goodput.inc(n_emit, tenant=seq.tenant)
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
        if seq.trace is not None:
            end_ns = time.time_ns()
            if seq.t_first_ns:
                seq.trace.stage("engine.decode", seq.t_first_ns, end_ns,
                                tokens=seq.generated,
                                compiled=seq.decode_compiled)
            seq.trace.end(
                status="OK" if reason in (FINISH_STOP, FINISH_LENGTH)
                else "ERROR",
                finish_reason=reason, tokens=seq.generated)
        seq.finished = True
        if seq in self._running:
            self._running.remove(seq)
        if seq in self._waiting:
            self._waiting.remove(seq)
        if release_pages:
            self._release(seq.pages)
        seq.pages = []
        if self.tenant_metrics is not None and seq.tenant is not None:
            self.tenant_metrics.kv_blocks.set(
                self._tenant_pages(seq.tenant), tenant=seq.tenant)
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
        n = len(page_ids)
        with self._kv_buffer_lock:
            return self._tracked(
                "gather_kv", (n,),
                lambda: kernels.paged_kv_gather(self.k_cache, self.v_cache,
                                                ids, self._cache_ptrs),
                (0, 0, n, 0, 0))

    def _staging(self, name: str, shape: tuple, dtype: torch.dtype,
                 pinned: bool) -> torch.Tensor:
        """A view of the reused buffer `name` with this shape: pinned
        host memory or the engine's device, grown (to the next power of
        two of bytes) only when a batch outgrows it. Call under
        `_kv_buffer_lock`, never while a CUDA graph captures: the engine
        allocates only from its scheduler's own iteration, outside any
        capture."""
        nbytes = dtype.itemsize
        for d in shape:
            nbytes *= d
        buf = self._kv_staging.get(name)
        if buf is None or buf.numel() < nbytes:
            size = 1 << max(nbytes - 1, 1).bit_length()
            buf = (torch.empty(size, dtype=torch.uint8, pin_memory=True)
                   if pinned else
                   torch.empty(size, dtype=torch.uint8, device=self.device))
            self._kv_staging[name] = buf
        return buf[:nbytes].view(dtype).view(shape)

    def _read_kv_pages_sync(self, page_ids: list[int]) -> list[torch.Tensor]:
        """KVBM's offload read: each page as its own host tensor (2, L,
        KVH, P, D) [k; v] that owns its storage, the tier format. On the
        card, on the engine's stream (behind every step that wrote the
        pages): one gather launch, one copy into the reused device buffer
        "offload_dev" in block order (n, 2, L, KVH, P, D), one copy to the
        reused pinned "offload" buffer; then a wait for that copy and one
        contiguous host copy per block. Each stage's time goes to
        `metrics.kvbm_stage`. Blocks the caller: the inline offload stalls
        admission for it."""
        mcfg = self.model_cfg
        n = len(page_ids)
        shape = (n, 2, mcfg.num_layers, mcfg.num_kv_heads, mcfg.page_size,
                 mcfg.head_dim)
        stage = self.metrics.kvbm_stage
        with torch.inference_mode(), self._kv_buffer_lock:
            t0 = time.perf_counter()
            events = None
            if self.device.type == "cuda":
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(3)]
                events[0].record()
            got = self._gather_kv_pages(page_ids).permute(3, 0, 1, 2, 4, 5)
            if events is not None:
                dev = self._staging("offload_dev", shape, got.dtype,
                                    pinned=False)
                dev.copy_(got)
                events[1].record()
                host = self._staging("offload", shape, got.dtype,
                                     pinned=True)
                host.copy_(dev, non_blocking=True)
                events[2].record()
                events[2].synchronize()
                stage["offload_gather"].observe(
                    events[0].elapsed_time(events[1]) / 1e3)
                stage["offload_copy"].observe(
                    events[1].elapsed_time(events[2]) / 1e3)
            else:
                host = got
                stage["offload_gather"].observe(time.perf_counter() - t0)
            t0 = time.perf_counter()
            blocks = [host[i].clone(memory_format=torch.contiguous_format)
                      for i in range(n)]
            stage["offload_split"].observe(time.perf_counter() - t0)
            return blocks

    def write_kv_blocks(self, page_ids: list[int],
                        blocks: list[torch.Tensor]) -> None:
        """KVBM's onboard write: store host blocks (2, L, KVH, P, D) as
        pages `page_ids`. On the card the blocks are stacked into the
        reused pinned "onboard" buffer (n, 2, L, KVH, P, D), copied to the
        card in one copy on the engine's stream and written by K3, one
        launch per layer reading each layer's K and V blocks by their
        strides; the pinned buffer is reused once the previous onboard has
        left it. Each stage's time goes to `metrics.kvbm_stage` (the
        copy's and K3's once they have run: `_settle_onboard`). Call on
        the scheduler's thread or under the device lock."""
        mcfg = self.model_cfg
        n = len(blocks)
        shape = (n, 2, mcfg.num_layers, mcfg.num_kv_heads, mcfg.page_size,
                 mcfg.head_dim)
        dtype = self.k_cache[0].dtype
        cuda = self.device.type == "cuda"
        stage = self.metrics.kvbm_stage
        with torch.inference_mode(), self._kv_buffer_lock:
            self._settle_onboard()
            t0 = time.perf_counter()
            host = self._staging("onboard", shape, dtype, pinned=cuda)
            torch.stack([b.to(dtype) for b in blocks], out=host)
            stage["onboard_stack"].observe(time.perf_counter() - t0)
            ids = self._dev(np.asarray(page_ids, dtype=np.int32))
            events = None
            if cuda:
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(3)]
                events[0].record()
                data = self._staging("onboard_dev", shape, dtype,
                                     pinned=False)
                data.copy_(host, non_blocking=True)
                events[1].record()
            else:
                data = host
            t0 = time.perf_counter()

            def write():
                for l in range(mcfg.num_layers):
                    kernels.paged_kv_write_pages(
                        self.k_cache[l], self.v_cache[l], data[:, 0, l],
                        data[:, 1, l], ids)
            self._tracked("write_kv", (n,), write, (0, 0, n, 0, 0))
            if cuda:
                events[2].record()
                self._onboard_events = events
            else:
                stage["onboard_write"].observe(time.perf_counter() - t0)

    def _settle_onboard(self) -> None:
        """Wait for the last onboard's copy and K3 launches to finish (its
        pinned buffer is free after) and observe their device times."""
        with self._kv_buffer_lock:
            events, self._onboard_events = self._onboard_events, None
            if events is None:
                return
            events[2].synchronize()
            stage = self.metrics.kvbm_stage
            stage["onboard_copy"].observe(
                events[0].elapsed_time(events[1]) / 1e3)
            stage["onboard_write"].observe(
                events[1].elapsed_time(events[2]) / 1e3)

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
        n = len(page_ids)

        def write():
            for l in range(self.model_cfg.num_layers):
                kernels.paged_kv_write_pages(
                    self.k_cache[l], self.v_cache[l],
                    data[0, l].permute(1, 0, 2, 3),
                    data[1, l].permute(1, 0, 2, 3), ids)
        with self._kv_buffer_lock:
            self._tracked("write_kv", (n,), write, (0, 0, n, 0, 0))

    def _publish_metrics(self) -> None:
        """One ForwardPassMetrics to `metrics_sink` (the reference's
        `_publish_metrics`, `:3343`): slots, queue depth and KV blocks for
        the router's load view, the scheduler counters for the planner."""
        if self.metrics_sink is None:
            return
        perf = self.perf
        sched_stats = {
            "prefill_chunks": perf["prefill_chunks"],
            "decode_steps_during_prefill":
                perf["decode_steps_during_prefill"],
            "mixed_steps": perf["mixed_steps"],
            "itl_p50_ms": itl_percentile(perf["itl_hist"], 0.5),
            "itl_p99_ms": itl_percentile(perf["itl_hist"], 0.99),
            # the median admitted request's blocking work (KVBM's inline
            # offloads and onboard; 0.0 without KVBM), where the reference
            # publishes the running sum (perf["admission_stall_ms"] here)
            "admission_stall_ms": round(
                self.metrics.admission_stall.quantile(0.5) * 1e3, 3),
            "compiles": self.compile_tracker.total,
        }
        rec = self.step_recorder
        if rec is not None:
            # extra keys only while the recorder is armed (the
            # reference's `:3358`)
            s = rec.summary()
            sched_stats["goodput_tokens"] = s["totals"]["good_tokens"]
            sched_stats["padded_tokens"] = s["totals"]["padded_tokens"]
            sched_stats["padded_pct"] = round(s["totals"]["padded_pct"], 3)
            sched_stats["dispatch_gap_mean_ms"] = round(
                s["dispatch_gap"]["mean_s"] * 1e3, 4)
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
            spec_decode_stats=self._spec_stats,
            scheduler_stats=sched_stats))

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
        if seq.trace is not None:
            seq.trace.event("preempted", generated=seq.generated)
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
