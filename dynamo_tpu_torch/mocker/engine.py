"""MockEngine: continuous-batching scheduler simulation over MockKvManager.

Port of `dynamo_tpu/mocker/engine.py` (the port keeps its own copy):
watermark-gated admission, the prefill cost model, per-iteration decode,
preemption of the newest request under KV pressure, cancellation and the
deadline admission drop, and publication of real KV events and
ForwardPassMetrics. It takes `PreprocessedRequest` dicts and streams
`EngineOutput` dicts, the engine contract of `TorchEngine`, so everything
above the engine boundary runs for real with no device: the mocker
creates no CUDA context and allocates nothing on a card.

It arms the planes the port has, as the reference's mocker does: the step
recorder (`DYN_STEP_PROFILE`, with `_pow2` / `_ragged_bucket` as the
bucketing model), the KV lifecycle recorder (`DYN_KV_LIFECYCLE`), the
memory ledger over its analytic `memory_stats()` (`DYN_MEM_LEDGER`) and
the fault injector's `on_dispatch` (`dispatch_wedge`, and `oom`, which
exits rc 45 under `DYN_OOM_EXIT`), and the tenancy and serving-class
planes (`DYN_TENANCY`, `DYN_CLASSES`): the same fair-share admission
over tenant heads, per-tenant KV budgets and `dynamo_tenant_*` series
as `TorchEngine`, with `spec_shrink` carried inertly (the mock has no
draft). The mesh plane is refused at construction (`runtime/planes.py`).

Reference: `lib/llm/src/mocker/{engine.rs,scheduler.rs}`.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable, Optional

from dynamo_tpu_torch.engine.metrics import EngineMetrics
from dynamo_tpu_torch.engine.profiler import recorder_from_env
from dynamo_tpu_torch.mocker.kv_manager import MockKvManager
from dynamo_tpu_torch.protocols import (
    DEADLINE_ADMIT_ERR,
    FINISH_CANCELLED,
    FINISH_ERROR,
    FINISH_LENGTH,
    FINISH_STOP,
    EngineOutput,
    ForwardPassMetrics,
    KvCacheEvent,
    KvStats,
    PreprocessedRequest,
    WorkerStats,
)
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


def _pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1) — the mocker's stand-in for
    the real engine's shape bucketing, so padded-lane/padded-token math
    is analytically checkable device-free (tests/test_torch_mocker.py
    recomputes it from the scripted batch mix)."""
    p = 1
    n = max(n, 1)
    while p < n:
        p <<= 1
    return p


def _ragged_bucket(n: int, lo: int = 16) -> int:
    """Total-token bucket for the mock ragged path — the same family as
    the reference TpuEngine's _ragged_bucket (pow2 below `lo` so decode-tail rounds
    match the legacy width axis, then the {lo*2^k, lo*3*2^(k-1)} ladder
    with no page alignment or chunk cap), so the perf gate's
    padded-token delta between the legacy rectangles and the ragged
    flat dispatch is analytically recomputable, like _pow2 is for the
    legacy model."""
    n = max(n, 1)
    if n < lo:
        return _pow2(n)
    b = lo
    while b < n:
        mid = b + b // 2
        if n <= mid:
            return mid
        b *= 2
    return b


@dataclass
class MockEngineConfig:
    total_kv_blocks: int = 1024
    block_size: int = 16
    max_batch_size: int = 64
    watermark: float = 0.95          # admission cap on active-block usage
    prefill_us_per_token: float = 20.0
    decode_ms_per_iter: float = 4.0
    speedup: float = 1.0             # >1 = run faster than "real" time
    worker_id: int = 0
    dp_rank: int = 0
    default_max_tokens: int = 16
    vocab_size: int = 32000
    # analytic device-memory model (engine/memory.py MemoryLedger): the mock
    # "device" is a closed-form byte budget so every ledger number —
    # classes, workspace, residual, headroom — is exactly recomputable
    # in tests, the same way _pow2 makes padding math checkable.
    hbm_bytes: int = 16 << 30
    weights_bytes: int = 4 << 30
    kv_block_bytes: int = 1 << 20
    workspace_bytes_per_token: int = 4096
    unattributed_bytes: int = 0      # deliberate residual for tests
    # bounded admission skip-ahead (TorchEngineConfig.admit_lookahead):
    # 0 = exact head-only order; ignored when DYN_TENANCY arms fair share
    admit_lookahead: int = 0
    # ragged attention cost model (engine/ragged.py analog): steps record
    # the flat-token `ragged_step` entry — work is the total-token bucket
    # (_ragged_bucket), not a pow2 rectangle — so the step recorder
    # credits the padded-token delta deterministically
    ragged: bool = False


@dataclass
class _MockRequest:
    req: PreprocessedRequest
    ctx: Context
    queue: asyncio.Queue
    seq: TokenBlockSequence
    generated: int = 0
    prefilled: bool = False
    arrival: int = 0
    # lifecycle trace — None when DYN_TRACE is off, so every scheduler
    # touch is a guarded attribute read (same contract as TorchEngine)
    trace: Optional[RequestTrace] = None
    t_enqueue_ns: int = 0
    t_admit_ns: int = 0
    t_first_ns: int = 0
    t_last_ns: int = 0
    # resolved tenant / class names when DYN_TENANCY / DYN_CLASSES are
    # armed, else None (TorchEngine's _Seq contract)
    tenant: Optional[str] = None
    cls: Optional[str] = None

    @property
    def max_tokens(self) -> int:
        return self.req.stop.max_tokens or 0


class MockEngine:
    """AsyncEngine: PreprocessedRequest dict in → EngineOutput dict stream."""

    def __init__(self, config: Optional[MockEngineConfig] = None,
                 event_sink: Optional[Callable[[KvCacheEvent], None]] = None,
                 metrics_sink: Optional[Callable[[ForwardPassMetrics], None]]
                 = None) -> None:
        refuse_unported_planes("MockEngine")
        self.config = config or MockEngineConfig()
        self.kv = MockKvManager(
            self.config.total_kv_blocks, self.config.block_size,
            self.config.worker_id, self.config.dp_rank, event_sink,
        )
        self.metrics_sink = metrics_sink
        # same one-source-of-truth metrics surface as TorchEngine, so a
        # mocker deployment's /metrics matches the real worker's
        self.metrics = EngineMetrics()
        # step flight recorder parity with TorchEngine (engine/profiler.py):
        # None unless DYN_STEP_PROFILE — the simulated prefill/decode
        # steps record the same goodput/padding attribution the real
        # dispatch sites do, with _pow2 as the bucketing model
        self.step_recorder = recorder_from_env(self.metrics)
        # runtime-resizable bucket rungs (engine/bucketing.py): the
        # flight-control bucket autotuner (control/controllers.py)
        # installs one; None keeps the static _pow2 bucketing
        self.bucket_ladder = None
        # controller-facing ragged signal (the engines' ragged_active)
        self.ragged_active = self.config.ragged
        # KV lifecycle flight recorder parity (kvbm/lifecycle.py): the
        # mock block pools record the same allocate/hit/evict/kv_event
        # transitions, so the lifecycle math is analytically checkable
        # device-free. None unless DYN_KV_LIFECYCLE.
        from dynamo_tpu_torch.kvbm.lifecycle import KvbmMetrics
        from dynamo_tpu_torch.kvbm.lifecycle import \
            recorder_from_env as kv_recorder_from_env
        self.kv_metrics = KvbmMetrics()
        self.kv_lifecycle = kv_recorder_from_env(self.kv_metrics)
        self.kv.lifecycle = self.kv_lifecycle
        # tenancy and serving-class parity with TorchEngine: None unless
        # DYN_TENANCY / DYN_CLASSES, then the same fair-share admission
        # and per-tenant budgets; spec_shrink is carried inertly (no
        # draft model) so brownout sees the same surface on mock fleets
        self.tenancy = tenancy_from_env()
        self.fair = None
        self.tenant_metrics = None
        if self.tenancy is not None:
            self.fair = FairScheduler(self.tenancy)
            self.tenant_metrics = TenantMetrics()
        self.classes = classes_from_env()
        self.spec_shrink = False
        if self.classes is not None and self.fair is not None:
            self.fair.classes = self.classes
        self._waiting: list[_MockRequest] = []
        self._running: list[_MockRequest] = []
        self._arrivals = 0
        self._loop_task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self._stopped = False
        self._progress = 0  # scheduler forward-progress token (canary)
        # seeded chaos seam (runtime/faults.py kind=dispatch_wedge): the
        # scheduler loop consults this once per iteration and parks when
        # a wedge rule fires — the device-free model of a dispatch that
        # never returns, for the dispatch watchdog to catch.
        # None (the default, no DYN_FAULTS) costs one attribute check.
        self.fault_injector = FaultInjector.from_env()
        # Memory ledger parity (engine/memory.py): None unless
        # DYN_MEM_LEDGER. The mock engine IS its own "device" — its
        # memory_stats() below is the analytic model the ledger
        # reconciles against, so attribution/residual math is
        # device-free testable.
        from dynamo_tpu_torch.engine.memory import (
            MemoryMetrics,
            ledger_from_env,
        )
        self.memory_metrics = MemoryMetrics()
        self.memory_ledger = ledger_from_env(self.memory_metrics,
                                             device=self)
        self._oom = False
        self._peak_bytes = 0
        if self.memory_ledger is not None:
            cfg = self.config
            self.memory_ledger.set_class(
                "weights", cfg.weights_bytes,
                source="MockEngineConfig.weights_bytes (analytic)")
            self.memory_ledger.set_class(
                "kv_pool", cfg.total_kv_blocks * cfg.kv_block_bytes,
                source="total_kv_blocks * kv_block_bytes (analytic)")

    def attach_sinks(self, event_sink: Optional[
                         Callable[[KvCacheEvent], None]],
                     metrics_sink: Optional[
                         Callable[[ForwardPassMetrics], None]]) -> None:
        """Set where the KV events and ForwardPassMetrics go (the worker
        wires them once the runtime's event bus exists, as for
        TorchEngine)."""
        self.kv.event_sink = event_sink
        self.metrics_sink = metrics_sink

    def memory_stats(self) -> dict:
        """The analytic stand-in for the device's memory stats:
        in-use = every class the ledger books plus the configured
        deliberate residual — so a test can assert the ledger's
        unattributed_bytes equals cfg.unattributed_bytes EXACTLY."""
        cfg = self.config
        led = self.memory_ledger
        ws = led.workspace_total() if led is not None else 0
        in_use = (cfg.weights_bytes
                  + cfg.total_kv_blocks * cfg.kv_block_bytes
                  + ws + cfg.unattributed_bytes)
        self._peak_bytes = max(self._peak_bytes, in_use)
        return {"bytes_in_use": in_use, "bytes_limit": cfg.hbm_bytes,
                "peak_bytes_in_use": self._peak_bytes}

    # -- engine contract ---------------------------------------------------

    async def generate(self, request: dict, context: Context
                       ) -> AsyncIterator[dict]:
        req = PreprocessedRequest.from_dict(request)
        if req.extra.get("embed"):
            # deterministic unit-norm vector from the token ids, so tests
            # can assert same-input ⇒ same-embedding across workers
            import hashlib
            import math as _math

            dim = 64
            seed = hashlib.blake2b(
                ",".join(map(str, req.token_ids)).encode(),
                digest_size=16).digest()
            vals = []
            for i in range(dim):
                h = hashlib.blake2b(seed + i.to_bytes(2, "big"),
                                    digest_size=4).digest()
                vals.append(int.from_bytes(h, "big") / 2**31 - 1.0)
            norm = _math.sqrt(sum(v * v for v in vals)) or 1.0
            yield {"embedding": [v / norm for v in vals],
                   "token_ids": [], "finish_reason": "stop"}
            return
        if req.stop.max_tokens is None:
            req.stop.max_tokens = self.config.default_max_tokens
        prompt_blocks = len(req.token_ids) // self.config.block_size
        if prompt_blocks > self.config.total_kv_blocks:
            yield EngineOutput(
                token_ids=[], finish_reason=FINISH_ERROR,
                extra={"error": "prompt exceeds KV capacity"},
            ).to_dict()
            return
        attrs = {"request.id": context.request_id,
                 "engine.worker_id": self.config.worker_id,
                 "engine.kind": "mocker"}
        tenant = None
        if self.tenancy is not None:
            tenant = self.tenancy.tenant_of(
                getattr(context, "headers", None))
            attrs["tenant"] = tenant
        cls = None
        if self.classes is not None:
            cls = self.classes.class_of(
                getattr(context, "headers", None))
            attrs["class"] = cls
        trace = RequestTrace.begin(
            "engine.request", getattr(context, "headers", None), attrs)
        mreq = _MockRequest(
            req=req, ctx=context, queue=asyncio.Queue(),
            seq=TokenBlockSequence(self.config.block_size, req.token_ids),
            arrival=self._arrivals,
            trace=trace, t_enqueue_ns=time.time_ns(),
            tenant=tenant,
            cls=cls,
        )
        self._arrivals += 1
        if trace is not None:
            trace.event("enqueued", waiting=len(self._waiting),
                        running=len(self._running),
                        prompt_tokens=len(req.token_ids))
        self._ensure_loop()
        self._waiting.append(mreq)
        self._wake.set()
        while True:
            out = await mreq.queue.get()
            if out is None:
                return
            yield out
            if out.get("finish_reason"):
                return

    # -- scheduler loop ----------------------------------------------------

    def _ensure_loop(self) -> None:
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.get_running_loop().create_task(
                self._scheduler_loop())

    async def _sleep(self, seconds: float) -> None:
        await asyncio.sleep(seconds / self.config.speedup)

    async def _scheduler_loop(self) -> None:
        while not self._stopped:
            if not self._waiting and not self._running:
                self._wake.clear()
                await self._wake.wait()
                continue
            lad = self.bucket_ladder
            if lad is not None:
                # safe point: between dispatches, before this iteration's
                # bucketing math runs
                lad.maybe_apply()
            inj = self.fault_injector
            if inj is not None:
                action = inj.on_dispatch(
                    f"dispatch.{self.config.worker_id}")
                if action is not None and action[0] == "oom":
                    # injected OOM: the device-free model of a
                    # dispatch dying with RESOURCE_EXHAUSTED — runs the
                    # same forensic path the real engine's scheduler
                    # loop does (crash file, engine._oom, rc 45 when
                    # DYN_OOM_EXIT is armed), errors out in-flight
                    # streams, then kills the loop task so the
                    # supervisor's task-mode _death_cause fires
                    exc = RuntimeError(OOM_ERROR)
                    from dynamo_tpu_torch.engine.memory import record_oom

                    if self.memory_ledger is not None:
                        record_oom(self, exc)
                    self._fail_all(exc)
                    raise exc
                if action is not None:
                    # injected wedge: park with work pending, exactly
                    # like a hung device dispatch; only close()
                    # (cancel) frees us, so recovery MUST come from
                    # watchdog → quarantine
                    logger.error("[fault] dispatch wedge: scheduler "
                                 "parked with %d running / %d waiting",
                                 len(self._running), len(self._waiting))
                    await asyncio.Event().wait()
            self._admit()
            progressed = await self._prefill_new()
            progressed |= await self._decode_iter()
            self._publish_metrics()
            if progressed:
                self._progress += 1
            if not progressed:
                # Nothing runnable (e.g. head-of-line request waiting for KV
                # space): yield the event loop instead of spinning.
                await asyncio.sleep(0.001 / self.config.speedup)

    def _admission_order(self) -> list[int]:
        """Candidate indexes for one admission round (TorchEngine's
        `_admission_order` contract): head-only, a bounded skip-ahead
        when admit_lookahead > 0, per-tenant heads by weighted deficit
        when DYN_TENANCY arms the fair scheduler."""
        if self.fair is not None:
            return self.fair.candidate_indexes(
                [r.tenant for r in self._waiting])
        la = self.config.admit_lookahead
        if la > 0:
            return list(range(min(la + 1, len(self._waiting))))
        return [0]

    def _tenant_blocks(self, tenant: Optional[str]) -> int:
        """KV blocks the tenant's running sequences hold."""
        return sum(len(r.seq.seq_hashes()) for r in self._running
                   if r.tenant == tenant)

    def _admit_one(self) -> bool:
        cfg = self.config
        for idx in self._admission_order():
            cand = self._waiting[idx]
            if cand.ctx.is_cancelled():
                self._waiting.pop(idx)
                if cand.trace is not None:
                    cand.trace.end(status="ERROR",
                                   finish_reason=FINISH_CANCELLED)
                cand.queue.put_nowait(EngineOutput(
                    token_ids=[], finish_reason=FINISH_CANCELLED).to_dict())
                cand.queue.put_nowait(None)
                return True
            # deadline already blown while queued: drop before prefill
            # with the distinct in-band error (the engines' _admit_one
            # parity) — no ConnectionError, so breaker/replay never fire
            deadline = cand.ctx.deadline
            if deadline is not None \
                    and asyncio.get_running_loop().time() >= deadline:
                self._waiting.pop(idx)
                if cand.trace is not None:
                    cand.trace.end(status="ERROR",
                                   finish_reason=FINISH_ERROR)
                cand.queue.put_nowait(EngineOutput(
                    token_ids=[], finish_reason=FINISH_ERROR,
                    extra={"error": DEADLINE_ADMIT_ERR}).to_dict())
                cand.queue.put_nowait(None)
                return True
            new_active = self.kv.blocks_to_activate(cand.seq)
            if self.fair is not None:
                budget = self.tenancy.get(cand.tenant).kv_block_budget
                if (budget > 0 and self._running
                        and self._tenant_blocks(cand.tenant) + new_active
                        > budget):
                    continue  # tenant at its KV budget this round
            if (self.kv.active_blocks + new_active
                    > cfg.watermark * cfg.total_kv_blocks
                    and self._running):
                continue  # watermark: wait for space unless batch is empty
            if not self.kv.can_allocate(new_active):
                continue
            self._waiting.pop(idx)
            self._running.append(cand)
            now_ns = time.time_ns()
            if not cand.t_admit_ns:  # re-admits after preempt: events only
                wait_s = (now_ns - cand.t_enqueue_ns) / 1e9
                self.metrics.queue_wait.observe(wait_s)
                tm = self.tenant_metrics
                if tm is not None and cand.tenant is not None:
                    tm.observe_queue_wait(cand.tenant, wait_s)
                if cand.trace is not None:
                    cand.trace.stage("engine.queue_wait", cand.t_enqueue_ns,
                                     now_ns,
                                     prompt_tokens=len(cand.req.token_ids))
            if self.fair is not None:
                self.fair.on_admit(
                    cand.tenant,
                    len(cand.req.token_ids) + cand.max_tokens,
                    cls=cand.cls)
                tm = self.tenant_metrics
                if tm is not None and cand.tenant is not None:
                    # cand is already in _running, so this counts it
                    tm.kv_blocks.set(self._tenant_blocks(cand.tenant),
                                     tenant=cand.tenant)
            if cand.trace is not None:
                cand.trace.event("admitted", running=len(self._running))
            cand.t_admit_ns = now_ns
            return True
        return False

    def _admit(self) -> None:
        cfg = self.config
        while self._waiting and len(self._running) < cfg.max_batch_size:
            if not self._admit_one():
                break

    async def _prefill_new(self) -> bool:
        cfg = self.config
        progressed = False
        for r in [r for r in self._running if not r.prefilled]:
            cached = self.kv.prefix_match_blocks(r.seq)
            uncached_tokens = len(r.req.token_ids) - cached * cfg.block_size
            if not self.kv.allocate_sequence(r.seq):
                # cannot fit even after eviction: preempt or requeue
                self._preempt(r)
                continue
            good = max(uncached_tokens, 0)
            if cfg.ragged:
                entry, shape = "ragged_step", (_ragged_bucket(good),)
                bucket = shape[0]
            else:
                entry = "prefill"
                bucket = _pow2(good)
                if self.bucket_ladder is not None:
                    bucket = self.bucket_ladder.bucket_for(good, bucket)
                shape = (1, bucket)
            led = self.memory_ledger
            if led is not None:
                led.on_dispatch(
                    entry, shape,
                    nbytes=bucket * cfg.workspace_bytes_per_token)
            t0_ns = time.time_ns()
            await self._sleep(max(uncached_tokens, 0)
                              * cfg.prefill_us_per_token / 1e6)
            r.prefilled = True
            progressed = True
            end_ns = time.time_ns()
            self.metrics.prefill_chunk.observe((end_ns - t0_ns) / 1e9)
            rec = self.step_recorder
            if rec is not None:
                rec.record(entry, shape,
                           (end_ns - t0_ns) / 1e9, good_tokens=good,
                           work_tokens=bucket, lanes=1, width=1)
            if r.trace is not None:
                r.trace.stage("engine.prefill.chunk", t0_ns, end_ns,
                              tokens=max(uncached_tokens, 0),
                              cached_blocks=cached)
                r.trace.stage("engine.prefill", r.t_admit_ns or t0_ns,
                              end_ns,
                              prompt_tokens=len(r.req.token_ids),
                              cached_blocks=cached)
        return progressed

    async def _decode_iter(self) -> bool:
        cfg = self.config
        runnable = [r for r in self._running if r.prefilled]
        if not runnable:
            return False
        if cfg.ragged:
            d_entry = "ragged_step"
            d_shape = (_ragged_bucket(len(runnable)),)
            d_work = d_shape[0]
        else:
            d_entry = "decode_burst"
            w = _pow2(len(runnable))
            if self.bucket_ladder is not None:
                w = self.bucket_ladder.bucket_for(len(runnable), w)
            d_work = min(w, cfg.max_batch_size)
            d_shape = (d_work, 1)
        led = self.memory_ledger
        if led is not None:
            led.on_dispatch(d_entry, d_shape,
                            nbytes=d_work * cfg.workspace_bytes_per_token)
        t0_ns = time.time_ns()
        await self._sleep(cfg.decode_ms_per_iter / 1e3)
        step_ns = time.time_ns() - t0_ns
        emitted = 0
        for r in list(runnable):
            if r not in self._running or not r.prefilled:
                continue  # preempted earlier in this same iteration
            if r.ctx.is_cancelled():
                self._finish(r, FINISH_CANCELLED)
                continue
            token = self._next_token(r)
            block = r.seq.append(token)
            if block is not None:
                ok = self.kv.append_block(block.seq_hash, block.local_hash,
                                          block.parent_seq_hash)
                if not ok:
                    # KV pressure: preempt the newest other runnable request
                    # and retry; if still no room, preempt self — the token
                    # stands either way and its block is re-accounted at
                    # re-prefill (reference scheduler.rs preemption).
                    victims = [x for x in runnable
                               if x in self._running and x is not r]
                    if victims:
                        self._preempt(max(victims, key=lambda x: x.arrival))
                        ok = self.kv.append_block(
                            block.seq_hash, block.local_hash,
                            block.parent_seq_hash)
                    if not ok:
                        self._preempt(r)
            r.generated += 1
            now_ns = time.time_ns()
            if r.generated == 1:
                r.t_first_ns = now_ns
                self.metrics.ttft.observe((now_ns - r.t_enqueue_ns) / 1e9)
                if r.trace is not None:
                    r.trace.event("first_token")
            elif r.t_last_ns:
                self.metrics.itl.observe((now_ns - r.t_last_ns) / 1e6)
            r.t_last_ns = now_ns
            self.metrics.tokens_emitted.inc()
            if self.tenant_metrics is not None and r.tenant is not None:
                self.tenant_metrics.goodput.inc(tenant=r.tenant)
            emitted += 1
            finish = None
            if r.req.stop.stop_token_ids and token in r.req.stop.stop_token_ids:
                finish = FINISH_STOP
            elif r.generated >= r.max_tokens:
                finish = FINISH_LENGTH
            r.queue.put_nowait(EngineOutput(
                token_ids=[token], finish_reason=finish).to_dict())
            if finish is not None:
                self._finish(r, finish, emit=False)
        rec = self.step_recorder
        if rec is not None:
            # decode goodput == emitted tokens (make profile-smoke
            # asserts the two counters agree); work is the lane bucket
            # the real engine would have dispatched — a pow2 rectangle
            # on the legacy path, the flat total-token bucket on ragged
            rec.record(d_entry, d_shape, step_ns / 1e9,
                       good_tokens=emitted, work_tokens=d_work,
                       lanes=len(runnable), width=d_work,
                       tokens=emitted)
        return True

    def _next_token(self, r: _MockRequest) -> int:
        # Deterministic, checkable: echo prompt tokens then count upward.
        prompt = r.req.token_ids
        i = r.generated
        if i < len(prompt):
            return prompt[i]
        return (prompt[-1] + i) % self.config.vocab_size if prompt else i

    def _finish(self, r: _MockRequest, reason: str, emit: bool = True) -> None:
        if r.trace is not None:
            end_ns = time.time_ns()
            if r.t_first_ns:
                r.trace.stage("engine.decode", r.t_first_ns, end_ns,
                              tokens=r.generated)
            r.trace.end(
                status="OK" if reason in (FINISH_STOP, FINISH_LENGTH)
                else "ERROR",
                finish_reason=reason, tokens=r.generated)
        if r in self._running:
            self._running.remove(r)
        if r in self._waiting:  # finished in the same iter it was preempted
            self._waiting.remove(r)
        self.kv.free_sequence(r.seq.seq_hashes())
        if self.tenant_metrics is not None and r.tenant is not None:
            self.tenant_metrics.kv_blocks.set(
                self._tenant_blocks(r.tenant), tenant=r.tenant)
        if emit:
            r.queue.put_nowait(EngineOutput(
                token_ids=[], finish_reason=reason).to_dict())
        r.queue.put_nowait(None)

    def _fail_all(self, exc) -> None:
        """Error out every in-flight stream (TorchEngine._fail_all
        analog) so callers see FINISH_ERROR instead of hanging on a
        dead scheduler loop."""
        for r in self._running + self._waiting:
            if r.trace is not None:
                r.trace.end(status="ERROR", finish_reason=FINISH_ERROR)
            r.queue.put_nowait(EngineOutput(
                token_ids=[], finish_reason=FINISH_ERROR,
                extra={"error": str(exc)}).to_dict())
            r.queue.put_nowait(None)
        self._running.clear()
        self._waiting.clear()

    def _preempt(self, r: _MockRequest) -> None:
        """Push a running request back to the head of the waiting queue,
        releasing its blocks (reference scheduler.rs preemption)."""
        if r.trace is not None:
            r.trace.event("preempted", generated=r.generated)
        if r in self._running:
            self._running.remove(r)
        self.kv.free_sequence(r.seq.seq_hashes())
        r.prefilled = False
        # keep generated tokens: re-prefill includes them (seq already has them)
        self._waiting.insert(0, r)

    def _publish_metrics(self) -> None:
        if self.metrics_sink is None:
            return
        m = ForwardPassMetrics(
            worker_id=self.config.worker_id, dp_rank=self.config.dp_rank,
            worker_stats=WorkerStats(
                request_active_slots=len(self._running),
                request_total_slots=self.config.max_batch_size,
                num_requests_waiting=len(self._waiting),
            ),
            kv_stats=KvStats(
                kv_active_blocks=self.kv.active_blocks,
                kv_total_blocks=self.kv.total_blocks,
                hbm_cache_usage=self.kv.usage(),
            ),
        )
        rec = self.step_recorder
        if rec is not None:
            # same gated attribution block TorchEngine publishes; absent
            # (not zeroed) when the recorder is off
            s = rec.summary()
            m.scheduler_stats = {
                "goodput_tokens": s["totals"]["good_tokens"],
                "padded_tokens": s["totals"]["padded_tokens"],
                "padded_pct": round(s["totals"]["padded_pct"], 3),
                "dispatch_gap_mean_ms": round(
                    s["dispatch_gap"]["mean_s"] * 1e3, 4),
            }
        self.metrics_sink(m)

    def progress_token(self) -> int:
        """Scheduler forward-progress marker (see TorchEngine.progress_token)."""
        return self._progress

    def clear_kv_blocks(self) -> int:
        """Admin cache clear (clear_kv_blocks.rs analog): forget every
        inactive cached block; in-flight requests keep theirs."""
        n = len(self.kv._inactive)
        self.kv.clear()
        return n

    async def close(self) -> None:
        self._stopped = True
        self._wake.set()
        if self._loop_task is not None:
            self._loop_task.cancel()
