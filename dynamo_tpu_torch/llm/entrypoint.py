"""Entrypoints: build a serving engine + card, serve it, front it.

Port of `dynamo_tpu/llm/entrypoint.py`:
- `start_frontend` (`:65`): model discovery (`ModelWatcher`, with the KV
  router's config for `kv` cards) + the OpenAI HTTP service, the fleet
  telemetry collector behind `/fleet/status` (always on) with this
  process's own snapshot publisher when `telemetry_interval` > 0, and the
  SLO monitor fed by the HTTP service's TTFT/ITL samples when an
  objective is set (`:120-240`); with `DYN_CLASSES` the deadline gate's
  `AdmissionEstimator` and the `BrownoutMachine` over the late-bound
  engines, the per-class objectives (`ttft:<class>`, `itl:<class>`) and
  the brownout fed by the SLO loop's transitions (`:143-225`); with
  `DYN_CONTROL` the flight-control plane over the engines, the kv-mode
  routers and the brownout (`control_plane_from_env`, ticked every
  `DYN_CONTROL_INTERVAL_S`). The reference's gRPC frontend and
  breaker-event counter wait with their subsystems.
- `serve_engine` (`:263`) / `WorkerHandle` (`:245`): serve an engine on
  its card's endpoint, join the engine's metrics (`EngineMetrics` and its
  CUDA-graph counts) to the process's registry, serve the admin endpoints
  `clear_kv_blocks` and (with KVBM) `kvbm_controller` (`:335-369`),
  publish the card, and opt the generate endpoint into canary probes
  with a one-token greedy payload (`:325-334`; probed only when the
  runtime's health manager is on), and with `telemetry_interval` > 0
  publish the worker's MetricsSnapshot on the telemetry subject
  (`:371-383`); with `DYN_TENANCY` the engine-role `dynamo_tenant_*`
  series join the scrape (`:319-324`). The mesh surface waits.
- `wire_engine_events` (`:388`): the sinks that publish an engine's KV
  events and ForwardPassMetrics on the runtime's event bus, under the
  subjects the card's KV router consumes.
- `build_tpu_engine` (`:418-566`) as `build_torch_engine`: resolve the checkpoint, read its config.json,
load the weights through the port's own loader (or random-init them from
a seed), and fill the card so the pipeline builds the matching
tokenizer. The engine runs on `device` — "cuda" by default, which raises
when no card is present — on the phase path, or on the ragged path when
`DYN_ATTENTION_IMPL=ragged`, as the reference reads that variable
(`dynamo_tpu/engine/attention.py:36`). Guided decoding gets the serving
tokenizer's token-bytes map as a lazy provider and its EOS id
(`:508-545`). `kvbm_host_blocks` > 0 attaches a `KvbmManager` with the
pipeline knobs (`:546-554`). `draft_model` serves speculative decoding
with a second checkpoint at the target's page geometry (`:497-503`).
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Optional

from dynamo_tpu_torch.control.plane import control_plane_from_env
from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine import cuda_build
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.kvbm.lifecycle import tier_occupancy
from dynamo_tpu_torch.llm.guided import token_bytes_of
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.model_card import (
    ModelDeploymentCard,
    ModelRuntimeConfig,
    register_llm,
)
from dynamo_tpu_torch.llm.model_manager import (
    ModelManager,
    ModelWatcher,
    check_router_mode,
)
from dynamo_tpu_torch.llm.tokenizer import make_tokenizer
from dynamo_tpu_torch.router.kv_router import (
    KvRouterConfig,
    kv_events_subject,
    metrics_subject,
)
from dynamo_tpu_torch.models.loader import (
    config_from_hf,
    load_llama_params,
    resolve_model,
)
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.runtime.events import LocalEventBus
from dynamo_tpu_torch.runtime.slo import (
    SLO_EVENTS_SUBJECT,
    SloMonitor,
    SloObjective,
)
from dynamo_tpu_torch.runtime.telemetry import (
    TelemetryCollector,
    TelemetryPublisher,
    _publish_best_effort,
)
from dynamo_tpu_torch.serving_classes import (
    AdmissionEstimator,
    BrownoutMachine,
)

logger = logging.getLogger(__name__)

_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json",
                    "tokenizer.model")


@dataclass
class Frontend:
    runtime: DistributedRuntime
    manager: ModelManager
    watcher: ModelWatcher
    http: HttpService
    collector: object = None     # TelemetryCollector (fleet view)
    publisher: object = None     # TelemetryPublisher when interval > 0
    slo: object = None           # SloMonitor when objectives configured
    _slo_task: object = None
    control: object = None       # ControlPlane when DYN_CONTROL armed

    @property
    def url(self) -> str:
        return f"{self.http.scheme}://{self.http.host}:{self.http.port}"

    async def stop(self) -> None:
        if self._slo_task is not None:
            self._slo_task.cancel()
        if self.control is not None:
            await self.control.stop()
        if self.publisher is not None:
            await self.publisher.stop()
        if self.collector is not None:
            await self.collector.stop()
        await self.http.stop()
        await self.watcher.stop()
        await self.manager.close()


async def start_frontend(runtime: DistributedRuntime,
                         host: str = "127.0.0.1", port: int = 0,
                         router_mode_override: Optional[str] = None,
                         namespace: Optional[str] = None,
                         tls_cert: Optional[str] = None,
                         tls_key: Optional[str] = None,
                         request_template: Optional[dict] = None,
                         router_config: Optional[KvRouterConfig] = None
                         ) -> Frontend:
    """HTTP frontend: model discovery + OpenAI server (Input::Http).

    `router_mode_override` must be set before the watcher's initial MDC
    scan builds pipelines; `router_config` tunes every `kv` model's
    router (its block size is always the card's); `namespace` (if set)
    restricts discovery to cards in that namespace; `tls_cert`/`tls_key`
    serve HTTPS."""
    if router_mode_override is not None:
        check_router_mode(router_mode_override)
    manager = ModelManager(runtime, router_config)
    manager.router_mode_override = router_mode_override
    watcher = await ModelWatcher(manager, namespace=namespace).start()
    try:
        http = HttpService(manager, host, port, tls_cert=tls_cert,
                           tls_key=tls_key,
                           request_template=request_template)
        await http.start()
    except BaseException:
        await watcher.stop()
        await manager.close()
        raise
    # the /debug routes read the engines `serve_engine` registered on this
    # runtime (late-bound: an in-process worker may start after the
    # frontend; a frontend-only process lists none)
    def engines_supplier() -> list:
        return list(getattr(runtime, "profile_engines", []))

    http.profile_engines = engines_supplier
    # Fleet telemetry plane: the frontend always runs the collector (a
    # passive event-plane subscription serving /fleet/status); publishing
    # its own snapshot and the SLO monitor are opt-in via config
    cfg = runtime.config
    collector = TelemetryCollector(runtime.events)
    await collector.start()
    # serving classes (DYN_CLASSES, parsed by HttpService): the deadline
    # gate's estimator over the live engines' histograms and, when the
    # config arms it, the brownout machine, fed by the SLO loop below and
    # walked back by the control plane's tick (when attached there) or
    # by the SLO loop itself
    brownout = None
    classes_cfg = http.classes
    if classes_cfg is not None:
        http.admission = AdmissionEstimator(
            engines_supplier, classes_cfg.admission_quantile)
        if classes_cfg.brownout:
            brownout = BrownoutMachine(
                classes_cfg, engines=engines_supplier,
                bus=runtime.events, metrics=http.class_metrics,
                clock=time.time)
            http.brownout = brownout
    # flight control (DYN_CONTROL): None when unset; armed, the plane
    # observes what this process reaches: the in-process engines, the
    # kv-mode routers and the brownout machine (a planner's forecast
    # controller is attached by whoever owns the planner). The plane
    # ticks the machine at its own `now`, so both run on one clock:
    # the machine's SLO-event stamps and the plane's tick stamps are
    # then comparable, and recover_s and hold_s hold across the two.
    control = control_plane_from_env(
        runtime, engines=engines_supplier,
        routers=lambda: manager.kv_routers(), brownout=brownout,
        now=time.time)
    if control is not None:
        control.start()
        http.control_plane = control
    brownout_on_plane = (control is not None and brownout is not None
                         and brownout in control.controllers)
    slo = slo_task = None
    objectives = []
    if cfg.slo_ttft > 0:
        objectives.append(SloObjective(
            "ttft", cfg.slo_ttft, cfg.slo_target_ratio))
    if cfg.slo_itl > 0:
        objectives.append(SloObjective(
            "itl", cfg.slo_itl, cfg.slo_target_ratio))
    if classes_cfg is not None:
        # per-class objectives, fed by the HTTP path's per-class samples,
        # so the brownout can fire on one class's burn while the global
        # windows look healthy
        for name, c in sorted(classes_cfg.classes.items()):
            if c.ttft_objective_s > 0:
                objectives.append(SloObjective(
                    f"ttft:{name}", c.ttft_objective_s,
                    cfg.slo_target_ratio))
            if c.itl_objective_s > 0:
                objectives.append(SloObjective(
                    f"itl:{name}", c.itl_objective_s,
                    cfg.slo_target_ratio))
    if objectives:
        slo = SloMonitor(objectives,
                         fast_window=cfg.slo_fast_window,
                         slow_window=cfg.slo_slow_window,
                         fast_burn=cfg.slo_fast_burn,
                         slow_burn=cfg.slo_slow_burn)
        slo.register(runtime.metrics)
        http.slo = slo

        async def _slo_loop() -> None:
            while True:
                await asyncio.sleep(cfg.slo_check_interval)
                for ev in slo.evaluate():
                    _publish_best_effort(runtime.events,
                                         SLO_EVENTS_SUBJECT, ev)
                    if brownout is not None:
                        brownout.on_slo_event(ev)
                if brownout is not None and not brownout_on_plane:
                    brownout.tick()

        slo_task = asyncio.get_running_loop().create_task(_slo_loop())
    http.fleet_status_provider = lambda: collector.fleet_status(
        slo=slo,
        control=(control.summary if control is not None else None),
        brownout=(brownout.state if brownout is not None else None))
    publisher = None
    if cfg.telemetry_interval > 0:
        publisher = TelemetryPublisher(
            runtime.events, runtime.metrics, component="frontend",
            instance=f"{http.host}:{http.port}", role="frontend",
            interval=cfg.telemetry_interval)
        publisher.start()
    return Frontend(runtime, manager, watcher, http, collector, publisher,
                    slo, slo_task, control)


@dataclass
class WorkerHandle:
    runtime: DistributedRuntime
    card: ModelDeploymentCard
    served: object
    admin: list = field(default_factory=list)   # the admin endpoints
    publisher: object = None     # TelemetryPublisher when interval > 0

    async def stop(self) -> None:
        if self.publisher is not None:
            await self.publisher.stop()
        for served in self.admin:
            await served.shutdown()
        await self.served.shutdown()


def register_engine_metrics(runtime: DistributedRuntime, engine) -> None:
    """Join an engine's own metrics to the process's scrape: its
    `EngineMetrics` (the `dynamo_engine_*` series and the compile
    tracker's `dynamo_compile_*`), its `KvbmMetrics` (`dynamo_kv_lifecycle_*`,
    `dynamo_kvbm_tier_*`), its `MemoryMetrics` (`dynamo_memory_*`; an
    armed ledger polls at every scrape), its CUDA-graph captures, replays and
    pool bytes, the process's kernel launch counts (one source of
    truth, no second bookkeeping path), and with `DYN_TENANCY` its
    engine-role `dynamo_tenant_*` series. Engines without them are
    skipped."""
    metrics = getattr(engine, "metrics", None)
    if metrics is not None:
        metrics.register(runtime.metrics)
    tm = getattr(engine, "tenant_metrics", None)
    if tm is not None:
        tm.register(runtime.metrics, role="engine")
    # the KV lifecycle counters and the per-tier occupancy gauges
    # (refreshed per scrape; the recorder stays None unless armed)
    km = getattr(engine, "kv_metrics", None)
    if km is not None:
        km.register(runtime.metrics,
                    occupancy=lambda eng=engine: tier_occupancy(eng))
    mm = getattr(engine, "memory_metrics", None)
    if mm is not None:
        mm.register(runtime.metrics,
                    ledger=getattr(engine, "memory_ledger", None))
    graphs = getattr(engine, "graphs", None)
    if graphs is None:
        return
    g = runtime.metrics.gauge(
        "engine_cuda_graphs",
        "the engine's CUDA graphs: captures, replays and pool bytes")
    launches = runtime.metrics.gauge(
        "engine_kernel_launches",
        "hand-written kernel launches in this process, graph replays "
        "included (engine/cuda_build.py)")

    def sync() -> None:
        g.set(graphs.captures, kind="captures")
        g.set(graphs.replays, kind="replays")
        g.set(graphs.pool_bytes(), kind="pool_bytes")
        for name, n in cuda_build.launch_counts().items():
            launches.set(n, kernel=name)

    runtime.metrics.on_scrape(sync)


async def serve_engine(runtime: DistributedRuntime, engine: AsyncEngine,
                       card: ModelDeploymentCard,
                       instance_id: Optional[int] = None) -> WorkerHandle:
    """Worker side (entrypoint/input/endpoint.rs): serve a core engine on
    the card's endpoint and publish the card. A disagg worker serves a
    handler wrapping its engine (`disagg/handlers.py`): the engine's own
    metrics join the scrape."""
    core = getattr(engine, "engine", engine)
    register_engine_metrics(runtime, core)
    if hasattr(core, "step_recorder"):
        # in-process deployments share one runtime between the worker and
        # the frontend: the /debug routes reach this engine's recorders
        if not hasattr(runtime, "profile_engines"):
            runtime.profile_engines = []
        runtime.profile_engines.append(core)
    comp = runtime.namespace(card.namespace).component(card.component)
    # one-token greedy canary; the extra.canary marker lets sinks and
    # metrics tell probes from traffic
    from dynamo_tpu_torch.runtime.health_check import DEFAULT_CANARY_PAYLOAD

    canary = {**DEFAULT_CANARY_PAYLOAD, "model": card.name}
    served = await comp.endpoint(card.endpoint).serve(
        engine, instance_id=instance_id,
        metadata={"dp_size": card.runtime_config.data_parallel_size},
        health_payload=canary)
    admin = []
    clear_fn = getattr(core, "clear_kv_blocks", None)
    if clear_fn is not None:
        async def clear_handler(request, context):
            n = clear_fn()
            if inspect.isawaitable(n):
                n = await n
            yield {"status": "success", "cleared_pages": int(n or 0)}

        admin.append(await comp.endpoint("clear_kv_blocks").serve(
            clear_handler, instance_id=served.instance.instance_id))
    kvbm = getattr(core, "kvbm", None)
    if kvbm is not None:
        async def controller_handler(request, context):
            # the reference's block_manager/controller.rs ControlMessage:
            # Status / ResetPool(level) / ResetAll
            op = (request or {}).get("op", "status")
            if op == "status":
                yield {"status": "success", **kvbm.status()}
            elif op == "reset":
                try:
                    dropped = kvbm.reset((request or {}).get("level", "all"))
                except ValueError as e:
                    yield {"status": "error", "error": str(e)}
                    return
                yield {"status": "success", "dropped": dropped}
            else:
                yield {"status": "error",
                       "error": f"unknown kvbm controller op {op!r}"}

        admin.append(await comp.endpoint("kvbm_controller").serve(
            controller_handler, instance_id=served.instance.instance_id))
    await register_llm(runtime, card)
    # telemetry plane: publish this worker's MetricsSnapshot (its engine
    # histograms joined runtime.metrics above) on the event bus, so the
    # frontend's collector sees it without an HTTP scrape
    publisher = None
    if runtime.config.telemetry_interval > 0:
        publisher = TelemetryPublisher(
            runtime.events, runtime.metrics,
            component=f"{card.namespace}/{card.component}",
            instance=f"{served.instance.instance_id:x}", role="worker",
            interval=runtime.config.telemetry_interval)
        publisher.start()
    return WorkerHandle(runtime, card, served, admin, publisher)


def wire_engine_events(runtime: DistributedRuntime,
                       card: ModelDeploymentCard):
    """(event_sink, metrics_sink): callables that publish a worker
    engine's KV events and ForwardPassMetrics on the runtime's event bus
    under the card's component subjects. Call them on the event loop's
    thread (the engine does): the in-process bus is not thread-safe, and
    a coordinator's bus publishes from a task, in call order."""
    ev_subject = kv_events_subject(card.namespace, card.component)
    m_subject = metrics_subject(card.namespace, card.component)
    bus = runtime.events
    # the loop keeps only weak references to tasks: hold each publish
    # until it is done
    in_flight: set[asyncio.Task] = set()

    def publisher(subject: str):
        if isinstance(bus, LocalEventBus):
            def publish(item) -> None:
                bus.publish_nowait(subject, item.to_dict())
        else:
            def publish(item) -> None:
                task = asyncio.get_running_loop().create_task(
                    bus.publish(subject, item.to_dict()))
                in_flight.add(task)
                task.add_done_callback(in_flight.discard)
        return publish

    return publisher(ev_subject), publisher(m_subject)


def attention_impl_from_env() -> str:
    """The engine path DYN_ATTENTION_IMPL selects: "ragged" for "ragged";
    the phase path for anything else ("auto", "xla", "pallas" are all the
    reference's phase path)."""
    impl = os.environ.get("DYN_ATTENTION_IMPL", "auto").strip().lower()
    return "ragged" if impl == "ragged" else "phase"


def build_torch_engine(model: str, served_name: Optional[str] = None, *,
                       num_pages: int = 2048, max_batch_size: int = 8,
                       prefill_chunk_budget: int = 0,
                       decode_steps_per_sync: int = 8,
                       pipeline_bursts: bool = True,
                       random_init: bool = False, rng_seed: int = 0,
                       quantize: Optional[str] = None,
                       device: str = "cuda", worker_id: int = 0,
                       dp_rank: int = 0, event_sink=None,
                       metrics_sink=None, kvbm_host_blocks: int = 0,
                       kvbm_offload_queue: int = 0,
                       kvbm_offload_workers: int = 0,
                       kvbm_prefetch_blocks: int = 0,
                       kvbm_offload_queue_bytes: int = 0,
                       draft_model: Optional[str] = None,
                       spec_gamma: int = 4, spec_iters_per_sync: int = 8,
                       **model_overrides
                       ) -> tuple[TorchEngine, ModelDeploymentCard]:
    """(TorchEngine, ModelDeploymentCard) for a checkpoint dir (or an
    already-downloaded HF-cache name). `random_init=True` skips the weight
    read and draws weights from `rng_seed` (benchmarks on synthetic
    weights). `quantize` ("int8" | "w8a8" | "int4") serves quantized
    weights: the loader quantizes each projection as it lands (the
    reference's `load_llama_params_device(quantize=...)`), and a random
    init is quantized by the engine. The path is
    `attention_impl_from_env()`'s. `worker_id` / `dp_rank` stamp the
    engine's KV events and metrics, which go to `event_sink` /
    `metrics_sink` (`wire_engine_events`). `kvbm_host_blocks` > 0
    attaches KVBM's host tier of that many blocks, its pipeline set by
    the other `kvbm_*` knobs (`kvbm/manager.py` KvbmConfig; all 0 = the
    synchronous path). `draft_model` (a checkpoint dir or HF-cache name)
    serves speculative decoding: its config is read at the target's page
    size, context and dtype, its weights loaded (a tied checkpoint, as
    Llama-3.2-1B's, through the loader's tied lm_head) or, with
    `random_init`, drawn from `rng_seed + 1`; `spec_gamma` draft tokens
    per iteration, `spec_iters_per_sync` iterations per burst.
    `model_overrides` tune the target's config, e.g. ``max_pages_per_seq``
    or ``num_layers`` (depth cut)."""
    dev = resolve_device(device)
    path = resolve_model(model)
    cfg = config_from_hf(path, **model_overrides)
    params = None if random_init else load_llama_params(path, cfg, dev,
                                                        quantize=quantize)
    draft_cfg = draft = None
    if draft_model is not None:
        dpath = resolve_model(draft_model)
        draft_cfg = config_from_hf(
            dpath, page_size=cfg.page_size,
            max_pages_per_seq=cfg.max_pages_per_seq, dtype=cfg.dtype)
        draft = None if random_init else load_llama_params(
            dpath, draft_cfg, dev, quantize=quantize)
    has_tok = any(os.path.exists(os.path.join(path, f))
                  for f in _TOKENIZER_FILES)
    # guided decoding needs the tokenizer's id -> bytes map; the provider
    # is lazy, so the O(vocab) build runs only if a guided request arrives
    token_bytes, eos_id = None, 0
    try:
        tok = make_tokenizer("hf" if has_tok else "byte",
                             path if has_tok else "")

        def token_bytes(tok=tok, vocab=cfg.vocab_size):
            return token_bytes_of(tok, vocab)

        eos_id = tok.eos_token_id or 0
    except Exception as e:
        logger.warning("guided decoding disabled (tokenizer unavailable: "
                       "%s)", e)
    engine = TorchEngine(
        TorchEngineConfig(model=cfg, num_pages=num_pages,
                          max_batch_size=max_batch_size,
                          prefill_chunk_budget=prefill_chunk_budget,
                          decode_steps_per_sync=decode_steps_per_sync,
                          pipeline_bursts=pipeline_bursts,
                          attention_impl=attention_impl_from_env(),
                          quantize=quantize, rng_seed=rng_seed,
                          device=str(dev), worker_id=worker_id,
                          dp_rank=dp_rank, draft_model=draft_cfg,
                          spec_gamma=spec_gamma,
                          spec_iters_per_sync=spec_iters_per_sync),
        model=params, token_bytes=token_bytes, eos_token_id=eos_id,
        event_sink=event_sink, metrics_sink=metrics_sink, draft=draft)
    if kvbm_host_blocks:
        from dynamo_tpu_torch.kvbm import KvbmConfig, KvbmManager

        KvbmManager(engine, KvbmConfig(
            host_blocks=kvbm_host_blocks,
            offload_queue_depth=kvbm_offload_queue,
            offload_workers=kvbm_offload_workers,
            prefetch_blocks=kvbm_prefetch_blocks,
            offload_queue_bytes=kvbm_offload_queue_bytes))
    card = ModelDeploymentCard(
        name=served_name or os.path.basename(path.rstrip("/")),
        tokenizer_kind="hf" if has_tok else "byte",
        tokenizer_path=path if has_tok else "",
        model_path=path,
        context_length=cfg.context_length, kv_block_size=cfg.page_size,
        runtime_config=ModelRuntimeConfig(
            total_kv_blocks=engine.pool.capacity,
            max_batch_size=max_batch_size))
    return engine, card
