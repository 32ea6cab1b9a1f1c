"""Entrypoints: build a serving engine + card, serve it, front it.

Port of `dynamo_tpu/llm/entrypoint.py`:
- `start_frontend` (`:65`): model discovery (`ModelWatcher`, with the KV
  router's config for `kv` cards) + the OpenAI HTTP service. The
  reference's gRPC frontend, breaker-event counter, telemetry, SLO,
  serving-class and flight-control planes wait with their subsystems.
- `serve_engine` (`:263`) / `WorkerHandle` (`:245`): serve an engine on
  its card's endpoint, join the engine's metrics (`EngineMetrics` and its
  CUDA-graph counts) to the process's registry, publish the card. The
  canary, KVBM, memory, mesh and tenancy surfaces wait.
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
(`:508-545`).
"""

from __future__ import annotations

import asyncio
import logging
import os
from dataclasses import dataclass
from typing import Optional

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
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

logger = logging.getLogger(__name__)

_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json",
                    "tokenizer.model")


@dataclass
class Frontend:
    runtime: DistributedRuntime
    manager: ModelManager
    watcher: ModelWatcher
    http: HttpService

    @property
    def url(self) -> str:
        return f"{self.http.scheme}://{self.http.host}:{self.http.port}"

    async def stop(self) -> None:
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
    return Frontend(runtime, manager, watcher, http)


@dataclass
class WorkerHandle:
    runtime: DistributedRuntime
    card: ModelDeploymentCard
    served: object

    async def stop(self) -> None:
        await self.served.shutdown()


def register_engine_metrics(runtime: DistributedRuntime, engine) -> None:
    """Join an engine's own metrics to the process's scrape: its
    `EngineMetrics` (the `dynamo_engine_*` series and the compile
    tracker's `dynamo_compile_*`) and its CUDA-graph captures, replays and
    pool bytes (one source of truth, no second bookkeeping path). Engines
    without them are skipped."""
    metrics = getattr(engine, "metrics", None)
    if metrics is not None:
        metrics.register(runtime.metrics)
    graphs = getattr(engine, "graphs", None)
    if graphs is None:
        return
    g = runtime.metrics.gauge(
        "engine_cuda_graphs",
        "the engine's CUDA graphs: captures, replays and pool bytes")

    def sync() -> None:
        g.set(graphs.captures, kind="captures")
        g.set(graphs.replays, kind="replays")
        g.set(graphs.pool_bytes(), kind="pool_bytes")

    runtime.metrics.on_scrape(sync)


async def serve_engine(runtime: DistributedRuntime, engine: AsyncEngine,
                       card: ModelDeploymentCard,
                       instance_id: Optional[int] = None) -> WorkerHandle:
    """Worker side (entrypoint/input/endpoint.rs): serve a core engine on
    the card's endpoint and publish the card."""
    register_engine_metrics(runtime, engine)
    ep = (runtime.namespace(card.namespace).component(card.component)
          .endpoint(card.endpoint))
    served = await ep.serve(
        engine, instance_id=instance_id,
        metadata={"dp_size": card.runtime_config.data_parallel_size})
    await register_llm(runtime, card)
    return WorkerHandle(runtime, card, served)


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
                       metrics_sink=None, **model_overrides
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
    `metrics_sink` (`wire_engine_events`). `model_overrides` tune the
    config, e.g. ``max_pages_per_seq`` or ``num_layers`` (depth cut)."""
    dev = resolve_device(device)
    path = resolve_model(model)
    cfg = config_from_hf(path, **model_overrides)
    params = None if random_init else load_llama_params(path, cfg, dev,
                                                        quantize=quantize)
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
                          dp_rank=dp_rank),
        model=params, token_bytes=token_bytes, eos_token_id=eos_id,
        event_sink=event_sink, metrics_sink=metrics_sink)
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
