"""DistributedRuntime: the per-process cluster handle.

Port of `dynamo_tpu/runtime/distributed.py`: the store, the transport
server and client, the process-wide circuit breaker, the metrics
registry, the event bus (the store's own over a coordinator, an in-process
`LocalEventBus` otherwise: KV events, forward-pass metrics and router
replica sync ride it), the in-process engine registry, the
re-registration of lease-attached keys after a coordinator restart, the
KVBM wiring, the system status server (`runtime/status.py`, with
`system_port`), the health-check manager (`runtime/health_check.py`, with
`health_check_enabled`) and the adaptive idle timeout
(`stream_idle_adaptive_margin`, `_adaptive_idle_timeout`). Breaker
events and the store-degradation flags wait with their subsystems.

On an in-process store ("memory") the runtime keeps its own lease alive,
as `StoreClient` does over a coordinator: the reference's runtime does
not, so there every lease-attached key (instances, model cards) vanishes
`lease_ttl` seconds after start and an in-process `run in=http` stops
finding its model.

Reference: `lib/runtime/src/distributed.rs:43-191` — holds the etcd client
(here: store), NATS client (here: transport server/client), component
registry, metrics registries, and the system status server. Static mode
(`distributed.rs:48-56`): store_url="memory" runs everything in-process with
no coordinator, the analog of the reference's MemoryStore static mode.
"""

from __future__ import annotations

import asyncio
import logging
import socket
from typing import Optional

from dynamo_tpu_torch.runtime.breaker import CircuitBreaker
from dynamo_tpu_torch.runtime.component import Namespace
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.runtime.events import EventBus, LocalEventBus
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.runtime.store import (
    KeyValueStore,
    MemoryStore,
    connect_store,
)
from dynamo_tpu_torch.runtime.tracing import tracer
from dynamo_tpu_torch.runtime.transport import TransportClient, TransportServer

logger = logging.getLogger(__name__)


class DistributedRuntime:
    def __init__(self, config: RuntimeConfig, store: KeyValueStore,
                 transport_server: TransportServer, lease_id: int) -> None:
        self.config = config
        self.store = store
        self.transport_server = transport_server
        self.transport_client = TransportClient(
            idle_timeout=config.stream_idle_timeout,
            deadline=config.request_deadline,
            connect_retries=config.connect_retries,
            connect_backoff_base=config.connect_backoff_base,
            connect_backoff_max=config.connect_backoff_max,
            connect_neg_cache=config.connect_neg_cache,
            idle_timeout_provider=(
                self._adaptive_idle_timeout
                if config.stream_idle_adaptive_margin > 0 else None))
        # process-wide per-instance circuit breaker: every PushRouter in
        # this process shares it, so one router's failures steer them all
        self.breaker = CircuitBreaker(config.breaker_fail_limit,
                                      config.breaker_cooldown)
        self.lease_id = lease_id
        # a coordinator's client is its own event bus; in static (memory)
        # mode a LocalEventBus serves the process
        self.events: EventBus = (
            store if isinstance(store, EventBus) else LocalEventBus())
        self._lease_task: Optional[asyncio.Task] = None
        if isinstance(store, MemoryStore):
            self._lease_task = asyncio.get_running_loop().create_task(
                self._keep_lease_alive())
        self.metrics = MetricsRegistry("dynamo")
        # the process tracer's export/drop counters render on /metrics
        # like everything else (they are plain registry Counters)
        tracer().register_metrics(self.metrics)
        # surface retry/timeout/breaker counters on both observability
        # planes: the `_sys.stats` scrape and the Prometheus registry
        self._kvbm_manager = None   # wire_kvbm
        transport_server.extra_stats = self._robustness_stats
        self._wire_robustness_metrics()
        self._local_engines: dict[str, AsyncEngine] = {}
        self._shutdown = asyncio.Event()
        self._status_server = None
        self.health = None  # HealthCheckManager when enabled
        # async callables replayed after a coordinator restart: the new
        # store is empty, so every lease-attached key must be re-put
        # (instance registrations, model cards)
        self._reregisters: list = []
        if hasattr(store, "on_reconnect"):
            store.on_reconnect.append(self._on_store_reconnect)

    async def _keep_lease_alive(self) -> None:
        """Renew this process's lease on an in-process store every third
        of its TTL (StoreClient renews a coordinator's lease)."""
        while True:
            await asyncio.sleep(self.config.lease_ttl / 3)
            await self.store.keep_alive(self.lease_id)

    # minimum inter-token-gap samples before the adaptive idle timeout
    # engages — below this the percentile is noise and the hand-set
    # static value (or "wait forever") stays in force
    ADAPTIVE_IDLE_MIN_SAMPLES = 100

    def _adaptive_idle_timeout(self) -> float:
        """The per-stream idle timeout derived from this process's
        observed inter-token gaps: p99.9 of the ITL histogram ×
        stream_idle_adaptive_margin. Prefers the engine's histogram (the
        model served here); falls back to the frontend's HTTP
        inter-token histogram. Returns 0.0 (defer to the static knob)
        until enough samples exist."""
        margin = self.config.stream_idle_adaptive_margin
        if margin <= 0:
            return 0.0
        metrics = self.metrics._root._metrics
        # (name, multiplier into seconds): the engine's ITL is in ms
        from dynamo_tpu_torch.engine.metrics import ITL_HISTOGRAM

        for name, scale in ((ITL_HISTOGRAM, 1e-3),
                            ("dynamo_http_inter_token_latency_seconds",
                             1.0)):
            h = metrics.get(name)
            if h is None or getattr(h, "count", 0) \
                    < self.ADAPTIVE_IDLE_MIN_SAMPLES:
                continue
            gap = h.quantile(0.999) * scale
            if gap > 0 and gap != float("inf"):
                return gap * margin
        return 0.0

    def _robustness_stats(self) -> dict:
        """Process-level counters merged into the `_sys.stats` scrape:
        the transport client's and the breaker's, and this process's
        metrics registry as Prometheus text (a worker serves no HTTP of
        its own until the status server is ported)."""
        out = {"transport": dict(self.transport_client.stats),
               "breaker": self.breaker.snapshot(),
               "metrics": self.metrics.render()}
        if self._kvbm_manager is not None:
            out["kvbm"] = self._kvbm_manager.pipeline_stats()
        return out

    def _wire_robustness_metrics(self) -> None:
        events = self.metrics.gauge(
            "transport_client_events",
            "client-side transport events (retries, timeouts, response "
            "frames) by kind")
        transitions = self.metrics.gauge(
            "breaker_transitions",
            "circuit breaker state transitions by target state")
        open_g = self.metrics.gauge(
            "breaker_open_instances",
            "instances currently filtered from routing (open/half-open)")

        def sync() -> None:
            for kind, v in self.transport_client.stats.items():
                events.set(v, kind=kind)
            for state, n in self.breaker.transitions.items():
                transitions.set(n, state=state)
            open_g.set(self.breaker.open_count())

        self.metrics.on_scrape(sync)

    def wire_kvbm(self, manager) -> None:
        """Export a KvbmManager's pipeline counters on the `_sys.stats`
        scrape ("kvbm") and the Prometheus registry
        (`dynamo_kvbm_pipeline{kind=...}`), as the robustness counters
        above."""
        self._kvbm_manager = manager
        g = self.metrics.gauge(
            "kvbm_pipeline",
            "KVBM offload/onboard pipeline counters by kind (blocks "
            "unless the kind is suffixed _bytes/_ms/_pages)")

        def sync() -> None:
            for kind, v in manager.pipeline_stats().items():
                g.set(v, kind=kind)

        self.metrics.on_scrape(sync)

    def replay_on_reconnect(self, fn) -> None:
        """Register an async callable that re-publishes one
        lease-attached key after a coordinator restart. Called AFTER
        the runtime's lease has been re-created (self.lease_id is fresh
        when fn runs)."""
        self._reregisters.append(fn)

    def drop_replay(self, fn) -> None:
        try:
            self._reregisters.remove(fn)
        except ValueError:
            pass

    async def _on_store_reconnect(self) -> None:
        self.lease_id = await self.store.create_lease(
            self.config.lease_ttl)
        for fn in list(self._reregisters):
            try:
                await fn()
            except Exception:
                logger.warning(
                    "re-registration failed after coordinator restart",
                    exc_info=True)

    # -- construction ------------------------------------------------------

    @classmethod
    async def create(cls, config: Optional[RuntimeConfig] = None
                     ) -> "DistributedRuntime":
        config = config or RuntimeConfig.from_env()
        store = await connect_store(config.store_url)
        server = TransportServer(config.listen_host, config.listen_port)
        await server.start()
        if config.advertise_host:
            server.host = config.advertise_host
        lease_id = await store.create_lease(config.lease_ttl)
        rt = cls(config, store, server, lease_id)
        if config.system_port is not None:
            from dynamo_tpu_torch.runtime.status import SystemStatusServer

            rt._status_server = SystemStatusServer(rt, config.system_host,
                                                   config.system_port)
            await rt._status_server.start()
        if config.health_check_enabled:
            from dynamo_tpu_torch.runtime.health_check import (
                HealthCheckConfig,
                HealthCheckManager,
            )

            rt.health = HealthCheckManager(rt, HealthCheckConfig(
                canary_wait=config.health_check_interval,
                request_timeout=config.health_check_timeout))
        logger.info("runtime up: transport=%s store=%s",
                    server.address, config.store_url)
        return rt

    # -- component model ---------------------------------------------------

    def namespace(self, name: str) -> Namespace:
        return Namespace(self, name)

    @property
    def transport_address(self) -> str:
        return self.transport_server.address

    # -- local engine registry (in-proc fast path) -------------------------

    def register_local(self, subject: str, engine: AsyncEngine) -> None:
        self._local_engines[subject] = engine

    def unregister_local(self, subject: str) -> None:
        self._local_engines.pop(subject, None)

    def local_engine(self, subject: str) -> Optional[AsyncEngine]:
        return self._local_engines.get(subject)

    # -- lifecycle ---------------------------------------------------------

    def shutdown(self) -> None:
        self._shutdown.set()

    async def wait_shutdown(self) -> None:
        await self._shutdown.wait()

    async def close(self) -> None:
        self.shutdown()
        if self.health is not None:
            await self.health.close()
        if self._status_server is not None:
            await self._status_server.stop()
        if self._lease_task is not None:
            self._lease_task.cancel()
        try:
            await self.store.revoke_lease(self.lease_id)
        except Exception:
            pass
        await self.transport_client.close()
        await self.transport_server.stop()
        await self.store.close()


def free_port(host: str = "127.0.0.1") -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]
