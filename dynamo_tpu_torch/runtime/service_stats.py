"""ServiceClient: pull-model stats scrape across a component's instances.

Port of `dynamo_tpu/runtime/service_stats.py` (the port keeps its own
copy).

Reference: `lib/runtime/src/service.rs:442` — NATS service stats
($SRV.STATS) scraped into `ProcessedEndpoints` for the router/metrics
aggregator. Here every TransportServer answers the builtin
``_sys.stats`` subject; the scraper fans out to each live instance's
address and merges per-endpoint counters.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.transport import TransportServer


@dataclass
class EndpointStats:
    instance_id: int
    address: str
    subject: str
    requests: int = 0
    errors: int = 0
    items: int = 0
    inflight: int = 0
    total_processing_s: float = 0.0

    @property
    def avg_processing_s(self) -> float:
        return (self.total_processing_s / self.requests
                if self.requests else 0.0)


@dataclass
class ProcessedEndpoints:
    """Merged scrape of one endpoint across its instances."""

    endpoints: list[EndpointStats] = field(default_factory=list)
    # per-address process-level extras: client-side transport counters
    # (retries, timeouts) + circuit-breaker snapshot, when the scraped
    # process's runtime wired them in (distributed.py:_robustness_stats)
    client_stats: dict[str, dict] = field(default_factory=dict)

    def total_requests(self) -> int:
        return sum(e.requests for e in self.endpoints)

    def least_loaded(self) -> Optional[EndpointStats]:
        return min(self.endpoints, key=lambda e: e.inflight, default=None)


class ServiceClient:
    def __init__(self, runtime) -> None:
        self.runtime = runtime

    async def collect_services(self, namespace: str, component: str,
                               endpoint: str = "generate"
                               ) -> ProcessedEndpoints:
        """Scrape every live instance of namespace/component/endpoint."""
        client = await (self.runtime.namespace(namespace)
                        .component(component).endpoint(endpoint).client())
        await client.start()
        out = ProcessedEndpoints()
        try:
            for inst in client.instances():
                try:
                    async for payload in self.runtime.transport_client \
                            .request(inst.address,
                                     TransportServer.STATS_SUBJECT, {},
                                     Context()):
                        stat = (payload.get("stats") or {}).get(
                            inst.subject)
                        if stat is not None:
                            out.endpoints.append(EndpointStats(
                                instance_id=inst.instance_id,
                                address=inst.address,
                                subject=inst.subject, **stat))
                        if payload.get("client"):
                            out.client_stats[inst.address] = \
                                payload["client"]
                        break
                except ConnectionError:
                    continue  # instance died between watch + scrape
        finally:
            await client.stop()
        return out
