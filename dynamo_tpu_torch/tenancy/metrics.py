"""Always-on `dynamo_tenant_*` metrics (docs/multitenancy.md).

One fixed-name surface shared by the two sides of the tenancy plane:

- frontend (quota gate): admitted/rejected counters, live stream gauge,
  client-visible TTFT per tenant;
- engine (fair scheduler): goodput tokens, queue-wait, KV blocks held.

`register(registry, role=...)` adopts only the metrics that role owns —
a frontend and a worker sharing one in-proc registry (tests, run/main)
must not shadow each other's identically-named objects (the registry is
first-wins by name).

Counters/gauges carry a `tenant` label. The runtime Histogram has no
label support, so `TenantHistogram` shards one histogram per tenant and
renders them as a single labeled Prometheus family — quantiles stay
available per tenant for /debug/tenants and doctor. Per-tenant *_sum
counters ride alongside so the event-plane telemetry snapshots (which
only walk Counter/Gauge/Histogram) can still merge per-tenant latency
across the fleet.

Port of `dynamo_tpu/tenancy/metrics.py`: the same decisions, records and
payloads, on the port's own modules (no jax, no `dynamo_tpu` import).
"""

from __future__ import annotations

import threading
from typing import Sequence

from dynamo_tpu_torch.runtime.metrics import Counter, Gauge, Histogram

_TTFT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                 5.0, 10.0, 30.0)
_WAIT_BUCKETS = (0.0001, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 2.5,
                 5.0, 10.0, 30.0)


class TenantHistogram:
    """Per-tenant histogram shards rendered as one labeled family."""

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = _TTFT_BUCKETS) -> None:
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self._shards: dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def _shard(self, tenant: str) -> Histogram:
        h = self._shards.get(tenant)
        if h is None:
            with self._lock:
                h = self._shards.setdefault(
                    tenant, Histogram(self.name, self.help, self.buckets))
        return h

    def observe(self, tenant: str, value: float) -> None:
        self._shard(tenant).observe(value)

    def quantile(self, tenant: str, q: float) -> float:
        h = self._shards.get(tenant)
        return h.quantile(q) if h is not None else 0.0

    def stats(self, tenant: str) -> tuple[float, int]:
        h = self._shards.get(tenant)
        return (h.sum, h.count) if h is not None else (0.0, 0)

    def tenants(self) -> list[str]:
        return sorted(self._shards)

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        for tenant in sorted(self._shards):
            counts, total_sum, total = self._shards[tenant].snapshot()
            acc = 0
            for i, ub in enumerate(self.buckets):
                acc += counts[i]
                out.append(f'{self.name}_bucket'
                           f'{{le="{ub}",tenant="{tenant}"}} {acc}')
            acc += counts[-1]
            out.append(f'{self.name}_bucket'
                       f'{{le="+Inf",tenant="{tenant}"}} {acc}')
            out.append(f'{self.name}_sum{{tenant="{tenant}"}} {total_sum}')
            out.append(f'{self.name}_count{{tenant="{tenant}"}} {total}')
        return out


class TenantMetrics:
    """The fixed-name tenant metric set (EngineMetrics pattern)."""

    def __init__(self) -> None:
        # -- frontend (quota gate) role --
        self.admitted = Counter(
            "dynamo_tenant_admitted_total",
            "requests past the quota gate, by tenant")
        self.rejected = Counter(
            "dynamo_tenant_rejected_total",
            "quota 429s by tenant and reason (streams|token_rate)")
        self.streams = Gauge(
            "dynamo_tenant_streams", "live streams by tenant")
        self.ttft = TenantHistogram(
            "dynamo_tenant_ttft_seconds",
            "client-visible TTFT by tenant", _TTFT_BUCKETS)
        self.ttft_sum = Counter(
            "dynamo_tenant_ttft_seconds_total",
            "sum of client-visible TTFT by tenant (mergeable)")
        self.first_tokens = Counter(
            "dynamo_tenant_first_tokens_total",
            "TTFT sample count by tenant (mergeable)")
        # -- engine (fair scheduler) role --
        self.goodput = Counter(
            "dynamo_tenant_goodput_tokens_total",
            "decoded tokens emitted by tenant")
        self.queue_wait = TenantHistogram(
            "dynamo_tenant_queue_wait_seconds",
            "enqueue-to-admission wait by tenant", _WAIT_BUCKETS)
        self.queue_wait_sum = Counter(
            "dynamo_tenant_queue_wait_seconds_total",
            "sum of admission waits by tenant (mergeable)")
        self.admissions = Counter(
            "dynamo_tenant_admissions_total",
            "engine admissions by tenant (mergeable wait count)")
        self.kv_blocks = Gauge(
            "dynamo_tenant_kv_blocks",
            "KV pages/blocks held by running sequences, by tenant")

    _ROLES = {
        "frontend": ("admitted", "rejected", "streams", "ttft",
                     "ttft_sum", "first_tokens"),
        "engine": ("goodput", "queue_wait", "queue_wait_sum",
                   "admissions", "kv_blocks"),
    }

    def observe_ttft(self, tenant: str, seconds: float) -> None:
        self.ttft.observe(tenant, seconds)
        self.ttft_sum.inc(seconds, tenant=tenant)
        self.first_tokens.inc(tenant=tenant)

    def observe_queue_wait(self, tenant: str, seconds: float) -> None:
        self.queue_wait.observe(tenant, seconds)
        self.queue_wait_sum.inc(seconds, tenant=tenant)
        self.admissions.inc(tenant=tenant)

    def register(self, registry, role: str) -> None:
        """Adopt this role's metrics into a registry (idempotent)."""
        for attr in self._ROLES[role]:
            registry.register(getattr(self, attr))
