"""Per-tenant quota enforcement at the frontend (docs/multitenancy.md).

Two independent limits, both checked BEFORE the request touches the
engine pipeline so an over-quota tenant costs the fleet nothing:

- concurrency: `max_concurrent_streams` live streams per tenant;
- token rate: a token bucket refilled at `token_rate` tokens/second
  with `token_burst` capacity, charged the *estimated* request cost
  (prompt words + max_tokens) at admission. Requests larger than the
  burst run a debt model — they pass when the bucket is full and drive
  its level negative, so a giant request is rate-limited by refill time
  rather than deadlocked forever.

Denials map to HTTP 429 with a Retry-After computed from the bucket's
refill rate. The clock is injected for tests.

Port of `dynamo_tpu/tenancy/quota.py`: the same decisions, records and
payloads, on the port's own modules (no jax, no `dynamo_tpu` import).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Optional

from dynamo_tpu_torch.tenancy.config import Tenant, TenancyConfig
from dynamo_tpu_torch.tenancy.metrics import TenantMetrics


def estimate_request_tokens(body: dict) -> int:
    """Admission-time cost estimate under the word tokenizer: prompt
    words plus the requested completion budget. Deliberately cheap and
    slightly generous — the bucket charges predicted work, goodput
    counters record actual work."""
    n = 0
    msgs = body.get("messages")
    if isinstance(msgs, list):
        for m in msgs:
            content = m.get("content") if isinstance(m, dict) else None
            if isinstance(content, str):
                n += len(content.split())
    prompt = body.get("prompt")
    if isinstance(prompt, str):
        n += len(prompt.split())
    elif isinstance(prompt, list):
        n += len(prompt)
    inp = body.get("input")
    if isinstance(inp, str):
        n += len(inp.split())
    elif isinstance(inp, list):
        n += len(inp)
    for key in ("max_tokens", "max_completion_tokens", "max_output_tokens"):
        v = body.get(key)
        if isinstance(v, (int, float)) and v > 0:
            n += int(v)
            break
    return max(n, 1)


class TokenBucket:
    """Classic token bucket with on-demand refill and debt (see module
    docstring). Pure given its injected clock."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.rate = rate
        self.burst = burst
        self._clock = clock
        self._level = burst
        self._at = clock()

    def _refill(self) -> None:
        now = self._clock()
        self._level = min(self.burst,
                          self._level + (now - self._at) * self.rate)
        self._at = now

    def level(self) -> float:
        self._refill()
        return self._level

    def take(self, n: float) -> tuple[bool, float]:
        """(granted, retry_after_s). A request needs min(n, burst)
        available; granting subtracts the full n (debt)."""
        self._refill()
        need = min(n, self.burst)
        if self._level >= need:
            self._level -= n
            return True, 0.0
        if self.rate <= 0:
            return False, float("inf")
        return False, (need - self._level) / self.rate


class QuotaGate:
    """Frontend-side quota state: per-tenant stream counts and token
    buckets, created lazily. One gate per HttpService."""

    def __init__(self, cfg: TenancyConfig,
                 metrics: Optional[TenantMetrics] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.cfg = cfg
        self.metrics = metrics or TenantMetrics()
        self._clock = clock
        self._buckets: dict[str, TokenBucket] = {}
        self._streams: dict[str, int] = {}
        self._lock = threading.Lock()

    def _bucket(self, t: Tenant) -> Optional[TokenBucket]:
        if t.token_rate <= 0:
            return None
        b = self._buckets.get(t.name)
        if b is None:
            b = TokenBucket(t.token_rate, t.burst, self._clock)
            self._buckets[t.name] = b
        return b

    def try_admit(self, tenant: Tenant,
                  tokens: int) -> tuple[bool, str, float]:
        """(admitted, reject_reason, retry_after_s). Admission takes a
        stream slot and charges the bucket; callers MUST `release` the
        tenant exactly once after an admitted stream finishes."""
        m = self.metrics
        with self._lock:
            live = self._streams.get(tenant.name, 0)
            if 0 < tenant.max_concurrent_streams <= live:
                m.rejected.inc(tenant=tenant.name, reason="streams")
                return False, "streams", 1.0
            bucket = self._bucket(tenant)
            if bucket is not None:
                ok, retry = bucket.take(tokens)
                if not ok:
                    m.rejected.inc(tenant=tenant.name, reason="token_rate")
                    return False, "token_rate", retry
            self._streams[tenant.name] = live + 1
        m.admitted.inc(tenant=tenant.name)
        m.streams.set(live + 1, tenant=tenant.name)
        return True, "", 0.0

    def release(self, name: str) -> None:
        with self._lock:
            live = max(self._streams.get(name, 0) - 1, 0)
            self._streams[name] = live
        self.metrics.streams.set(live, tenant=name)

    def payload(self) -> dict:
        """Live quota view for /debug/tenants."""
        out = {}
        cfg_view = self.cfg.payload()
        with self._lock:
            names = set(cfg_view) | set(self._streams)
            for name in sorted(names):
                t = self.cfg.get(name)
                bucket = self._buckets.get(name)
                out[name] = {
                    **cfg_view.get(name, {"weight": t.weight}),
                    "live_streams": self._streams.get(name, 0),
                    "bucket_level": (round(bucket.level(), 3)
                                     if bucket is not None else None),
                    "admitted": self.metrics.admitted.get(tenant=name),
                    "rejected": sum(
                        v for labels, v in self.metrics.rejected.items()
                        if labels.get("tenant") == name),
                    "ttft_p90_s": self.metrics.ttft.quantile(name, 0.9),
                }
        return {"default_tenant": self.cfg.default_tenant or None,
                "tenants": out}


def retry_after_header(seconds: float) -> str:
    """Retry-After wants integral seconds; never advertise 0 (clients
    would hot-loop) or inf (unlimited-rate denials are stream-slot
    denials with their own small hint)."""
    if not math.isfinite(seconds):
        return "60"
    return str(max(1, math.ceil(seconds)))
