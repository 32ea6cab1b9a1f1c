"""Layered runtime configuration.

Port of `dynamo_tpu/runtime/config.py`: the fields of the runtime the
port serves (control-plane store, transport, leases, the system status
server, health canaries, request deadlines and the adaptive idle timeout,
dial retries, the circuit breaker, the KVBM pipeline knobs, the fleet
telemetry plane's publish interval and the SLO monitor's objectives).

Reference: `lib/runtime/src/config.rs` (figment: defaults < file < DYN_* env).
Here: dataclass defaults < optional JSON file < ``DYN_*`` environment.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Optional

ENV_PREFIX = "DYN_"


@dataclass
class RuntimeConfig:
    """Knobs for a single process's runtime (reference `config.rs:75-167`)."""

    # Control-plane store: "memory" (single-process / tests) or "tcp://host:port"
    # pointing at a `StoreServer` coordinator.
    store_url: str = "memory"
    # Address this process binds its transport server to; port 0 = ephemeral.
    listen_host: str = "127.0.0.1"
    listen_port: int = 0
    # Advertised host (what other nodes dial); defaults to listen_host.
    advertise_host: Optional[str] = None
    # Lease TTL for instance liveness, seconds (reference etcd lease).
    lease_ttl: float = 10.0
    # System status HTTP server (/live /health /metrics /config);
    # disabled when port is None.
    system_port: Optional[int] = None
    system_host: str = "0.0.0.0"
    # Health-check manager (runtime/health_check.py).
    health_check_enabled: bool = False
    health_check_interval: float = 5.0
    health_check_timeout: float = 3.0
    # Overall per-request wall clock, seconds; 0 = unbounded. Propagated
    # to the server so an abandoned handler is aborted too.
    request_deadline: float = 0.0
    # Max silence between response frames before the stream is declared
    # dead (raises the Migration-retryable error); 0 = wait forever.
    stream_idle_timeout: float = 0.0
    # Adaptive idle timeout: > 0 derives the effective idle timeout from
    # this process's observed inter-token gaps — p99.9 of the ITL
    # histograms × this margin — once enough samples exist. The static
    # stream_idle_timeout stays the floor (and the sole value before
    # warmup). 0 = off.
    stream_idle_adaptive_margin: float = 0.0
    # Extra dial attempts on connection setup (jittered exp backoff).
    connect_retries: int = 2
    connect_backoff_base: float = 0.05
    connect_backoff_max: float = 2.0
    # Seconds an exhausted dial cycle poisons its address so callers
    # queued on the same dial lock fail fast (0 disables).
    connect_neg_cache: float = 0.25
    # Per-instance circuit breaker: consecutive infra failures before the
    # instance leaves the candidate set, and the open → half-open probe
    # cooldown, seconds.
    breaker_fail_limit: int = 3
    breaker_cooldown: float = 5.0
    # KVBM async offload/onboard pipeline (kvbm/manager.py KvbmConfig),
    # read by the worker when its --kvbm-* flag is unset. All 0 = the
    # synchronous in-scheduler behavior.
    kvbm_offload_queue: int = 0
    kvbm_offload_workers: int = 0
    kvbm_prefetch_blocks: int = 0
    kvbm_offload_queue_bytes: int = 0
    # Fleet telemetry plane (runtime/telemetry.py). Seconds between
    # MetricsSnapshot publishes on the `telemetry` event subject; 0 = off
    # (no publisher task).
    telemetry_interval: float = 0.0
    # SLO burn-rate monitor (runtime/slo.py). Objective thresholds in
    # seconds; 0 = objective disabled (no monitor when both are 0).
    slo_ttft: float = 0.0
    slo_itl: float = 0.0
    slo_target_ratio: float = 0.99
    slo_fast_window: float = 60.0
    slo_slow_window: float = 600.0
    slo_fast_burn: float = 14.4
    slo_slow_burn: float = 6.0
    slo_check_interval: float = 5.0

    @classmethod
    def from_env(cls, path: Optional[str] = None) -> "RuntimeConfig":
        """defaults < json file (path or DYN_CONFIG) < DYN_<FIELD> env vars."""
        values: dict[str, Any] = {}
        cfg_path = path or os.environ.get(ENV_PREFIX + "CONFIG")
        if cfg_path and os.path.exists(cfg_path):
            with open(cfg_path) as f:
                values.update(json.load(f))
        for f_ in dataclasses.fields(cls):
            env_key = ENV_PREFIX + f_.name.upper()
            if env_key in os.environ:
                raw = os.environ[env_key]
                values[f_.name] = _coerce(raw, f_.type)
        known = {f_.name for f_ in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in values.items() if k in known})


def _coerce(raw: str, type_hint: Any) -> Any:
    hint = str(type_hint)
    if "int" in hint:
        return int(raw)
    if "float" in hint:
        return float(raw)
    if "bool" in hint:
        return raw.lower() in ("1", "true", "yes", "on")
    if "dict" in hint:
        return json.loads(raw)
    return raw
