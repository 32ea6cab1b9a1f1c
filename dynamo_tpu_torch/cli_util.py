"""Shared CLI plumbing for the `python -m dynamo_tpu_torch.*` components.

Port of `dynamo_tpu/cli_util.py`: every component is an argparse CLI whose
flags layer over `RuntimeConfig` env (`DYN_*`) the way figment does in
`lib/runtime/src/config.rs:214-226`. The reference's XLA compile cache
(`enable_compile_cache`) belongs to JAX and has no counterpart here.
`--faults` / `--faults-seed` are exported as `DYN_FAULTS` /
`DYN_FAULTS_SEED` before any fault injector is built
(`export_faults`), so every injector of the process (transport, store,
engine, KVBM) and every child it starts reads the same spec.

Flags of the reference that name a subsystem the port does not have yet
are parsed under their names and refused when set (`refuse_unported`):
they are never ignored.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal

from dynamo_tpu_torch.runtime.config import RuntimeConfig

# what a refused flag waits for (ROADMAP.md, queue 1): item 4 is the
# tools and control layer
OPS = "ROADMAP queue 1 item 4: tools and control"


def add_runtime_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--store", default=None,
                   help="control-plane store url: memory | tcp://host:port "
                        "(default: DYN_STORE_URL env or memory)")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--system-port", type=int, default=None,
                   help="system status server port (/live /health "
                        "/metrics /config; 0 = an ephemeral port)")
    p.add_argument("--lease-ttl", type=float, default=None)
    p.add_argument("--health-check", action="store_true",
                   help="enable canary health probes on served endpoints")
    p.add_argument("--health-check-interval", type=float, default=None,
                   help="idle seconds before a canary probe fires")
    p.add_argument("--health-check-timeout", type=float, default=None)
    p.add_argument("--request-deadline", type=float, default=None,
                   help="overall per-request wall clock, seconds "
                        "(0 = unbounded; stalled requests migrate)")
    p.add_argument("--stream-idle-timeout", type=float, default=None,
                   help="max silence between response frames before the "
                        "stream is declared dead and migrated")
    p.add_argument("--stream-idle-adaptive-margin", type=float,
                   default=None,
                   help="derive the idle timeout from observed "
                        "inter-token gaps (p99.9 x this margin) once "
                        "enough samples exist; the static timeout stays "
                        "the floor (0 = off; "
                        "DYN_STREAM_IDLE_ADAPTIVE_MARGIN)")
    add_fault_args(p)
    p.add_argument("--telemetry-interval", type=float, default=None,
                   help="seconds between MetricsSnapshot publishes on "
                        "the telemetry event subject (0 = off; "
                        "DYN_TELEMETRY_INTERVAL)")
    p.add_argument("--log-level", default="info",
                   choices=["debug", "info", "warning", "error"])


def add_fault_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--faults", default=None, metavar="SPEC",
                   help="deterministic fault-injection spec "
                        "(runtime/faults.py grammar); exported as "
                        "DYN_FAULTS so every injector in the process — "
                        "transport, store, engine, KVBM offload worker — "
                        "picks it up")
    p.add_argument("--faults-seed", type=int, default=None,
                   help="seed for probabilistic fault rules "
                        "(DYN_FAULTS_SEED; default 0)")


def export_faults(args: argparse.Namespace) -> None:
    """Publish `--faults` / `--faults-seed` through the environment, not
    the config: `FaultInjector.from_env()` is read independently by the
    transport, the store, the engine and KVBM, and child processes must
    inherit the spec."""
    if getattr(args, "faults", None) is None:
        return
    from dynamo_tpu_torch.runtime.faults import ENV_SEED, ENV_SPEC

    os.environ[ENV_SPEC] = args.faults
    if getattr(args, "faults_seed", None) is not None:
        os.environ[ENV_SEED] = str(args.faults_seed)


def add_refused(p: argparse.ArgumentParser, flags: dict) -> None:
    """Parse each reference flag the port cannot serve yet, so that
    `refuse_unported` can name what it waits for. `flags` maps a flag to
    (what it waits for, kind): kind "store_true", "int>1" (refused above
    1), or "value" (refused when given)."""
    for flag, (_, kind) in flags.items():
        if kind == "store_true":
            p.add_argument(flag, action="store_true",
                           help=argparse.SUPPRESS)
        elif kind == "int>1":
            p.add_argument(flag, type=int, default=1,
                           help=argparse.SUPPRESS)
        else:
            p.add_argument(flag, default=None, help=argparse.SUPPRESS)


def refuse_unported(args: argparse.Namespace, flags: dict,
                    prog: str) -> None:
    """SystemExit naming the missing part for the first refused flag that
    was set (see `add_refused`)."""
    for flag, (waits_for, kind) in flags.items():
        v = getattr(args, flag.lstrip("-").replace("-", "_"))
        if (kind == "store_true" and v) or (kind == "int>1" and v > 1) \
                or (kind == "value" and v is not None):
            raise SystemExit(
                f"{prog}: {flag} is not supported by dynamo_tpu_torch yet: "
                f"it waits for {waits_for}")


def runtime_config_from_args(args: argparse.Namespace) -> RuntimeConfig:
    cfg = RuntimeConfig.from_env()
    if args.store is not None:
        cfg.store_url = args.store
    if getattr(args, "system_port", None) is not None:
        cfg.system_port = args.system_port
    if getattr(args, "lease_ttl", None) is not None:
        cfg.lease_ttl = args.lease_ttl
    if getattr(args, "health_check", False):
        cfg.health_check_enabled = True
    if getattr(args, "health_check_interval", None) is not None:
        cfg.health_check_interval = args.health_check_interval
    if getattr(args, "health_check_timeout", None) is not None:
        cfg.health_check_timeout = args.health_check_timeout
    if getattr(args, "request_deadline", None) is not None:
        cfg.request_deadline = args.request_deadline
    if getattr(args, "stream_idle_timeout", None) is not None:
        cfg.stream_idle_timeout = args.stream_idle_timeout
    if getattr(args, "stream_idle_adaptive_margin", None) is not None:
        cfg.stream_idle_adaptive_margin = args.stream_idle_adaptive_margin
    if getattr(args, "telemetry_interval", None) is not None:
        cfg.telemetry_interval = args.telemetry_interval
    for slo_flag in ("slo_ttft", "slo_itl", "slo_target_ratio",
                     "slo_fast_window", "slo_slow_window",
                     "slo_fast_burn", "slo_slow_burn",
                     "slo_check_interval"):
        v = getattr(args, slo_flag, None)
        if v is not None:
            setattr(cfg, slo_flag, v)
    export_faults(args)
    return cfg


def setup_logging(level: str) -> None:
    """The log format `DYN_LOG_FORMAT` names (jsonl or text) at `level`,
    or at the per-module levels of `DYN_LOG` (`runtime/logging_util.py`)."""
    from dynamo_tpu_torch.runtime.logging_util import init_logging

    init_logging(level.upper())


def run_until_signal(main_coro_factory, *, shutdown=None) -> None:
    """asyncio.run a service until SIGINT/SIGTERM.

    `main_coro_factory()` must return (started) objects with an optional
    async `stop()`/`close()`; `shutdown(objs)` overrides teardown.
    """

    async def runner():
        stop_event = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop_event.set)
        objs = await main_coro_factory()
        try:
            await stop_event.wait()
        finally:
            logging.getLogger(__name__).info("shutting down")
            if shutdown is not None:
                await shutdown(objs)
            # the spans still queued reach the trace file before exit
            from dynamo_tpu_torch.runtime.tracing import tracer

            await tracer().close()

    asyncio.run(runner())
