"""Shared CLI plumbing for the `python -m dynamo_tpu_torch.*` components.

Port of `dynamo_tpu/cli_util.py`: every component is an argparse CLI whose
flags layer over `RuntimeConfig` env (`DYN_*`) the way figment does in
`lib/runtime/src/config.rs:214-226`. The reference's XLA compile cache
(`enable_compile_cache`) belongs to JAX and has no counterpart here.

Flags of the reference that name a subsystem the port does not have yet
are parsed under their names and refused when set (`refuse_unported`):
they are never ignored.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal

from dynamo_tpu_torch.runtime.config import RuntimeConfig

# what a refused flag waits for (ROADMAP.md, queue 1)
STATUS_PLANE = ("the system status server, health canaries and telemetry "
                "(ROADMAP queue 1: worker and HTTP serving, what waits)")

# the reference's runtime flags whose subsystems the port has not ported:
# flag -> (what it waits for, kind), see add_refused
RUNTIME_REFUSED = {
    "--system-port": (STATUS_PLANE, "value"),
    "--health-check": (STATUS_PLANE, "store_true"),
    "--health-check-interval": (STATUS_PLANE, "value"),
    "--health-check-timeout": (STATUS_PLANE, "value"),
    "--telemetry-interval": (STATUS_PLANE, "value"),
    "--stream-idle-adaptive-margin": (
        "the engine's latency metrics (ROADMAP queue 1: engine state that "
        "the router and control planes read)", "value"),
    "--faults": ("a fault injector, which the port does not carry",
                 "value"),
    "--faults-seed": ("a fault injector, which the port does not carry",
                      "value"),
}


def add_runtime_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--store", default=None,
                   help="control-plane store url: memory | tcp://host:port "
                        "(default: DYN_STORE_URL env or memory)")
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--lease-ttl", type=float, default=None)
    p.add_argument("--request-deadline", type=float, default=None,
                   help="overall per-request wall clock, seconds "
                        "(0 = unbounded; stalled requests migrate)")
    p.add_argument("--stream-idle-timeout", type=float, default=None,
                   help="max silence between response frames before the "
                        "stream is declared dead and migrated")
    p.add_argument("--log-level", default="info",
                   choices=["debug", "info", "warning", "error"])
    add_refused(p, RUNTIME_REFUSED)


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
    if getattr(args, "lease_ttl", None) is not None:
        cfg.lease_ttl = args.lease_ttl
    if getattr(args, "request_deadline", None) is not None:
        cfg.request_deadline = args.request_deadline
    if getattr(args, "stream_idle_timeout", None) is not None:
        cfg.stream_idle_timeout = args.stream_idle_timeout
    return cfg


def setup_logging(level: str) -> None:
    logging.basicConfig(
        level=level.upper(),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")


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

    asyncio.run(runner())
