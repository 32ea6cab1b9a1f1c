"""`python -m dynamo_tpu_torch.frontend` — OpenAI HTTP frontend.

Port of `dynamo_tpu/frontend/__main__.py`: router mode (`kv`,
`round_robin`, `random`), the KV router's knobs
(`--kv-overlap-score-weight`, `--router-temperature`, `--no-kv-events`,
`--router-replica-sync`), port, namespace, request template and TLS, and
the runtime's status server (`--system-port`), adaptive idle timeout
(`--stream-idle-adaptive-margin`) and fleet telemetry publisher
(`--telemetry-interval`), and the SLO burn-rate monitor's objectives
and windows (`--slo-*`, `runtime/slo.py`). What still waits:
`--grpc-port` (the KServe gRPC frontend) is parsed under its name and
refused, naming what it waits for.

Reference: `components/src/dynamo/frontend/main.py:4-16,342`.
"""

from __future__ import annotations

import argparse
import json
import logging

from dynamo_tpu_torch.cli_util import (
    OPS,
    add_refused,
    add_runtime_args,
    refuse_unported,
    run_until_signal,
    runtime_config_from_args,
    setup_logging,
)

logger = logging.getLogger(__name__)

PROG = "python -m dynamo_tpu_torch.frontend"
FRONTEND_REFUSED = {
    "--grpc-port": (f"the KServe gRPC frontend (grpc_frontend/, {OPS}, "
                    f"last)", "value"),
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog=PROG, description="dynamo_tpu_torch OpenAI HTTP frontend")
    add_runtime_args(p)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--router-mode", default=None,
                   choices=["kv", "round_robin", "random"],
                   help="override each model card's router mode")
    p.add_argument("--kv-overlap-score-weight", type=float, default=1.0)
    p.add_argument("--router-temperature", type=float, default=0.0)
    p.add_argument("--no-kv-events", action="store_true",
                   help="kv mode: predict each worker's cache from the "
                        "routing decisions (ApproxKvIndexer) instead of "
                        "consuming its KV events")
    p.add_argument("--router-replica-sync", action="store_true")
    p.add_argument("--tls-cert-path", default=None,
                   help="PEM certificate; with --tls-key-path serves HTTPS")
    p.add_argument("--tls-key-path", default=None)
    p.add_argument("--request-template", default=None,
                   help="JSON file of request defaults (model, "
                        "temperature, max_completion_tokens)")
    # SLO burn-rate monitor (runtime/slo.py): objectives default off, so
    # no monitor and no change in behavior
    p.add_argument("--slo-ttft", type=float, default=None,
                   help="TTFT objective threshold seconds (0 = off)")
    p.add_argument("--slo-itl", type=float, default=None,
                   help="ITL objective threshold seconds (0 = off)")
    p.add_argument("--slo-target-ratio", type=float, default=None,
                   help="fraction of requests that must beat the "
                        "threshold (default 0.99)")
    p.add_argument("--slo-fast-window", type=float, default=None)
    p.add_argument("--slo-slow-window", type=float, default=None)
    p.add_argument("--slo-fast-burn", type=float, default=None,
                   help="fast-window burn-rate alert threshold (14.4)")
    p.add_argument("--slo-slow-burn", type=float, default=None,
                   help="slow-window burn-rate alert threshold (6)")
    p.add_argument("--slo-check-interval", type=float, default=None)
    add_refused(p, FRONTEND_REFUSED)
    return p.parse_args(argv)


def router_config_from_args(args: argparse.Namespace):
    from dynamo_tpu_torch.router.kv_router import KvRouterConfig

    return KvRouterConfig(
        overlap_weight=args.kv_overlap_score_weight,
        temperature=args.router_temperature,
        use_kv_events=not args.no_kv_events,
        replica_sync=args.router_replica_sync)


def main(argv=None) -> None:
    from dynamo_tpu_torch.llm.model_manager import check_router_mode

    args = parse_args(argv)
    refuse_unported(args, FRONTEND_REFUSED, PROG)
    if args.router_mode is not None:
        try:
            check_router_mode(args.router_mode)
        except ValueError as e:
            raise SystemExit(f"{PROG}: {e}") from None
    setup_logging(args.log_level)

    async def start():
        from dynamo_tpu_torch.llm.entrypoint import start_frontend
        from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

        rt = await DistributedRuntime.create(runtime_config_from_args(args))
        template = None
        if args.request_template:
            with open(args.request_template) as f:
                template = json.load(f)
        fe = await start_frontend(rt, host=args.host, port=args.port,
                                  request_template=template,
                                  router_mode_override=args.router_mode,
                                  router_config=router_config_from_args(
                                      args),
                                  namespace=args.namespace,
                                  tls_cert=args.tls_cert_path,
                                  tls_key=args.tls_key_path)
        print(f"FRONTEND_READY {fe.url}", flush=True)
        return rt, fe

    async def stop(objs):
        rt, fe = objs
        await fe.stop()
        await rt.close()

    run_until_signal(start, shutdown=stop)


if __name__ == "__main__":
    main()
