"""`python -m dynamo_tpu_torch.frontend` — OpenAI HTTP frontend.

Port of `dynamo_tpu/frontend/__main__.py`: router mode (`kv`,
`round_robin`, `random`), the KV router's knobs
(`--kv-overlap-score-weight`, `--router-temperature`, `--no-kv-events`,
`--router-replica-sync`), port, namespace, request template and TLS. The
SLO monitor's flags (`--slo-*`) and `--grpc-port` are parsed under their
names and refused, naming what they wait for.

Reference: `components/src/dynamo/frontend/main.py:4-16,342`.
"""

from __future__ import annotations

import argparse
import json
import logging

from dynamo_tpu_torch.cli_util import (
    RUNTIME_REFUSED,
    add_refused,
    add_runtime_args,
    refuse_unported,
    run_until_signal,
    runtime_config_from_args,
    setup_logging,
)

logger = logging.getLogger(__name__)

PROG = "python -m dynamo_tpu_torch.frontend"
SLO = "the SLO monitor (ROADMAP queue 1: worker and HTTP serving, what waits)"
FRONTEND_REFUSED = {
    "--grpc-port": ("the KServe gRPC frontend (ROADMAP queue 1: worker and "
                    "HTTP serving, what waits)", "value"),
    **{f"--slo-{name}": (SLO, "value")
       for name in ("ttft", "itl", "target-ratio", "fast-window",
                    "slow-window", "fast-burn", "slow-burn",
                    "check-interval")},
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
    refuse_unported(args, {**RUNTIME_REFUSED, **FRONTEND_REFUSED}, PROG)
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
