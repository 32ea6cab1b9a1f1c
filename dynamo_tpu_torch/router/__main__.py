"""`python -m dynamo_tpu_torch.router` — standalone KV-router service.

Port of `dynamo_tpu/router/__main__.py`: a route-and-forward `generate`
endpoint and a query-only `best_worker_id` endpoint over the runtime,
targeting an existing worker component. `--kv-record PATH` (or
`DYN_KV_RECORD`) captures the KV-event stream the router consumes to
JSONL (`router/recorder.py`), replayable into any indexer of either
package.

Reference: `components/src/dynamo/router/__main__.py:30-143`.
"""

from __future__ import annotations

import argparse
import logging
import os

from dynamo_tpu_torch.cli_util import (
    add_runtime_args,
    run_until_signal,
    runtime_config_from_args,
    setup_logging,
)

logger = logging.getLogger(__name__)

PROG = "python -m dynamo_tpu_torch.router"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog=PROG, description="standalone KV-aware router service")
    add_runtime_args(p)
    p.add_argument("--component", default="backend",
                   help="worker component to route to")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--router-component", default="router",
                   help="component name this service registers as")
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--kv-overlap-score-weight", type=float, default=1.0)
    p.add_argument("--router-temperature", type=float, default=0.0)
    p.add_argument("--no-kv-events", action="store_true")
    p.add_argument("--router-replica-sync", action="store_true")
    p.add_argument("--kv-record", default=os.environ.get("DYN_KV_RECORD"),
                   metavar="PATH",
                   help="capture the consumed KV-event stream to this "
                        "JSONL file (replayable into any KvIndexer); "
                        "DYN_KV_RECORD is the env equivalent")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    setup_logging(args.log_level)

    async def start():
        from dynamo_tpu_torch.router.kv_router import (
            KvPushRouter,
            KvRouterConfig,
        )
        from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

        rt = await DistributedRuntime.create(runtime_config_from_args(args))
        ns = rt.namespace(args.namespace)
        client = await ns.component(args.component) \
            .endpoint(args.endpoint).client()
        await client.start()
        router = await KvPushRouter(client, rt.events, KvRouterConfig(
            block_size=args.block_size,
            overlap_weight=args.kv_overlap_score_weight,
            temperature=args.router_temperature,
            use_kv_events=not args.no_kv_events,
            replica_sync=args.router_replica_sync,
            kv_record_path=args.kv_record)).start()

        async def best_worker_id(request: dict, context):
            wid, dp, overlap, margin = await router.best_worker_id(
                list(request.get("token_ids", ())))
            yield {"worker_id": wid, "dp_rank": dp,
                   "overlap_blocks": overlap, "logit_margin": margin}

        comp = ns.component(args.router_component)
        served = [
            await comp.endpoint("generate").serve(router),
            await comp.endpoint("best_worker_id").serve(best_worker_id),
        ]
        print(f"ROUTER_READY {args.namespace}/{args.router_component}",
              flush=True)
        return rt, router, client, served

    async def stop(objs):
        rt, router, client, served = objs
        for s in served:
            await s.shutdown()
        await router.stop()
        await client.stop()
        await rt.close()

    run_until_signal(start, shutdown=stop)


if __name__ == "__main__":
    main()
