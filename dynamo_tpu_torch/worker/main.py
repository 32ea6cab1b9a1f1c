"""Worker CLI implementation (see package docstring).

Port of `dynamo_tpu/worker/main.py`: parse args, build the engine,
register the endpoint and the model card, serve until signal; the engine
monitor force-exits so the lease drops when the engine dies.

Flags keep the reference's names and defaults for what this slice serves.
Disaggregated serving as the reference's worker serves it
(`dynamo_tpu/worker/main.py:280-310`, `:360-432`): `--is-prefill-worker`
serves the engine under `<component>_prefill` behind
`PrefillWorkerHandler` and its `kv_pull` endpoint; `--enable-disagg`
serves it behind `DecodeWorkerHandler`, which sends prompts longer than
`--max-local-prefill-length` uncached tokens to that prefill pool (the
threshold follows the store key `disagg_config_key`).
One flag is the port's own: `--device` (default cuda; the worker raises
without a card unless `--device cpu` asks for the CPU). The reference's
flags for parts the port has not ported yet are parsed under their names
and refused with a message that names what they wait for.

The engine is built BEFORE the runtime takes its lease: a build that
holds the event loop (an 8B random init, the first kernel builds) longer
than the lease TTL would otherwise let the lease expire before the
worker registers (the reference builds it after `DistributedRuntime.create`).
It is built with `worker_id` = the instance id, as the reference's is
(`dynamo_tpu/worker/main.py:403-410`); its KV-event and metrics sinks
(`wire_engine_events`, which needs the runtime's event bus) are attached
right after the runtime exists and before the instance is served, so no
event precedes them.

Reference: `components/src/dynamo/vllm/main.py:69-228`.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

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

PROG = "python -m dynamo_tpu_torch.worker"
QUEUE = ("the durable prefill-queue dispatch (ROADMAP queue 1: "
         "disagg/prefill_queue.py and runtime/queue.py)")
SPEC = "speculative decoding (ROADMAP queue 1: engine/spec.py)"
MULTI = "the multi-device paths (ROADMAP queue 1: TP, PP, SP)"
KVBM = "KVBM (ROADMAP queue 1: KVBM and disagg)"
MM = "multimodal serving (ROADMAP queue 1: multimodal)"
MOCK = ("the mocker engine, which the port does not carry (--echo serves "
        "without a model)")
WORKER_REFUSED = {
    "--prefill-queue": (QUEUE, "store_true"),
    "--draft-model": (SPEC, "value"),
    "--spec-gamma": (SPEC, "value"),
    "--spec-iters-per-sync": (SPEC, "value"),
    "--sp-degree": (MULTI, "value"),
    "--sp-threshold": (MULTI, "value"),
    "--sp-layout": (MULTI, "value"),
    "--tensor-parallel-size": (MULTI, "int>1"),
    "--expert-parallel-size": (
        "MoE and the multi-device paths (ROADMAP queue 1)", "int>1"),
    "--pipeline-parallel-size": (MULTI, "int>1"),
    "--pp-microbatches": (MULTI, "value"),
    "--num-nodes": (MULTI, "int>1"),
    "--node-rank": (MULTI, "value"),
    "--leader-addr": (MULTI, "value"),
    "--kvbm-host-blocks": (KVBM, "value"),
    "--kvbm-offload-queue": (KVBM, "value"),
    "--kvbm-offload-workers": (KVBM, "value"),
    "--kvbm-prefetch-blocks": (KVBM, "value"),
    "--kvbm-offload-queue-bytes": (KVBM, "value"),
    "--mock": (MOCK, "store_true"),
    "--mock-speedup": (MOCK, "value"),
    "--mock-decode-ms": (MOCK, "value"),
    "--mock-total-blocks": (MOCK, "value"),
    "--encode-worker": (MM, "store_true"),
    "--encode-component": (MM, "value"),
    "--image-vocab-offset": (MM, "value"),
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog=PROG, description="dynamo_tpu_torch engine worker")
    add_runtime_args(p)
    eng = p.add_mutually_exclusive_group()
    eng.add_argument("--model", default=None,
                     help="checkpoint dir or cached HF name (TorchEngine)")
    eng.add_argument("--echo", action="store_true",
                     help="serve the token-echo engine")
    p.add_argument("--served-model-name", default=None)
    p.add_argument("--component", default="backend")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--migration-limit", type=int, default=0)
    p.add_argument("--router-mode", default="kv",
                   choices=["kv", "round_robin", "random"],
                   help="published on the card")
    p.add_argument("--instance-id", type=int, default=None)
    # engine geometry
    p.add_argument("--num-pages", type=int, default=2048)
    p.add_argument("--max-batch-size", type=int, default=8)
    p.add_argument("--decode-steps-per-sync", type=int, default=8)
    p.add_argument("--prefill-chunk", type=int, default=512)
    p.add_argument("--context-length", type=int, default=None,
                   help="override model context (max_pages_per_seq)")
    p.add_argument("--quantize", default=None,
                   choices=["int8", "w8a8", "int4"],
                   help="int8 = weight-only (W8A16); w8a8 = int8 weights "
                        "and per-row int8 activations (K5); int4 = "
                        "packed-nibble W4A8 (K6)")
    p.add_argument("--random-init", action="store_true",
                   help="skip weight load (synthetic benchmarking)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    # disaggregated serving
    p.add_argument("--is-prefill-worker", action="store_true",
                   help="serve remote prefill for decode workers "
                        "(component <component>_prefill)")
    p.add_argument("--enable-disagg", action="store_true",
                   help="decode worker: long prompts go to the prefill pool")
    p.add_argument("--max-local-prefill-length", type=int, default=512,
                   help="uncached prompt tokens above which a decode worker "
                        "prefills remotely")
    add_refused(p, WORKER_REFUSED)
    return p.parse_args(argv)


def check_args(args: argparse.Namespace) -> None:
    """SystemExit for a flag the port refuses or a router mode it cannot
    serve — before anything is built."""
    from dynamo_tpu_torch.llm.model_manager import check_router_mode

    refuse_unported(args, {**RUNTIME_REFUSED, **WORKER_REFUSED}, PROG)
    try:
        check_router_mode(args.router_mode)
    except ValueError as e:
        raise SystemExit(f"{PROG}: {e}") from None
    if not args.model and not args.echo:
        raise SystemExit(f"{PROG}: one of --model / --echo is required")
    if args.is_prefill_worker and args.enable_disagg:
        raise SystemExit(f"{PROG}: --is-prefill-worker and --enable-disagg "
                         f"name the two sides; give one")
    if args.echo and (args.is_prefill_worker or args.enable_disagg):
        raise SystemExit(f"{PROG}: disaggregated serving needs --model (the "
                         f"echo engine holds no KV)")


def instance_id_of(args: argparse.Namespace) -> int:
    return (args.instance_id if args.instance_id is not None
            else (os.getpid() << 16 | 1))


def build_engine_and_card(args: argparse.Namespace):
    """(engine, card) per the CLI's engine selection; the engine's KV
    events and metrics carry the instance id as their worker id."""
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    # the reference's component suffix for the prefill pool (:159)
    component = args.component + ("_prefill" if args.is_prefill_worker
                                  else "")
    if args.echo:
        from dynamo_tpu_torch.engines import EchoEngine

        name = args.served_model_name or "echo"
        card = ModelDeploymentCard(
            name=name, namespace=args.namespace, component=component,
            endpoint=args.endpoint, tokenizer_kind="word",
            tokenizer_path=name, migration_limit=args.migration_limit,
            router_mode=args.router_mode)
        return EchoEngine(), card

    from dynamo_tpu_torch.llm.entrypoint import build_torch_engine

    overrides = {}
    if args.context_length is not None:
        overrides["max_pages_per_seq"] = max(1, args.context_length // 16)
    engine, card = build_torch_engine(
        args.model, served_name=args.served_model_name,
        num_pages=args.num_pages, max_batch_size=args.max_batch_size,
        decode_steps_per_sync=args.decode_steps_per_sync,
        random_init=args.random_init, quantize=args.quantize,
        device=args.device, worker_id=instance_id_of(args), **overrides)
    engine.config.prefill_chunk = args.prefill_chunk
    card.namespace = args.namespace
    card.component = component
    card.endpoint = args.endpoint
    card.migration_limit = args.migration_limit
    card.router_mode = args.router_mode
    return engine, card


async def _build_decode_handler(rt, args, card, engine):
    """Decode-side wiring: the prefill pool's generate and kv_pull
    clients and the threshold router, watching its store key."""
    from dynamo_tpu_torch.disagg.disagg_router import DisaggRouter
    from dynamo_tpu_torch.disagg.handlers import (
        KV_PULL_ENDPOINT,
        DecodeWorkerHandler,
    )
    from dynamo_tpu_torch.runtime.push import PushRouter

    pf = rt.namespace(card.namespace).component(args.component + "_prefill")
    pull_client = await pf.endpoint(KV_PULL_ENDPOINT).client()
    await pull_client.start()
    gen_client = await pf.endpoint(args.endpoint).client()
    await gen_client.start()
    dr = await DisaggRouter(
        max_local_prefill_length=args.max_local_prefill_length
    ).start_watch(rt, card.namespace, args.component)
    handler = DecodeWorkerHandler(
        engine, prefill_router=PushRouter(gen_client),
        kv_pull_router=PushRouter(pull_client), disagg_router=dr)
    return handler, [dr.stop, pull_client.stop, gen_client.stop]


async def start_worker(args: argparse.Namespace):
    """Build the engine, then take the lease, serve, publish the card.
    Returns (runtime, engine, handle, monitor, stops): `stops` are the
    disagg wiring's shutdown coroutines."""
    from dynamo_tpu_torch.llm.entrypoint import (
        serve_engine,
        wire_engine_events,
    )
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.worker.monitor import EngineDeathMonitor

    t0 = time.perf_counter()
    engine, card = build_engine_and_card(args)
    logger.info("engine built in %.2f s (before the lease is taken)",
                time.perf_counter() - t0)
    rt = await DistributedRuntime.create(runtime_config_from_args(args))
    instance_id = instance_id_of(args)
    attach = getattr(engine, "attach_sinks", None)
    if attach is not None:
        attach(*wire_engine_events(rt, card))
    serving, stops = engine, []
    if args.is_prefill_worker:
        from dynamo_tpu_torch.disagg.handlers import (
            PrefillWorkerHandler,
            serve_kv_pull,
        )

        serving = PrefillWorkerHandler(engine, instance_id)
        served = await serve_kv_pull(rt, card.namespace, card.component,
                                     serving, instance_id)
        stops.append(served.shutdown)
    elif args.enable_disagg:
        serving, stops = await _build_decode_handler(rt, args, card, engine)
    handle = await serve_engine(rt, serving, card, instance_id=instance_id)
    monitor = EngineDeathMonitor(engine)
    monitor.start()
    print(f"WORKER_READY {card.namespace}/{card.component}/"
          f"{card.endpoint}/{instance_id:x}", flush=True)
    return rt, engine, handle, monitor, stops


async def stop_worker(objs) -> None:
    rt, engine, handle, monitor, stops = objs
    monitor.stop()
    await handle.stop()
    for stop in stops:
        await stop()
    close = getattr(engine, "close", None)
    if close is not None:
        await close()
    await rt.close()


def main(argv=None) -> None:
    args = parse_args(argv)
    check_args(args)
    setup_logging(args.log_level)
    run_until_signal(lambda: start_worker(args), shutdown=stop_worker)


if __name__ == "__main__":
    main()
