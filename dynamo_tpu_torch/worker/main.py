"""Worker CLI implementation (see package docstring).

Port of `dynamo_tpu/worker/main.py`: parse args, build the engine,
register the endpoint and the model card, serve until signal; the engine
monitor force-exits so the lease drops when the engine dies.

Flags keep the reference's names and defaults for what this slice serves.
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
DISAGG = "disaggregated serving (ROADMAP queue 1: KVBM and disagg)"
SPEC = "speculative decoding (ROADMAP queue 1: engine/spec.py)"
MULTI = "the multi-device paths (ROADMAP queue 1: TP, PP, SP)"
KVBM = "KVBM (ROADMAP queue 1: KVBM and disagg)"
MM = "multimodal serving (ROADMAP queue 1: multimodal)"
MOCK = ("the mocker engine, which the port does not carry (--echo serves "
        "without a model)")
WORKER_REFUSED = {
    "--is-prefill-worker": (DISAGG, "store_true"),
    "--enable-disagg": (DISAGG, "store_true"),
    "--prefill-queue": (DISAGG, "store_true"),
    "--max-local-prefill-length": (DISAGG, "value"),
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


def instance_id_of(args: argparse.Namespace) -> int:
    return (args.instance_id if args.instance_id is not None
            else (os.getpid() << 16 | 1))


def build_engine_and_card(args: argparse.Namespace):
    """(engine, card) per the CLI's engine selection; the engine's KV
    events and metrics carry the instance id as their worker id."""
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    if args.echo:
        from dynamo_tpu_torch.engines import EchoEngine

        name = args.served_model_name or "echo"
        card = ModelDeploymentCard(
            name=name, namespace=args.namespace, component=args.component,
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
    card.component = args.component
    card.endpoint = args.endpoint
    card.migration_limit = args.migration_limit
    card.router_mode = args.router_mode
    return engine, card


async def start_worker(args: argparse.Namespace):
    """Build the engine, then take the lease, serve, publish the card.
    Returns (runtime, engine, handle, monitor)."""
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
    handle = await serve_engine(rt, engine, card, instance_id=instance_id)
    monitor = EngineDeathMonitor(engine)
    monitor.start()
    print(f"WORKER_READY {card.namespace}/{card.component}/"
          f"{card.endpoint}/{instance_id:x}", flush=True)
    return rt, engine, handle, monitor


async def stop_worker(objs) -> None:
    rt, engine, handle, monitor = objs
    monitor.stop()
    await handle.stop()
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
