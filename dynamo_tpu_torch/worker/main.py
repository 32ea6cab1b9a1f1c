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
threshold follows the store key `disagg_config_key`). With
`--prefill-queue` the remote prefills ride the durable queue
(`disagg/prefill_queue.py`): the decode worker enqueues, and a prefill
worker runs a `PrefillQueueConsumer` on its component's queue beside its
push endpoint (`:297-303`, `:420-430`). `--kvbm-host-blocks` attaches
KVBM's host tier to the engine, the other `--kvbm-*` flags (or their
`DYN_KVBM_*` runtime-config fields) set its offload pipeline, and the
worker serves the G4 tier (`KvbmDistributed`) and the pipeline counters on
its scrape (`:444-455`). `--draft-model` (with `--spec-gamma` and
`--spec-iters-per-sync`) serves speculative decoding (`:236-238`).
The runtime flags `--system-port` (`/live`, `/health`, `/metrics`,
`/config`) and `--health-check*` (idle canaries through the engine) are
served; persistent canary failure exits the process with rc 43 so the
lease drops (`:434-443`). `DYN_WATCHDOG_STALL_S` arms the dispatch
watchdog, whose trip quarantines the worker — deregister, abort streams
into `Migration`, flush KVBM — and exits rc 44 (`:458-481`). With
`DYN_MEM_LEDGER` arming the engine's memory ledger and `DYN_OOM_EXIT`
set, an out-of-memory error in the engine's scheduler writes its
forensic crash file (under `DYN_MEM_CRASH_DIR`) and exits rc 45
(`engine/memory.py` record_oom), so a supervisor tells an OOM from an
engine death.
`--encode-worker` serves the multimodal image-encode endpoint instead of
a model (component `encoder` unless `--component` names another; image
tokens start at `--image-vocab-offset`), and `--encode-component` puts
that component on an LM worker's card so the frontend sends its image
parts there (`:170`, `:251-254`, `:382-405`). A Mixtral checkpoint or
config serves like any other; `--expert-parallel-size` is accepted at 1,
the reference's default (`:113`), and refused above it.
`--mock` serves the mocker (`mocker/engine.py`: card `mock-model`, the
word tokenizer, the instance id as its `worker_id`; `--mock-speedup`,
`--mock-decode-ms`, `--mock-total-blocks`), which needs no device and
makes no CUDA context (`:161-179`).
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
import asyncio
import logging
import os
import time

from dynamo_tpu_torch.cli_util import (
    add_refused,
    add_runtime_args,
    refuse_unported,
    run_until_signal,
    runtime_config_from_args,
    setup_logging,
)

logger = logging.getLogger(__name__)

PROG = "python -m dynamo_tpu_torch.worker"
MULTI = "the multi-device paths (ROADMAP queue 1: TP, PP, SP)"
WORKER_REFUSED = {
    "--sp-degree": (MULTI, "value"),
    "--sp-threshold": (MULTI, "value"),
    "--sp-layout": (MULTI, "value"),
    "--tensor-parallel-size": (MULTI, "int>1"),
    "--expert-parallel-size": (
        "the multi-device paths (ROADMAP queue 1: EP)", "int>1"),
    "--pipeline-parallel-size": (MULTI, "int>1"),
    "--pp-microbatches": (MULTI, "value"),
    "--num-nodes": (MULTI, "int>1"),
    "--node-rank": (MULTI, "value"),
    "--leader-addr": (MULTI, "value"),
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog=PROG, description="dynamo_tpu_torch engine worker")
    add_runtime_args(p)
    eng = p.add_mutually_exclusive_group()
    eng.add_argument("--model", default=None,
                     help="checkpoint dir or cached HF name (TorchEngine)")
    eng.add_argument("--mock", action="store_true",
                     help="serve the mocker engine (no device needed)")
    eng.add_argument("--echo", action="store_true",
                     help="serve the token-echo engine")
    eng.add_argument("--encode-worker", action="store_true",
                     help="serve the multimodal image-encode endpoint "
                          "(no LM)")
    p.add_argument("--image-vocab-offset", type=int, default=128256,
                   help="encode worker: image tokens start here")
    p.add_argument("--encode-component", default="",
                   help="LM workers: enable image inputs via this "
                        "encode-worker component")
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
    # speculative decoding
    p.add_argument("--draft-model", default=None,
                   help="small checkpoint for speculative decoding")
    p.add_argument("--spec-gamma", type=int, default=4,
                   help="draft tokens proposed per spec iteration")
    p.add_argument("--spec-iters-per-sync", type=int, default=8,
                   help="fused spec iterations per host sync (scales "
                        "burst length and the admission lookahead)")
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
    p.add_argument("--prefill-queue", action="store_true",
                   help="disagg jobs ride the durable queue (pull model) "
                        "instead of push routing; on prefill workers "
                        "starts the queue consumer")
    # KVBM
    p.add_argument("--kvbm-host-blocks", type=int, default=0,
                   help="enable the KVBM host tier with this many blocks")
    p.add_argument("--kvbm-offload-queue", type=int, default=None,
                   help="async KVBM pipeline: staging-queue bound in "
                        "blocks for background offload (default: "
                        "DYN_KVBM_OFFLOAD_QUEUE or 0 = inline/sync)")
    p.add_argument("--kvbm-offload-workers", type=int, default=None,
                   help="tier-IO thread pool width (default: "
                        "DYN_KVBM_OFFLOAD_WORKERS or 0 = one thread)")
    p.add_argument("--kvbm-prefetch-blocks", type=int, default=None,
                   help="blocks prefetched per waiting request into the "
                        "staged host buffer (default: "
                        "DYN_KVBM_PREFETCH_BLOCKS or 0 = off)")
    p.add_argument("--kvbm-offload-queue-bytes", type=int, default=None,
                   help="byte bound on the staged offload queue — "
                        "tightens --kvbm-offload-queue when both are set "
                        "(default: DYN_KVBM_OFFLOAD_QUEUE_BYTES or 0 = "
                        "block count only)")
    # mocker knobs
    p.add_argument("--mock-speedup", type=float, default=1.0)
    p.add_argument("--mock-decode-ms", type=float, default=4.0)
    p.add_argument("--mock-total-blocks", type=int, default=1024)
    add_refused(p, WORKER_REFUSED)
    return p.parse_args(argv)


def check_args(args: argparse.Namespace) -> None:
    """SystemExit for a flag the port refuses or a router mode it cannot
    serve — before anything is built."""
    from dynamo_tpu_torch.llm.model_manager import check_router_mode

    from dynamo_tpu_torch.engine.watchdog import watchdog_from_env

    refuse_unported(args, WORKER_REFUSED, PROG)
    try:
        check_router_mode(args.router_mode)
        watchdog_from_env(None)     # DYN_WATCHDOG_* read before the build
    except ValueError as e:
        raise SystemExit(f"{PROG}: {e}") from None
    if not (args.model or args.mock or args.echo or args.encode_worker):
        raise SystemExit(f"{PROG}: one of --model / --mock / --echo / "
                         f"--encode-worker is required")
    if args.is_prefill_worker and args.enable_disagg:
        raise SystemExit(f"{PROG}: --is-prefill-worker and --enable-disagg "
                         f"name the two sides; give one")
    fake = "echo" if args.echo else "mocker" if args.mock else None
    if fake and (args.is_prefill_worker or args.enable_disagg):
        raise SystemExit(f"{PROG}: disaggregated serving needs --model (the "
                         f"{fake} engine holds no KV)")
    if fake and args.kvbm_host_blocks:
        raise SystemExit(f"{PROG}: KVBM needs --model (the {fake} engine "
                         f"holds no KV)")
    if fake and args.draft_model:
        raise SystemExit(f"{PROG}: speculative decoding needs --model (the "
                         f"{fake} engine has no target to verify)")


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
    if args.mock:
        from dynamo_tpu_torch.mocker.engine import (
            MockEngine,
            MockEngineConfig,
        )

        name = args.served_model_name or "mock-model"
        card = ModelDeploymentCard(
            name=name, namespace=args.namespace, component=component,
            endpoint=args.endpoint, tokenizer_kind="word",
            tokenizer_path=name, migration_limit=args.migration_limit,
            router_mode=args.router_mode,
            encode_component=args.encode_component)
        engine = MockEngine(MockEngineConfig(
            block_size=card.kv_block_size,
            total_kv_blocks=args.mock_total_blocks,
            speedup=args.mock_speedup,
            decode_ms_per_iter=args.mock_decode_ms,
            worker_id=instance_id_of(args)))
        return engine, card
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
        device=args.device, worker_id=instance_id_of(args),
        kvbm_host_blocks=args.kvbm_host_blocks,
        kvbm_offload_queue=args.kvbm_offload_queue or 0,
        kvbm_offload_workers=args.kvbm_offload_workers or 0,
        kvbm_prefetch_blocks=args.kvbm_prefetch_blocks or 0,
        kvbm_offload_queue_bytes=args.kvbm_offload_queue_bytes or 0,
        draft_model=args.draft_model, spec_gamma=args.spec_gamma,
        spec_iters_per_sync=args.spec_iters_per_sync, **overrides)
    engine.config.prefill_chunk = args.prefill_chunk
    card.namespace = args.namespace
    card.component = component
    card.endpoint = args.endpoint
    card.migration_limit = args.migration_limit
    card.router_mode = args.router_mode
    card.encode_component = args.encode_component
    return engine, card


def apply_kvbm_defaults(args: argparse.Namespace, cfg) -> None:
    """Unset --kvbm-* pipeline flags fall back to the runtime config's
    (`DYN_KVBM_*` env or its file), so a fleet flips the pipeline without
    touching every unit file."""
    for name in ("kvbm_offload_queue", "kvbm_offload_workers",
                 "kvbm_prefetch_blocks", "kvbm_offload_queue_bytes"):
        if getattr(args, name) is None:
            setattr(args, name, getattr(cfg, name))


async def _build_decode_handler(rt, args, card, engine):
    """Decode-side wiring: the prefill pool's kv_pull client, the
    threshold router watching its store key, and either the pool's
    generate client (push) or the queue client (`--prefill-queue`)."""
    from dynamo_tpu_torch.disagg.disagg_router import DisaggRouter
    from dynamo_tpu_torch.disagg.handlers import (
        KV_PULL_ENDPOINT,
        DecodeWorkerHandler,
    )
    from dynamo_tpu_torch.runtime.push import PushRouter

    pf_comp = args.component + "_prefill"
    pf = rt.namespace(card.namespace).component(pf_comp)
    pull_client = await pf.endpoint(KV_PULL_ENDPOINT).client()
    await pull_client.start()
    dr = await DisaggRouter(
        max_local_prefill_length=args.max_local_prefill_length
    ).start_watch(rt, card.namespace, args.component)
    if args.prefill_queue:
        from dynamo_tpu_torch.disagg.prefill_queue import QueuePrefillClient

        handler = DecodeWorkerHandler(
            engine, kv_pull_router=PushRouter(pull_client),
            disagg_router=dr,
            prefill_queue_client=QueuePrefillClient(
                rt, card.namespace, queue=pf_comp))
        return handler, [dr.stop, pull_client.stop]
    gen_client = await pf.endpoint(args.endpoint).client()
    await gen_client.start()
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

    cfg = runtime_config_from_args(args)
    if args.encode_worker:
        return await _start_encode_worker(args, cfg)
    apply_kvbm_defaults(args, cfg)
    t0 = time.perf_counter()
    engine, card = build_engine_and_card(args)
    logger.info("engine built in %.2f s (before the lease is taken)",
                time.perf_counter() - t0)
    rt = await DistributedRuntime.create(cfg)
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
        if args.prefill_queue:
            from dynamo_tpu_torch.disagg.prefill_queue import (
                PrefillQueueConsumer,
            )

            # scoped like the push path's pool: two models in one
            # namespace never take each other's jobs
            consumer = PrefillQueueConsumer(
                rt, serving, card.namespace, queue=card.component).start()
            stops.append(consumer.stop)
            consumer.register(rt.metrics)
    elif args.enable_disagg:
        serving, stops = await _build_decode_handler(rt, args, card, engine)
    if rt.health is not None:
        # persistent canary failure = wedged-but-alive worker: exit so the
        # lease drops and routers stop sending traffic (the engine-death
        # monitor's exit contract)
        def _canary_dead(subject: str) -> None:
            logger.error("canary health checks failing for %s; exiting so "
                         "the lease drops", subject)
            os._exit(43)

        rt.health.on_unhealthy = _canary_dead
    if getattr(engine, "kvbm", None) is not None:
        # G4: advertise and serve this worker's tier blocks, pull peers'
        # at admission; the pipeline counters join the scrape
        from dynamo_tpu_torch.kvbm.distributed import KvbmDistributed

        kvbm_dist = KvbmDistributed(engine.kvbm, rt, card.namespace,
                                    card.component, worker_id=instance_id)
        await kvbm_dist.start()
        stops.append(kvbm_dist.close)
        rt.wire_kvbm(engine.kvbm)
    handle = await serve_engine(rt, serving, card, instance_id=instance_id)
    monitor = EngineDeathMonitor(engine)
    monitor.start()
    # dispatch watchdog (None unless DYN_WATCHDOG_STALL_S): a wedged
    # dispatch quarantines this process and exits rc 44 so a supervisor
    # respawns it; hard_exit covers the event loop itself being wedged
    from dynamo_tpu_torch.engine.watchdog import watchdog_from_env

    watchdog = watchdog_from_env(engine, runtime=rt,
                                 instance=f"{instance_id:x}",
                                 hard_exit=True)
    if watchdog is not None:
        from dynamo_tpu_torch.worker.quarantine import quarantine_worker

        def _on_trip(event: dict) -> None:
            asyncio.get_running_loop().create_task(quarantine_worker(
                rt, handle, engine,
                reason=f"watchdog: {event.get('cause')}",
                exit_process=True, watchdog=watchdog))

        watchdog.on_trip = _on_trip
        watchdog.start()

        async def _stop_watchdog() -> None:
            watchdog.stop()

        stops.append(_stop_watchdog)
    print(f"WORKER_READY {card.namespace}/{card.component}/"
          f"{card.endpoint}/{instance_id:x}", flush=True)
    return rt, engine, handle, monitor, stops


class _EncodeHandle:
    """The encode endpoint under the worker's handle protocol."""

    def __init__(self, served) -> None:
        self.served = served

    async def stop(self) -> None:
        await self.served.shutdown()


class _NoMonitor:
    def stop(self) -> None:
        pass


async def _start_encode_worker(args: argparse.Namespace, cfg):
    """The encode worker: its encoder (trained weights, on `--device`)
    is ready before the runtime takes its lease."""
    from dynamo_tpu_torch.multimodal import (
        EncodeWorkerHandler,
        ImageEncoderConfig,
        serve_encode_worker,
    )
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    handler = EncodeWorkerHandler(
        ImageEncoderConfig(vocab_offset=args.image_vocab_offset),
        device=args.device)
    rt = await DistributedRuntime.create(cfg)
    # the default component is the LM's; an encode worker defaults to its own
    comp = "encoder" if args.component == "backend" else args.component
    served = await serve_encode_worker(rt, args.namespace, comp,
                                       instance_id=args.instance_id,
                                       handler=handler)
    print(f"WORKER_READY {args.namespace}/{comp}/encode/"
          f"{served.instance.instance_id:x}", flush=True)
    return rt, None, _EncodeHandle(served), _NoMonitor(), []


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
