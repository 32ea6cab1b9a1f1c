"""Launcher: one engine fed from text, a batch file or HTTP.

Port of `dynamo_tpu/run/main.py` for the torch engine:

    python -m dynamo_tpu_torch.run in=text:<prompt> out=torch:<ckpt> [flags]
    python -m dynamo_tpu_torch.run in=batch:<file.jsonl> out=torch:<ckpt>
    python -m dynamo_tpu_torch.run in=http out=torch:<ckpt> [--port N]
    python -m dynamo_tpu_torch.run in=text:<prompt>|batch:<file> \
        out=dyn://<namespace>.<component>.<endpoint> --store tcp://host:port

A batch line may carry chat request fields beside its text, e.g. a
guided or penalised request:
    {"text": "pick", "nvext": {"guided_choice": ["yes", "no"]}}
    {"text": "json", "response_format": {"type": "json_object"}}
    {"text": "x", "nvext": {"guided_regex": "[a-z]+"},
     "presence_penalty": 1.5}

`out=torch:<ckpt>` serves a checkpoint directory through
`build_torch_engine` on `--device` (default cuda; it raises without a
card), on the phase path (`DYN_ATTENTION_IMPL=ragged`: the ragged
path). For text and batch inputs the pipeline is OpenAIPreprocessor →
Backend → TorchEngine, as `build_pipeline_for` builds it. `in=http` serves
the engine on an in-process memory store (`serve_engine`) and starts the
OpenAI frontend over it (`start_frontend`), as the reference does: the
same discovery-driven path as a multi-process deployment, in one process;
it prints `RUN_READY <url>` and serves until SIGINT/SIGTERM.
`out=dyn://ns.comp.ep` routes text and batch inputs to live remote workers
found through `--store`; the tokenizer comes from the workers' published
card. `--router-mode` (round_robin by default, random, or kv) routes
both: under `kv` the in-process engine publishes its KV events on the
runtime's bus and the frontend's KV router reads them, and `dyn://`
routes through a `KvPushRouter` over the workers' events.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from typing import Optional

USAGE = ("python -m dynamo_tpu_torch.run in=text:<prompt>|batch:<file>|http "
         "out=torch:<ckpt>|dyn://<ns>.<component>.<endpoint> [flags]")
PROG = "python -m dynamo_tpu_torch.run"
# keys of a batch line that are not chat request fields
_BATCH_OWN_KEYS = ("text", "prompt", "messages", "max_tokens", "model",
                   "stream")


def parse_io(argv: list[str]) -> tuple[str, str, list[str]]:
    """Split the positional in=/out= pair from the remaining flags."""
    inp, out = "", ""
    rest = []
    for a in argv:
        if a.startswith("in="):
            inp = a[3:]
        elif a.startswith("out="):
            out = a[4:]
        else:
            rest.append(a)
    return inp, out, rest


def parse_args(rest: list[str]) -> argparse.Namespace:
    from dynamo_tpu_torch.cli_util import add_runtime_args

    p = argparse.ArgumentParser(prog=PROG, usage=USAGE)
    add_runtime_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080,
                   help="in=http: the frontend's port")
    p.add_argument("--router-mode", default="round_robin",
                   choices=["kv", "round_robin", "random"],
                   help="in=http and dyn:// routing")
    p.add_argument("--model-name", default=None,
                   help="served model name (default: checkpoint dir name)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--max-tokens", type=int, default=64)
    p.add_argument("--context-length", type=int, default=None)
    p.add_argument("--batch-output", default=None,
                   help="batch mode: output JSONL path (default stdout)")
    p.add_argument("--tokenizer", default="auto",
                   choices=["auto", "word", "byte"],
                   help="override the card's tokenizer")
    p.add_argument("--random-init", action="store_true",
                   help="seeded random weights instead of the checkpoint's")
    p.add_argument("--num-pages", type=int, default=2048)
    p.add_argument("--max-batch-size", type=int, default=8)
    p.add_argument("--prefill-chunk-budget", type=int, default=0)
    p.add_argument("--no-pipeline-bursts", dest="pipeline_bursts",
                   action="store_false",
                   help="phase path: sync each decode burst before "
                        "dispatching the next")
    return p.parse_args(rest)


def build_pipeline_for(card, sink_engine, args, encode_router=None):
    """OpenAIPreprocessor → Backend → `sink_engine`, with the card's
    tokenizer unless `args.tokenizer` overrides it; `encode_router` (an
    AsyncEngine over encode workers) serves image parts."""
    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.llm.tokenizer import make_tokenizer
    from dynamo_tpu_torch.runtime.engine import build_pipeline

    kind, tpath = card.tokenizer_kind, card.tokenizer_path
    if args.tokenizer != "auto":
        kind, tpath = args.tokenizer, card.name
    tok = make_tokenizer(kind, tpath)
    pre = OpenAIPreprocessor(
        tok, card.name,
        context_length=args.context_length or card.context_length,
        default_max_tokens=args.max_tokens,
        tool_call_parser=card.tool_call_parser,
        reasoning_parser=card.reasoning_parser,
        encode_router=encode_router)
    return build_pipeline(pre, Backend(tok), sink=sink_engine)


async def run_one(pipeline, model: str, prompt: str, max_tokens: int,
                  stream_out=None) -> str:
    """One chat turn through the pipeline; returns the full text."""
    from dynamo_tpu_torch.runtime.context import Context

    req = {"_kind": "chat", "body": {
        "model": model, "stream": True, "max_tokens": max_tokens,
        "messages": [{"role": "user", "content": prompt}]}}
    parts = []
    async for chunk in pipeline.generate(req, Context()):
        for ch in chunk.get("choices", ()):
            t = ch.get("delta", {}).get("content")
            if t:
                parts.append(t)
                if stream_out is not None:
                    stream_out.write(t)
                    stream_out.flush()
    if stream_out is not None:
        stream_out.write("\n")
    return "".join(parts)


async def run_batch(pipeline, model: str, path: str, max_tokens: int,
                    out_path: Optional[str]) -> list[dict]:
    """batch:<file.jsonl> — one {"text": ...} or {"messages": [...]} per
    line, all in flight at once; any other key of a line is a chat request
    field (temperature, seed, min_p, presence_penalty, response_format,
    nvext guided_regex / guided_choice / guided_json, logprobs,
    top_logprobs, return_tokens_as_token_ids, ...). Writes one JSONL
    result per line (text, finish reason, completion tokens, seconds, the
    seconds to the first chunk that carried a token, and the logprobs
    entries when the line asked for them) and returns the results."""
    from dynamo_tpu_torch.runtime.context import Context

    async def one(i: int, d: dict) -> dict:
        msgs = d.get("messages") or [
            {"role": "user", "content": d.get("text", d.get("prompt", ""))}]
        body = {k: v for k, v in d.items()
                if k not in _BATCH_OWN_KEYS}
        body.update({"model": model, "stream": True,
                     "max_tokens": int(d.get("max_tokens") or max_tokens),
                     "messages": msgs})
        req = {"_kind": "chat", "body": body}
        t0 = time.perf_counter()
        parts = []
        finish = None
        tokens = 0
        first = None
        lps: list[dict] = []
        async for chunk in pipeline.generate(req, Context()):
            if chunk.get("usage"):
                tokens = chunk["usage"]["completion_tokens"]
            for ch in chunk.get("choices", ()):
                t = ch.get("delta", {}).get("content")
                entries = (ch.get("logprobs") or {}).get("content") or ()
                if first is None and (t or entries):
                    first = time.perf_counter() - t0
                if t:
                    parts.append(t)
                lps.extend(entries)
                if ch.get("finish_reason"):
                    finish = ch["finish_reason"]
        out = {"index": i, "text": "".join(parts),
               "finish_reason": finish, "completion_tokens": tokens,
               "elapsed_s": round(time.perf_counter() - t0, 4),
               "ttft_s": None if first is None else round(first, 4)}
        if body.get("logprobs"):
            out["logprobs"] = lps
        return out

    with open(path, encoding="utf-8") as f:
        jobs = [json.loads(line) for line in f if line.strip()]
    results = await asyncio.gather(*(one(i, d) for i, d in enumerate(jobs)))
    results = sorted(results, key=lambda r: r["index"])
    sink = open(out_path, "w", encoding="utf-8") if out_path else sys.stdout
    try:
        for r in results:
            sink.write(json.dumps(r) + "\n")
    finally:
        if out_path:
            sink.close()
    return results


async def connect_remote(out: str, args, runtime):
    """out=dyn://ns.component.endpoint → a router over live instances
    plus a pipeline card (tokenization happens HERE, so the card's
    tokenizer must match the remote model — resolved from the remote's
    published MDC when one exists)."""
    from dynamo_tpu_torch.llm.model_card import (
        MDC_PREFIX,
        ModelDeploymentCard,
    )
    from dynamo_tpu_torch.router.kv_router import (
        KvPushRouter,
        KvRouterConfig,
    )
    from dynamo_tpu_torch.runtime.push import PushRouter

    spec = out[len("dyn://"):]
    try:
        ns, comp, ep = spec.split(".", 2)
    except ValueError:
        raise SystemExit(f"bad dyn:// target {out!r}: want "
                         "dyn://namespace.component.endpoint") from None
    card: Optional[ModelDeploymentCard] = None
    for kv in await runtime.store.get_prefix(f"{MDC_PREFIX}{ns}/{comp}/"):
        card = ModelDeploymentCard.from_json(kv.value)
        break
    if card is None:  # no published card: assume word-tokenizer echo-style
        name = args.model_name or "run-model"
        card = ModelDeploymentCard(name=name, namespace=ns, component=comp,
                                   endpoint=ep, tokenizer_kind="word",
                                   tokenizer_path=name)
    client = await (runtime.namespace(ns).component(comp)
                    .endpoint(ep).client())
    await client.start()
    await client.wait_ready()
    if args.router_mode == "kv":
        return await KvPushRouter(client, runtime.events, KvRouterConfig(
            block_size=card.kv_block_size)).start(), card
    return PushRouter(client, mode=args.router_mode), card


async def serve_http(engine, card, args) -> None:
    """in=http: serve the engine on an in-process memory store and front
    it with the OpenAI HTTP service until SIGINT/SIGTERM. The worker and
    the frontend share the runtime, so the frontend's /debug routes read
    this engine's flight recorders."""
    import signal

    from dynamo_tpu_torch.cli_util import runtime_config_from_args
    from dynamo_tpu_torch.llm.entrypoint import (
        serve_engine,
        start_frontend,
        wire_engine_events,
    )
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    cfg = runtime_config_from_args(args)
    cfg.store_url = "memory"        # fully local run
    runtime = await DistributedRuntime.create(cfg)
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, runtime.shutdown)
    card.namespace = args.namespace
    card.component = "run"
    card.router_mode = args.router_mode
    if args.router_mode == "kv":
        engine.attach_sinks(*wire_engine_events(runtime, card))
    handle = fe = None
    try:
        # the instance id is the engine's worker id, which its KV events
        # carry: the KV router keys both by it
        handle = await serve_engine(runtime, engine, card,
                                    instance_id=engine.config.worker_id)
        fe = await start_frontend(runtime, host=args.host, port=args.port)
        print(f"RUN_READY {fe.url}", flush=True)
        await runtime.wait_shutdown()
    finally:
        if fe is not None:
            await fe.stop()
        if handle is not None:
            await handle.stop()
        await runtime.close()


async def amain(inp: str, out: str, args) -> None:
    from dynamo_tpu_torch.llm.entrypoint import build_torch_engine

    remote = out.startswith("dyn://")
    if inp == "http" and remote:
        raise SystemExit(
            "in=http out=dyn:// — run python -m dynamo_tpu_torch.frontend "
            "against the shared store instead")
    if not remote and (not out.startswith("torch:")
                       or not out[len("torch:"):]):
        raise SystemExit(f"unknown out={out!r}; expected out=torch:<ckpt> "
                         f"or out=dyn://<ns>.<component>.<endpoint>")
    if not (inp == "http" or inp.startswith(("text:", "batch:"))):
        raise SystemExit(f"unknown in={inp!r}; expected "
                         f"text:<prompt>|batch:<file>|http")
    runtime = engine = sink = None
    try:
        if remote:
            from dynamo_tpu_torch.cli_util import runtime_config_from_args
            from dynamo_tpu_torch.runtime.distributed import (
                DistributedRuntime,
            )

            runtime = await DistributedRuntime.create(
                runtime_config_from_args(args))
            sink, card = await connect_remote(out, args, runtime)
        else:
            engine, card = build_torch_engine(
                out[len("torch:"):], args.model_name,
                num_pages=args.num_pages,
                max_batch_size=args.max_batch_size,
                prefill_chunk_budget=args.prefill_chunk_budget,
                pipeline_bursts=args.pipeline_bursts,
                random_init=args.random_init, device=args.device)
            sink = engine
        if inp == "http":
            await serve_http(engine, card, args)
            return
        pipeline = build_pipeline_for(card, sink, args)
        if inp.startswith("text:"):
            prompt = inp[len("text:"):]
            if not prompt:
                raise SystemExit("in=text:<prompt> needs a prompt")
            await run_one(pipeline, card.name, prompt, args.max_tokens,
                          stream_out=sys.stdout)
        else:
            results = await run_batch(pipeline, card.name,
                                      inp[len("batch:"):], args.max_tokens,
                                      args.batch_output)
            print(f"BATCH_DONE {len(results)}", file=sys.stderr, flush=True)
    finally:
        if engine is not None:
            await engine.close()
        if remote and hasattr(sink, "stop"):
            await sink.stop()           # a KvPushRouter's consumers
        if runtime is not None:
            await runtime.close()


def main(argv: Optional[list[str]] = None) -> None:
    from dynamo_tpu_torch.cli_util import export_faults, setup_logging

    inp, out, rest = parse_io(list(argv if argv is not None
                                   else sys.argv[1:]))
    args = parse_args(rest)
    export_faults(args)        # before the engine's injector is built
    setup_logging(args.log_level)
    asyncio.run(amain(inp, out, args))
