"""Launcher: one engine, in process, fed from text or a batch file.

Port of `dynamo_tpu/run/main.py` for the torch engine:

    python -m dynamo_tpu_torch.run in=text:<prompt> out=torch:<ckpt> [flags]
    python -m dynamo_tpu_torch.run in=batch:<file.jsonl> out=torch:<ckpt>

A batch line may carry chat request fields beside its text, e.g. a
guided or penalised request:
    {"text": "pick", "nvext": {"guided_choice": ["yes", "no"]}}
    {"text": "json", "response_format": {"type": "json_object"}}
    {"text": "x", "nvext": {"guided_regex": "[a-z]+"},
     "presence_penalty": 1.5}

`out=torch:<ckpt>` serves a checkpoint directory through
`build_torch_engine` on `--device` (default cuda; it raises without a
card), on the phase path (`DYN_ATTENTION_IMPL=ragged`: the ragged
path). The pipeline is OpenAIPreprocessor → Backend → TorchEngine, as
`build_pipeline_for` builds it. `in=http` and `dyn://` outputs arrive with
the worker slice.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from typing import Optional

USAGE = ("python -m dynamo_tpu_torch.run in=text:<prompt>|batch:<file> "
         "out=torch:<ckpt> [flags]")
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
    p = argparse.ArgumentParser(prog="python -m dynamo_tpu_torch.run",
                                usage=USAGE)
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


def build_pipeline_for(card, sink_engine, args):
    """OpenAIPreprocessor → Backend → `sink_engine`, with the card's
    tokenizer unless `args.tokenizer` overrides it."""
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
        default_max_tokens=args.max_tokens)
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
    nvext guided_regex / guided_choice / guided_json, ...). Writes one
    JSONL result per line (text, finish reason, completion tokens,
    seconds) and returns the results."""
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
        async for chunk in pipeline.generate(req, Context()):
            if chunk.get("usage"):
                tokens = chunk["usage"]["completion_tokens"]
            for ch in chunk.get("choices", ()):
                t = ch.get("delta", {}).get("content")
                if t:
                    parts.append(t)
                if ch.get("finish_reason"):
                    finish = ch["finish_reason"]
        return {"index": i, "text": "".join(parts),
                "finish_reason": finish, "completion_tokens": tokens,
                "elapsed_s": round(time.perf_counter() - t0, 4)}

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


async def amain(inp: str, out: str, args) -> None:
    from dynamo_tpu_torch.llm.entrypoint import build_torch_engine

    if not out.startswith("torch:") or not out[len("torch:"):]:
        raise SystemExit(f"unknown out={out!r}; expected out=torch:<ckpt>")
    engine, card = build_torch_engine(
        out[len("torch:"):], args.model_name, num_pages=args.num_pages,
        max_batch_size=args.max_batch_size,
        prefill_chunk_budget=args.prefill_chunk_budget,
        pipeline_bursts=args.pipeline_bursts,
        random_init=args.random_init, device=args.device)
    try:
        pipeline = build_pipeline_for(card, engine, args)
        if inp.startswith("text:"):
            prompt = inp[len("text:"):]
            if not prompt:
                raise SystemExit("in=text:<prompt> needs a prompt")
            await run_one(pipeline, card.name, prompt, args.max_tokens,
                          stream_out=sys.stdout)
        elif inp.startswith("batch:"):
            results = await run_batch(pipeline, card.name,
                                      inp[len("batch:"):], args.max_tokens,
                                      args.batch_output)
            print(f"BATCH_DONE {len(results)}", file=sys.stderr, flush=True)
        else:
            raise SystemExit(f"unknown in={inp!r}; expected "
                             f"text:<prompt>|batch:<file>")
    finally:
        await engine.close()


def main(argv: Optional[list[str]] = None) -> None:
    inp, out, rest = parse_io(list(argv if argv is not None
                                   else sys.argv[1:]))
    args = parse_args(rest)
    asyncio.run(amain(inp, out, args))
