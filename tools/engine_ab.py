#!/usr/bin/env python3
"""Serve chip_smoke.py's main-path batch through the engines of several
trees of this repository on one NVIDIA GPU, in turns, and compare the
end-to-end numbers: output tok/s and TTFT p50.

    python3 tools/engine_ab.py OLD NEW NEW OLD

Each argument is a directory holding a `dynamo_tpu_torch` package (a
checkout, or `git archive <commit> dynamo_tpu_torch | tar -x -C DIR`).
Each runs in a process of its own, in the order given: it builds that
tree's kernels, makes Llama-3-8B with random bf16 weights (seed 0,
`chip_smoke.LLAMA3_8B_CONFIG`), and serves three batches of 10 chat
requests of 16..1500 bytes (`chip_smoke.write_jobs`, seeds 0, 1, 2, so
no batch reuses another's prefixes), max_tokens 32, prefill budget 512,
one after the other through one engine: first on the phase path (k = 8
pipelined bursts), then through a ragged engine on the same weights.
Batch 1 pays every first dispatch (on a tree with `engine/graphs.py`,
the graph captures); batches 2 and 3 are the steady state. Prints one
JSON line per tree, then a table, then the card's name and power limit.
"""

from __future__ import annotations

import asyncio
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCHES = 3


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def serve(torch, eng, card, jobs: list[str]) -> list[dict]:
    """Each jobs file as one batch through `eng`, in one event loop."""
    from dynamo_tpu_torch.run.main import build_pipeline_for, run_batch

    args = type("Args", (), {"tokenizer": "auto", "context_length": None,
                             "max_tokens": 32})()
    pipeline = build_pipeline_for(card, eng, args)
    graphs = getattr(eng, "graphs", None)

    async def go():
        out = []
        try:
            for path in jobs:
                n_ttft, tokens, rounds = (len(eng.ttft_s), eng.tokens_emitted,
                                          eng.rounds)
                captures = graphs.captures if graphs is not None else 0
                t0 = time.perf_counter()
                await run_batch(pipeline, card.name, path, 32, None)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                ttft = eng.ttft_s[n_ttft:]
                out.append({
                    "tok/s": (eng.tokens_emitted - tokens) / wall,
                    "TTFT p50 ms": 1e3 * statistics.median(ttft),
                    "wall s": wall, "dispatches": eng.rounds - rounds,
                    "captures": (graphs.captures - captures
                                 if graphs is not None else None)})
        finally:
            await eng.close()
        return out

    return asyncio.run(go())


def one(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from dynamo_tpu_torch.engine import cuda_build
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.llm.entrypoint import build_torch_engine

    if not cuda_build.__file__.startswith(root):
        raise RuntimeError(f"loaded {cuda_build.__file__}, not from {root}")
    sm = _smoke()
    cuda_build.build_all()
    work = tempfile.mkdtemp(prefix="engine_ab_")
    ckpt = os.path.join(work, "llama3-8b")
    os.makedirs(ckpt)
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(sm.LLAMA3_8B_CONFIG, f)
    jobs = [sm.write_jobs(os.path.join(work, f"jobs{i}.jsonl"), seed=i)
            for i in range(BATCHES)]
    os.environ.pop("DYN_ATTENTION_IMPL", None)
    engine, card = build_torch_engine(
        ckpt, "llama3-8b", num_pages=2048, max_batch_size=8,
        prefill_chunk_budget=512, decode_steps_per_sync=8,
        pipeline_bursts=True, random_init=True, rng_seed=0, device="cuda")
    model = engine.model
    out = {"root": root}
    runs = {"phase": serve(torch, engine, card, jobs)}
    ragged = TorchEngine(TorchEngineConfig(
        model=model.cfg, num_pages=2048, max_batch_size=8,
        prefill_chunk_budget=512, attention_impl="ragged", device="cuda"),
        model=model)
    runs["ragged"] = serve(torch, ragged, card, jobs)
    for path, batches in runs.items():
        first, steady = batches[0], batches[1:]
        out[f"{path} first tok/s"] = first["tok/s"]
        out[f"{path} first TTFT p50 ms"] = first["TTFT p50 ms"]
        out[f"{path} first captures"] = first["captures"]
        out[f"{path} steady tok/s"] = statistics.median(
            b["tok/s"] for b in steady)
        out[f"{path} steady TTFT p50 ms"] = statistics.median(
            b["TTFT p50 ms"] for b in steady)
        out[f"{path} steady captures"] = sum(
            b["captures"] or 0 for b in steady)
        out[f"{path} dispatches"] = [b["dispatches"] for b in batches]
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for root in argv:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    keys = [k for k in dict.fromkeys(k for r in runs for k in r)
            if k != "root"]
    print(" | " + " | ".join(r["root"] for r in runs))
    for key in keys:
        print(f"{key} | " + " | ".join(
            str(r.get(key)) if not isinstance(r.get(key), float)
            else f"{r[key]:.2f}" for r in runs))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
