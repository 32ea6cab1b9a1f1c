#!/usr/bin/env python3
"""Time the bf16 attention kernels K1 and K4 of several trees of this
repository on one NVIDIA GPU, in turns.

    python3 tools/attention_ab.py OLD NEW NEW OLD

Each argument is a directory holding a `dynamo_tpu_torch` package (a
checkout, or `git archive <commit> dynamo_tpu_torch | tar -x -C DIR`).
Each runs in a process of its own, in the order given: it builds that
tree's kernels, then times them at `chip_smoke.py` phase 13's shapes — K1
on the ragged path's mixed round (a 512-row chunk + 8 decode rows in the
768-row bucket) and decode round (8 rows, contexts 44..1033), K4 on the
phase path's burst (8 lanes, contexts 44..1033) — with `chip_smoke.time_ms`
(median of 20 launches, L2 flushed, device time only), after holding
each against its plain version. Prints one JSON line per run, then a
table, then the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from dynamo_tpu_torch.engine import attention, cuda_build, ragged

    if not ragged.__file__.startswith(root):
        raise RuntimeError(f"loaded {ragged.__file__}, not from {root}")
    sm = _smoke()
    dev = torch.device("cuda")
    cuda_build.build_all()
    gen = torch.Generator().manual_seed(0)
    kvh, d, p, h, n_pages, max_pages = 8, 128, 16, 32, 2048, 512
    kp = torch.randn(kvh, n_pages, p, d, generator=gen).to(dev, torch.bfloat16)
    vp = torch.randn(kvh, n_pages, p, d, generator=gen).to(dev, torch.bfloat16)
    flush_buf = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    plain_k1 = sm.blocked_plain_attention(ragged, torch)
    out = {"root": root}
    shapes = {
        "k1_mixed": sm.attention_mix(torch, gen, n_pages, p, max_pages,
                                     [41, 70, 130, 230, 380, 650, 850, 1030],
                                     [(512, 512)], n_pad=768 - 520),
        "k1_decode": sm.attention_mix(torch, gen, n_pages, p, max_pages,
                                      [44, 73, 133, 233, 383, 653, 853, 1033],
                                      [], n_pad=0),
    }
    for label, (qp, ln, tb) in shapes.items():
        qp, ln, tb = qp.to(dev), ln.to(dev), tb.to(dev)
        q = torch.randn(qp.numel(), h, d, generator=gen).to(dev,
                                                            torch.bfloat16)
        got = ragged.ragged_paged_attention(q, kp, vp, qp, ln, tb)
        want = plain_k1(q, kp, vp, qp, ln, tb)
        torch.testing.assert_close(got.float(), want.float(),
                                   **sm.K1_BF16_TOL)
        out[label] = sm.time_ms(torch, lambda: ragged.ragged_paged_attention(
            q, kp, vp, qp, ln, tb), flush=flush_buf.zero_)
    q4, _, _, l4, t4 = sm.decode_case(
        torch, gen, dev, torch.bfloat16, [44, 73, 133, 233, 383, 653, 853,
                                          1033], n_pages, max_pages, h, kvh,
        p, d)
    got = attention.paged_attention_decode(q4, kp, vp, l4, t4)
    want = attention.paged_attention_decode_ref(q4, kp, vp, l4, t4)
    torch.testing.assert_close(got.float(), want.float(), **sm.K4_BF16_TOL)
    out["k4_burst"] = sm.time_ms(torch, lambda: attention
                                 .paged_attention_decode(q4, kp, vp, l4, t4),
                                 flush=flush_buf.zero_)
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
    for r in runs:
        print(f"{r['root']}: K1 mixed {r['k1_mixed']:.4f} ms, K1 decode "
              f"{r['k1_decode']:.4f} ms, K4 burst {r['k4_burst']:.4f} ms")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
