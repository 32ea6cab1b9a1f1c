#!/usr/bin/env python3
"""Per-CTA timeline of the A8 stream GEMM (K5 / K6 at M <= 16) on one
NVIDIA GPU.

    python3 tools/a8_trace.py [TREE]

Copies TREE's `dynamo_tpu_torch` (default: this checkout) into
`_build/a8_trace/`, adds `%globaltimer` stamps to that copy's stream GEMM
(`csrc/a8_gemm.cuh` `stream_body`) — each CTA writes, past the end of the
partial slots, when it started, when its producer's griddepcontrol.wait
returned (the row quantize had completed), when its consumers found their
first and their last stage full, and when it ended — builds the copy, and
runs one K5 and one K6 call at the 8B gate/up and down shapes at M = 8
after `chip_smoke.time_ms`'s L2 flush. Prints, per call, the min / median
/ max over the CTAs of each stamp in µs from the first CTA's start. The
package itself carries no stamps: this is a probe, not a mode.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMPS = ("start", "quantized", "first_stage", "last_stage", "end")

# (anchor in stream_body, stamp inserted after it)
PATCHES = [
    ("  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n",
     "  unsigned long long* stamp = reinterpret_cast<unsigned long long*>(\n"
     "      g.part + TRACE_AT) + 8 * c;\n"
     "  auto now = []() {\n"
     "    unsigned long long t;\n"
     "    asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
     "    return t;\n"
     "  };\n"
     "  if (threadIdx.x == 0) stamp[0] = now();\n"),
    ("    griddep_wait();\n    for (int i = 0; i < pre; ++i) load_x(i);\n",
     "    stamp[1] = now();\n"),
    ("    mbar_wait(&full[slot], (i / S::kStages) & 1);\n",
     "    if (threadIdx.x == 0 && i == 0) stamp[2] = now();\n"
     "    if (threadIdx.x == 0 && i == n - 1) stamp[3] = now();\n"),
    ("    zero();\n  }\n", "  if (threadIdx.x == 0) stamp[4] = now();\n"),
]


def instrument(src: str, trace_at: int) -> str:
    for anchor, stamp in PATCHES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"a8_trace: anchor not found once in "
                               f"stream_body:\n{anchor}")
        src = src.replace(anchor, anchor + stamp)
    return src.replace("TRACE_AT", str(trace_at))


def main(argv: list[str]) -> int:
    tree = os.path.abspath(argv[0] if argv else HERE)
    copy = os.path.join(HERE, "_build", "a8_trace")
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "dynamo_tpu_torch"),
                    os.path.join(copy, "dynamo_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    sys.path.insert(0, copy)
    sys.path.insert(1, HERE)
    import torch

    import chip_smoke as sm
    from dynamo_tpu_torch.engine import cuda_build, int4_mm, paged_core, quant

    dev = torch.device("cuda")
    n_ctas = int4_mm.STREAM_CTAS_PER_SM * paged_core.sm_count(dev)
    trace_at = int4_mm.PART_INTS_PER_CTA * n_ctas       # past every slot
    header = os.path.join(copy, "dynamo_tpu_torch", "csrc", "a8_gemm.cuh")
    with open(header) as f:
        src = f.read()
    with open(header, "w") as f:
        f.write(instrument(src, trace_at))
    # room for the stamps behind the slots (8 words of 64 bits per CTA)
    int4_mm.PART_INTS_PER_CTA += 16
    cuda_build.build_all()
    gen = torch.Generator().manual_seed(4)
    flush_buf = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    for label in ("gate/up", "down"):
        k, n = sm.PROJECTIONS[label]
        w = torch.randn(k, n, generator=gen).to(dev, torch.bfloat16)
        for bits, fn in ((8, int4_mm.w8a8_matmul), (4, int4_mm.int4_matmul)):
            qt = quant.quantize(w, bits, 8 if bits == 8 else 16)
            x = sm.a8_case(torch, gen, dev, 8, k, torch.bfloat16)
            for _ in range(3):
                fn(x, qt.q, qt.s)
            part, _ = int4_mm.stream_scratch(x.device, qt.q.shape[0])
            part[trace_at:trace_at + 16 * n_ctas] = 0
            flush_buf.zero_()
            torch.cuda._sleep(sm.SLEEP_CYCLES)
            fn(x, qt.q, qt.s)
            torch.cuda.synchronize()
            t = part[trace_at:trace_at + 16 * n_ctas].view(torch.int64) \
                .view(n_ctas, 8)[:, :len(STAMPS)].cpu()
            t = t[t[:, 0] > 0]                     # CTAs that ran
            us = (t - t[:, 0].min()).double() / 1e3
            row = {"call": f"{'K5' if bits == 8 else 'K6'} {label} M=8",
                   "ctas": int(t.shape[0])}
            for i, name in enumerate(STAMPS):
                col = us[:, i]
                row[name] = [round(float(v), 2) for v in
                             (col.min(), col.median(), col.max())]
            print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
