#!/usr/bin/env python3
"""Time the hand-written kernels of several trees of this repository on
one NVIDIA GPU, in turns: the bf16 attention kernels K1 and K4, the A8
GEMMs K5 (w8a8_matmul) and K6 (int4_matmul), and the KV stores K2
(paged_kv_write) and K3 (paged_kv_write_pages).

    python3 tools/kernel_ab.py [--only attention|a8|a8-group|floor|kv]
                               [--probe] OLD NEW NEW OLD

Each argument is a directory holding a `dynamo_tpu_torch` package (a
checkout, or `git archive <commit> dynamo_tpu_torch | tar -x -C DIR`).
Each runs in a process of its own, in the order given: it builds that
tree's kernels, then times them with `chip_smoke.time_ms` (median of 20
launches, L2 flushed by a 64 MB write, or for `kv` by a 64 MB read,
device time only), after holding each against its plain version:
- K1 on the ragged path's mixed round (a 512-row chunk + 8 decode rows in
  the 768-row bucket) and decode round (8 rows, contexts 44..1033), K4 on
  the phase path's burst (8 lanes, contexts 44..1033), as `chip_smoke.py`
  phase 13;
- K5 and K6 at Llama-3-8B's four projection shapes (wq/wo, wk/wv,
  gate/up, down) at M = 8 (a decode burst's step) and 512 (a prefill
  chunk), and gate/up at M = 40, bf16 activations, each bit-identical
  with its plain version first;
- `a8-group` (not in the default set): one grouped K5 / K6 call over
  q/k/v and over gate/up against one call per weight, M = 8 and 40;
- `floor` (not in the default set): what the timing itself costs and
  allows — a 1-element kernel, a plain PyTorch read of the 8B gate/up
  int8 weights (`amax`), and K5 / K6 at gate/up M = 8, each with L2
  flushed by writing 64 MB (`time_ms`'s flush: it leaves dirty lines the
  timed work must write back) and by reading 64 MB;
- `kv` (not in the default set): K2 at the ragged path's 8-row decode and
  768-row mixed rounds and K3 at the phase path's 32-slot chunk (a
  480-token chunk in the 512 bucket), each bit-exact with its plain
  version outside page 0 first: one launch on contiguous sources, a run
  of 32 launches (one per layer, 32 cache pairs) as `ms per launch`, and
  the whole per-layer KV write as that tree's step issues it, over 32
  layers including what the step computes once (the K2 targets, the
  chunk writer): the redirect ops + K2, or the block copies + K3, of a
  tree that has them against one launch per layer; K3 also on the
  chunk's permuted view where the tree takes it. An empty kernel's time
  under the same flush is printed beside them.
`--probe` skips the plain-version checks of `a8`, for trees whose
kernels leave work out on purpose (a probe of what limits a kernel: its
epilogue or its MMAs removed); their times are not a kernel's times.
Prints one JSON line per run, then a table, then the card's name and
power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KV_PAGES = 2048           # the 8B run's KV pool
A8_CASES = [(label, m) for label in ("wq/wo", "wk/wv", "gate/up", "down")
            for m in (8, 512)] + [("gate/up", 40)]


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def attention_times(sm, torch, dev, flush) -> dict:
    from dynamo_tpu_torch.engine import attention, ragged

    gen = torch.Generator().manual_seed(0)
    kvh, d, p, h, n_pages, max_pages = 8, 128, 16, 32, 2048, 512
    kp = torch.randn(kvh, n_pages, p, d, generator=gen).to(dev, torch.bfloat16)
    vp = torch.randn(kvh, n_pages, p, d, generator=gen).to(dev, torch.bfloat16)
    plain_k1 = sm.blocked_plain_attention(ragged, torch)
    out = {}
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
            q, kp, vp, qp, ln, tb), flush=flush)
    q4, _, _, l4, t4 = sm.decode_case(
        torch, gen, dev, torch.bfloat16, [44, 73, 133, 233, 383, 653, 853,
                                          1033], n_pages, max_pages, h, kvh,
        p, d)
    got = attention.paged_attention_decode(q4, kp, vp, l4, t4)
    want = attention.paged_attention_decode_ref(q4, kp, vp, l4, t4)
    torch.testing.assert_close(got.float(), want.float(), **sm.K4_BF16_TOL)
    out["k4_burst"] = sm.time_ms(torch, lambda: attention
                                 .paged_attention_decode(q4, kp, vp, l4, t4),
                                 flush=flush)
    return out


def a8_times(sm, torch, dev, flush, check: bool = True) -> dict:
    from dynamo_tpu_torch.engine import int4_mm, quant

    gen = torch.Generator().manual_seed(1)
    out = {}
    for label in dict.fromkeys(lbl for lbl, _ in A8_CASES):
        k, n = sm.PROJECTIONS[label]
        w = torch.randn(k, n, generator=gen).to(dev, torch.bfloat16)
        for bits, fn, ref, key in (
                (8, int4_mm.w8a8_matmul, int4_mm.w8a8_matmul_ref, "k5"),
                (4, int4_mm.int4_matmul, int4_mm.int4_matmul_ref, "k6")):
            qt = quant.quantize(w, bits, 8 if bits == 8 else 16)
            for m in (m for lbl, m in A8_CASES if lbl == label):
                x = sm.a8_case(torch, gen, dev, m, k, torch.bfloat16)
                if check and not torch.equal(fn(x, qt.q, qt.s),
                                             ref(x, qt.q, qt.s)):
                    raise AssertionError(f"{key} {label} M={m} differs from "
                                         f"its plain version")
                out[f"{key} {label} M={m}"] = sm.time_ms(
                    torch, lambda: fn(x, qt.q, qt.s), flush=flush)
            del qt
        del w
    return out


def a8_group_times(sm, torch, dev, flush) -> dict:
    from dynamo_tpu_torch.engine import int4_mm, quant

    gen = torch.Generator().manual_seed(2)
    out = {}
    for label, ns in (("q/k/v", (4096, 1024, 1024)),
                      ("gate/up", (14336, 14336))):
        for bits, key in ((8, "k5"), (4, "k6")):
            qts = [quant.quantize(torch.randn(4096, n, generator=gen).to(
                dev, torch.bfloat16), bits, 8 if bits == 8 else 16)
                for n in ns]
            pairs = [(qt.q, qt.s) for qt in qts]
            group = (int4_mm.w8a8_matmul_group if bits == 8
                     else int4_mm.int4_matmul_group)
            single = (int4_mm.w8a8_matmul if bits == 8
                      else int4_mm.int4_matmul)
            for m in (8, 40):
                x = sm.a8_case(torch, gen, dev, m, 4096, torch.bfloat16)
                outs = group(x, pairs)
                if not all(torch.equal(o, single(x, q, s))
                           for o, (q, s) in zip(outs, pairs)):
                    raise AssertionError(f"grouped {key} {label} M={m} "
                                         f"differs from single calls")
                out[f"{key} {label} M={m} grouped"] = sm.time_ms(
                    torch, lambda: group(x, pairs), flush=flush)
                out[f"{key} {label} M={m} one call per weight"] = sm.time_ms(
                    torch, lambda: [single(x, q, s) for q, s in pairs],
                    flush=flush)
    return out


def floor_times(sm, torch, dev, flush_buf) -> dict:
    from dynamo_tpu_torch.engine import int4_mm, quant

    gen = torch.Generator().manual_seed(3)
    words = flush_buf.view(torch.int32)
    flushes = {"write-flush": flush_buf.zero_, "read-flush": words.amax}
    tiny = torch.zeros(1, device=dev)
    k, n = sm.PROJECTIONS["gate/up"]
    w = torch.randn(k, n, generator=gen).to(dev, torch.bfloat16)
    x = sm.a8_case(torch, gen, dev, 8, k, torch.bfloat16)
    k5 = quant.quantize(w, 8, 8)
    k6 = quant.quantize(w, 4)
    out = {}
    for name, flush in flushes.items():
        out[f"1-element kernel, {name}"] = sm.time_ms(torch, tiny.zero_,
                                                      flush=flush)
        out[f"read of the gate/up int8 weights (amax), {name}"] = \
            sm.time_ms(torch, lambda: k5.q.view(torch.int32).amax(),
                       flush=flush)
        out[f"k5 gate/up M=8, {name}"] = sm.time_ms(
            torch, lambda: int4_mm.w8a8_matmul(x, k5.q, k5.s), flush=flush)
        out[f"k6 gate/up M=8, {name}"] = sm.time_ms(
            torch, lambda: int4_mm.int4_matmul(x, k6.q, k6.s), flush=flush)
    return out


def kv_times(sm, torch, dev, flush) -> dict:
    from dynamo_tpu_torch.engine import kernels
    from dynamo_tpu_torch.models import llama

    gen = torch.Generator().manual_seed(4)
    cfg = llama.LlamaConfig.llama3_8b()
    kvh, d, p, n_pages, max_pages = 8, 128, 16, KV_PAGES, 512
    bf = torch.bfloat16
    runs = sm.N_LAYER_RUN
    caches = [tuple(torch.randn(kvh, n_pages, p, d, generator=gen)
                    .to(dev, bf) for _ in range(2)) for _ in range(runs)]
    tiny = torch.zeros(1, device=dev)
    out = {"empty kernel": sm.time_ms(torch, tiny.zero_, flush=flush),
           "empty kernel, ms per launch in a run":
               sm.time_run_ms(torch, [tiny.zero_] * runs, flush=flush)}

    def check(write, ref, *args):
        kc, vc = caches[0]
        got_k, got_v, want_k, want_v = kc.clone(), vc.clone(), kc.clone(), \
            vc.clone()
        write(got_k, got_v, *args)
        ref(want_k, want_v, *args)
        if not (torch.equal(got_k[:, 1:], want_k[:, 1:])
                and torch.equal(got_v[:, 1:], want_v[:, 1:])):
            raise AssertionError(f"{write.__name__} differs from its plain "
                                 f"version")

    # K2 on the ragged rounds' rows (valid rows' targets from the lanes'
    # tables, padding rows invalid), rows as the projections leave them
    rounds = {
        "decode": sm.attention_mix(torch, gen, n_pages, p, max_pages,
                                   [44, 73, 133, 233, 383, 653, 853, 1033],
                                   [], n_pad=0),
        "mixed": sm.attention_mix(torch, gen, n_pages, p, max_pages,
                                  [41, 70, 130, 230, 380, 650, 850, 1030],
                                  [(512, 512)], n_pad=768 - 520),
    }
    for label, (qpos, lanes, tables) in rounds.items():
        b = qpos.numel()
        valid = (qpos >= 0).to(dev)
        pos = qpos.clamp(min=0)
        page_ids = tables[lanes.long(), (pos // p).long()].to(dev)
        offsets = (pos % p).to(torch.int32).to(dev)
        safe_pages = torch.where(valid, page_ids, 0).to(torch.int32)
        safe_offs = torch.where(valid, offsets, 0).to(torch.int32)
        srcs = [tuple(torch.randn(b, kvh * d, generator=gen).to(dev, bf)
                      .view(b, kvh, d) for _ in range(2))
                for _ in range(runs)]
        check(kernels.paged_kv_write, kernels.paged_kv_write_ref, *srcs[0],
              safe_pages, safe_offs)
        key = f"k2 {label} rows={b}"
        out[key] = sm.time_ms(torch, lambda: kernels.paged_kv_write(
            *caches[0], *srcs[0], safe_pages, safe_offs), flush=flush)
        out[f"{key}, ms per launch in a run"] = sm.time_run_ms(torch, [
            (lambda c=c, s=s: kernels.paged_kv_write(*c, *s, safe_pages,
                                                     safe_offs))
            for c, s in zip(caches, srcs)], flush=flush)
        if hasattr(llama, "_kv_targets"):      # once per step, then K2
            def step():
                pg, of = llama._kv_targets(page_ids, offsets, valid)
                for c, s in zip(caches, srcs):
                    kernels.paged_kv_write(*c, *s, pg, of)
        else:                                  # redirect + K2 per layer
            def step():
                for c, s in zip(caches, srcs):
                    llama._write_kv(*c, *s, page_ids, offsets, valid)
        out[f"{key}, whole KV write per layer"] = sm.time_ms(
            torch, step, flush=flush, sleep_cycles=sm.RUN_SLEEP_CYCLES) / runs
        del srcs

    # K3 at the chunk shape: Bp 1, T 512 from cursor 0, seq_len 480 → 32
    # slots, the last 2 on page 0; the chunk's K/V token-major
    t = 512
    table = torch.zeros(1, max_pages, dtype=torch.int32)
    table[0, :32] = 1 + torch.randperm(n_pages - 1, generator=gen)[:32]
    table = table.to(dev)
    positions = torch.arange(t, dtype=torch.int32, device=dev)[None]
    seq_lens = torch.full((1,), 480, dtype=torch.int32, device=dev)
    ids = torch.where(torch.arange(32, device=dev) < 30, table[0, :32],
                      0).to(torch.int32)
    srcs = [tuple(torch.randn(1, t, kvh, d, generator=gen).to(dev, bf)
                  for _ in range(2)) for _ in range(runs)]

    def view(a):
        return a.view(32, p, kvh, d).permute(0, 2, 1, 3)

    blocks = [tuple(view(a).contiguous() for a in s) for s in srcs]
    check(kernels.paged_kv_write_pages, kernels.paged_kv_write_pages_ref,
          *blocks[0], ids)
    out["k3 chunk slots=32"] = sm.time_ms(
        torch, lambda: kernels.paged_kv_write_pages(*caches[0], *blocks[0],
                                                    ids), flush=flush)
    out["k3 chunk slots=32, ms per launch in a run"] = sm.time_run_ms(
        torch, [(lambda c=c, s=s: kernels.paged_kv_write_pages(*c, *s, ids))
                for c, s in zip(caches, blocks)], flush=flush)
    views = [tuple(view(a) for a in s) for s in srcs]
    try:
        check(kernels.paged_kv_write_pages, kernels.paged_kv_write_pages_ref,
              *views[0], ids)
    except ValueError:                 # a tree whose K3 takes no views
        out["k3 chunk slots=32 on the chunk's view"] = None
    else:
        out["k3 chunk slots=32 on the chunk's view"] = sm.time_ms(
            torch, lambda: kernels.paged_kv_write_pages(
                *caches[0], *views[0], ids), flush=flush)
        out["k3 chunk slots=32 on the chunk's view, ms per launch in a "
            "run"] = sm.time_run_ms(torch, [
                (lambda c=c, s=s: kernels.paged_kv_write_pages(*c, *s, ids))
                for c, s in zip(caches, views)], flush=flush)

    def step():                        # the writer once, then every layer
        write = llama._chunk_kv_writer(cfg, table, positions, seq_lens,
                                       aligned=True)
        for c, s in zip(caches, srcs):
            write(*c, *s)
    out["k3 chunk slots=32, whole KV write per layer"] = sm.time_ms(
        torch, step, flush=flush, sleep_cycles=sm.RUN_SLEEP_CYCLES) / runs
    return out


def one(root: str, only: str | None, check: bool = True) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from dynamo_tpu_torch.engine import cuda_build

    if not cuda_build.__file__.startswith(root):
        raise RuntimeError(f"loaded {cuda_build.__file__}, not from {root}")
    sm = _smoke()
    dev = torch.device("cuda")
    cuda_build.build_all()
    flush_buf = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    out = {"root": root}
    if only in (None, "attention"):
        out.update(attention_times(sm, torch, dev, flush_buf.zero_))
    if only in (None, "a8"):
        out.update(a8_times(sm, torch, dev, flush_buf.zero_, check))
    if only == "a8-group":
        out.update(a8_group_times(sm, torch, dev, flush_buf.zero_))
    if only == "floor":
        out.update(floor_times(sm, torch, dev, flush_buf))
    if only == "kv":
        out.update(kv_times(sm, torch, dev,
                            flush_buf.view(torch.int32).amax))
    return out


def main(argv: list[str]) -> int:
    only, probe = None, False
    if argv[:1] == ["--only"]:
        only, argv = argv[1], argv[2:]
    if argv[:1] == ["--probe"]:
        probe, argv = True, argv[1:]
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(argv[1], only, check=not probe)), flush=True)
        return 0
    if not argv or only not in (None, "attention", "a8", "a8-group",
                                "floor", "kv"):
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for root in argv:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              *(["--only", only] if only else []),
                              *(["--probe"] if probe else []), "--one",
                              root], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    keys = [k for k in dict.fromkeys(k for r in runs for k in r)
            if k != "root"]
    print("ms | " + " | ".join(r["root"] for r in runs))
    for key in keys:
        print(f"{key} | " + " | ".join(
            "n/a" if r.get(key) is None else f"{r[key]:.4f}" for r in runs))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
