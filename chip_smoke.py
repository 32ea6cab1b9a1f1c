#!/usr/bin/env python3
"""Drive the PyTorch port (dynamo_tpu_torch) on one NVIDIA GPU and hold
its hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches an error and goes
on):
 1. device: require CUDA; print the card's name and power limit
 2. build: compile every kernel from csrc/ (one nvcc per source, in
    parallel) into _build/dynamo_tpu_torch/<hash>/
 3. K2 paged_kv_write vs plain at Llama-3-8B geometry: bit-exact outside
    scratch page 0, on contiguous rows and on strided views (a slice of a
    wider projection output, a head-major tensor transposed)
 4. K3 paged_kv_write_pages vs plain at Llama-3-8B geometry (KVH 8, P 16,
    D 128, bf16): bit-exact outside page 0, several padding slots aimed at
    page 0, on contiguous blocks and on the chunk's token-major K/V viewed
    per page (what the chunk writer passes)
 5. K1 ragged_paged_attention vs plain at Llama-3-8B geometry, bf16 and
    fp32, on a ragged mix (decode rows to 4096 tokens of context, chunk
    rows straddling pages, padding rows that must be exact zeros) and on
    decode rows alone (split across CTAs); in bf16 also with q = 0, where
    the output is each row's exact mean of the V rows it can see; one bf16
    call captured in a CUDA graph and replayed with token_qpos changed in
    place on the device, equal to an eager call
 6. K4 paged_attention_decode vs plain at Llama-3-8B geometry, bf16 and
    fp32: length-0 lanes (exact zeros), lengths at page edges (1, 15, 16,
    17, 32), contexts to 4096 (split across CTAs); in bf16 also q = 0; one
    bf16 call captured in a CUDA graph and replayed with lengths changed in
    place, equal to an eager call
 7. K5 w8a8_matmul and K6 int4_matmul vs plain at the four Llama-3-8B
    projection shapes (4096x4096 wq/wo, 4096x1024 wk/wv, 4096x14336
    gate/up, 14336x4096 down), M in A8_MS (both sides of every design
    edge: the stream GEMM's 8- and 16-row activation tiles, the wide GEMM
    above, with K6's 256- and 128-column tiles), bf16 and fp32
    activations, with an all-zero row (sx
    at its 1e-12 floor) and an outlier: outputs bit-identical; the
    grouped calls q/k/v and gate/up (one quantize, one GEMM) bit-identical
    with the plain version of each weight; one K5, one K6 and one grouped
    call captured in a CUDA graph, x changed in place, replayed: equal to
    an eager call
 8. main paths: Llama-3-8B at full width and depth (random weights from a
    seed) served through `dynamo_tpu_torch.run`'s pipeline, a batch of 10
    chat requests of 16..1500 bytes, prefill_chunk_budget 512; first the
    phase path (the default: k = 8 bursts, pipelined), then the ragged
    path (DYN_ATTENTION_IMPL=ragged) on the same weights; each with the
    launch counts zeroed just before and read just after (phase: K2, K3,
    K4 > 0 and K1 = K5 = K6 = 0; ragged: K1, K2 > 0 and K3 = K4 = K5 = K6
    = 0); greedy determinism; the same greedy request (100-token prompt,
    12 tokens, top-8 logprobs) on both paths, equal up to a parting at a
    bf16 near-tie (BF16_TIE_TOL), printed with its step, tokens and gap
 9. quantized main path: the same batch on the phase path through
    `build_torch_engine(quantize="w8a8")`, then `quantize="int4"` (the
    same random weights, quantized by the engine): w8a8 launches K5 and
    not K6, int4 K6 and not K5, both K2, K3, K4 and not K1; greedy
    determinism; every projection held as int8 / packed int4 only
    (resident weight bytes printed per mode); one bare decode_step
    launches its GEMM exactly 4 x 32 times (q/k/v and gate/up grouped)
10. kernel path vs plain path at 8B: one mixed ragged round and one
    mixed_prefill_decode step in bf16, and one mixed_prefill_decode step
    per quantized mode (logits within a stated tolerance)
11. profiles at 8B: host wall time (with the one sync) and device busy time
    (torch.profiler's CUDA kernels and copies) of a bare ragged decode
    round, a bare ragged mixed round and a bare 8-step decode burst (bf16,
    w8a8, int4, and int8 = W8A16), device time by kernel class and device
    ops per step; each
    bf16 path's engine batch once more with kernel tracing only (host wall
    vs device busy)
12. kernel path vs plain path at 2 layers, full width, fp32: greedy
    streams over 16 steps x 3 requests across phase-kernel, phase-plain,
    ragged-kernel and ragged-plain — identical unquantized, and under
    w8a8 and int4 identical up to partings at near-ties (A8_TIE_TOL)
13. numbers: at the main paths' shapes, each kernel held against its
    plain version once more, then kernel / plain / library times (CUDA
    events around device work only: the card sleeps while the host queues
    the launches; median of 20, L2 flushed before each by reading 64 MB,
    the kernels also after a 64 MB write as in older records), the
    empty-kernel floor under the same flush, K2 and K3 also per launch in
    a run of 32 (one per layer, 32 cache pairs), bounds from bytes and
    operations; K5/K6 at the four projection shapes at M = 8 (burst) and
    512 (chunk) beside torch._int_mm + epilogue and bf16 torch.matmul;
    each path's and mode's output tok/s and TTFT p50

The last three lines of stdout are the kernels JSON, the nvidia-smi line
and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import asyncio
import contextlib
import itertools
import json
import os
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Llama-3-8B's published shape (models/llama.py LlamaConfig.llama3_8b)
LLAMA3_8B_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 128, "vocab_size": 128256,
    "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
    "max_position_embeddings": 8192, "tie_word_embeddings": False,
}
# card peaks (NVIDIA data sheets, dense): HBM bytes/s, bf16 and fp32 flop/s,
# int8 op/s
PEAKS = {"H100 SXM": (3.35e12, 989e12, 67e12, 1979e12),
         "H100 PCIe": (2.0e12, 756e12, 51e12, 1513e12),
         "H100 NVL": (3.9e12, 835e12, 60e12, 1671e12)}
# K1 in bf16 vs the plain version (fp32 softmax): |got - want| <=
# atol + rtol * |want|. The kernel rounds P to bf16 before PV and both
# sides round the output to bf16 once: two bf16 ulps relative (rtol), and
# atol 2^-8 for rows whose output is small beside its V values.
K1_BF16_TOL = {"atol": 4e-3, "rtol": 1.6e-2}
K1_FP32_TOL = {"atol": 2e-5, "rtol": 2e-5}   # the reference's parity check
# K1 in bf16 with q = 0: every score is 0, so P = 1 is exact in bf16 and
# each row's output is the fp32 mean of the V rows it can see, rounded to
# bf16 once. Held against the plain version in fp32 to half a bf16 ulp
# (2^-8 relative): one key too many or too few moves a row's mean by about
# |v| / context, above that for every context these checks use
K1_UNIFORM_TOL = {"atol": 1e-5, "rtol": 4e-3}
# K4 against its plain version: fp32 at the reference's kernel-parity
# tolerance; bf16 as K1 (K4's bf16 path is K1's core at one row per lane,
# so it too rounds P to bf16 before PV); q = 0 as K1
K4_FP32_TOL = K1_FP32_TOL
K4_BF16_TOL = K1_BF16_TOL
K4_UNIFORM_TOL = K1_UNIFORM_TOL
# 8B mixed round / mixed step, kernel vs plain path in bf16: the attention
# outputs differ by bf16 roundings that 32 layers carry to the logits
# (measured 0.094 at max |logit| 4.8 on an H100 80GB HBM3, 700 W)
LOGITS_BF16_TOL = 0.15
# Greedy bf16 8B streams of one request, phase path vs ragged path: the two
# attend through different bf16 kernels (plain prefill attention + K4 vs
# K1), which move each logprob by up to what phase 10 measures between
# kernel and plain paths (0.1245 for the mixed step's decode top-8
# logprobs on an H100 80GB HBM3, 700 W; bounded there by LOGITS_BF16_TOL).
# Where the streams part, both runs' logprobs of the two tokens moved by at
# most that and their order flipped, so each run's margin is at most twice
# it
BF16_TIE_TOL = 2 * LOGITS_BF16_TOL
# The same step under w8a8 / int4. The A8 GEMMs are bit-identical with
# their plain versions, but each bf16 rounding difference in attention that
# crosses an int8 step of an activation row becomes a whole step (~1/127
# of the row's absmax), so the differences grow past the bf16 path's
# (measured 0.156 for w8a8's decode top-8 logprobs beside bf16's 0.0935 on
# an H100 80GB HBM3, 700 W)
LOGITS_A8_TOL = 0.4
PLAIN_ROW_BLOCK = 64      # the plain K1 gathers whole contexts per row
# Greedy fp32 streams under w8a8/int4 across paths: the A8 rounding is
# discontinuous, so an fp32 difference of one ulp in attention (kernel vs
# plain, phase vs ragged) now and then rounds an activation to the next
# int8 step, and the 2-layer full-width model's logits move by a few
# hundredths. Two streams may then part at a greedy near-tie: the streams
# must agree before it, and there each run must rank the other's token
# within this many nats of its own (partings measured at 0.020-0.054 nats
# on an H100 80GB HBM3, 700 W; a wrong product moves logits by O(1))
A8_TIE_TOL = 0.15
# the card spins this many cycles (~1 ms) before each timed launch, so the
# host has queued the launch before the start event fires and the events
# read device time only
SLEEP_CYCLES = 2_000_000
# ~10 ms: a run of 32 layers' launches (up to 4 host ops each) is queued
# before the start event fires
RUN_SLEEP_CYCLES = 20_000_000
# Llama-3-8B's projections (K, N): wq/wo, wk/wv, gate/up, down
PROJECTIONS = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024),
               "gate/up": (4096, 14336), "down": (14336, 4096)}
QUANT_MODES = ("w8a8", "int4")
# K5/K6 activation rows held against the plain versions: both sides of
# every design edge (int4_mm.design)
A8_MS = (1, 8, 9, 16, 17, 40, 64, 65, 512, 600)
GEMM_OF = {"w8a8": "w8a8_matmul", "int4": "int4_matmul"}
K2_LAYOUTS = ("contiguous", "fused", "heads")
K3_LAYOUTS = ("chunk", "contiguous")
N_LAYER_RUN = 32          # Llama-3-8B's layers: one KV store each per step


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks_for(name: str) -> tuple[str, tuple[float, float, float]]:
    for key in ("PCIe", "NVL"):
        if key in name:
            return f"H100 {key}", PEAKS[f"H100 {key}"]
    return "H100 SXM", PEAKS["H100 SXM"]


def time_ms(torch, fn, reps: int = 20, flush=None,
            sleep_cycles: int = SLEEP_CYCLES) -> float:
    """Median of `reps` single launches timed with CUDA events; `flush`
    (outside the timed window) evicts L2 first, and the card then sleeps
    `sleep_cycles` so that the events time the device work and not the
    host's enqueue of it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(sleep_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_run_ms(torch, fns, reps: int = 20, flush=None) -> float:
    """A run of launches as a step issues them (one per layer, say): the
    median over `reps` of the run's device time after one flush, over the
    number of launches. The card sleeps RUN_SLEEP_CYCLES first, long
    enough for the host to queue the whole run."""
    return time_ms(torch, lambda: [fn() for fn in fns], reps, flush,
                   RUN_SLEEP_CYCLES) / len(fns)


def l2_flushes(torch, dev) -> dict:
    """{"read": ..., "write": ...}: two ways to evict the 50 MB L2 before
    a timed launch. The write flush (zeroing 64 MB) leaves dirty lines
    that the timed work then pays to write back; the read flush (an amax
    over the same 64 MB into one scalar) leaves only clean lines."""
    buf = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    words = buf.view(torch.int32)
    return {"read": words.amax, "write": buf.zero_}


def k2_rows(torch, gen, dev, b, kvh, d, layout, dtype=None):
    """(B, KVH, D) K2 rows laid out as a caller may hand them: "contiguous"
    (a projection's output viewed as heads, what every step passes),
    "fused" (a slice of a wider (B, 3·KVH·D) projection output), "heads"
    (a head-major tensor transposed)."""
    dtype = dtype or torch.bfloat16
    if layout == "fused":
        wide = torch.randn(b, 3 * kvh * d, generator=gen).to(dev, dtype)
        return wide[:, kvh * d:2 * kvh * d].view(b, kvh, d)
    if layout == "heads":
        return torch.randn(kvh, b, d, generator=gen).to(dev, dtype) \
            .transpose(0, 1)
    return torch.randn(b, kvh * d, generator=gen).to(dev, dtype) \
        .view(b, kvh, d)


def k3_blocks(torch, gen, dev, m, kvh, p, d, layout, dtype=None):
    """(M, KVH, P, D) K3 blocks: "chunk" (a token-major (M·P, KVH, D)
    chunk K/V viewed per page and permuted, what `_chunk_kv_writer`
    passes) or "contiguous"."""
    dtype = dtype or torch.bfloat16
    if layout == "chunk":
        return torch.randn(m * p, kvh, d, generator=gen).to(dev, dtype) \
            .view(m, p, kvh, d).permute(0, 2, 1, 3)
    return torch.randn(m, kvh, p, d, generator=gen).to(dev, dtype)


def attention_mix(torch, gen, n_pages: int, page_size: int, max_pages: int,
                  decode_ctx: list[int], chunks: list[tuple[int, int]],
                  n_pad: int):
    """Flat rows of one ragged round: one decode row per context length
    (attending positions < ctx), chunk rows (start, length), padding rows.
    Each lane gets its own pages (never page 0). Returns (qpos, lanes,
    tables) int32 on the CPU."""
    lanes_n = len(decode_ctx) + len(chunks)
    tables = torch.zeros(lanes_n, max_pages, dtype=torch.int32)
    free = (1 + torch.randperm(n_pages - 1, generator=gen)).tolist()
    qpos, lanes = [], []
    for lane, ctx in enumerate(decode_ctx):
        need = -(-ctx // page_size)
        tables[lane, :need] = torch.tensor(free[:need])
        free = free[need:]
        qpos.append(ctx - 1)
        lanes.append(lane)
    for j, (start, n) in enumerate(chunks):
        lane = len(decode_ctx) + j
        need = -(-(start + n) // page_size)
        tables[lane, :need] = torch.tensor(free[:need])
        free = free[need:]
        qpos += list(range(start, start + n))
        lanes += [lane] * n
    qpos += [-1] * n_pad
    lanes += [0] * n_pad
    return (torch.tensor(qpos, dtype=torch.int32),
            torch.tensor(lanes, dtype=torch.int32), tables)


def bound(nbytes: float, flops: float, flop_rate: float, peaks):
    """max(bytes / HBM rate, flops / peak rate) in ms, and which binds."""
    t_bytes, t_ops = nbytes / peaks[0], flops / flop_rate
    return 1e3 * max(t_bytes, t_ops), \
        ("bytes" if t_bytes >= t_ops else "operations")


def k1_bound_ms(torch, qpos, lanes, tables, h, kvh, d, p, esize, peaks):
    """Least time for K1's work on these inputs. Bytes: q of the valid
    rows, every output row (padding rows write zeros), every qpos, the
    valid rows' lanes, the table entries of the pages those rows can see,
    and those pages' K and V once each. Flops: 4 per (head, visible key,
    d)."""
    valid = qpos >= 0
    ctx = (qpos[valid].long() + 1)
    pages = set()
    for lane, c in zip(lanes[valid].tolist(), ctx.tolist()):
        pages.update((lane, j) for j in range(-(-c // p)))
    unique = {int(tables[lane, j]) for lane, j in pages}
    rows, n_valid = qpos.numel(), int(valid.sum())
    nbytes = ((n_valid + rows) * h * d * esize
              + 2 * len(unique) * kvh * p * d * esize
              + 4 * rows + 4 * n_valid + 4 * len(pages))
    flops = 4 * h * d * int(ctx.sum())
    return bound(nbytes, flops, peaks[1] if esize == 2 else peaks[2], peaks)


def k2_bound_ms(page_ids, kvh, d, esize, peaks):
    """Least time for K2's work: every row's page id and offset; K and V
    of the rows that land outside scratch page 0 read and written once,
    plus one page-0 row (all padding rows write the same slot)."""
    n_pad = int((page_ids == 0).sum())
    kept = page_ids.numel() - n_pad + min(n_pad, 1)
    return bound(4 * kept * kvh * d * esize + 8 * page_ids.numel(), 0.0,
                 peaks[1], peaks)


def k3_bound_ms(page_ids, kvh, p, d, esize, peaks):
    """Least time for K3's work: every slot's page id; the K and V pages of
    the slots that land outside scratch page 0 read and written once, plus
    one page-0 slot (all padding slots write the same page)."""
    n_pad = int((page_ids == 0).sum())
    kept = page_ids.numel() - n_pad + min(n_pad, 1)
    return bound(4 * kept * kvh * p * d * esize + 4 * page_ids.numel(), 0.0,
                 peaks[1], peaks)


def a8_bound_ms(m, k, n, bits, esize, peaks):
    """Least time for K5's (bits 8) or K6's (bits 4) work: x read once,
    the weights (K·N·bits/8 bytes) and scales read once, y written once;
    2·M·K·N int8 operations at the int8 dense peak."""
    nbytes = m * k * esize + k * n * bits // 8 + 4 * n + m * n * esize
    return bound(nbytes, 2.0 * m * k * n, peaks[3], peaks)


def k4_bound_ms(lengths, tables, h, kvh, d, p, esize, peaks):
    """Least time for K4's work on these inputs. Bytes: q of the lanes with
    a length, every output lane (padding lanes write zeros), the lengths,
    the table entries of the pages the lanes can see and those pages' K and
    V once each. Flops: 4 per (head, visible key, d)."""
    lens = [int(x) for x in lengths.tolist()]
    pages = [(b, j) for b, n in enumerate(lens) for j in range(-(-n // p))]
    unique = {int(tables[b, j]) for b, j in pages}
    n_valid = sum(1 for n in lens if n > 0)
    nbytes = ((n_valid + len(lens)) * h * d * esize + 4 * len(lens)
              + 4 * len(pages) + 2 * len(unique) * kvh * p * d * esize)
    flops = 4 * h * d * sum(lens)
    return bound(nbytes, flops, peaks[1] if esize == 2 else peaks[2], peaks)


def decode_case(torch, gen, dev, dtype, lengths, n_pages, max_pages, h, kvh,
                p, d, zero_q=False):
    """K4 inputs: one query per lane, each lane its own pages (never page
    0). Returns (q, k_pages, v_pages, lengths, tables) on `dev`."""
    b = len(lengths)
    tables = torch.zeros(b, max_pages, dtype=torch.int32)
    free = (1 + torch.randperm(n_pages - 1, generator=gen)).tolist()
    for i, n in enumerate(lengths):
        need = -(-n // p)
        tables[i, :need] = torch.tensor(free[:need], dtype=torch.int32)
        free = free[need:]
    q = torch.zeros(b, h, d) if zero_q else torch.randn(b, h, d,
                                                        generator=gen)
    kp = torch.randn(kvh, n_pages, p, d, generator=gen)
    vp = torch.randn(kvh, n_pages, p, d, generator=gen)
    return (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype),
            torch.tensor(lengths, dtype=torch.int32).to(dev), tables.to(dev))


def uniform_check(ragged, plain_k1, torch, kp, vp, qpos, lanes, tables,
                  h, label):
    """K1 in bf16 with q = 0 against the plain version in fp32 on the same
    (bf16-valued) pages: each row's output is the mean of the V rows it
    can see, so a dropped or extra key, page, tile step or split shows."""
    q = torch.zeros(qpos.numel(), h, kp.shape[-1], device=kp.device,
                    dtype=torch.bfloat16)
    got = ragged.ragged_paged_attention(q, kp, vp, qpos, lanes, tables)
    want = plain_k1(q.float(), kp.float(), vp.float(), qpos, lanes, tables)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, **K1_UNIFORM_TOL)
    err = (got.float() - want).abs().max().item()
    log(f"[k1] {label} uniform attention (q = 0) bf16 vs fp32 plain: "
        f"max_abs_err {err:.3e} ({K1_UNIFORM_TOL})")


def graph_replay_check(torch, call, index, values, label):
    """`call()` (a bf16 K1 or K4 launch) captured once in a CUDA graph,
    then replayed after each of `values` is copied in place into the
    device tensor `index` (token_qpos or lengths): each replay must equal
    an eager call on the same inputs, so the kernel read nothing of
    `index` on the host when it was captured."""
    call()                              # the scratch exists before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for new in values:
        index.copy_(new)
        graph.replay()
        want = call()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"{label}: the graph replay differs from an "
                                 f"eager call")
    del graph
    log(f"[graph] {label}: captured once, replayed with {len(values)} "
        f"in-place changes, equal to eager calls")


def blocked_plain_attention(ragged, torch):
    """The plain K1 over row blocks of PLAIN_ROW_BLOCK (its per-row
    context gather would not fit the card for a whole round)."""
    def run(q, kp, vp, qpos, lanes, tables):
        outs = [ragged.ragged_attention_ref(
                    q[i:i + PLAIN_ROW_BLOCK], kp, vp,
                    qpos[i:i + PLAIN_ROW_BLOCK],
                    lanes[i:i + PLAIN_ROW_BLOCK], tables)
                for i in range(0, q.shape[0], PLAIN_ROW_BLOCK)]
        return torch.cat(outs) if outs else torch.empty_like(q)
    return run


def write_jobs(path: str, seed: int) -> str:
    """The main path's batch: 10 chat prompts of 16..1500 bytes."""
    rng = random.Random(seed)
    with open(path, "w") as f:
        for n in (16, 40, 100, 200, 350, 600, 800, 1000, 1250, 1500):
            text = "".join(rng.choice("abcdefghij klmnop qrstuv wxyz.,")
                           for _ in range(n))
            f.write(json.dumps({"text": text}) + "\n")
    return path


def profile_engine_batch(torch, engine, pipeline, run_batch, name: str,
                         jobs: str, out_path: str):
    """The batch once more, through a fresh engine, with CUPTI kernel
    tracing only (no host-op recording, so the host runs at its normal
    pace), and host clocks around the engine's device-blocking calls it
    makes on its own methods (ragged: its rounds and first-token
    sampling; phase: first-token sampling only — its chunk rounds,
    bursts and mixed steps run inside closures). Returns (wall_s,
    device_busy_s or None, rounds, seconds inside the clocked calls)."""
    from torch.profiler import ProfilerActivity, profile

    inside = [0.0]

    def clocked(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                inside[0] += time.perf_counter() - t0
        return run

    engine._ragged_core = clocked(engine._ragged_core)
    engine._first_token_packed = clocked(engine._first_token_packed)

    async def go():
        try:
            t0 = time.perf_counter()
            await run_batch(pipeline, name, jobs, 32, out_path)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        finally:
            await engine.close()

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = asyncio.run(go())
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    return wall, busy or None, engine.rounds, inside[0]


def kernel_class(name: str) -> str:
    low = name.lower()
    if "paged_attention_core" in low:     # the bf16 core: <D, kDecode>
        return ("K4 paged_attention_decode" if "true>" in low
                else "K1 ragged_paged_attention")
    if "paged_decode" in low or "decode_combine" in low:
        return "K4 paged_attention_decode"
    if any(w in low for w in ("ragged_tile", "ragged_fp32", "combine")):
        return "K1 ragged_paged_attention"
    if "paged_kv_write_pages" in low:
        return "K3 paged_kv_write_pages"
    if "paged_kv_write" in low:
        return "K2 paged_kv_write"
    if "w8a8_gemm" in low:
        return "K5 w8a8_matmul GEMM"
    if "int4_gemm" in low:
        return "K6 int4_matmul GEMM"
    if "quantize_rows" in low:
        return "K5/K6 row quantize"
    if any(w in low for w in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
        return "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if "sort" in low or "radix" in low:
        return "sort (sampling top-k)"
    return "other (elementwise, norms, softmax, sampling)"


def profile_rounds(torch, llama, model, dev, n_pad_mixed: int,
                   labels=("decode", "mixed", "burst")):
    """Bare device steps of `model` outside the engine, as the engine runs
    them: host arrays copied to the card, the step, the packed result
    copied back (its one sync) — a ragged decode round and a ragged mixed
    round, and the phase path's 8-step decode burst over the same 8 lanes
    (those of `labels`). Returns {label: (wall_ms, busy_ms, device ops per
    step, {class: ms}, [(ms, kernel), ...] top 5)}; busy_ms is None where
    the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    cfg = model.cfg
    P, bmax = cfg.page_size, 8
    ctx = [44, 73, 133, 233, 383, 653, 853, 1033]
    kc, vc = llama.init_cache(cfg, 1 + 72 * (bmax + 1), dev)
    for cache in kc + vc:           # attention over real-valued keys
        cache.normal_()

    def host_round(chunk: int):
        """(chunk rows of lane 0 at positions chunk..2*chunk-1) + the
        decode block of 8 lanes, padded to chunk + 8 + n_pad rows."""
        # lane 0 = the chunk's, lanes bmax.. = decode; 72 own pages each
        tables = torch.zeros(2 * bmax, cfg.max_pages_per_seq,
                             dtype=torch.int32)
        for i, lane in enumerate([0, *range(bmax, 2 * bmax)]):
            tables[lane, :72] = torch.arange(1 + 72 * i, 73 + 72 * i)
        pos = list(range(chunk, 2 * chunk)) + [c - 1 for c in ctx]
        lane = [0] * chunk + list(range(bmax, 2 * bmax))
        pad = n_pad_mixed if chunk else 0
        pos_t = torch.tensor(pos + [0] * pad, dtype=torch.int32)
        lane_t = torch.tensor(lane + [0] * pad, dtype=torch.int32)
        valid = torch.arange(pos_t.numel()) < len(pos)
        pages = tables[lane_t.long(), (pos_t // P).long()]
        z = torch.zeros(bmax, dtype=torch.int64)
        return [torch.randint(0, cfg.vocab_size, (pos_t.numel(),),
                              dtype=torch.int32), pos_t, pages, pos_t % P,
                valid, lane_t, tables,
                torch.tensor([max(chunk - 1, 0)] * bmax, dtype=torch.int32),
                torch.arange(chunk, chunk + bmax, dtype=torch.int32), z, z,
                torch.zeros(bmax), torch.ones(bmax), z]

    def one(args):
        packed, _ = llama.ragged_prefill_decode(
            model, kc, vc, *(a.to(dev) for a in args))
        return packed.cpu()

    def burst(args):
        return llama.decode_multi_step(
            model, kc, vc, *(a.to(dev) for a in args), num_steps=8).cpu()

    # the phase path's burst: the same 8 decode lanes, 8 fused steps
    tables = torch.zeros(bmax, cfg.max_pages_per_seq, dtype=torch.int32)
    for i in range(bmax):
        tables[i, :72] = torch.arange(73 + 72 * i, 145 + 72 * i)
    z = torch.zeros(bmax, dtype=torch.int64)
    burst_args = [torch.randint(0, cfg.vocab_size, (bmax,),
                                dtype=torch.int32),
                  torch.tensor(ctx, dtype=torch.int32) - 1, tables,
                  torch.ones(bmax, dtype=torch.bool), z, z,
                  torch.zeros(bmax), torch.ones(bmax), z]
    steps = {"decode": (one, lambda: host_round(0)),
             "mixed": (one, lambda: host_round(512)),
             "burst": (burst, lambda: burst_args)}
    out = {}
    with torch.inference_mode():
        for label in labels:
            fn, make = steps[label]
            args = make()
            out[label] = measure(torch, lambda: fn(args), ProfilerActivity,
                                 profile)
    del kc, vc
    return out


def measure(torch, step, ProfilerActivity, profile, reps: int = 5):
    """Host wall (median of 10) of `step` (which ends in its one sync),
    then `reps` more under torch.profiler: (wall_ms, busy_ms or None,
    device ops per step, {class: ms}, top 5 [(ms, kernel)])."""
    for _ in range(3):
        step()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        walls.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
    by_class, n_kernels, top = {}, 0, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3 / reps
        cls = kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        n_kernels += e.count
        top.append((ms, e.key))
    busy = sum(by_class.values()) or None
    return (statistics.median(walls), busy, n_kernels / reps, by_class,
            sorted(top, reverse=True)[:5])


@contextlib.contextmanager
def plain_path(ragged, kernels, attention, int4_mm, torch):
    """Swap every kernel's wrapper for its plain version (this script's
    comparison only; the package has no such switch)."""
    names = ((ragged, "ragged_paged_attention"), (kernels, "paged_kv_write"),
             (kernels, "paged_kv_write_pages"),
             (attention, "paged_attention_decode"),
             (int4_mm, "w8a8_matmul"), (int4_mm, "int4_matmul"),
             (int4_mm, "w8a8_matmul_group"), (int4_mm, "int4_matmul_group"))
    saved = [getattr(mod, name) for mod, name in names]
    ragged.ragged_paged_attention = blocked_plain_attention(ragged, torch)
    kernels.paged_kv_write = kernels.paged_kv_write_ref
    kernels.paged_kv_write_pages = kernels.paged_kv_write_pages_ref
    attention.paged_attention_decode = attention.paged_attention_decode_ref
    int4_mm.w8a8_matmul = int4_mm.w8a8_matmul_ref
    int4_mm.int4_matmul = int4_mm.int4_matmul_ref
    int4_mm.w8a8_matmul_group = lambda x, ws: [
        int4_mm.w8a8_matmul_ref(x, q, s) for q, s in ws]
    int4_mm.int4_matmul_group = lambda x, ws: [
        int4_mm.int4_matmul_ref(x, p, s) for p, s in ws]
    try:
        yield
    finally:
        for (mod, name), fn in zip(names, saved):
            setattr(mod, name, fn)


def stream_partings(a, b, tol: float) -> list:
    """[(request, step, gap)] where greedy streams `a` and `b` (lists of
    (tokens, top-k [[id, logprob], ...] per token) per request) part;
    raises unless at every parting each run ranks the other's token within
    `tol` nats of its own choice (a near-tie; past it the two continue from
    different tokens and are not compared)."""
    def gap(top, mine, theirs):
        lp = dict((int(i), v) for i, v in top)
        return lp[mine] - lp[theirs] if theirs in lp else float("inf")

    partings = []
    for r, ((ta, ka), (tb, kb)) in enumerate(zip(a, b)):
        if len(ta) != len(tb):
            raise AssertionError(f"request {r}: {len(ta)} vs {len(tb)} tokens")
        step = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y),
                    None)
        if step is None:
            continue
        x, y = ta[step], tb[step]
        g = max(gap(ka[step], x, y), gap(kb[step], y, x))
        if not g <= tol:
            raise AssertionError(f"request {r} parts at step {step}: tokens "
                                 f"{x} vs {y}, logprob gap {g}")
        partings.append((r, step, g))
    return partings


def a8_fns(int4_mm, mode: str):
    """(kernel wrapper, plain version) of a quantized mode."""
    return ((int4_mm.w8a8_matmul, int4_mm.w8a8_matmul_ref) if mode == "w8a8"
            else (int4_mm.int4_matmul, int4_mm.int4_matmul_ref))


def a8_case(torch, gen, dev, m, k, dtype):
    """Activations of mixed row scales for K5/K6, row 0 all zeros (its
    scale sits at the 1e-12 floor), row 2 with an outlier."""
    x = torch.randn(m, k, generator=gen)
    x *= torch.logspace(-3, 2, m)[:, None]
    x[0] = 0.0
    if m > 2:
        x[2, k // 3] = 500.0
    return x.to(dev, dtype)


def check_quantized(torch, quant, model, mode: str) -> None:
    """Every projection is held as int8 (w8a8) or packed int4 only, with
    its mode's activation bits; no layer holds a float tensor larger than
    a norm or a bias."""
    bits, act = quant._bits_of(mode), quant._act_bits_of(mode)
    cfg = model.cfg
    for layer in model.layers:
        for key in quant.QUANT_KEYS:
            w = getattr(layer, key)
            k, n = w.shape
            if not (isinstance(w, quant.QTensor) and w.bits == bits
                    and w.act_bits == act and w.q.dtype == torch.int8
                    and tuple(w.q.shape) == (n * bits // 8, k)):
                raise AssertionError(f"{mode}: {key} is not held as "
                                     f"{bits}-bit weights: {w}")
        for t in layer.parameters():
            if t.numel() > cfg.num_heads * cfg.head_dim:
                raise AssertionError(f"{mode}: a layer holds a float tensor "
                                     f"of {tuple(t.shape)}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from dynamo_tpu_torch.engine import (
        attention,
        cuda_build,
        int4_mm,
        kernels,
        quant,
        ragged,
    )
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.llm.entrypoint import build_torch_engine
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.run.main import build_pipeline_for, run_batch
    from dynamo_tpu_torch.runtime.context import Context

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    sku, peaks = peaks_for(name)
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | peaks as {sku}")

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    log(f"[build] {sorted(cuda_build.KERNELS)} in "
        f"{time.perf_counter() - t0:.1f}s into {cuda_build.build_dir()}")
    for kname, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {kname}: {line.strip()}")

    gen = torch.Generator().manual_seed(0)
    KVH, D, P, H = 8, 128, 16, 32
    N_PAGES, MAX_PAGES = 2048, 512

    # 3. K2 vs plain ---------------------------------------------------------
    B = 64
    kc = torch.randn(KVH, N_PAGES, P, D, generator=gen).to(dev, torch.bfloat16)
    vc = torch.randn(KVH, N_PAGES, P, D, generator=gen).to(dev, torch.bfloat16)
    slots = torch.randperm((N_PAGES - 1) * P, generator=gen)[:B]
    kv_pages = (1 + slots // P).to(torch.int32)
    kv_offs = (slots % P).to(torch.int32)
    kv_pages[-6:] = 0                      # padding rows → scratch page 0
    kv_offs[-6:] = 0
    kv_pages, kv_offs = kv_pages.to(dev), kv_offs.to(dev)
    k2_err = 0.0
    for layout in K2_LAYOUTS:
        k_rows, v_rows = (k2_rows(torch, gen, dev, B, KVH, D, layout)
                          for _ in range(2))
        want_k, want_v = kc.clone(), vc.clone()
        kernels.paged_kv_write_ref(want_k, want_v, k_rows, v_rows, kv_pages,
                                   kv_offs)
        got_k, got_v = kc.clone(), vc.clone()
        kernels.paged_kv_write(got_k, got_v, k_rows, v_rows, kv_pages,
                               kv_offs)
        torch.cuda.synchronize()
        err = max((got_k[:, 1:].float() - want_k[:, 1:].float()).abs().max()
                  .item(), (got_v[:, 1:].float() - want_v[:, 1:].float())
                  .abs().max().item())
        if err != 0.0 or not (torch.equal(got_k[:, 1:], want_k[:, 1:])
                              and torch.equal(got_v[:, 1:], want_v[:, 1:])):
            raise AssertionError(f"K2 differs from its plain version on "
                                 f"{layout} sources: {err}")
        k2_err = max(k2_err, err)
    log(f"[k2] paged_kv_write B={B} KVH={KVH} D={D} P={P} N={N_PAGES}, "
        f"sources {K2_LAYOUTS}: bit-exact outside page 0")

    # 4. K3 vs plain ---------------------------------------------------------
    M = 40
    slot_ids = (1 + torch.randperm(N_PAGES - 1, generator=gen)[:M]) \
        .to(torch.int32)
    slot_ids[[5, 17, 30, 31, 39]] = 0      # padding slots → scratch page 0
    slot_ids = slot_ids.to(dev)
    k3_err = 0.0
    for layout in K3_LAYOUTS:
        k_blocks, v_blocks = (k3_blocks(torch, gen, dev, M, KVH, P, D, layout)
                              for _ in range(2))
        want_k, want_v = kc.clone(), vc.clone()
        kernels.paged_kv_write_pages_ref(want_k, want_v, k_blocks, v_blocks,
                                         slot_ids)
        got_k, got_v = kc.clone(), vc.clone()
        kernels.paged_kv_write_pages(got_k, got_v, k_blocks, v_blocks,
                                     slot_ids)
        torch.cuda.synchronize()
        err = max((got_k[:, 1:].float() - want_k[:, 1:].float()).abs().max()
                  .item(), (got_v[:, 1:].float() - want_v[:, 1:].float())
                  .abs().max().item())
        if err != 0.0 or not (torch.equal(got_k[:, 1:], want_k[:, 1:])
                              and torch.equal(got_v[:, 1:], want_v[:, 1:])):
            raise AssertionError(f"K3 differs from its plain version on "
                                 f"{layout} blocks: {err}")
        k3_err = max(k3_err, err)
    log(f"[k3] paged_kv_write_pages M={M} (5 padding slots on page 0) "
        f"KVH={KVH} P={P} D={D} N={N_PAGES}, blocks {K3_LAYOUTS}: bit-exact "
        f"outside page 0")
    del kc, vc, got_k, got_v, want_k, want_v

    # 5. K1 vs plain ---------------------------------------------------------
    decode_ctx = [1, 17, 100, 511, 1024, 2047, 3000, 4096]
    mixes = {   # (decode contexts, chunks (start, rows), padding rows)
        "mixed": (decode_ctx, [(1000, 100), (0, 60), (7, 25)], 12),
        "decode": (decode_ctx, [], 2),     # few rows: split-KV path
    }
    plain_k1 = blocked_plain_attention(ragged, torch)
    k1_err = {}
    for (label, mix), (dtype, tol) in itertools.product(
            mixes.items(), ((torch.bfloat16, K1_BF16_TOL),
                            (torch.float32, K1_FP32_TOL))):
        qpos, lanes, tables = attention_mix(torch, gen, N_PAGES, P,
                                            MAX_PAGES, *mix)
        qpos_d, lanes_d, tables_d = (x.to(dev)
                                     for x in (qpos, lanes, tables))
        grid = (ragged.grid_ctas(dev) if dtype == torch.bfloat16 else
                ragged.num_splits(qpos.numel(), KVH, MAX_PAGES,
                                  ragged.sm_count(dev)))
        q = torch.randn(qpos.numel(), H, D, generator=gen).to(dev, dtype)
        kp = torch.randn(KVH, N_PAGES, P, D, generator=gen).to(dev, dtype)
        vp = torch.randn(KVH, N_PAGES, P, D, generator=gen).to(dev, dtype)
        got = ragged.ragged_paged_attention(q, kp, vp, qpos_d, lanes_d,
                                            tables_d)
        want = plain_k1(q, kp, vp, qpos_d, lanes_d, tables_d)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        pad = qpos_d < 0
        if not torch.all(got[pad] == 0):
            raise AssertionError("K1 padding rows are not exact zeros")
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        at = want.flatten()[diff.argmax()].float().abs().item()
        k1_err[dtype] = max(k1_err.get(dtype, 0.0), err)
        log(f"[k1] ragged_paged_attention {label} {str(dtype)[6:]} rows="
            f"{qpos.numel()} {'grid' if dtype == torch.bfloat16 else 'splits'}"
            f"={grid} ctx<=4096: max_abs_err "
            f"{err:.3e} at |want| {at:.3f} ({tol})")
        del q, got, want
        if dtype == torch.bfloat16:
            uniform_check(ragged, plain_k1, torch, kp, vp, qpos_d, lanes_d,
                          tables_d, H, f"{label} ctx<=4096")
            qg = torch.randn(qpos.numel(), H, D, generator=gen).to(dev, dtype)
            deeper = torch.where(qpos_d >= 0, qpos_d + 1, qpos_d)
            graph_replay_check(
                torch, lambda: ragged.ragged_paged_attention(
                    qg, kp, vp, qpos_d, lanes_d, tables_d), qpos_d,
                [deeper, torch.full_like(qpos_d, -1), qpos_d.clone()],
                f"K1 {label} round")
            del qg
        del kp, vp

    # 6. K4 vs plain ---------------------------------------------------------
    k4_lengths = {  # lanes: page edges, empty lanes, long contexts
        "edges": [1, 15, 16, 17, 32, 0, 33, 0],
        "long": [0, 100, 511, 1024, 2047, 3000, 4096, 4000],
    }
    k4_err = {}
    for (label, lens), (dtype, tol) in itertools.product(
            k4_lengths.items(), ((torch.bfloat16, K4_BF16_TOL),
                                 (torch.float32, K4_FP32_TOL))):
        args = decode_case(torch, gen, dev, dtype, lens, N_PAGES, MAX_PAGES,
                           H, KVH, P, D)
        grid = (ragged.grid_ctas(dev) if dtype == torch.bfloat16 else
                ragged.num_splits(len(lens), KVH, MAX_PAGES,
                                  ragged.sm_count(dev)))
        got = attention.paged_attention_decode(*args)
        want = attention.paged_attention_decode_ref(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        empty = args[3] == 0
        if not torch.all(got[empty] == 0):
            raise AssertionError("K4 length-0 lanes are not exact zeros")
        err = (got.float() - want.float()).abs().max().item()
        k4_err[dtype] = max(k4_err.get(dtype, 0.0), err)
        log(f"[k4] paged_attention_decode {label} {str(dtype)[6:]} "
            f"lanes={len(lens)} {'grid' if dtype == torch.bfloat16 else 'splits'}"
            f"={grid} lengths={lens}: max_abs_err "
            f"{err:.3e} ({tol})")
        if dtype == torch.bfloat16:
            zq = (torch.zeros_like(args[0]),) + args[1:]
            got = attention.paged_attention_decode(*zq)
            want = attention.paged_attention_decode_ref(
                *[a.float() if a.is_floating_point() else a for a in zq])
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want, **K4_UNIFORM_TOL)
            log(f"[k4] {label} uniform attention (q = 0) bf16 vs fp32 plain: "
                f"max_abs_err {(got.float() - want).abs().max().item():.3e} "
                f"({K4_UNIFORM_TOL})")
            lens_d = args[3]
            graph_replay_check(
                torch, lambda: attention.paged_attention_decode(*args),
                lens_d, [lens_d.flip(0), torch.zeros_like(lens_d),
                         lens_d.clone()], f"K4 {label} lanes")
        del args, got, want

    # 7. K5 / K6 vs plain ---------------------------------------------------
    a8_err = {"w8a8": 0.0, "int4": 0.0}
    a8_w = {}
    for label, (k, n) in PROJECTIONS.items():
        w = torch.randn(k, n, generator=gen).to(dev, torch.bfloat16)
        for mode in QUANT_MODES:
            qt = quant.quantize(w, quant._bits_of(mode),
                                quant._act_bits_of(mode))
            a8_w[(mode, label)] = qt
            fn, ref = a8_fns(int4_mm, mode)
            for m, dtype in itertools.product(
                    A8_MS, (torch.bfloat16, torch.float32)):
                x = a8_case(torch, gen, dev, m, k, dtype)
                got, want = fn(x, qt.q, qt.s), ref(x, qt.q, qt.s)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                a8_err[mode] = max(a8_err[mode], err)
                if not (torch.equal(got, want) and torch.all(got[0] == 0)):
                    raise AssertionError(
                        f"{GEMM_OF[mode]} {label} M={m} {dtype} differs from "
                        f"its plain version: {err}")
        del w
        log(f"[a8] K5 w8a8_matmul and K6 int4_matmul {label} K={k} N={n}, "
            f"M in {A8_MS}, bf16 and fp32, an all-zero row: bit-identical "
            f"with the plain versions")
    # grouped calls: q/k/v (wq, wk, wv) and gate/up of the same x
    groups = {"q/k/v": ("wq/wo", "wk/wv", "wk/wv"),
              "gate/up": ("gate/up", "gate/up")}
    for mode in QUANT_MODES:
        group_fn = (int4_mm.w8a8_matmul_group if mode == "w8a8"
                    else int4_mm.int4_matmul_group)
        _, ref = a8_fns(int4_mm, mode)
        for gname, members in groups.items():
            pairs = [(a8_w[(mode, lbl)].q, a8_w[(mode, lbl)].s)
                     for lbl in members]
            for m in (1, 8, 40, 65, 512):
                x = a8_case(torch, gen, dev, m, 4096, torch.bfloat16)
                outs = group_fn(x, pairs)
                torch.cuda.synchronize()
                for out, (q, sc) in zip(outs, pairs):
                    if not torch.equal(out, ref(x, q, sc)):
                        raise AssertionError(f"grouped {GEMM_OF[mode]} "
                                             f"{gname} M={m} differs")
        log(f"[a8] grouped {GEMM_OF[mode]} q/k/v and gate/up, M in (1, 8, "
            f"40, 65, 512): bit-identical with the plain version per weight")
    for mode, gname in (("w8a8", None), ("int4", None), ("w8a8", "q/k/v"),
                        ("int4", "gate/up")):
        x = a8_case(torch, gen, dev, 8, 4096, torch.bfloat16)
        if gname is None:
            fn, _ = a8_fns(int4_mm, mode)
            qt = a8_w[(mode, "gate/up")]
            call = (lambda fn=fn, qt=qt, x=x: [fn(x, qt.q, qt.s)])
        else:
            group_fn = (int4_mm.w8a8_matmul_group if mode == "w8a8"
                        else int4_mm.int4_matmul_group)
            pairs = [(a8_w[(mode, lbl)].q, a8_w[(mode, lbl)].s)
                     for lbl in groups[gname]]
            call = (lambda g=group_fn, p=pairs, x=x: g(x, p))
        call()                                # scratch exists before capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = call()
        x.mul_(-2.5)
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(o, e) for o, e in zip(outs, call())):
            raise AssertionError(f"{GEMM_OF[mode]} {gname or ''} graph "
                                 f"replay differs from an eager call")
        log(f"[a8] {GEMM_OF[mode]} {gname or 'gate/up'} M=8 captured in a "
            f"CUDA graph, x changed in place, replayed: equal to an eager "
            f"call")
        del graph, outs
    del a8_w

    # 8. main paths --------------------------------------------------------
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    ckpt = os.path.join(work, "llama3-8b")
    os.makedirs(ckpt)
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(LLAMA3_8B_CONFIG, f)
    t0 = time.perf_counter()
    os.environ.pop("DYN_ATTENTION_IMPL", None)     # the default: phase
    engine, card = build_torch_engine(
        ckpt, "llama3-8b", num_pages=N_PAGES, max_batch_size=8,
        prefill_chunk_budget=512, decode_steps_per_sync=8,
        pipeline_bursts=True, random_init=True, rng_seed=0, device="cuda")
    torch.cuda.synchronize()
    if engine.ragged:
        raise AssertionError("the default engine is not on the phase path")
    log(f"[main] Llama-3-8B random init + {N_PAGES}-page KV pool in "
        f"{time.perf_counter() - t0:.1f}s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    jobs = write_jobs(os.path.join(work, "jobs.jsonl"), seed=0)
    args = type("Args", (), {"tokenizer": "auto", "context_length": None,
                             "max_tokens": 32})()
    model = engine.model
    cfg = model.cfg

    async def greedy_on(eng, prompt, n, top=0):
        """Greedy tokens of one request; with `top`, also each token's
        top-`top` [[id, logprob], ...]."""
        toks, tops = [], []
        async for o in eng.generate(
                {"token_ids": prompt,
                 "sampling": {"temperature": 0.0, "top_logprobs": top},
                 "stop": {"max_tokens": n}}, Context()):
            toks.extend(o.get("token_ids", ()))
            tops.extend(o.get("top_logprobs") or ())
        return (toks, tops) if top else toks

    def serve_batch(eng, label, must_launch, must_not_launch):
        """The batch through the pipeline with launch counts zeroed just
        before and read just after, then greedy determinism; one event
        loop for the engine, which is closed at the end."""
        pipeline = build_pipeline_for(card, eng, args)

        async def go():
            try:
                cuda_build.reset_launch_counts()
                t0 = time.perf_counter()
                results = await run_batch(pipeline, card.name, jobs, 32,
                                          os.path.join(work, "out.jsonl"))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = {k: v.launches
                            for k, v in cuda_build.KERNELS.items()}
                out_tokens, n_rounds = eng.tokens_emitted, eng.rounds
                ttft = list(eng.ttft_s)
                prompt = list(range(40, 140))
                same = await asyncio.gather(
                    greedy_on(eng, prompt, 12, top=8),
                    greedy_on(eng, prompt, 12, top=8))
                return (results, wall, launches, out_tokens, n_rounds,
                        ttft, same)
            finally:
                await eng.close()

        results, wall, launches, out_tokens, n_rounds, ttft, (a, b) = \
            asyncio.run(go())
        log(f"[main] {label} path: {len(results)} requests, {out_tokens} "
            f"output tokens in {wall:.2f}s; {n_rounds} device dispatches "
            f"({eng.pipelined_bursts} pipelined bursts); launches "
            f"{launches}")
        for r in results:
            if r["finish_reason"] not in ("length", "eos") \
                    or r["completion_tokens"] < 1:
                raise AssertionError(f"request did not finish right: {r}")
        for kname in must_launch:
            if launches[kname] == 0:
                raise AssertionError(f"kernel {kname} never launched on the "
                                     f"{label} main path")
        for kname in must_not_launch:
            if launches[kname] != 0:
                raise AssertionError(f"kernel {kname} launched on the "
                                     f"{label} main path")
        if a[0] != b[0] or len(a[0]) != 12 or len(a[1]) != 12:
            raise AssertionError(f"greedy streams differ: {a[0]} vs {b[0]}")
        log(f"[main] {label} greedy determinism: two identical requests -> "
            f"{a[0][:6]}...")
        return {"wall": wall, "launches": launches, "tokens": out_tokens,
                "rounds": n_rounds, "ttft": ttft, "stream": a}

    phase = serve_batch(engine, "phase",
                        ("paged_kv_write", "paged_kv_write_pages",
                         "paged_attention_decode"),
                        ("ragged_paged_attention", "w8a8_matmul",
                         "int4_matmul"))
    del engine
    torch.cuda.empty_cache()
    ragged_eng = TorchEngine(TorchEngineConfig(
        model=cfg, num_pages=N_PAGES, max_batch_size=8,
        prefill_chunk_budget=512, attention_impl="ragged", device="cuda"),
        model=model)
    ragged_run = serve_batch(ragged_eng, "ragged",
                             ("ragged_paged_attention", "paged_kv_write"),
                             ("paged_kv_write_pages",
                              "paged_attention_decode", "w8a8_matmul",
                              "int4_matmul"))
    del ragged_eng
    torch.cuda.empty_cache()
    # the same greedy request on both paths: equal up to a parting at a
    # bf16 near-tie, where each run ranks the other's token within
    # BF16_TIE_TOL nats of its own
    partings = stream_partings([phase["stream"]], [ragged_run["stream"]],
                               BF16_TIE_TOL)
    if partings:
        (_, step, gap), = partings
        toks = (phase["stream"][0][step], ragged_run["stream"][0][step])
        log(f"[main] greedy stream of the same 100-token prompt, phase vs "
            f"ragged path (bf16): part at step {step} of 12, tokens {toks[0]}"
            f" vs {toks[1]}, logprob gap {gap:.4f} nats (tie tolerance "
            f"{BF16_TIE_TOL}); identical before it")
    else:
        log(f"[main] greedy stream of the same 100-token prompt, phase vs "
            f"ragged path (bf16): identical over 12 steps")

    # 9. quantized main path -------------------------------------------------

    def bare_decode_launches(mdl):
        """One bare decode_step over 8 lanes: the launches it made."""
        kc, vc = llama.init_cache(cfg, 1 + 8 * 8, dev)
        tables = torch.zeros(8, cfg.max_pages_per_seq, dtype=torch.int32)
        tables[:, :8] = torch.arange(1, 65, dtype=torch.int32).reshape(8, 8)
        step = [torch.arange(8, dtype=torch.int32) * 11,            # tokens
                torch.tensor([5, 17, 40, 63, 100, 120, 7, 0],
                             dtype=torch.int32),                      # positions
                tables, torch.ones(8, dtype=torch.bool)]
        with torch.inference_mode():
            cuda_build.reset_launch_counts()
            logits = llama.decode_step(mdl, kc, vc,
                                       *(a.to(dev) for a in step))
            torch.cuda.synchronize()
            counts = {k: v.launches for k, v in cuda_build.KERNELS.items()}
        if not torch.isfinite(logits).all() or logits.shape != (
                8, cfg.vocab_size):
            raise AssertionError("bare decode_step logits are not finite")
        return counts

    bf16_bytes = quant.weight_bytes(model)
    quantized, q_models = {}, {}
    for mode in QUANT_MODES:
        gemm = GEMM_OF[mode]
        other = GEMM_OF["int4" if mode == "w8a8" else "w8a8"]
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        q_engine, _ = build_torch_engine(
            ckpt, "llama3-8b", num_pages=N_PAGES, max_batch_size=8,
            prefill_chunk_budget=512, decode_steps_per_sync=8,
            pipeline_bursts=True, random_init=True, rng_seed=0,
            quantize=mode, device="cuda")
        torch.cuda.synchronize()
        q_model = q_engine.model
        check_quantized(torch, quant, q_model, mode)
        q_bytes = quant.weight_bytes(q_model)
        proj_bytes = sum(getattr(layer, key).nbytes
                         for layer in q_model.layers
                         for key in quant.QUANT_KEYS)
        log(f"[quant] {mode}: Llama-3-8B random init (seed 0) quantized by "
            f"the engine in {time.perf_counter() - t0:.1f}s; resident weight "
            f"bytes {q_bytes} ({q_bytes / 2**30:.3f} GiB; projections "
            f"{proj_bytes}, the rest embed + bf16 lm_head + norms) against "
            f"bf16 {bf16_bytes} ({bf16_bytes / 2**30:.3f} GiB); the engine "
            f"added {(torch.cuda.memory_allocated() - before) / 2**30:.2f} "
            f"GiB allocated incl. its {N_PAGES}-page KV pool")
        quantized[mode] = serve_batch(
            q_engine, f"phase {mode}",
            (gemm, "paged_kv_write", "paged_kv_write_pages",
             "paged_attention_decode"), (other, "ragged_paged_attention"))
        quantized[mode]["bytes"] = q_bytes
        del q_engine
        torch.cuda.empty_cache()
        counts = bare_decode_launches(q_model)
        want = 4 * cfg.num_layers            # q/k/v, o, gate/up, down
        if counts[gemm] != want or counts[other] != 0:
            raise AssertionError(f"a bare {mode} decode_step launched {gemm} "
                                 f"{counts[gemm]} times (want {want}) and "
                                 f"{other} {counts[other]} times")
        log(f"[quant] one bare {mode} decode_step (8 lanes): {gemm} launched "
            f"{counts[gemm]} = 4 x {cfg.num_layers} times (q/k/v and gate/up "
            f"grouped); launches {counts}")
        q_models[mode] = q_model
    torch.cuda.empty_cache()

    # 10. kernel path vs plain path -----------------------------------------

    def mixed_round(kcache, vcache):
        """Round 1: two chunks (300 and 200 tokens); round 2: lane 0's
        next 100-token chunk + lane 1's decode row. Returns both rounds'
        chunk logits and round 2's decode logprob."""
        tables_r = torch.zeros(2, cfg.max_pages_per_seq, dtype=torch.int32)
        tables_r[0, :30] = torch.arange(1, 31)
        tables_r[1, :20] = torch.arange(31, 51)
        g = torch.Generator().manual_seed(5)
        toks0 = torch.randint(0, 256, (500,), generator=g, dtype=torch.int32)
        toks1 = torch.randint(0, 256, (101,), generator=g, dtype=torch.int32)

        def run(tok, pos, lane, ch_rows, d_rows):
            pos = torch.tensor(pos, dtype=torch.int32)
            lane = torch.tensor(lane, dtype=torch.int32)
            pages = tables_r[lane.long(), (pos // P).long()]
            tb = tok.numel()
            z = torch.zeros(2, dtype=torch.int64)
            a = [tok, pos, pages, pos % P, torch.ones(tb, dtype=torch.bool),
                 lane, tables_r, torch.tensor(ch_rows, dtype=torch.int32),
                 torch.tensor(d_rows, dtype=torch.int32), z, z,
                 torch.zeros(2), torch.ones(2), z]
            return llama.ragged_prefill_decode(
                model, kcache, vcache, *(x.to(dev) for x in a))

        _, ch1 = run(toks0, list(range(300)) + list(range(200)),
                     [0] * 300 + [1] * 200, [299, 499], [0, 0])
        packed2, ch2 = run(toks1, list(range(300, 400)) + [200],
                           [0] * 100 + [1], [99, 99], [100, 100])
        return torch.cat([ch1, ch2]).float(), packed2[1, 0, 0].float()

    def mixed_step(mdl, kcache, vcache):
        """One mixed_prefill_decode step of `mdl` on caches holding random
        K/V:
        page-aligned chunks of 512 and 300 tokens from cursors 0 and 64
        (K3) beside 8 decode lanes at positions 40..1000 (K2, K4), 2 burst
        steps, top-8 logprobs. Returns (chunk logits (2, V), the decode
        lanes' step-0 top-8 logprobs (8, 8))."""
        g = torch.Generator().manual_seed(6)
        g_dev = torch.Generator(device=dev).manual_seed(6)
        for c in kcache + vcache:
            c.copy_(torch.randn(c.shape, generator=g_dev, device=dev))
        ch_tables = torch.zeros(2, cfg.max_pages_per_seq, dtype=torch.int32)
        ch_tables[0, :32] = torch.arange(1, 33)
        ch_tables[1, :24] = torch.arange(33, 57)
        ch_tok = torch.randint(0, 256, (2, 512), generator=g,
                               dtype=torch.int32)
        ch_cached = torch.tensor([0, 64], dtype=torch.int32)
        ch_lens = torch.tensor([512, 364], dtype=torch.int32)
        pos = torch.tensor([40, 73, 133, 233, 383, 653, 853, 1000],
                           dtype=torch.int32)
        d_tables = torch.zeros(8, cfg.max_pages_per_seq, dtype=torch.int32)
        for i in range(8):
            d_tables[i, :64] = torch.arange(57 + 64 * i, 121 + 64 * i)
        z = torch.zeros(8, dtype=torch.int64)
        a = [ch_tok, ch_tables, ch_cached, ch_lens,
             torch.randint(0, 256, (8,), generator=g, dtype=torch.int32),
             pos, d_tables, torch.ones(8, dtype=torch.bool), z, z,
             torch.zeros(8), torch.ones(8), z]
        packed, ch_logits = llama.mixed_prefill_decode(
            mdl, kcache, vcache, *(x.to(dev) for x in a), num_steps=2,
            aligned=True, topk_lp=8)
        return ch_logits.float(), packed[10:18, 0].T.float()

    with torch.inference_mode():
        caches = [llama.init_cache(cfg, 64, dev) for _ in range(2)]
        k_logits, k_lp = mixed_round(*caches[0])
        with plain_path(ragged, kernels, attention, int4_mm, torch):
            before = {k: v.launches for k, v in cuda_build.KERNELS.items()}
            p_logits, p_lp = mixed_round(*caches[1])
            after = {k: v.launches for k, v in cuda_build.KERNELS.items()}
        torch.cuda.synchronize()
        if before != after:
            raise AssertionError("the plain path launched a kernel")
        logit_err = (k_logits - p_logits).abs().max().item()
        log(f"[path] 8B mixed ragged round bf16: max |logit diff| "
            f"{logit_err:.4f} (|logits| max {p_logits.abs().max().item():.2f}"
            f", tolerance {LOGITS_BF16_TOL}); decode logprob diff "
            f"{abs(k_lp.item() - p_lp.item()):.4f}; greedy agree "
            f"{int((k_logits.argmax(-1) == p_logits.argmax(-1)).sum())}/4")
        if not logit_err <= LOGITS_BF16_TOL:
            raise AssertionError(f"8B logits kernel vs plain: {logit_err}")
        del caches
        for mode, mdl in (("bf16", model), *q_models.items()):
            caches = [llama.init_cache(cfg, 1 + 57 + 64 * 8, dev)
                      for _ in range(2)]
            before = {k: v.launches for k, v in cuda_build.KERNELS.items()}
            k_ch, k_top = mixed_step(mdl, *caches[0])
            mid = {k: v.launches for k, v in cuda_build.KERNELS.items()}
            with plain_path(ragged, kernels, attention, int4_mm, torch):
                p_ch, p_top = mixed_step(mdl, *caches[1])
                after = {k: v.launches for k, v in cuda_build.KERNELS.items()}
            torch.cuda.synchronize()
            for kname in ("paged_kv_write", "paged_kv_write_pages",
                          "paged_attention_decode",
                          *((GEMM_OF[mode],) if mode in GEMM_OF else ())):
                if mid[kname] == before[kname]:
                    raise AssertionError(f"the {mode} mixed step skipped "
                                         f"{kname}")
            if mid != after:
                raise AssertionError("the plain path launched a kernel")
            ch_err = (k_ch - p_ch).abs().max().item()
            top_err = (k_top - p_top).abs().max().item()
            tol = LOGITS_BF16_TOL if mode == "bf16" else LOGITS_A8_TOL
            log(f"[path] 8B mixed_prefill_decode step {mode} (chunks 512 + "
                f"300, 8 decode lanes): chunk logits max |diff| {ch_err:.4f} "
                f"(|logits| max {p_ch.abs().max().item():.2f}), decode top-8 "
                f"logprobs max |diff| {top_err:.4f}, tolerance {tol}; chunk "
                f"greedy agree "
                f"{int((k_ch.argmax(-1) == p_ch.argmax(-1)).sum())}/2")
            if not max(ch_err, top_err) <= tol:
                raise AssertionError(f"8B {mode} mixed step kernel vs plain: "
                                     f"{ch_err}, {top_err}")
            del caches
    torch.cuda.empty_cache()

    # 11. profiles ---------------------------------------------------------
    profiles = {("bf16", k): v for k, v in profile_rounds(
        torch, llama, model, dev, n_pad_mixed=768 - 520).items()}
    # "int8" (W8A16: cuBLAS over weights converted to bf16 on every call)
    # is not a main-path cell; its burst is profiled for its step time
    # only, on a model that shares every other tensor with the bf16 one
    for mode, mdl in (*q_models.items(),
                      ("int8", quant.quantize_params(model, mode="int8"))):
        profiles[(mode, "burst")] = profile_rounds(
            torch, llama, mdl, dev, n_pad_mixed=0, labels=("burst",))["burst"]
        del mdl
    for (mode, label), (wall_ms, busy, n_k, by_class, top) in \
            profiles.items():
        what = {"decode": "ragged decode round", "mixed":
                "ragged mixed round", "burst": "phase decode burst (8 "
                "steps)"}[label] + f", {mode}"
        per_step = f" ({n_k / 8:.0f} per step)" if label == "burst" else ""
        if busy is None:
            log(f"[profile] {what}: wall {wall_ms:.2f} ms; device busy not "
                f"measured (the profiler saw no device activity)")
            continue
        log(f"[profile] {what} (8B, bare): wall {wall_ms:.2f} ms (median "
            f"of 10), device busy {busy:.2f} ms, idle "
            f"{100 * max(0.0, 1 - busy / wall_ms):.1f}%, {n_k:.0f} device "
            f"ops{per_step}, on {smi}")
        for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
            log(f"[profile]   {cls}: {ms:.3f} ms ({100 * ms / busy:.1f}% "
                f"of busy)")
        for ms, kname in top:
            log(f"[profile]   top kernel {ms:.3f} ms: {kname[:90]}")
    for label, run, impl in (("phase", phase, "phase"),
                             ("ragged", ragged_run, "ragged")):
        log(f"[profile] engine (phase 7, {label}): "
            f"{1e3 * run['wall'] / run['rounds']:.2f} ms per dispatch on "
            f"average over the batch's {run['rounds']} dispatches")
        eng2 = TorchEngine(TorchEngineConfig(
            model=cfg, num_pages=N_PAGES, max_batch_size=8,
            prefill_chunk_budget=512, attention_impl=impl, device="cuda"),
            model=model)
        b_wall, b_busy, b_rounds, b_inside = profile_engine_batch(
            torch, eng2, build_pipeline_for(card, eng2, args), run_batch,
            card.name,
            write_jobs(os.path.join(work, f"jobs_{label}.jsonl"), seed=1),
            os.path.join(work, f"out_{label}.jsonl"))
        busy_txt = "not measured" if b_busy is None else \
            f"{b_busy:.3f} s, idle {100 * max(0.0, 1 - b_busy / b_wall):.1f}%"
        log(f"[profile] engine batch, {label} path (fresh prompts, kernels "
            f"traced): wall {b_wall:.3f} s, {b_rounds} dispatches, "
            f"{b_inside:.3f} s inside the engine's own device calls "
            f"({'rounds + ' if impl == 'ragged' else ''}first-token "
            f"sampling), device busy {busy_txt}, on {smi}")
        del eng2
    shutil.rmtree(work)
    del model, q_models
    torch.cuda.empty_cache()

    # 12. kernel path vs plain path, 2 layers, fp32 ------------------------

    cfg2 = llama.LlamaConfig.llama3_8b(num_layers=2, dtype=torch.float32)
    model2 = llama.init_params(cfg2, 1, dev)

    def fp32_streams(impl, mode=None):
        eng = TorchEngine(TorchEngineConfig(
            model=cfg2, num_pages=128, max_batch_size=4,
            prefill_chunk_budget=64, attention_impl=impl, quantize=mode,
            device="cuda"), model=model2)

        async def go():
            try:
                g = torch.Generator().manual_seed(9)
                prompts = [torch.randint(0, 128256, (n,), generator=g)
                           .tolist() for n in (90, 33, 150)]
                return await asyncio.gather(
                    *(greedy_on(eng, p, 16, top=8) for p in prompts))
            finally:
                await eng.close()
        return asyncio.run(go())

    for mode in (None, *QUANT_MODES):
        streams = {}
        for impl in ("phase", "ragged"):
            cuda_build.reset_launch_counts()
            streams[f"{impl}-kernels"] = fp32_streams(impl, mode)
            used = sorted(k for k, v in cuda_build.KERNELS.items()
                          if v.launches)
            if mode is not None and GEMM_OF[mode] not in used:
                raise AssertionError(f"the 2-layer {mode} {impl} run never "
                                     f"launched {GEMM_OF[mode]}")
            with plain_path(ragged, kernels, attention, int4_mm, torch):
                streams[f"{impl}-plain"] = fp32_streams(impl, mode)
            log(f"[path] 2-layer fp32 {mode or 'unquantized'} {impl} path, "
                f"kernels launched: {used}")
        first = streams["phase-kernels"]
        if any(len(t) != 16 for t, _ in first):
            raise AssertionError(f"fp32 {mode} streams are short: {first}")
        if mode is None:
            if any([t for t, _ in s] != [t for t, _ in first]
                   for s in streams.values()):
                raise AssertionError(f"fp32 greedy streams differ: {streams}")
            log(f"[path] 2-layer full-width fp32 unquantized: greedy streams "
                f"identical over 16 steps x {len(first)} requests across "
                f"{sorted(streams)}")
            continue
        partings = {k: stream_partings(first, s, A8_TIE_TOL)
                    for k, s in streams.items() if k != "phase-kernels"}
        log(f"[path] 2-layer full-width fp32 {mode}: greedy streams over 16 "
            f"steps x {len(first)} requests, against phase-kernels: "
            + "; ".join(f"{k} " + ("identical" if not v else
                                   "parts at near-ties " + ", ".join(
                                       f"(request {r}, step {i}, logprob "
                                       f"gap {g:.2e})" for r, i, g in v))
                        for k, v in sorted(partings.items()))
            + f" (tie tolerance {A8_TIE_TOL})")
    del model2
    torch.cuda.empty_cache()

    # 13. numbers ------------------------------------------------------------
    # every kernel timed after a read flush (the yardstick) and, for
    # continuity with older records, after a write flush; the empty-kernel
    # floor under the same flush beside them
    flushes = l2_flushes(torch, dev)
    flush, wflush = flushes["read"], flushes["write"]
    tiny = torch.zeros(1, device=dev)
    floor = {"ms": time_ms(torch, tiny.zero_, flush=flush),
             "write": time_ms(torch, tiny.zero_, flush=wflush),
             "run": time_run_ms(torch, [tiny.zero_] * N_LAYER_RUN,
                                flush=flush)}
    log(f"[time] empty-kernel floor (1-element zero_): {floor['ms']:.4f} ms "
        f"after a read flush, {floor['write']:.4f} after a write flush, "
        f"{floor['run']:.4f} per launch in a run of {N_LAYER_RUN} on {smi}")

    def timed(fn) -> tuple[float, float]:
        """One launch of `fn`: (ms after a read flush, after a write)."""
        return (time_ms(torch, fn, flush=flush),
                time_ms(torch, fn, flush=wflush))

    # the ragged path's biggest round: a 512-token prompt chunk (the second
    # of a 1517-token prompt) + the fixed block of 8 decode rows, padded
    # to the 768-row bucket; and a decode-only round of 8 rows
    shapes = {
        "mixed": attention_mix(torch, gen, N_PAGES, P, MAX_PAGES,
                               [41, 70, 130, 230, 380, 650, 850, 1030],
                               [(512, 512)], n_pad=768 - 520),
        "decode": attention_mix(torch, gen, N_PAGES, P, MAX_PAGES,
                                [44, 73, 133, 233, 383, 653, 853, 1033],
                                [], n_pad=0),
    }
    kp = torch.randn(KVH, N_PAGES, P, D, generator=gen).to(dev,
                                                           torch.bfloat16)
    vp = torch.randn(KVH, N_PAGES, P, D, generator=gen).to(dev,
                                                           torch.bfloat16)
    # one (K, V) cache pair per layer for the runs of N_LAYER_RUN launches
    layer_caches = [(torch.empty_like(kp), torch.empty_like(vp))
                    for _ in range(N_LAYER_RUN)]
    # rows[key] = (rows, ms, plain_ms, bound, bound_by, library_ms,
    #              ms after a write flush, ms per launch in a run or None)
    rows = {}
    for label, (qp, ln, tb) in shapes.items():
        qp_d, ln_d, tb_d = qp.to(dev), ln.to(dev), tb.to(dev)
        q = torch.randn(qp.numel(), H, D, generator=gen).to(dev,
                                                             torch.bfloat16)
        ms, ms_w = timed(lambda: ragged.ragged_paged_attention(
            q, kp, vp, qp_d, ln_d, tb_d))
        plain_ms = time_ms(torch, lambda: plain_k1(q, kp, vp, qp_d, ln_d,
                                                   tb_d), reps=5,
                           flush=flush)
        k1_bound, by = k1_bound_ms(torch, qp, ln, tb, H, KVH, D, P, 2,
                                   peaks)
        rows[("k1", label)] = (qp.numel(), ms, plain_ms, k1_bound, by, None,
                               ms_w, None)
        got = ragged.ragged_paged_attention(q, kp, vp, qp_d, ln_d, tb_d)
        want = plain_k1(q, kp, vp, qp_d, ln_d, tb_d)
        torch.testing.assert_close(got.float(), want.float(), **K1_BF16_TOL)
        if not torch.all(got[qp_d < 0] == 0):
            raise AssertionError("K1 padding rows are not exact zeros")
        err = (got.float() - want.float()).abs().max().item()
        k1_err[torch.bfloat16] = max(k1_err[torch.bfloat16], err)
        uniform_check(ragged, plain_k1, torch, kp, vp, qp_d, ln_d, tb_d, H,
                      f"{label} round at the main path's shapes")
        # K2 on the same round's rows, as the step hands them: projection
        # outputs viewed as heads, targets redirected once
        b = qp.numel()
        srcs = [(k2_rows(torch, gen, dev, b, KVH, D, "contiguous"),
                 k2_rows(torch, gen, dev, b, KVH, D, "contiguous"))
                for _ in range(N_LAYER_RUN)]
        kr, vr = srcs[0]
        pg = torch.where(qp_d >= 0, tb_d[ln_d.long(), (qp_d.clamp(min=0)
                                                     // P).long()], 0)
        of = torch.where(qp_d >= 0, qp_d % P, 0).to(torch.int32)
        pg = pg.to(torch.int32).contiguous()
        kcw, vcw = kp.clone(), vp.clone()
        kernels.paged_kv_write(kcw, vcw, kr, vr, pg, of)
        want_k, want_v = kp.clone(), vp.clone()
        kernels.paged_kv_write_ref(want_k, want_v, kr, vr, pg, of)
        if not (torch.equal(kcw[:, 1:], want_k[:, 1:])
                and torch.equal(vcw[:, 1:], want_v[:, 1:])):
            raise AssertionError(f"K2 differs from its plain version on the "
                                 f"{label} round")
        del want_k, want_v
        log(f"[check] {label} round at the main path's shapes: K1 max_abs_err "
            f"{err:.3e} ({K1_BF16_TOL}), K2 bit-exact outside "
            f"page 0")
        ms2, ms2_w = timed(lambda: kernels.paged_kv_write(
            kcw, vcw, kr, vr, pg, of))
        run2 = time_run_ms(torch, [
            (lambda c=c, s=s: kernels.paged_kv_write(*c, *s, pg, of))
            for c, s in zip(layer_caches, srcs)], flush=flush)
        plain2 = time_ms(torch, lambda: kernels.paged_kv_write_ref(
            kcw, vcw, kr, vr, pg, of), flush=flush)

        def index_put():
            kcw[:, pg.long(), of.long()] = kr.transpose(0, 1)
            vcw[:, pg.long(), of.long()] = vr.transpose(0, 1)

        lib2 = time_ms(torch, index_put, flush=flush)
        bound2, by2 = k2_bound_ms(pg, KVH, D, 2, peaks)
        rows[("k2", label)] = (b, ms2, plain2, bound2, by2, lib2, ms2_w, run2)
        del kcw, vcw, srcs, kr, vr

    # K3 at the phase path's chunk shape: a 480-token page-aligned chunk in
    # the 512 bucket = 32 slots, the last 2 padding (→ page 0); its blocks
    # the chunk's token-major K/V viewed per page, as `_chunk_kv_writer`
    # hands them
    ids3 = torch.zeros(32, dtype=torch.int32)
    ids3[:30] = 1 + torch.randperm(N_PAGES - 1, generator=gen)[:30]
    ids3_d = ids3.to(dev)
    srcs = [(k3_blocks(torch, gen, dev, 32, KVH, P, D, "chunk"),
             k3_blocks(torch, gen, dev, 32, KVH, P, D, "chunk"))
            for _ in range(N_LAYER_RUN)]
    kb3, vb3 = srcs[0]
    kcw, vcw = kp.clone(), vp.clone()
    kernels.paged_kv_write_pages(kcw, vcw, kb3, vb3, ids3_d)
    want_k, want_v = kp.clone(), vp.clone()
    kernels.paged_kv_write_pages_ref(want_k, want_v, kb3, vb3, ids3_d)
    if not (torch.equal(kcw[:, 1:], want_k[:, 1:])
            and torch.equal(vcw[:, 1:], want_v[:, 1:])):
        raise AssertionError("K3 differs from its plain version at the main "
                             "path's shape")
    del want_k, want_v
    ms3, ms3_w = timed(lambda: kernels.paged_kv_write_pages(
        kcw, vcw, kb3, vb3, ids3_d))
    run3 = time_run_ms(torch, [
        (lambda c=c, s=s: kernels.paged_kv_write_pages(*c, *s, ids3_d))
        for c, s in zip(layer_caches, srcs)], flush=flush)
    kb3c, vb3c = kb3.contiguous(), vb3.contiguous()
    ms3_c = time_ms(torch, lambda: kernels.paged_kv_write_pages(
        kcw, vcw, kb3c, vb3c, ids3_d), flush=flush)
    log(f"[time] paged_kv_write_pages chunk on contiguous blocks: "
        f"{ms3_c:.4f} ms after a read flush on {smi}")
    plain3 = time_ms(torch, lambda: kernels.paged_kv_write_pages_ref(
        kcw, vcw, kb3, vb3, ids3_d), flush=flush)
    ids3_l = ids3_d.long()

    def index_copy():
        kcw.index_copy_(1, ids3_l, kb3.transpose(0, 1))
        vcw.index_copy_(1, ids3_l, vb3.transpose(0, 1))

    lib3 = time_ms(torch, index_copy, flush=flush)
    bound3, by3 = k3_bound_ms(ids3, KVH, P, D, 2, peaks)
    rows[("k3", "chunk")] = (32, ms3, plain3, bound3, by3, lib3, ms3_w, run3)
    del kcw, vcw, srcs, kb3, vb3, kb3c, vb3c, layer_caches

    # K4 at the phase path's burst shape: 8 decode lanes, contexts 44..1033
    lens4 = [44, 73, 133, 233, 383, 653, 853, 1033]
    q4, _, _, l4, t4 = decode_case(torch, gen, dev, torch.bfloat16, lens4,
                                   N_PAGES, MAX_PAGES, H, KVH, P, D)
    ms4, ms4_w = timed(lambda: attention.paged_attention_decode(
        q4, kp, vp, l4, t4))
    plain4 = time_ms(torch, lambda: attention.paged_attention_decode_ref(
        q4, kp, vp, l4, t4), flush=flush)
    got = attention.paged_attention_decode(q4, kp, vp, l4, t4)
    want = attention.paged_attention_decode_ref(q4, kp, vp, l4, t4)
    torch.testing.assert_close(got.float(), want.float(), **K4_BF16_TOL)
    err4 = (got.float() - want.float()).abs().max().item()
    k4_err[torch.bfloat16] = max(k4_err[torch.bfloat16], err4)
    log(f"[check] burst shape: K4 max_abs_err {err4:.3e} ({K4_BF16_TOL}), "
        f"K3 bit-exact outside page 0")
    bound4, by4 = k4_bound_ms(l4.cpu(), t4.cpu(), H, KVH, D, P, 2, peaks)
    rows[("k4", "burst")] = (8, ms4, plain4, bound4, by4, None, ms4_w, None)

    del kp, vp
    torch.cuda.empty_cache()

    # K5 / K6 at the four projection shapes: M = 8 (a burst's decode step)
    # and M = 512 (a prefill chunk), bf16 activations; gate/up M = 8 / 512
    # are the "burst" / "chunk" rows of the kernels line
    matmul_ms = {}
    for shape, (k8, n8) in PROJECTIONS.items():
        w_bf = torch.randn(k8, n8, generator=gen).to(dev, torch.bfloat16)
        for mode in QUANT_MODES:
            bits = quant._bits_of(mode)
            qt = quant.quantize(w_bf, bits, quant._act_bits_of(mode))
            fn, ref = a8_fns(int4_mm, mode)
            # the library's int8 GEMM takes plain int8 weights: K6's unpacked
            q8 = qt.q if bits == 8 else quant._unpack4(qt.q.T).T.contiguous()
            for m, label in ((8, "burst"), (512, "chunk")):
                x = a8_case(torch, gen, dev, m, k8, torch.bfloat16)
                got, want = fn(x, qt.q, qt.s), ref(x, qt.q, qt.s)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"{GEMM_OF[mode]} {shape} M={m} "
                                         f"differs from its plain version at "
                                         f"the timed shape")
                xq, sx = int4_mm.a8_prologue_ref(x)
                # torch._int_mm takes more than 16 rows: pad to 32 with zeros
                xq_lib = xq if m > 16 else torch.cat([xq, xq.new_zeros(
                    32 - m, k8)])

                def library():
                    y = torch._int_mm(xq_lib, q8.T)
                    return ((y[:m].float() * sx) * qt.s).to(x.dtype)

                lib_same = torch.equal(library(), got)
                ms, ms_w = timed(lambda: fn(x, qt.q, qt.s))
                plain_ms = time_ms(torch, lambda: ref(x, qt.q, qt.s), reps=5,
                                   flush=flush)
                lib_ms = time_ms(torch, library, flush=flush)
                key = (mode, label if shape == "gate/up" else
                       f"{shape} {label}")
                matmul_ms[key] = time_ms(torch, lambda: x @ w_bf, flush=flush)
                bnd, by = a8_bound_ms(m, k8, n8, bits, 2, peaks)
                rows[key] = (m, ms, plain_ms, bnd, by, lib_ms, ms_w, None)
                log(f"[check] {GEMM_OF[mode]} {shape} M={m} K={k8} N={n8} "
                    f"bf16: bit-identical with its plain version; the library "
                    f"yardstick (torch._int_mm"
                    f"{' on unpacked weights' if bits == 4 else ''} + epilogue"
                    f"{', rows padded to 32' if m <= 16 else ''}) "
                    f"{'agrees bit for bit' if lib_same else 'differs'}")
            del qt, q8
        del w_bf

    for (key, label), (n, ms, plain_ms, bnd, by, lib, ms_w, run) in \
            rows.items():
        kname = GEMM_OF.get(key, key)
        extra = (f", bf16 torch.matmul {matmul_ms[(key, label)]:.4f} ms"
                 if (key, label) in matmul_ms else "")
        in_run = (f", {run:.4f} ms per launch in a run of {N_LAYER_RUN} "
                  f"(floor {floor['run']:.4f})" if run is not None else "")
        log(f"[time] {kname} {label} rows={n}: kernel {ms:.4f} ms after a "
            f"read flush (write flush {ms_w:.4f}; floor {floor['ms']:.4f})"
            f"{in_run}, plain {plain_ms:.4f} ms, library "
            f"{'n/a' if lib is None else f'{lib:.4f} ms'}{extra}, bound "
            f"{bnd:.6f} ms ({by}) on {smi}")
    for label, run in (("phase", phase), ("ragged", ragged_run),
                       *((f"phase {m}", quantized[m]) for m in QUANT_MODES)):
        ttft = run["ttft"]
        log(f"[batch] {label} path: output {run['tokens'] / run['wall']:.1f} "
            f"tok/s, TTFT p50 {statistics.median(ttft) * 1e3:.1f} ms (min "
            f"{min(ttft) * 1e3:.1f}, max {max(ttft) * 1e3:.1f}) over "
            f"{len(ttft)} requests, {run['rounds']} dispatches, Llama-3-8B "
            f"random weights ({label.split()[-1] if ' ' in label else 'bf16'}"
            f"), max_tokens 32, on {smi}")
    log(f"[done] {time.perf_counter() - t_start:.1f}s")

    def entry(kname, source, replaces, key, err, run):
        n, ms, plain_ms, bnd, by, lib, ms_w, _ = rows[key]
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": run["launches"][kname],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd, "bound_by": by, "library_ms": lib,
                "ms_write_flush": ms_w}

    print(json.dumps({"kernels": [
        entry("ragged_paged_attention",
              "dynamo_tpu_torch/csrc/ragged_paged_attention.cu",
              "dynamo_tpu/engine/ragged.py:80", ("k1", "mixed"),
              k1_err[torch.bfloat16], ragged_run),
        entry("paged_kv_write", "dynamo_tpu_torch/csrc/paged_kv_write.cu",
              "dynamo_tpu/engine/kernels.py:32", ("k2", "mixed"), k2_err,
              phase),
        entry("paged_kv_write_pages",
              "dynamo_tpu_torch/csrc/paged_kv_write_pages.cu",
              "dynamo_tpu/engine/kernels.py:78", ("k3", "chunk"), k3_err,
              phase),
        entry("paged_attention_decode",
              "dynamo_tpu_torch/csrc/paged_attention_decode.cu",
              "dynamo_tpu/engine/attention.py:226", ("k4", "burst"),
              k4_err[torch.bfloat16], phase),
        entry("w8a8_matmul", "dynamo_tpu_torch/csrc/w8a8_matmul.cu",
              "dynamo_tpu/engine/int4_mm.py:107", ("w8a8", "burst"),
              a8_err["w8a8"], quantized["w8a8"]),
        entry("int4_matmul", "dynamo_tpu_torch/csrc/int4_matmul.cu",
              "dynamo_tpu/engine/int4_mm.py:168", ("int4", "burst"),
              a8_err["int4"], quantized["int4"]),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
