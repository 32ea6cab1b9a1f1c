"""What the router reads from a worker, held against the JAX package's:
the KV events and forward-pass metrics, on the wire and from the engine.

- `KvCacheEvent`, `ForwardPassMetrics` and their parts give equal dicts
  in both packages and read each other's; a sequence hash above 2^63
  crosses the port's MessagePack as uint64, both ways against msgpack.
- `PagePool`: the same seeded allocate / register / release / evict /
  clear history through the port's pool and the reference's gives the
  same event dicts (kinds, event ids, hashes, parents).
- `TorchEngine` and `TpuEngine` (same fp32 weights, a pool small enough
  to evict) serve the same requests with sinks attached: the KV-event
  dict streams are identical, prefix hits, evictions, a duplicate prefill
  and `clear_kv_blocks` included, on the phase and the ragged path; the
  `ForwardPassMetrics` `kv_stats` and `worker_stats` agree step for step
  (consecutive repeats folded: the engines' idle iterations differ).
- `EngineMetrics`: the port's series keep the reference's names, and its
  ITL quantile the reference's; a pool change on another thread reaches
  the sink on the event loop's thread.
"""

import asyncio
import random
import threading

import msgpack
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu import protocols as rp
from dynamo_tpu.engine import attention as jattn
from dynamo_tpu.engine import pages as rpages
from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.engine.metrics import EngineMetrics as RefEngineMetrics
from dynamo_tpu.models import llama as jl
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch import protocols as tp
from dynamo_tpu_torch.engine import pages as tpages
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.metrics import EngineMetrics
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.runtime import codec
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.tokens import TokenBlockSequence

BIG = 0xD2B4_5F5E_1A6B_3C79          # SEED_HASH: above 2^63


def _event_dicts():
    return [
        dict(kind="stored", worker_id=3, dp_rank=1, event_id=7,
             parent_seq_hash=BIG, blocks=[[2**64 - 1, 2**63], [5, BIG]],
             seq_hashes=[]),
        dict(kind="removed", worker_id=3, dp_rank=0, event_id=8,
             parent_seq_hash=None, blocks=[], seq_hashes=[BIG, 1]),
        dict(kind="cleared", worker_id=9, dp_rank=0, event_id=0,
             parent_seq_hash=None, blocks=[], seq_hashes=[]),
    ]


def test_kv_event_dicts_match_reference_and_cross_the_codec():
    for d in _event_dicts():
        ours = tp.KvCacheEvent.from_dict(d)
        ref = rp.KvCacheEvent.from_dict(d)
        assert ours.to_dict() == ref.to_dict() == d
        assert tp.KvCacheEvent.from_dict(ref.to_dict()).to_dict() == d
        wire = codec.packb(ours.to_dict())
        assert wire == msgpack.packb(ref.to_dict(), use_bin_type=True)
        assert msgpack.unpackb(wire, raw=False) == d
        assert codec.unpackb(msgpack.packb(d, use_bin_type=True)) == d


def test_forward_pass_metrics_dicts_match_reference():
    full = dict(worker_id=2**63 + 5, dp_rank=1,
                worker_stats=dict(request_active_slots=3,
                                  request_total_slots=8,
                                  num_requests_waiting=2),
                kv_stats=dict(kv_active_blocks=10, kv_total_blocks=2047,
                              hbm_cache_usage=0.25, host_cache_usage=0.0,
                              prefix_cache_hit_rate=0.5),
                spec_decode_stats=dict(num_draft_tokens=10,
                                       num_accepted_tokens=7),
                scheduler_stats={"prefill_chunks": 4, "itl_p50_ms": None})
    for d in (full, {"worker_id": 1, "kv_stats": {"kv_total_blocks": 9,
                                                  "unknown": 1}}):
        ours = tp.ForwardPassMetrics.from_dict(d)
        ref = rp.ForwardPassMetrics.from_dict(d)
        assert ours.to_dict() == ref.to_dict()
        assert tp.ForwardPassMetrics.from_dict(ref.to_dict()).to_dict() == \
            ours.to_dict()
        wire = codec.packb(ours.to_dict())
        assert wire == msgpack.packb(ref.to_dict(), use_bin_type=True)
        assert codec.unpackb(wire) == ref.to_dict()
    assert tp.SpecDecodeStats(10, 7).acceptance_rate == \
        rp.SpecDecodeStats(10, 7).acceptance_rate


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_pool_events_match_reference(seed):
    """A seeded history of sequences (shared prefixes, so prefix hits and
    duplicate seals), releases and clears: identical event dicts, free
    and active counts."""
    got, want = [], []
    pools = [tpages.PagePool(12, 4, worker_id=4, dp_rank=1,
                             event_sink=lambda e: got.append(e.to_dict())),
             rpages.PagePool(12, 4, worker_id=4, dp_rank=1,
                             event_sink=lambda e: want.append(e.to_dict()))]
    rng = random.Random(seed)
    bases = [[rng.randrange(30) for _ in range(24)] for _ in range(3)]
    held: list[list] = []                   # per pool: live page lists
    for step in range(60):
        r = rng.random()
        if r < 0.55:
            base = rng.choice(bases)
            toks = base[:rng.randrange(5, 24)]
            seq = TokenBlockSequence(4, toks)
            allocs = [p.allocate_sequence(seq.seq_hashes(), len(toks))
                      for p in pools]
            assert (allocs[0] is None) == (allocs[1] is None)
            if allocs[0] is None:
                continue
            assert allocs[0] == allocs[1]
            for pool, (pids, _) in zip(pools, allocs):
                for b in seq.blocks:
                    pool.register_page(pids[b.block_index], b.seq_hash,
                                       b.local_hash, b.parent_seq_hash)
            held.append(allocs[0][0])
        elif r < 0.9 and held:
            pids = held.pop(rng.randrange(len(held)))
            for pool in pools:
                pool.release_sequence(pids)
        elif r < 0.95:
            n = [p.clear_inactive() for p in pools]
            assert n[0] == n[1]
        assert pools[0].active_pages == pools[1].active_pages
        assert pools[0].usage() == pools[1].usage()
    assert got == want
    assert {e["kind"] for e in got} == {"stored", "removed"}


@pytest.fixture
def attention_impl():
    prev = jattn._impl
    yield jattn.set_attention_impl
    jattn.set_attention_impl(prev)


ENGINE_KW = dict(num_pages=24, max_batch_size=4, prefill_chunk=32,
                 min_prefill_bucket=8, default_max_tokens=8,
                 decode_steps_per_sync=2, worker_id=77, dp_rank=1)


def _engines(impl, events, metrics):
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    params = jl.init_params(jax.random.PRNGKey(0), jcfg)
    jax_eng = TpuEngine(TpuEngineConfig(model=jcfg, **ENGINE_KW),
                        params=params,
                        event_sink=lambda e: events[0].append(e.to_dict()),
                        metrics_sink=lambda m: metrics[0].append(m))
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    torch_eng = TorchEngine(
        TorchEngineConfig(model=tcfg, device="cpu", attention_impl=impl,
                          **ENGINE_KW), model=model,
        event_sink=lambda e: events[1].append(e.to_dict()),
        metrics_sink=lambda m: metrics[1].append(m))
    return jax_eng, torch_eng


def _req(tokens, max_tokens):
    return {"token_ids": list(tokens), "model": "m",
            "sampling": {"temperature": 0.0},
            "stop": {"max_tokens": max_tokens}}


async def _drain(eng, request):
    ctx = JaxContext() if isinstance(eng, TpuEngine) else Context()
    toks = []
    async for o in eng.generate(request, ctx):
        toks.extend(o.get("token_ids") or ())
    return toks


async def _workload(eng) -> list:
    """Requests one after another (prefix hits, then a prompt that evicts
    them), one batch submitted at once (two identical prompts: a
    duplicate seal), then a clear of the prefix cache."""
    a = list(range(1, 19))
    b = list(range(40, 62))
    c = list(range(80, 91))
    out = [await _drain(eng, _req(a, 6)),
           await _drain(eng, _req(a + [5, 6, 7], 5)),
           await _drain(eng, _req(b, 8)),
           await _drain(eng, _req(a[:9], 4))]
    out += await asyncio.gather(*(_drain(eng, _req(p, 6))
                                  for p in (c, c, a[:13])))
    out.append(eng.clear_kv_blocks())
    return out


def _stats(ms) -> list:
    """(worker_stats, kv_stats) per published metrics, consecutive repeats
    folded."""
    out = []
    for m in ms:
        d = m.to_dict()
        row = (d["worker_id"], d["dp_rank"], d["worker_stats"],
               d["kv_stats"])
        if not out or out[-1] != row:
            out.append(row)
    return out


@pytest.mark.parametrize("impl", ["phase", "ragged"])
async def test_engine_kv_events_and_metrics_match_tpu_engine(attention_impl,
                                                              impl):
    attention_impl("ragged" if impl == "ragged" else "auto")
    events, metrics = ([], []), ([], [])
    jax_eng, torch_eng = _engines(impl, events, metrics)
    try:
        want = await _workload(jax_eng)
        got = await _workload(torch_eng)
    finally:
        await jax_eng.close()
        await torch_eng.close()
    assert got == want
    assert events[1] == events[0]
    kinds = [e["kind"] for e in events[1]]
    assert kinds.count("removed") > 0 and kinds.count("stored") > 0
    assert [e["event_id"] for e in events[1]] == \
        list(range(1, len(events[1]) + 1))
    assert {(e["worker_id"], e["dp_rank"]) for e in events[1]} == {(77, 1)}
    # a seq_hash sealed twice (the duplicate prompts) is published twice
    stored = [b[0] for e in events[1] if e["kind"] == "stored"
              for b in e["blocks"]]
    assert len(stored) > len(set(stored))
    assert _stats(metrics[1]) == _stats(metrics[0])
    sched = metrics[1][-1].scheduler_stats
    assert set(sched) == set(metrics[0][-1].scheduler_stats)
    assert sched["compiles"] == torch_eng.compile_tracker.total > 0
    assert sched["itl_p50_ms"] is not None


def test_engine_metrics_names_match_reference():
    ours, ref = EngineMetrics(), RefEngineMetrics()
    for attr in ("prefill_chunk", "ttft", "itl", "tokens_emitted",
                 "pipelined_bursts", "mixed_steps",
                 "decode_steps_during_prefill"):
        a, b = getattr(ours, attr), getattr(ref, attr)
        assert (a.name, type(a).__name__) == (b.name, type(b).__name__)
        assert getattr(a, "buckets", None) == getattr(b, "buckets", None)
    view, ref_view = ours.perf_view(), ref.perf_view()
    assert set(view) <= set(ref_view)
    assert {k: v for k, v in ref_view.items() if k in view} == view
    # the ITL histogram's edges and quantile (llm/perf.py in both
    # packages; the engine's metrics read the edges from there)
    from dynamo_tpu.llm import perf as ref_perf
    from dynamo_tpu_torch.engine import metrics as tmetrics
    from dynamo_tpu_torch.llm import perf as tperf

    assert tmetrics.ITL_BUCKET_EDGES_MS == tperf.ITL_BUCKET_EDGES_MS == \
        ref_perf.ITL_BUCKET_EDGES_MS
    rng = random.Random(3)
    for _ in range(200):
        hist = [rng.choice([0, 0, 1, 5]) for _ in ref_perf.ITL_BUCKET_EDGES_MS]
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert tperf.itl_percentile(hist, q) == \
                ref_perf.itl_percentile(hist, q)


def test_pool_change_on_a_worker_thread_reaches_the_sink_on_the_loop():
    """An eviction inside a `to_thread` closure hops to the event loop's
    thread before the sink sees it (the runtime's bus is not
    thread-safe)."""
    seen = []
    eng = TorchEngine(TorchEngineConfig(
        model=tl.LlamaConfig.tiny(dtype=torch.float32), device="cpu",
        num_pages=16, max_batch_size=2, default_max_tokens=2),
        event_sink=lambda e: seen.append((e.kind, threading.get_ident())))

    async def main():
        await _drain(eng, _req(range(1, 14), 2))
        while eng.pool.active_pages:    # a pipelined burst may still hold
            await asyncio.sleep(0.001)  # the finished lane's pages
        loop_thread = threading.get_ident()
        n = await asyncio.to_thread(eng.clear_kv_blocks)
        await asyncio.sleep(0)          # let the hopped calls run
        await eng.close()
        return loop_thread, n

    loop_thread, n = asyncio.run(asyncio.wait_for(main(), 60))
    assert n > 0
    assert [k for k, _ in seen].count("removed") == n
    assert {t for _, t in seen} == {loop_thread}
