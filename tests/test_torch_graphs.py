"""The port's compiled-step layer on the CPU: `engine/bucketing.py`,
`engine/compile_tracker.py` and `runtime/metrics.py` against the JAX
package's modules on the same inputs; the engine's bucket family (the
(entry, bucket) keys its tracker records) against `TpuEngine`'s on both
paths; the launch-count bookkeeping of `engine/cuda_build.py` that keeps
counts honest under graph replay; and the scratch invariant of the
kernels' persistent buffers (none a graph was captured with is freed,
and none grows during a capture). The graphs themselves need the card:
tests/test_torch_cuda.py holds their replays against eager calls.
"""

import asyncio

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.engine import attention as jattn
from dynamo_tpu.engine.bucketing import BucketLadder as JaxLadder
from dynamo_tpu.engine.compile_tracker import CompileTracker as JaxTracker
from dynamo_tpu.runtime import metrics as jmetrics
from dynamo_tpu_torch.engine import cuda_build, int4_mm, paged_core
from dynamo_tpu_torch.engine.bucketing import BucketLadder
from dynamo_tpu_torch.engine.compile_tracker import CompileTracker
from dynamo_tpu_torch.engine.graphs import StepGraphs
from dynamo_tpu_torch.runtime import metrics as tmetrics
from tests.test_torch_engine import ENGINE_KW, _consume, _engines, req

# -- BucketLadder ------------------------------------------------------------

_OPS = st.lists(st.one_of(
    st.tuples(st.just("propose"),
              st.lists(st.integers(-4, 70), max_size=12)),
    st.tuples(st.just("apply")),
    st.tuples(st.just("bucket"), st.integers(1, 64), st.integers(1, 64),
              st.integers(1, 16), st.sampled_from([1, 2, 4, 8, 16]))),
    max_size=30)


@settings(max_examples=200, deadline=None, database=None)
@given(ops=_OPS, max_rungs=st.integers(1, 8))
def test_bucket_ladder_matches_reference(ops, max_rungs):
    """The same propose / maybe_apply / bucket_for sequence gives the same
    answers and the same state on both ladders."""
    ours, ref = BucketLadder(max_rungs), JaxLadder(max_rungs)
    for op in ops:
        if op[0] == "propose":
            assert ours.propose(op[1]) == ref.propose(op[1])
        elif op[0] == "apply":
            assert ours.maybe_apply() == ref.maybe_apply()
        else:
            _, n, base, lo, align = op
            assert ours.bucket_for(n, base, lo=lo, align=align) == \
                ref.bucket_for(n, base, lo=lo, align=align)
        assert ours.state() == ref.state()
        assert ours.rungs == ref.rungs


# -- CompileTracker and its metrics ------------------------------------------

def _drive(tracker, calls):
    """Track each (entry, shape, fails) call; a failing dispatch raises
    inside the context and records nothing. Returns each call's
    `compiled`."""
    compiled = []
    for entry, shape, fails in calls:
        trk = tracker.track(entry, shape)
        compiled.append(trk.compiled)
        try:
            with trk:
                if fails:
                    raise RuntimeError("dispatch failed")
        except RuntimeError:
            pass
    return compiled


@settings(max_examples=100, deadline=None, database=None)
@given(calls=st.lists(st.tuples(
    st.sampled_from(["decode_burst", "ragged_step", "prefill",
                     "sample_first"]),
    st.one_of(st.integers(1, 4), st.lists(st.integers(0, 3), min_size=1,
                                          max_size=3).map(tuple)),
    st.booleans()), max_size=25))
def test_compile_tracker_matches_reference(calls):
    """The same track sequence: the same `compiled` flags, seen keys,
    events (entry, shape label, order) and counter labels and counts."""
    ours, ref = CompileTracker(history=8), JaxTracker(history=8)
    assert _drive(ours, calls) == _drive(ref, calls)
    assert ours._seen == ref._seen and ours.total == ref.total
    assert [(e["entry"], e["shape"]) for e in ours.events] == \
        [(e["entry"], e["shape"]) for e in ref.events]
    assert ours.compile_total.name == ref.compile_total.name
    assert ours.compile_seconds.name == ref.compile_seconds.name
    assert sorted(map(repr, ours.compile_total.items())) == \
        sorted(map(repr, ref.compile_total.items()))
    assert sorted(repr(lab) for lab, _ in ours.compile_seconds.items()) == \
        sorted(repr(lab) for lab, _ in ref.compile_seconds.items())


def test_metrics_copy_renders_like_reference():
    """Counter and MetricsRegistry of the port render the same Prometheus
    text as the reference's, through child prefixes, registered metrics
    and scrape callbacks."""
    texts = []
    for m in (tmetrics, jmetrics):
        reg = m.MetricsRegistry()
        child = reg.child("engine")
        c = child.counter("steps_total", "steps")
        c.inc(entry="decode_burst", shape="8x8x0")
        c.inc(2.5, entry="ragged_step", shape="16x0")
        ext = m.Counter("dynamo_compile_total", "compiles")
        reg.register(ext)
        reg.on_scrape(lambda ext=ext: ext.inc(shape="4"))
        reg.on_scrape(lambda: 1 / 0)            # logged once, not raised
        assert child.counter("steps_total") is c
        texts.append((reg.render(), reg.render(), c.get(entry="ragged_step")))
    assert texts[0] == texts[1]
    assert 'dynamo_engine_steps_total{entry="ragged_step",shape="16x0"} 2.5' \
        in texts[0][0]


def test_engine_tracker_registers_into_a_registry():
    """The engine's tracker is adopted by a registry under the reference's
    counter names, as EngineMetrics adopts its `metrics.compile`."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig

    eng = TorchEngine(TorchEngineConfig(device="cpu", num_pages=16))
    reg = tmetrics.MetricsRegistry()
    eng.compile_tracker.register(reg)
    assert {"dynamo_compile_total", "dynamo_compile_seconds_total"} <= \
        set(reg.collect())


# -- the engine's buckets against TpuEngine's --------------------------------

_RUNGS = [(), (20,), (10, 20, 28), (5, 9, 12, 13, 28, 31), (4, 8, 36)]


@pytest.mark.parametrize("rungs", _RUNGS, ids=map(str, _RUNGS))
def test_token_bucket_with_ladder_matches_tpu_engine(rungs):
    """With a ladder installed and applied (and unarmed), `_token_bucket`
    equals TpuEngine's for every chunk length up to prefill_chunk."""
    jax_eng, torch_eng = _engines(12, impl="phase")
    unarmed = [torch_eng._token_bucket(n)
               for n in range(1, ENGINE_KW["prefill_chunk"] + 1)]
    assert unarmed == [jax_eng._token_bucket(n)
                       for n in range(1, ENGINE_KW["prefill_chunk"] + 1)]
    for eng, ladder in ((jax_eng, JaxLadder()), (torch_eng, BucketLadder())):
        eng.bucket_ladder = ladder
        ladder.propose(rungs)
        ladder.maybe_apply()
    got = [torch_eng._token_bucket(n)
           for n in range(1, ENGINE_KW["prefill_chunk"] + 1)]
    want = [jax_eng._token_bucket(n)
            for n in range(1, ENGINE_KW["prefill_chunk"] + 1)]
    assert got == want
    assert (got != unarmed) == bool({20, 28} & set(rungs))


@pytest.fixture
def restore_impl():
    prev = jattn._impl
    yield jattn.set_attention_impl
    jattn.set_attention_impl(prev)


# six requests, all in flight from the start, for four slots: the last two
# are admitted while the others decode (mixed steps under a budget). With
# no arrival timed by the wall clock, both engines make the same dispatches
UPFRONT = [(range(1, 6), 10), (range(3, 20), 6), (range(5, 28), 12),
           (range(2, 42), 8), (range(7, 16), 14), (range(9, 35), 5)]


async def _upfront_workload(eng):
    return await asyncio.gather(*(
        _consume(eng, req(list(p), n), str(i), [])
        for i, (p, n) in enumerate(UPFRONT)))


def _keys(seen, entries):
    return sorted(k for k in seen if k[0] in entries)


# every fixed-shape entry replays a CUDA graph on the card ("prefill",
# "mixed_step" and "sample_first" since K1 took the phase path's chunk
# attention); none is left eager
GRAPHED = ("decode_burst", "ragged_step", "prefill", "mixed_step",
           "sample_first")
EAGER = ()


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "sync"])
@pytest.mark.parametrize("budget", [12, 0], ids=["budgeted", "prefill-all"])
@pytest.mark.parametrize("impl", ["phase", "ragged"])
async def test_tracker_keys_match_tpu_engine(restore_impl, impl, budget,
                                             pipeline):
    """The same workload on both engines, on the phase path (the
    reference's "auto") and the ragged path: the port's tracker holds the
    reference's `metrics.compile` keys for every graphed entry, and the
    streams stay identical."""
    restore_impl("ragged" if impl == "ragged" else "auto")
    jax_eng, torch_eng = _engines(budget, impl=impl,
                                  pipeline_bursts=pipeline)
    try:
        want = await _upfront_workload(jax_eng)
        got = await _upfront_workload(torch_eng)
    finally:
        await jax_eng.close()
        await torch_eng.close()
    assert got == want
    ours, ref = torch_eng.compile_tracker._seen, jax_eng.metrics.compile._seen
    assert _keys(ours, GRAPHED) == _keys(ref, GRAPHED)
    assert _keys(ours, GRAPHED), "the workload dispatched no graphed entry"
    assert _keys(ours, EAGER) == _keys(ref, EAGER)
    assert {k[0] for k in ours} <= set(GRAPHED + EAGER)
    graphed = "ragged_step" if impl == "ragged" else "decode_burst"
    assert any(k[0] == graphed for k in ours)
    if impl == "phase" and budget:
        assert any(k[0] == "mixed_step" for k in ours)
    assert torch_eng.graphs.captures == 0         # no graphs on the CPU
    events = list(torch_eng.compile_tracker.events)
    assert len(events) == len(ours) and all(e["seconds"] >= 0
                                            for e in events)


async def test_ladder_applied_at_the_scheduler_safe_point(restore_impl):
    """A rung staged before a batch is swapped in by the scheduler loop
    and reshapes the prefill chunks: both engines record the rung's
    bucket under "prefill" and serve the same streams."""
    restore_impl("auto")
    jax_eng, torch_eng = _engines(0, impl="phase")
    ladders = (JaxLadder(), BucketLadder())
    for eng, ladder in zip((jax_eng, torch_eng), ladders):
        eng.bucket_ladder = ladder
        assert ladder.propose([20, 28])
    try:
        want = await _upfront_workload(jax_eng)
        got = await _upfront_workload(torch_eng)
    finally:
        await jax_eng.close()
        await torch_eng.close()
    assert got == want
    assert [lad.state() for lad in ladders] == [
        {"rungs": [20, 28], "pending": None, "proposals": 1, "applied": 1}] * 2
    ours = _keys(torch_eng.compile_tracker._seen, ("prefill",))
    assert ours == _keys(jax_eng.metrics.compile._seen, ("prefill",))
    assert any(k[1][1] in (20, 28) for k in ours)


# -- launch counts under replay ----------------------------------------------

def test_launch_delta_is_a_pure_difference():
    before = {"a": 3, "b": 0, "c": 7}
    after = {"a": 5, "b": 0, "c": 7, "d": 2}
    assert cuda_build.launch_delta(before, after) == {"a": 2, "d": 2}
    assert before == {"a": 3, "b": 0, "c": 7}         # inputs untouched
    assert cuda_build.launch_delta(after, after) == {}


def test_capture_then_replays_count_each_launch_once(monkeypatch):
    """A capture's launches are taken back (it ran nothing) and every
    replay adds them, so the counts equal the eager launches of the same
    calls."""
    counts = {name: 0 for name in cuda_build.KERNELS}
    for name, k in cuda_build.KERNELS.items():
        monkeypatch.setattr(k, "launches", 0)
    k2, k4 = "paged_kv_write", "paged_attention_decode"
    # the warm-up ran eagerly: its launches count
    cuda_build.KERNELS[k2].launches += 2
    cuda_build.KERNELS[k4].launches += 2
    before = cuda_build.launch_counts()
    cuda_build.KERNELS[k2].launches += 2          # the capture's calls
    cuda_build.KERNELS[k4].launches += 2
    delta = cuda_build.launch_delta(before, cuda_build.launch_counts())
    cuda_build.add_launches(delta, -1)
    assert cuda_build.launch_counts() == before
    for _ in range(3):                            # three replays
        cuda_build.add_launches(delta)
    counts.update({k2: 8, k4: 8})
    assert cuda_build.launch_counts() == counts


def test_step_graphs_call_the_step_on_the_cpu():
    graphs = StepGraphs(torch.device("cpu"))
    out = graphs.run(("ragged_step", (8, 0)), lambda a, b: a + b,
                     (np.arange(4, dtype=np.int32), torch.ones(4)))
    assert torch.equal(out, torch.tensor([1.0, 2.0, 3.0, 4.0]))
    assert graphs.captures == graphs.replays == 0 and not graphs.graphs
    assert graphs.pool_bytes() == 0


# -- the scratch invariant ----------------------------------------------------

@pytest.fixture
def fresh_scratch(monkeypatch):
    """Empty scratch maps (and retirement list) for the test, restored
    afterwards; 132 SMs."""
    monkeypatch.setattr(paged_core, "_SCRATCH", {})
    monkeypatch.setattr(paged_core, "_RETIRED", [])
    monkeypatch.setattr(int4_mm, "_SCRATCH", {})
    monkeypatch.setattr(paged_core, "sm_count", lambda device: 132)


def test_superseded_scratch_stays_alive(fresh_scratch):
    """A larger shape replaces the buffers and keeps the old ones alive
    (a graph captured with them still points at them); the new counters
    start at 0."""
    dev = torch.device("cpu")
    part, counters = paged_core.core_scratch(dev, 4, 64, 10)
    same = paged_core.core_scratch(dev, 4, 64, 10)
    assert same[0] is part and same[1] is counters
    part2, counters2 = paged_core.core_scratch(dev, 4, 64, 40)
    assert part2 is part and counters2 is not counters
    assert counters2.numel() == 40 and int(counters2.abs().sum()) == 0
    assert any(t is counters for t in paged_core._RETIRED)
    slots, tickets = int4_mm.stream_scratch(dev, 1024)
    slots2, tickets2 = int4_mm.stream_scratch(dev, 4096)
    assert slots2 is slots and tickets2 is not tickets
    assert any(t is tickets for t in paged_core._RETIRED)


def test_scratch_growth_during_capture_raises(fresh_scratch, monkeypatch):
    """While the current CUDA stream is capturing, a scratch buffer that
    would have to grow raises instead (its new memory would belong to the
    graph); one that fits is handed out as before."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    dev = torch.device("cuda")
    with pytest.raises(RuntimeError, match="eager call at this shape"):
        paged_core.core_scratch(dev, 264, 128, 64)
    with pytest.raises(RuntimeError, match="eager call at this shape"):
        int4_mm.stream_scratch(dev, 4096)
    cpu = torch.device("cpu")
    part, counters = paged_core.core_scratch(cpu, 4, 64, 10)   # no capture
    assert paged_core.core_scratch(cpu, 4, 64, 8) == (part, counters)


def test_engine_on_the_cpu_tracks_entries_without_graphs():
    """The graphs layer is inert on the CPU: an engine served there makes
    no graph, but tracks its entries."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.runtime.context import Context

    eng = TorchEngine(TorchEngineConfig(device="cpu", num_pages=32,
                                        max_batch_size=2,
                                        decode_steps_per_sync=2))

    async def serve():
        try:
            toks = []
            async for o in eng.generate({"token_ids": [1, 2, 3],
                                         "stop": {"max_tokens": 5}},
                                        Context()):
                toks += o.get("token_ids", [])
            return toks
        finally:
            await eng.close()

    assert len(asyncio.run(serve())) == 5
    assert eng.graphs.captures == 0 and not eng.graphs.graphs
    seen = eng.compile_tracker._seen
    assert ("decode_burst", (2, 2, 0)) in seen
    assert any(k[0] == "prefill" for k in seen)
    assert any(k[0] == "sample_first" for k in seen)


def test_gc_paused_holds_the_collector_across_threads():
    """`graphs.gc_paused` (around every capture) keeps the cyclic
    collector off while any hold is open, on any thread, and restores
    the state the first hold found."""
    import gc
    import threading

    from dynamo_tpu_torch.engine.graphs import gc_paused

    assert gc.isenabled()
    inner_open, release = threading.Event(), threading.Event()

    def other():
        with gc_paused():
            inner_open.set()
            release.wait(10)

    t = threading.Thread(target=other)
    with gc_paused():
        assert not gc.isenabled()
        t.start()
        assert inner_open.wait(10)
    # the other thread's hold is still open
    assert not gc.isenabled()
    release.set()
    t.join(10)
    assert gc.isenabled()
    gc.disable()
    try:
        with gc_paused():
            pass
        assert not gc.isenabled()       # it was off: it stays off
    finally:
        gc.enable()
    # under contention: more threads than cores, a short switch interval;
    # a lost update of the hold count would leave the collector off (or
    # turn it on inside another thread's hold)
    import os
    import sys

    errors: list = []

    def churn():
        for _ in range(300):
            with gc_paused():
                if gc.isenabled():
                    errors.append("collector on inside a hold")

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=churn)
                   for _ in range(2 * (os.cpu_count() or 4))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
    finally:
        sys.setswitchinterval(prev)
    assert not any(th.is_alive() for th in threads)
    assert errors == [] and gc.isenabled()
