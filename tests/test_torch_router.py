"""The port's KV router host code held against the JAX package's:
`RadixTree` / `KvIndexer` / `ApproxKvIndexer` (`router/indexer.py`),
`DefaultWorkerSelector` and the load tracking (`router/scheduler.py`),
`KvRouter` (`router/kv_router.py`) and the router metrics
(`router/decision_log.py`).

- The same seeded event streams (and a `hypothesis` stream of stored /
  removed / cleared events over several `(worker, dp_rank)` keys) go into
  both indexers: after every event `find_matches` gives equal
  `OverlapScores` for every probe, `dump_events` / `restore` round-trip
  equal, and event-id gaps are counted equal (with equal `on_gap` calls).
- `ApproxKvIndexer` under one injected clock: equal scores as TTLs run
  out and refresh.
- `DefaultWorkerSelector` with the same `random.Random(seed)`, at
  temperature 0 and above: the same worker, logits, margin, ties and
  draw, and the RNGs left in the same state.
- `KvRouter` end to end on the same events, metrics and requests: equal
  decisions, load and counters.

The reference's indexer runs its pure-Python tree (`use_native=False`),
the one the port carries."""

import random

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu import protocols as rp
from dynamo_tpu.router import indexer as ri
from dynamo_tpu.router import kv_router as rk
from dynamo_tpu.router import scheduler as rs
from dynamo_tpu.tokens import compute_block_hashes as ref_block_hashes
from dynamo_tpu.tokens import compute_seq_hashes as ref_seq_hashes
from dynamo_tpu_torch import protocols as tp
from dynamo_tpu_torch.router import indexer as ti
from dynamo_tpu_torch.router import kv_router as tk
from dynamo_tpu_torch.router import scheduler as ts
from dynamo_tpu_torch.tokens import compute_block_hashes, compute_seq_hashes

BS = 4
WORKERS = [(1, 0), (1, 1), (2, 0), (7, 3)]


def _prompts(seed: int, n: int = 5, blocks: int = 6) -> list[list[int]]:
    """Prompts that share prefixes: each starts as a copy of an earlier
    one up to a random block, then diverges."""
    rng = random.Random(seed)
    out = [[rng.randrange(50) for _ in range(blocks * BS)]]
    for _ in range(n - 1):
        base = rng.choice(out)
        keep = rng.randrange(blocks) * BS
        out.append(base[:keep] + [rng.randrange(50)
                                  for _ in range(blocks * BS - keep)])
    return out


def _chain(prompt):
    """(local hashes, seq hashes) of a prompt's blocks."""
    return (compute_block_hashes(prompt, BS), compute_seq_hashes(prompt, BS))


def _stored(mod, w, prompt, start, n, eid):
    local, seq = _chain(prompt)
    parent = seq[start - 1] if start else None
    return mod.KvCacheEvent(
        kind=mod.KV_STORED, worker_id=w[0], dp_rank=w[1], event_id=eid,
        parent_seq_hash=parent,
        blocks=[mod.StoredBlock(seq[i], local[i])
                for i in range(start, min(start + n, len(seq)))])


def _removed(mod, w, hashes, eid):
    return mod.KvCacheEvent(kind=mod.KV_REMOVED, worker_id=w[0],
                            dp_rank=w[1], event_id=eid,
                            seq_hashes=list(hashes))


def _cleared(mod, w, eid):
    return mod.KvCacheEvent(kind=mod.KV_CLEARED, worker_id=w[0],
                            dp_rank=w[1], event_id=eid)


def _scores(s) -> tuple:
    return dict(s.scores), s.matched_blocks, s.best()


def _event_stream(seed: int, n: int = 120) -> list[tuple]:
    """Seeded (kind, worker, args, event id) tuples: stored chains (some
    orphaned: parent never stored), removals, clears, and event-id jumps
    that a lossy bus would cause."""
    rng = random.Random(seed)
    prompts = _prompts(seed)
    eids = {w: 0 for w in WORKERS}
    out = []
    for _ in range(n):
        w = rng.choice(WORKERS)
        eids[w] += 1 + (rng.random() < 0.1) * rng.randrange(1, 4)
        r = rng.random()
        if r < 0.6:
            p = rng.randrange(len(prompts))
            out.append(("stored", w, (p, rng.choice([0, 0, 0, 1, 2]),
                                      rng.randrange(1, 7)), eids[w]))
        elif r < 0.92:
            p = rng.randrange(len(prompts))
            seq = _chain(prompts[p])[1]
            out.append(("removed", w, tuple(rng.sample(
                seq, rng.randrange(1, 3))), eids[w]))
        else:
            out.append(("cleared", w, (), eids[w]))
    return out


def _build(mod, op, prompts):
    kind, w, args, eid = op
    if kind == "stored":
        p, start, n = args
        return _stored(mod, w, prompts[p], start, n, eid)
    if kind == "removed":
        return _removed(mod, w, args, eid)
    return _cleared(mod, w, eid)


def test_hashes_match_reference():
    for prompt in _prompts(3):
        assert compute_block_hashes(prompt, BS) == ref_block_hashes(
            prompt, BS)
        assert compute_seq_hashes(prompt, BS) == ref_seq_hashes(prompt, BS)


def _replay(ops, prompts):
    """Apply `ops` to both KvIndexers; after every event, every prompt's
    scores must agree. Returns (port indexer, reference indexer, gaps
    seen by each on_gap)."""
    # both Python trees (the native one: tests/test_torch_native_radix.py)
    ours, ref = ti.KvIndexer(BS, use_native=False), \
        ri.KvIndexer(BS, use_native=False)
    seen_o, seen_r = [], []
    ours.on_gap = lambda w, n: seen_o.append((w, n))
    ref.on_gap = lambda w, n: seen_r.append((w, n))
    for op in ops:
        ours.apply_event(_build(tp, op, prompts))
        ref.apply_event(_build(rp, op, prompts))
        for prompt in prompts:
            assert _scores(ours.find_matches_for_tokens(prompt)) == \
                _scores(ref.find_matches_for_tokens(prompt)), op
    return ours, ref, seen_o, seen_r


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_kv_indexer_matches_reference_on_seeded_streams(seed):
    prompts = _prompts(seed)
    ours, ref, seen_o, seen_r = _replay(_event_stream(seed), prompts)
    assert seen_o == seen_r and seen_o          # some gaps were injected
    assert ours.gaps == ref.gaps
    assert ours.events_applied == ref.events_applied
    assert ours.tree.workers() == ref.tree.workers()
    for w in WORKERS:
        assert ours.tree.block_count(w) == ref.tree.block_count(w)
    dumped = [e.to_dict() for e in ours.tree.dump_events()]
    assert dumped == [e.to_dict() for e in ref.tree.dump_events()]
    # restore: both packages rebuild the same tree from the dump, and a
    # second dump/restore is a fixed point. (The first restore may hold
    # less than the original: a node every worker left but whose
    # children live emits no event, so its subtree arrives orphaned, in
    # the reference as in the port.)
    t2 = ti.RadixTree.restore(tp.KvCacheEvent.from_dict(d) for d in dumped)
    r2 = ri.RadixTree.restore(rp.KvCacheEvent.from_dict(d) for d in dumped)
    again = [e.to_dict() for e in t2.dump_events()]
    assert again == [e.to_dict() for e in r2.dump_events()]
    t3 = ti.RadixTree.restore(tp.KvCacheEvent.from_dict(d) for d in again)
    assert sorted(map(repr, (e.to_dict() for e in t3.dump_events()))) == \
        sorted(map(repr, again))
    for prompt in prompts:
        local = compute_block_hashes(prompt, BS)
        assert _scores(t2.find_matches(local)) == \
            _scores(r2.find_matches(local)) == _scores(t3.find_matches(local))
    # a worker's removal drops its blocks, cursor and gap count alike
    for idx in (ours, ref):
        idx.remove_worker(WORKERS[0])
    assert ours.gaps == ref.gaps
    assert [e.to_dict() for e in ours.tree.dump_events()] == \
        [e.to_dict() for e in ref.tree.dump_events()]


_op = st.tuples(
    st.sampled_from(["stored", "stored", "stored", "removed", "cleared"]),
    st.sampled_from(WORKERS),
    st.integers(0, 4),                 # prompt
    st.integers(0, 5),                 # start block (0: root-anchored)
    st.integers(1, 6),                 # blocks / removals
    st.integers(0, 2))                 # event-id jump


@settings(max_examples=60, deadline=None)
@given(st.lists(_op, min_size=1, max_size=40), st.integers(0, 3))
def test_kv_indexer_matches_reference_hypothesis(ops, seed):
    prompts = _prompts(seed)
    eids = {w: 0 for w in WORKERS}
    stream = []
    for kind, w, p, start, n, jump in ops:
        eids[w] += 1 + jump
        if kind == "stored":
            stream.append((kind, w, (p, start, n), eids[w]))
        elif kind == "removed":
            seq = _chain(prompts[p])[1]
            stream.append((kind, w, tuple(seq[start:start + n]), eids[w]))
        else:
            stream.append((kind, w, (), eids[w]))
    ours, ref, seen_o, seen_r = _replay(stream, prompts)
    assert seen_o == seen_r
    assert ours.gaps == ref.gaps
    assert [e.to_dict() for e in ours.tree.dump_events()] == \
        [e.to_dict() for e in ref.tree.dump_events()]


def test_approx_indexer_matches_reference_under_one_clock():
    now = [100.0]

    def clock():
        return now[0]

    ours = ti.ApproxKvIndexer(BS, ttl_secs=5.0, clock=clock)
    ref = ri.ApproxKvIndexer(BS, ttl_secs=5.0, clock=clock)
    prompts = _prompts(11)
    rng = random.Random(11)
    for step in range(80):
        now[0] += rng.choice([0.0, 0.5, 1.0, 2.5])
        if rng.random() < 0.5:
            w = rng.choice(WORKERS)
            p = rng.choice(prompts)
            cut = rng.randrange(1, len(p) // BS + 1) * BS
            ours.process_routing_decision(w, p[:cut])
            ref.process_routing_decision(w, p[:cut])
        elif rng.random() < 0.1:
            w = rng.choice(WORKERS)
            ours.remove_worker(w)
            ref.remove_worker(w)
        for prompt in prompts:
            assert _scores(ours.find_matches_for_tokens(prompt)) == \
                _scores(ref.find_matches_for_tokens(prompt)), step
    ours.clear()
    ref.clear()
    assert _scores(ours.find_matches_for_tokens(prompts[0])) == \
        _scores(ref.find_matches_for_tokens(prompts[0])) == ({}, 0, (None, 0))


def _loads(mod, rng, n):
    return [mod.WorkerLoad(
        worker=WORKERS[i % len(WORKERS)] if i < len(WORKERS) else (i, 0),
        overlap_blocks=rng.randrange(0, 6),
        active_prefill_tokens=rng.choice([0, 0, 16, 40, 100]),
        active_decode_blocks=rng.randrange(0, 12)) for i in range(n)]


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("seed", [0, 5])
def test_selector_matches_reference(seed, temperature):
    ours = ts.DefaultWorkerSelector(
        ts.SelectorConfig(overlap_weight=1.5, temperature=temperature,
                          block_size=BS), random.Random(seed))
    ref = rs.DefaultWorkerSelector(
        rs.SelectorConfig(overlap_weight=1.5, temperature=temperature,
                          block_size=BS), rng=random.Random(seed))
    gen = random.Random(100 + seed)
    ties = 0
    for _ in range(200):
        n = gen.randrange(1, 7)
        blocks = gen.randrange(1, 9)
        state = gen.getstate()
        a = ours.select(blocks, _loads(ts, gen, n))
        gen.setstate(state)
        b = ref.select(blocks, _loads(rs, gen, n))
        for field in ("worker", "overlap_blocks", "logits",
                      "potential_prefill", "potential_decode", "margin",
                      "ties", "draw"):
            assert getattr(a, field) == getattr(b, field), field
        ties += a.ties > 1
        assert ours.rng.getstate() == ref.rng.getstate()
    if temperature == 0.0:
        assert ties                     # the tie-break draw was exercised
    with pytest.raises(ValueError):
        ours.select(1, [])


def test_active_sequences_match_reference():
    ours, ref = ts.MultiWorkerSequences(BS), rs.MultiWorkerSequences(BS)
    rng = random.Random(4)
    live: list[str] = []
    for i in range(300):
        r = rng.random()
        if r < 0.45 or not live:
            rid, w = f"r{i}", rng.choice(WORKERS)
            pt, tb = rng.randrange(0, 80), rng.randrange(1, 12)
            ours.add_request(rid, w, pt, tb)
            ref.add_request(rid, w, pt, tb)
            live.append(rid)
        elif r < 0.7:
            rid = rng.choice(live)
            ours.mark_prefill_completed(rid)
            ref.mark_prefill_completed(rid)
        elif r < 0.95:
            rid = live.pop(rng.randrange(len(live)))
            ours.free(rid)
            ref.free(rid)
        else:
            w = rng.choice(WORKERS)
            ours.remove_worker(w)
            ref.remove_worker(w)
        assert ours.workers() == ref.workers()
        for w in ours.workers():
            a, b = ours.worker(w), ref.worker(w)
            assert (a.active_prefill_tokens, a.active_blocks,
                    a.num_active) == (b.active_prefill_tokens,
                                      b.active_blocks, b.num_active)


@pytest.mark.parametrize("use_kv_events", [True, False])
def test_kv_router_matches_reference(use_kv_events):
    """The same worker set, KV events, metrics and requests into both
    routers (selector RNGs seeded alike): the same decisions, the same
    predicted load, the same counters and index."""
    cfg = dict(block_size=BS, overlap_weight=1.0, temperature=0.0,
               use_kv_events=use_kv_events)
    ours, ref = tk.KvRouter(tk.KvRouterConfig(**cfg)), \
        rk.KvRouter(rk.KvRouterConfig(**cfg))
    ours.selector.rng, ref.selector.rng = random.Random(9), random.Random(9)
    for r in (ours, ref):
        r.add_worker(1, 2)
        r.add_worker(2)
    prompts = _prompts(21)
    stream = _event_stream(21, 60)
    rng = random.Random(21)
    for i, op in enumerate(stream):
        ours.apply_kv_event(_build(tp, op, prompts))
        ref.apply_kv_event(_build(rp, op, prompts))
        if i % 7 == 0:
            w = rng.choice([(1, 0), (1, 1), (2, 0)])
            fpm = dict(worker_id=w[0], dp_rank=w[1],
                       kv_stats=dict(kv_active_blocks=rng.randrange(20),
                                     kv_total_blocks=64))
            ours.apply_metrics(tp.ForwardPassMetrics.from_dict(fpm))
            ref.apply_metrics(rp.ForwardPassMetrics.from_dict(fpm))
        if i % 3 == 0:
            p = rng.choice(prompts)[:rng.randrange(1, 24)]
            update = rng.random() < 0.8
            a = ours.find_best_match(f"q{i}", p, update_states=update)
            b = ref.find_best_match(f"q{i}", p, update_states=update)
            assert (a.worker, a.overlap_blocks, a.prefill_tokens,
                    a.total_blocks, a.logits, a.margin, a.ties) == \
                (b.worker, b.overlap_blocks, b.prefill_tokens,
                 b.total_blocks, b.logits, b.margin, b.ties)
            if update and rng.random() < 0.5:
                for r in (ours, ref):
                    r.mark_prefill_completed(f"q{i}")
            if update and rng.random() < 0.3:
                for r in (ours, ref):
                    r.free(f"q{i}")
    # the port's stats also name the tree that serves: the native one by
    # default (the reference's default too), the Python one when approx
    stats = ours.index_stats()
    assert stats.pop("tree") == ("native" if use_kv_events else "python")
    assert stats == ref.index_stats()
    # the reference's router may run its native tree, which dumps in
    # another order
    assert sorted(map(repr, ours.dump_snapshot())) == \
        sorted(map(repr, ref.dump_snapshot()))
    for name in ("decisions", "prefill_tokens_saved", "kv_event_gaps"):
        assert sorted(getattr(ours.metrics, name).items(),
                      key=repr) == sorted(getattr(ref.metrics, name).items(),
                                          key=repr), name
    assert ours.metrics.load_error.snapshot() == \
        ref.metrics.load_error.snapshot()
    for w in [(1, 0), (1, 1), (2, 0)]:
        a, b = ours.sequences.worker(w), ref.sequences.worker(w)
        assert (a.active_prefill_tokens, a.active_blocks) == \
            (b.active_prefill_tokens, b.active_blocks)
    ours.remove_worker(1)
    ref.remove_worker(1)
    assert ours.worker_keys() == ref.worker_keys() == [(2, 0)]
    # the port's stats also name the tree that serves: the native one by
    # default (the reference's default too), the Python one when approx
    stats = ours.index_stats()
    assert stats.pop("tree") == ("native" if use_kv_events else "python")
    assert stats == ref.index_stats()


def test_router_metrics_names_match_reference():
    from dynamo_tpu.router.decision_log import RouterMetrics as RefMetrics
    from dynamo_tpu_torch.router.decision_log import RouterMetrics

    def names(m):
        return sorted((k, v.name, type(v).__name__)
                      for k, v in vars(m).items())

    assert names(RouterMetrics()) == names(RefMetrics())


def test_decision_recorder_matches_reference(monkeypatch):
    """`DYN_ROUTER_LOG` arms the same per-decision ring; armed, routing
    and the selector's RNG are unchanged."""
    monkeypatch.setenv("DYN_ROUTER_LOG", "1")
    routers = []
    for mod in (tk, rk):
        r = mod.KvRouter(mod.KvRouterConfig(block_size=BS))
        r.selector.rng = random.Random(2)
        r.add_worker(1)
        r.add_worker(2)
        routers.append(r)
    prompts = _prompts(2)
    for i, p in enumerate(prompts * 2):
        a, b = (r.find_best_match(f"r{i}", p) for r in routers)
        assert a.worker == b.worker
    sa, sb = (r.recorder.summary() for r in routers)
    assert sa == sb and sa["decisions"] == 2 * len(prompts)
    strip = [{k: v for k, v in rec.items() if k != "at"}
             for rec in routers[0].recorder.snapshot()]
    assert strip == [{k: v for k, v in rec.items() if k != "at"}
                     for rec in routers[1].recorder.snapshot()]
