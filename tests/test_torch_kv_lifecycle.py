"""The port's KV lifecycle recorder (`dynamo_tpu_torch/kvbm/lifecycle.py`)
held against the JAX package's: the recorder, page-pool and tier cases of
tests/test_kv_lifecycle.py, each fed to both packages' objects with the
same event sequence. The summaries must be equal, but for the wall-clock
residency means (which only the run's timing sets); the rings equal, but
for their timestamps. The port's own assertions are the reference's."""

import asyncio

import numpy as np
import pytest
import torch

from dynamo_tpu.engine import pages as rpages
from dynamo_tpu.kvbm import lifecycle as rlc
from dynamo_tpu.kvbm import manager as rmanager
from dynamo_tpu.kvbm import tiers as rtiers
from dynamo_tpu.runtime.metrics import MetricsRegistry as RefRegistry
from dynamo_tpu_torch.engine import pages as tpages
from dynamo_tpu_torch.kvbm import lifecycle as tlc
from dynamo_tpu_torch.kvbm import manager as tmanager
from dynamo_tpu_torch.kvbm import tiers as ttiers
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

PACKAGES = {"ref": (rlc, rpages, rtiers, rmanager, np.asarray),
            "port": (tlc, tpages, ttiers, tmanager, torch.from_numpy)}


def H(i: int) -> int:
    return 0x1000 + i


def scrub(summary: dict) -> dict:
    out = dict(summary)
    out["residency"] = {t: {k: v for k, v in row.items() if k != "mean_s"}
                        for t, row in summary["residency"].items()}
    return out


def records(rec) -> list:
    return [{k: v for k, v in r.items() if k != "at"}
            for r in rec.snapshot()]


def both(fn):
    """Run `fn(lifecycle, pages, tiers, manager, as_block)` for each
    package; assert the recorders it returns agree, and return the
    port's."""
    recs = {name: fn(*mods) for name, mods in PACKAGES.items()}
    assert scrub(recs["port"].summary()) == scrub(recs["ref"].summary())
    assert records(recs["port"]) == records(recs["ref"])
    return recs["port"]


# -- ring semantics ---------------------------------------------------------------


def test_ring_bound_and_eviction():
    def run(lc, *_):
        rec = lc.KvLifecycleRecorder(capacity=16)
        for i in range(40):
            rec.on_allocate(i)
        return rec

    rec = both(run)
    s = rec.summary()
    assert (s["events"], s["in_ring"], s["capacity"], s["evicted"]) == \
        (40, 16, 16, 24)
    assert s["allocations"] == 40 and s["by_event"]["allocate"] == 40
    assert len(rec.snapshot()) == 16
    assert len(rec.snapshot(limit=4)) == 4


@pytest.mark.parametrize("env", [
    {}, {"DYN_KV_LIFECYCLE": "0"},
    {"DYN_KV_LIFECYCLE": "1", "DYN_KV_LIFECYCLE_RING": "64",
     "DYN_KV_LIFECYCLE_PREMATURE": "8"},
    {"DYN_KV_LIFECYCLE": "yes", "DYN_KV_LIFECYCLE_RING": "nope"}])
def test_capacity_floor_and_env_gate(env):
    assert tlc.KvLifecycleRecorder(capacity=1).capacity == 16
    ours, ref = tlc.recorder_from_env(env=env), rlc.recorder_from_env(env=env)
    assert (ours is None) == (ref is None)
    assert tlc.lifecycle_enabled(env) == rlc.lifecycle_enabled(env)
    if ours is not None:
        assert (ours.capacity, ours.premature_window) == \
            (ref.capacity, ref.premature_window)
    if env.get("DYN_KV_LIFECYCLE_RING") == "64":
        assert (ours.capacity, ours.premature_window) == (64, 8)
    if env.get("DYN_KV_LIFECYCLE_RING") == "nope":
        assert ours.capacity == 2048


# -- analytic reuse distance + premature evictions --------------------------------


def test_reuse_distance_analytic():
    metrics = {}

    def run(lc, *_):
        m = metrics.setdefault(lc, lc.KvbmMetrics())
        rec = lc.KvLifecycleRecorder(metrics=m)
        rec.on_allocate(1)
        rec.on_register(1, 42)
        for i in range(5):
            rec.on_allocate(2 + i)
        rec.on_hit(42, 16)             # distance 5 -> bucket <= 8
        rec.on_hit(42, 16)             # distance 0
        return rec

    s = both(run).summary()
    rd = s["reuse_distance"]
    assert rd["samples"] == 2 and rd["mean"] == 2.5
    assert rd["counts"][rd["buckets"].index(8)] == 1
    assert rd["counts"][rd["buckets"].index(0)] == 1
    assert s["hits"] == 2 and s["tokens_saved"] == 32
    assert s["hotness"][0] == {"seq_hash": f"{42:016x}", "hits": 2,
                               "tokens_saved": 32, "tier": "g1"}
    m = metrics[tlc]
    assert m.events.get(ev="hit") == 2
    assert m.tokens_saved.get() == 32
    assert m.reuse_distance.snapshot()[2] == 2
    ref = metrics[rlc]
    for attr in ("events", "evictions", "premature", "tokens_saved",
                 "reuse_distance", "tier_blocks", "tier_bytes"):
        a, b = getattr(m, attr), getattr(ref, attr)
        assert (a.name, type(a).__name__) == (b.name, type(b).__name__)
    assert m.reuse_distance.snapshot() == ref.reuse_distance.snapshot()


def test_premature_eviction_window():
    def run(lc, *_):
        rec = lc.KvLifecycleRecorder(metrics=lc.KvbmMetrics(),
                                     premature_window=4)
        rec.on_evict(7, "capacity-pressure")
        rec.on_onboard([7], "local", 4)       # 0 allocs later: premature
        rec.on_evict(8, "capacity-pressure")
        for i in range(5):
            rec.on_allocate(i)
        rec.on_onboard([8], "local", 4)       # 5 > window
        rec.on_onboard([7], "local", 4)       # consumed: not again
        return rec

    rec = both(run)
    s = rec.summary()
    assert s["premature_evictions"] == 1 and s["premature_window"] == 4
    assert s["evictions"] == {"capacity-pressure": 2}
    assert s["tokens_saved"] == 12
    assert rec.metrics.premature.get() == 1


def test_residency_and_pins():
    def run(lc, *_):
        rec = lc.KvLifecycleRecorder()
        rec.on_register(1, 99)
        rec.on_register(2, 98)
        rec.on_evict(99, "clear")
        rec.on_pin(3)
        rec.on_unpin(2)
        return rec

    s = both(run).summary()
    assert s["residency"]["g1"]["samples"] == 1
    assert s["residency"]["g1"]["mean_s"] >= 0.0
    assert s["residency"]["g1"]["live"] == 1
    assert s["pins"] == {"pinned": 3, "released": 2}


# -- PagePool: cause attribution + byte-identical off path ------------------------


def _pool_script(lc, pages, armed: bool):
    """An allocator workout hitting all three eviction causes; the
    recorder (or None) and everything observable from outside it."""
    events, hooks = [], []
    pool = pages.PagePool(6, 4, worker_id=7, event_sink=events.append)
    pool.evict_hook = lambda batch: hooks.append(list(batch))
    if armed:
        pool.lifecycle = lc.KvLifecycleRecorder(capacity=64)
    pages_a, cached = pool.allocate_sequence([H(1), H(2)], 8)
    assert cached == 0
    for j, pid in enumerate(pages_a):
        pool.register_page(pid, H(1 + j), 10 + j, H(j) if j else 0)
    pool.release_sequence(pages_a)
    pages_b, cached = pool.allocate_sequence([H(1), H(3), H(4), H(5)], 16)
    assert cached == 4
    for j in range(1, 4):
        pool.register_page(pages_b[j], H(2 + j), 20 + j, H(1 + j))
    pool.release_sequence(pages_b)
    pages_c, _ = pool.allocate_sequence([H(6), H(7)], 8)
    pool.release_sequence(pages_c)
    for _ in range(3):
        assert pool.allocate_page() is not None
    pool.clear_inactive()
    return pool.lifecycle, {
        "events": [e.to_dict() for e in events], "hooks": hooks,
        "free": list(pool._free), "registered": sorted(pool._registered),
        "inactive": list(pool._inactive)}


def test_pagepool_cause_attribution():
    rec = both(lambda lc, pages, *_: _pool_script(lc, pages, True)[0])
    s = rec.summary()
    assert s["evictions"] == {"admission-deficit": 2,
                              "capacity-pressure": 1, "clear": 2}
    assert s["hits"] == 1 and s["tokens_saved"] == 4
    assert s["allocations"] == 10
    assert s["by_event"]["register"] == 5
    assert s["by_event"]["kv_event"] == 10


def test_pagepool_byte_identical_when_unarmed():
    """Arming the recorder changes no eviction order, hook batch, free
    list or KV-event byte, in either package, and the two packages'
    pools agree."""
    off = _pool_script(tlc, tpages, False)[1]
    on = _pool_script(tlc, tpages, True)[1]
    assert off == on == _pool_script(rlc, rpages, False)[1]
    assert off["hooks"] == [[(2, H(2)), (1, H(1))], [(3, H(3))]]


def test_pagepool_pins_match_reference():
    """A hook that pins its victims: allocation reports exhaustion after
    one eviction, the pinned pages stay out of the free list until
    released, and both packages agree step for step."""
    def run(lc, pages, *_):
        pool = pages.PagePool(5, 4, event_sink=lambda e: None)
        pool.lifecycle = lc.KvLifecycleRecorder(capacity=64)
        pool.evict_hook = lambda batch: pool.pin_for_offload(
            [pid for pid, _ in batch])
        got, _ = pool.allocate_sequence([H(1), H(2), H(3)], 12)
        for j, pid in enumerate(got):
            pool.register_page(pid, H(1 + j), j, H(j))
        pool.release_sequence(got)
        assert pool.allocate_sequence([H(9)], 8) is None   # pinned, not freed
        assert pool.pending_offload_pages == 2
        assert not set(pool._pending_offload) & set(pool._free)
        assert pool.allocate_page() is not None
        assert pool.allocate_page() is None                # evicts once
        assert pool.pending_offload_pages == 3
        pool.release_offload_pin(list(pool._pending_offload))
        pool.release_offload_pin([1, 2, 3])                 # idempotent
        assert pool.pending_offload_pages == 0
        assert len(pool._free) == 3
        with pytest.raises(pages.BlockStateInvalid):
            pool.pin_for_offload([pool.allocate_page()])
        return pool.lifecycle

    s = both(run).summary()
    assert s["pins"] == {"pinned": 3, "released": 3}


# -- tier transitions (TieredStore) -------------------------------------------------


def test_tiered_store_demote_promote_drop_clear():
    def run(lc, pages, tiers, manager, as_block):
        rec = lc.KvLifecycleRecorder(capacity=64)
        store = tiers.TieredStore(host_blocks=2, disk_blocks=2)
        store.lifecycle = rec
        blk = as_block(np.arange(16, dtype=np.float32).reshape(
            2, 1, 1, 2, 4))
        for i in range(1, 6):
            store.put(H(i), blk)
        assert store.get(H(2)) is not None    # disk hit: g3 -> g2
        store.clear("all")
        return rec

    rec = both(run)
    ev = rec.summary()["by_event"]
    assert (ev["demote"], ev["promote"], ev["drop"], ev["tier_clear"]) == \
        (9, 1, 1, 1)
    res = rec.summary()["residency"]
    assert res["g2"]["samples"] >= 1 and res["g3"]["samples"] >= 1


def test_tiered_store_unchanged_when_unarmed():
    def run(armed, tiers=ttiers, as_block=torch.from_numpy):
        store = tiers.TieredStore(host_blocks=2, disk_blocks=2)
        if armed:
            store.lifecycle = tlc.KvLifecycleRecorder()
        blk = as_block(np.ones((2, 1, 1, 2, 4), dtype=np.float32))
        for i in range(1, 6):
            store.put(H(i), blk)
        store.get(H(2))
        return (sorted(store.host._blocks), sorted(store.disk._lru),
                store.occupancy())

    assert run(False) == run(True) == run(False, rtiers, np.asarray)


# -- hint prefetch and the payload helpers ----------------------------------------


class _FakePool:
    evict_hook = None
    pending_offload_pages = 0
    capacity = 4
    used_pages = 1

    def match_prefix(self, hashes):
        return []


class _FakeCfg:
    num_layers = 1
    num_kv_heads = 1
    page_size = 2
    head_dim = 4


class _FakeEngine:
    def __init__(self, rec):
        self.pool = _FakePool()
        self.kv_lifecycle = rec
        self.model_cfg = _FakeCfg()
        self.perf = {}


async def test_hint_prefetch_staging_and_attribution():
    recs = {}
    for name, (lc, _, _, manager, as_block) in PACKAGES.items():
        rec = recs[name] = lc.KvLifecycleRecorder(capacity=64)
        mgr = manager.KvbmManager(_FakeEngine(rec), manager.KvbmConfig(
            host_blocks=8, prefetch_blocks=2))
        blk = as_block(np.ones((2, 1, 1, 2, 4), dtype=np.float32))
        mgr.store.put(H(1), blk)
        mgr.store.put(H(2), blk)
        mgr.prefetch_waiting([], hints=[[H(1), H(2)], [H(1), H(2)]])
        await asyncio.gather(*mgr._prefetch_tasks)
        assert mgr.stats.prefetched == 2     # the duplicate chain deduped
        assert set(mgr._staged) == {H(1), H(2)}
        assert mgr._hint_staged == {H(1), H(2)}
        assert mgr._take_staged(H(1)) is not None
        assert mgr.stats.prefetch_hint_hits == 1
        mgr._stage(H(9), blk)
        mgr._take_staged(H(9))
        assert mgr.stats.prefetch_hint_hits == 1
        await mgr.close()
    assert scrub(recs["port"].summary()) == scrub(recs["ref"].summary())
    ev = recs["port"].summary()["by_event"]
    assert (ev["prefetch_hint_stage"], ev["prefetch_stage"],
            ev["prefetch_consume"]) == (2, 1, 2)


async def test_tier_occupancy_and_payload():
    payloads = {}
    for name, (lc, _, _, manager, as_block) in PACKAGES.items():
        rec = lc.KvLifecycleRecorder(capacity=64)
        eng = _FakeEngine(rec)
        mgr = manager.KvbmManager(eng, manager.KvbmConfig(host_blocks=8))
        mgr.store.put(H(1), as_block(np.ones((2, 1, 1, 2, 4),
                                             dtype=np.float32)))
        rec.on_allocate(1)
        tiers = lc.tier_occupancy(eng)
        assert tiers["g2"] == {"blocks": 1, "capacity": 8, "bytes": 32}
        p = lc.kv_payload(eng, limit=8)
        assert p["enabled"] is True and p["summary"]["allocations"] == 1
        assert p["records"] and "pipeline" in p
        payloads[name] = (tiers, scrub(p["summary"]), p["pipeline"])
        await mgr.close()
    assert payloads["port"] == payloads["ref"]


def test_payload_off_by_default():
    class _Bare:
        pool = None

    class _Armed:
        pool = None
        kv_lifecycle = tlc.KvLifecycleRecorder()

    p = tlc.kv_payload(_Bare())
    assert p == rlc.kv_payload(_Bare())
    assert p["enabled"] is False and "DYN_KV_LIFECYCLE" in p["hint"]
    assert "summary" not in p
    armed = tlc.kv_payload(_Armed())
    assert armed["enabled"] is True and armed["records"] == []


@pytest.mark.parametrize("lc,registry", [(tlc, MetricsRegistry),
                                         (rlc, RefRegistry)])
def test_tier_gauges_refresh_on_scrape(lc, registry):
    occ = {"g1": {"blocks": 3, "bytes": 96}}
    m = lc.KvbmMetrics()
    reg = registry()
    m.register(reg, occupancy=lambda: occ)
    reg.collect()
    assert m.tier_blocks.get(tier="g1") == 3
    assert m.tier_bytes.get(tier="g1") == 96
    occ["g1"]["blocks"] = 5
    reg.collect()
    assert m.tier_blocks.get(tier="g1") == 5
    assert "dynamo_kvbm_tier_blocks" in reg.render()
