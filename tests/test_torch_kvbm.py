"""KVBM in the port (`dynamo_tpu_torch/kvbm/`), held against the JAX
package's on the same inputs.

- The cases of tests/test_kvbm.py and tests/test_kvbm_pipeline.py on the
  port: tier mechanics (host LRU, disk round trip and capacity, demote and
  promote), offload on eviction then onboard with the same stream, the
  disk tier end to end, the controller's status and reset, a pinned page
  never recycled before its gather lands, prefetched blocks consumed at
  admission, a stuck offload worker backpressuring into the inline copy,
  the all-zero knobs being the synchronous path byte for byte, and the
  queue's byte cap.
- `TorchEngine` + KVBM against `TpuEngine` + KVBM on the same fp32
  weights (`params_from_jax`), a pool smaller than the working set, on the
  phase and the ragged path: greedy streams identical, `KvbmStats` equal,
  KV-event dicts equal, and the tier blocks equal within 1e-5 (fp32: the
  two engines' prefills differ only in accumulation order).
- A stream with KVBM equals the stream without it.
- `DiskTier` writes bf16 blocks as the reference's raw bytes and reads the
  reference's files, in a process that never imports `ml_dtypes`.
"""

import asyncio
import os
import subprocess
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu import kvbm as rkvbm
from dynamo_tpu.engine import attention as jattn
from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.models import llama as jl
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.kvbm import (
    DiskTier,
    HostTier,
    KvbmConfig,
    KvbmManager,
    TieredStore,
)
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.faults import FaultInjector
from dynamo_tpu_torch.tokens import TokenBlockSequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 tier blocks of the two engines: the same pages prefilled by two
# implementations whose matmuls accumulate in different orders
BLOCK_TOL = {"atol": 1e-5, "rtol": 1e-5}


def blk(seed, shape=(2, 2, 2, 4, 8)):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32))


# -- tier mechanics ------------------------------------------------------------


def test_host_tier_lru_displaces():
    t = HostTier(capacity_blocks=2)
    assert t.put(1, blk(1)) == []
    assert t.put(2, blk(2)) == []
    t.get(1)                                   # 2 becomes LRU
    displaced = t.put(3, blk(3))
    assert [h for h, _ in displaced] == [2]
    assert t.contains(1) and t.contains(3) and not t.contains(2)


def test_disk_tier_roundtrip_and_capacity(tmp_path):
    t = DiskTier(capacity_blocks=2, directory=str(tmp_path))
    a = blk(7)
    t.put(10, a)
    t.put(11, blk(8))
    assert torch.equal(t.get(10), a)           # 11 becomes LRU
    t.put(12, blk(9))
    assert t.contains(10) and t.contains(12) and not t.contains(11)
    assert len(list(tmp_path.iterdir())) == 2


def test_tiered_store_demotes_and_promotes(tmp_path):
    s = TieredStore(host_blocks=1, disk_blocks=4, disk_dir=str(tmp_path))
    a, b = blk(1), blk(2)
    s.put(1, a)
    s.put(2, b)                                # 1 demoted to disk
    assert not s.host.contains(1) and s.disk.contains(1)
    assert torch.equal(s.get(1), a)            # disk hit promotes
    assert s.host.contains(1)
    assert s.match_prefix([1, 2, 3]) == 2
    assert s.resident_hashes() == {1: ("host", a.nbytes),
                                   2: ("disk", b.nbytes)}


@pytest.mark.parametrize("seed", [0, 1])
def test_tiered_store_matches_reference(tmp_path, seed):
    """A seeded history of puts, gets and clears on both packages' stores
    (host 3 blocks, disk 4): the same hashes per tier after every step,
    the same hits, the same bytes."""
    rng = np.random.RandomState(seed)
    ours = TieredStore(3, 4, str(tmp_path / "ours"))
    ref = rkvbm.TieredStore(3, 4, str(tmp_path / "ref"))
    for step in range(80):
        h = int(rng.randint(12))
        r = rng.rand()
        if r < 0.5:
            data = blk(h)
            ours.put(h, data)
            ref.put(h, data.numpy())
        elif r < 0.95:
            got, want = ours.get(h), ref.get(h)
            assert (got is None) == (want is None)
            if got is not None:
                assert got.numpy().tobytes() == want.tobytes()
        else:
            assert ours.clear("g2") == ref.clear("g2")
        assert list(ours.host._blocks) == list(ref.host._blocks)
        assert list(ours.disk._lru) == list(ref.disk._lru)
        assert ours.hashes() == ref.hashes()
        assert ours.occupancy() == ref.occupancy()


# -- the port's engine -----------------------------------------------------------

TINY_KW = dict(num_pages=10, max_batch_size=2, prefill_chunk=32,
               min_prefill_bucket=8, default_max_tokens=4,
               decode_steps_per_sync=2)


def make_engine(kvbm=True, num_pages=10, injector=None, host_blocks=64,
                **kvbm_kw):
    eng = TorchEngine(TorchEngineConfig(
        model=tl.LlamaConfig.tiny(dtype=torch.float32), device="cpu",
        **{**TINY_KW, "num_pages": num_pages}))
    mgr = (KvbmManager(eng, KvbmConfig(host_blocks=host_blocks, **kvbm_kw),
                       fault_injector=injector) if kvbm else None)
    return eng, mgr


def req(tokens, max_tokens=4):
    return {"token_ids": list(tokens), "model": "m",
            "sampling": {"temperature": 0.0},
            "stop": {"max_tokens": max_tokens}}


async def collect(eng, r):
    ctx = JaxContext() if isinstance(eng, TpuEngine) else Context()
    return [t async for o in eng.generate(r, ctx)
            for t in o.get("token_ids", ())]


async def churn(eng, bases=(50, 80, 110)):
    for base in bases:
        await collect(eng, req(list(range(base, base + 12))))


async def drain_pipeline(mgr, timeout=10.0):
    """Wait until no offload pins or queued batches remain."""
    async def wait():
        while (mgr.engine.pool.pending_offload_pages
               or mgr._offload_q_blocks):
            await asyncio.sleep(0.01)
    await asyncio.wait_for(wait(), timeout)


async def test_offload_on_eviction_then_onboard_hit():
    # 9 usable pages of 4 tokens: prompt A is 3 pages, the fillers push
    # its registered pages out, and A again onboards from the host tier
    eng, mgr = make_engine()
    try:
        a = list(range(1, 13))
        out1 = await collect(eng, req(a))
        await churn(eng)
        assert mgr.stats.offloaded >= 3
        out2 = await collect(eng, req(a))
        assert mgr.stats.onboarded >= 2
        assert out2 == out1
        # each tier block owns its storage, in the tier shape
        cfg = eng.model_cfg
        for h in mgr.store.hashes():
            b = mgr.store.get(h)
            assert b.shape == (2, cfg.num_layers, cfg.num_kv_heads,
                               cfg.page_size, cfg.head_dim)
            assert b.is_contiguous() and b.untyped_storage().nbytes() \
                == b.nbytes
    finally:
        await eng.close()


async def test_output_identical_with_and_without_kvbm():
    prompt = list(range(3, 15))
    eng_plain, _ = make_engine(kvbm=False)
    try:
        expect = await collect(eng_plain, req(prompt))
    finally:
        await eng_plain.close()
    eng, mgr = make_engine()
    try:
        first = await collect(eng, req(prompt))
        await churn(eng, bases=(60, 90, 120))
        again = await collect(eng, req(prompt))
        assert first == expect
        assert again == expect
        assert mgr.stats.onboarded > 0
    finally:
        await eng.close()


async def test_disk_tier_end_to_end(tmp_path):
    # a host tier of 1 block: everything beyond one block demotes to disk
    eng, mgr = make_engine(host_blocks=1, disk_blocks=32,
                           disk_dir=str(tmp_path))
    try:
        prompt = list(range(1, 13))
        out1 = await collect(eng, req(prompt))
        await churn(eng)
        assert len(mgr.store.disk) > 0
        out2 = await collect(eng, req(prompt))
        assert out2 == out1
        assert mgr.stats.onboarded > 0
    finally:
        await eng.close()


async def test_controller_status_and_reset(tmp_path):
    eng, mgr = make_engine(host_blocks=2, disk_blocks=8,
                           disk_dir=str(tmp_path))
    try:
        await collect(eng, req(list(range(1, 13))))
        await churn(eng)
        st = mgr.status()
        assert st["g1"]["pages"] == 9          # scratch page excluded
        assert st["g2"] == {"blocks": 2, "capacity": 2}
        assert st["g3"]["blocks"] >= 1
        assert st["stats"]["offloaded"] >= 3
        assert 0.0 <= st["stats"]["onboard_hit_rate"] <= 1.0
        dropped = mgr.reset("g3")
        assert dropped["g3"] >= 1 and "g2" not in dropped
        assert mgr.status()["g3"]["blocks"] == 0
        dropped = mgr.reset("all")
        assert dropped["g2"] == 2 and dropped["g1"] >= 0
        assert mgr.status()["g2"]["blocks"] == 0
        with pytest.raises(ValueError):
            mgr.reset("g7")
    finally:
        await eng.close()


async def test_pinned_page_never_recycled_before_gather():
    """While the offload gather is held back, the pinned victims stay out
    of the free list; once it lands they recycle and the offloaded bytes
    are the true ones — re-serving the prompt is identical."""
    eng, mgr = make_engine(offload_queue_depth=16)
    gate = threading.Event()
    real_read = eng._read_kv_pages_sync
    loop_thread = threading.current_thread()

    def gated_read(page_ids):
        # hold only the worker's to_thread gather; the loop-thread calls
        # (inline fallback, emergency flush) must not block
        if threading.current_thread() is not loop_thread:
            gate.wait(timeout=30)
        return real_read(page_ids)

    try:
        a = list(range(1, 13))
        out1 = await collect(eng, req(a))
        await collect(eng, req(list(range(50, 62))))
        assert eng.pool.pending_offload_pages == 0
        assert mgr.stats.offloaded == 0
        eng._read_kv_pages_sync = gated_read
        evicting = asyncio.ensure_future(
            collect(eng, req(list(range(110, 134)))))

        async def until_pinned():
            while not eng.pool.pending_offload_pages:
                await asyncio.sleep(0.01)
        await asyncio.wait_for(until_pinned(), 10)
        pinned = set(eng.pool._pending_offload)
        assert pinned
        assert not pinned & set(eng.pool._free)
        assert all(pid in eng.pool._pages for pid in pinned)
        gate.set()
        eng._read_kv_pages_sync = real_read
        await asyncio.wait_for(evicting, 30)
        await drain_pipeline(mgr)
        assert eng.pool.pending_offload_pages == 0
        assert mgr.stats.offloaded >= 1
        assert await collect(eng, req(a)) == out1
    finally:
        gate.set()
        eng._read_kv_pages_sync = real_read
        await eng.close()


async def test_prefetch_staged_blocks_hit_at_admission():
    eng, mgr = make_engine(prefetch_blocks=8)
    try:
        a = list(range(1, 13))
        out1 = await collect(eng, req(a))
        await churn(eng)
        await drain_pipeline(mgr)
        assert mgr.stats.offloaded >= 3
        seq = SimpleNamespace(
            prompt=a, prompt_hashes=TokenBlockSequence(4, a).seq_hashes(),
            import_kv=None)
        mgr.prefetch_waiting([seq])
        assert mgr._prefetch_tasks
        await asyncio.wait_for(asyncio.gather(*mgr._prefetch_tasks), 10)
        assert mgr.stats.prefetched >= 2
        assert len(mgr._staged) >= 2
        assert mgr.pipeline_stats()["staged_bytes"] > 0
        out2 = await collect(eng, req(a))
        assert mgr.stats.prefetch_hits >= 2
        assert out2 == out1
    finally:
        await eng.close()


async def test_stuck_offload_backpressures_to_inline_copy():
    inj = FaultInjector.from_spec("kind=offload_stall,times=1")
    eng, mgr = make_engine(offload_queue_depth=3, injector=inj)
    try:
        a = list(range(1, 13))
        out1 = await collect(eng, req(a))
        await churn(eng, bases=(50, 80, 110, 140, 170))
        assert inj.fired.get("offload_stall", 0) == 1
        assert mgr.stats.offload_inline > 0
        assert eng.pool.pending_offload_pages <= 3
        assert await collect(eng, req(a)) == out1
    finally:
        await eng.close()
        assert eng.pool.pending_offload_pages == 0


async def test_zero_knobs_reproduce_synchronous_path_exactly():
    workload = [list(range(1, 13)), list(range(50, 62)),
                list(range(80, 92)), list(range(1, 13))]

    async def run(kvbm_kw):
        eng, mgr = make_engine(**kvbm_kw)
        try:
            outs = [await collect(eng, req(p)) for p in workload]
            await drain_pipeline(mgr)
            hashes = sorted(mgr.store.hashes())
            blobs = {h: mgr.store.get(h).numpy().tobytes() for h in hashes}
            assert eng.pool.pending_offload_pages == 0
            if not any(kvbm_kw.values()):
                assert mgr._offload_task is None
                assert not mgr._staged
            return outs, hashes, blobs
        finally:
            await eng.close()

    o_default, h_default, b_default = await run({})
    o_zero, h_zero, b_zero = await run(dict(
        offload_queue_depth=0, offload_workers=0, prefetch_blocks=0))
    o_pipe, h_pipe, b_pipe = await run(dict(
        offload_queue_depth=16, offload_workers=2, prefetch_blocks=4))
    assert o_default == o_zero == o_pipe
    assert h_default == h_zero
    assert b_default == b_zero
    for h in set(h_default) & set(h_pipe):
        assert b_default[h] == b_pipe[h]


async def test_offload_queue_byte_cap_tightens_depth():
    eng, mgr = make_engine(offload_queue_depth=16)
    nbytes = mgr._block_nbytes()
    cfg = eng.model_cfg
    assert nbytes == 4 * 2 * cfg.num_layers * cfg.num_kv_heads \
        * cfg.page_size * cfg.head_dim
    await eng.close()
    inj = FaultInjector.from_spec("kind=offload_stall,times=1")
    eng, mgr = make_engine(offload_queue_depth=16,
                           offload_queue_bytes=2 * nbytes + 1, injector=inj)
    try:
        assert mgr._effective_queue_depth() == 2
        out1 = await collect(eng, req(list(range(1, 13))))
        await churn(eng, bases=(50, 80, 110, 140, 170))
        assert eng.pool.pending_offload_pages <= 2
        assert mgr.stats.offload_inline > 0
        assert mgr.pipeline_stats()["offload_queue_bytes"] <= 2 * nbytes
        assert await collect(eng, req(list(range(1, 13)))) == out1
    finally:
        await eng.close()
    for kw, depth in ((dict(offload_queue_depth=4,
                            offload_queue_bytes=1000 * nbytes), 4),
                      (dict(offload_queue_depth=4), 4)):
        eng, mgr = make_engine(**kw)
        assert mgr._effective_queue_depth() == depth
        await eng.close()
    eng, mgr = make_engine(offload_queue_bytes=64 * nbytes)
    try:
        await collect(eng, req(list(range(1, 13))))
        await churn(eng)
        assert mgr._offload_task is None
        assert not mgr._staged
    finally:
        await eng.close()


async def test_admission_stall_is_timed_and_published():
    """Every admission observes `admission_stall`; the forward-pass
    metrics publish its median in ms, the pipeline stats its sum."""
    published = []
    eng, mgr = make_engine()
    eng.attach_sinks(None, published.append)
    try:
        await collect(eng, req(list(range(1, 13))))
        await churn(eng)
        await collect(eng, req(list(range(1, 13))))
        assert eng.metrics.admission_stall.count == 5
        stall = published[-1].scheduler_stats["admission_stall_ms"]
        assert stall == round(
            eng.metrics.admission_stall.quantile(0.5) * 1e3, 3) > 0
        assert mgr.pipeline_stats()["admission_stall_ms"] == round(
            eng.metrics.admission_stall.sum * 1e3, 3)
        # each onboard and offload read is timed by stage (host time
        # here; the copies exist only on the card)
        stage = eng.metrics.kvbm_stage
        assert mgr.stats.onboarded > 0
        assert stage["onboard_stack"].count == 1
        assert stage["onboard_write"].count == 1
        assert stage["onboard_copy"].count == 0
        assert stage["offload_gather"].count == \
            stage["offload_split"].count > 0
        assert stage["offload_copy"].count == 0
    finally:
        await eng.close()


async def test_admission_stall_is_zero_without_kvbm():
    """Without KVBM there is no blocking admission work: nothing is
    observed and the published median is 0.0."""
    published = []
    eng, _ = make_engine(kvbm=False)
    eng.attach_sinks(None, published.append)
    try:
        await collect(eng, req(list(range(1, 13))))
        await churn(eng)
        assert eng.metrics.admission_stall.count == 0
        assert published[-1].scheduler_stats["admission_stall_ms"] == 0.0
    finally:
        await eng.close()


async def _outputs(eng, r):
    return [o async for o in eng.generate(r, Context())]


async def test_failed_offload_worker_read_raises_into_requests():
    """A failure of the pipelined worker's device read does not pass as
    a cache miss: the next scheduler iteration raises it, and the request
    it serves ends in an error; the pins are released and the engine
    serves the next request."""
    eng, mgr = make_engine(offload_queue_depth=16)
    loop_thread = threading.current_thread()
    real_read = eng._read_kv_pages_sync

    def failing_read(page_ids):
        if threading.current_thread() is not loop_thread:
            raise RuntimeError("gather launch failed")
        return real_read(page_ids)

    try:
        await collect(eng, req(list(range(1, 13))))
        await collect(eng, req(list(range(50, 62))))
        eng._read_kv_pages_sync = failing_read
        # the worker's read fails while the evicting request runs or
        # after it: that request or the next one ends in the error
        evicting = await _outputs(eng, req(list(range(110, 134))))
        await drain_pipeline(mgr)
        eng._read_kv_pages_sync = real_read
        after = await _outputs(eng, req(list(range(140, 146))))
        assert [o[-1]["finish_reason"] for o in (evicting, after)].count(
            "error") == 1
        assert mgr.device_error is None
        assert await collect(eng, req(list(range(140, 146))))
    finally:
        eng._read_kv_pages_sync = real_read
        await eng.close()
        assert eng.pool.pending_offload_pages == 0


async def test_failed_remote_onboard_write_raises_into_requests():
    """A remote fetch that fails is a cache miss; a device write of
    fetched blocks that fails raises, and the request ends in an error."""
    eng, mgr = make_engine()
    shape = mgr.block_shape()

    class Remote:
        fail_fetch = True

        async def fetch(self, hashes, expect_shape):
            if self.fail_fetch:
                raise ConnectionError("peer gone")
            return [torch.zeros(expect_shape) for _ in hashes]

    mgr.remote = Remote()
    prompt = list(range(1, 13))
    try:
        want = await collect(eng, req(prompt))
        eng.clear_kv_blocks()
        mgr.store.clear("all")
        assert await collect(eng, req(prompt)) == want
        assert mgr.stats.remote_onboarded == 0

        def failing_write(page_ids, blocks):
            assert blocks[0].shape == shape
            raise RuntimeError("K3 launch failed")

        eng.clear_kv_blocks()
        mgr.store.clear("all")
        mgr.remote.fail_fetch = False
        eng.write_kv_blocks = failing_write
        outs = await _outputs(eng, req(prompt))
        assert outs[-1]["finish_reason"] == "error"
        assert mgr.stats.remote_onboarded == 0
    finally:
        await eng.close()


# -- against the JAX package's engine --------------------------------------------

PARITY_KW = dict(num_pages=12, max_batch_size=2, prefill_chunk=32,
                 min_prefill_bucket=8, default_max_tokens=6,
                 decode_steps_per_sync=2, worker_id=5, dp_rank=0)


@pytest.fixture
def attention_impl():
    prev = jattn._impl
    yield jattn.set_attention_impl
    jattn.set_attention_impl(prev)


def _parity_engines(impl, events, host_blocks, disk_dirs):
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    params = jl.init_params(jax.random.PRNGKey(0), jcfg)
    jax_eng = TpuEngine(TpuEngineConfig(model=jcfg, **PARITY_KW),
                        params=params,
                        event_sink=lambda e: events[0].append(e.to_dict()))
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    torch_eng = TorchEngine(
        TorchEngineConfig(model=tcfg, device="cpu", attention_impl=impl,
                          **PARITY_KW), model=model,
        event_sink=lambda e: events[1].append(e.to_dict()))
    kw = dict(host_blocks=host_blocks, disk_blocks=16 if disk_dirs else 0)
    mgrs = (rkvbm.KvbmManager(jax_eng, rkvbm.KvbmConfig(
                disk_dir=disk_dirs[0] if disk_dirs else None, **kw)),
            KvbmManager(torch_eng, KvbmConfig(
                disk_dir=disk_dirs[1] if disk_dirs else None, **kw)))
    return (jax_eng, torch_eng), mgrs


async def _kvbm_workload(eng) -> list:
    """Three 3-page prompts one after another (the 11-page pool evicts),
    the first again (onboard), a batch of two at once, then a revisit of
    a 2-page prefix with a new tail."""
    a, b, c = (list(range(s, s + 12)) for s in (1, 40, 80))
    out = []
    for p in (a, b, c, a):
        out.append(await collect(eng, req(p, 5)))
    out += await asyncio.gather(collect(eng, req(b, 4)),
                                collect(eng, req(list(range(120, 130)), 4)))
    out.append(await collect(eng, req(c[:8] + [7, 7, 7], 4)))
    return out


@pytest.mark.parametrize("impl,host_blocks,disk", [
    ("phase", 64, False), ("ragged", 64, False), ("phase", 2, True)])
async def test_engine_with_kvbm_matches_tpu_engine(attention_impl, tmp_path,
                                                   impl, host_blocks, disk):
    attention_impl("ragged" if impl == "ragged" else "auto")
    events = ([], [])
    dirs = [str(tmp_path / "jax"), str(tmp_path / "torch")] if disk else None
    (jax_eng, torch_eng), (jmgr, tmgr) = _parity_engines(
        impl, events, host_blocks, dirs)
    try:
        want = await _kvbm_workload(jax_eng)
        got = await _kvbm_workload(torch_eng)
        assert got == want
        assert vars(tmgr.stats) == vars(jmgr.stats)
        assert tmgr.stats.offloaded > 0 and tmgr.stats.onboarded > 0
        assert events[1] == events[0]
        assert tmgr.store.hashes() == jmgr.store.hashes()
        assert tmgr.status()["g1"] == jmgr.status()["g1"]
        for h in jmgr.store.hashes():
            np.testing.assert_allclose(tmgr.store.get(h).numpy(),
                                       np.asarray(jmgr.store.get(h)),
                                       **BLOCK_TOL)
    finally:
        await jax_eng.close()
        await torch_eng.close()


# -- bf16 on disk without ml_dtypes ------------------------------------------------

_NO_ML_DTYPES = r"""
import sys, torch
from dynamo_tpu_torch.kvbm.tiers import DiskTier
d = sys.argv[1]
t = DiskTier(4, d)
x = torch.arange(2 * 2 * 2 * 4 * 8, dtype=torch.float32).reshape(
    2, 2, 2, 4, 8).div(7).to(torch.bfloat16)
t.put(1, x)
assert torch.equal(t.get(1), x)
ref = DiskTier(4, d)
ref._lru[2] = (sys.argv[2], "bfloat16", (2, 2, 2, 4, 8))
assert torch.equal(ref.get(2), x)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("ml_dtypes", "jax", "dynamo_tpu"))
print("FOREIGN", bad)
"""


def test_disk_tier_bf16_bytes_match_reference_without_ml_dtypes(tmp_path):
    """The reference's DiskTier writes a bf16 block (through ml_dtypes);
    a fresh process with only the port writes the same block to the same
    bytes and reads the reference's file back, importing no ml_dtypes."""
    import ml_dtypes

    x = (np.arange(2 * 2 * 2 * 4 * 8, dtype=np.float32).reshape(
        2, 2, 2, 4, 8) / 7).astype(ml_dtypes.bfloat16)
    ref = rkvbm.DiskTier(4, str(tmp_path / "ref"))
    ref.put(2, x)
    ref_path = ref._lru[2][0]
    assert ref._lru[2][1] == "bfloat16"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", _NO_ML_DTYPES, str(tmp_path / "ours"),
         ref_path], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOREIGN []" in out.stdout
    ours = os.path.join(tmp_path / "ours", os.path.basename(ref_path)
                        .replace(f"{2:016x}", f"{1:016x}"))
    with open(ours, "rb") as f, open(ref_path, "rb") as g:
        assert f.read() == g.read()
