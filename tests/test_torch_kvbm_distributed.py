"""The port's G4 tier (`dynamo_tpu_torch/kvbm/distributed.py`): the cases
of tests/test_kvbm_distributed.py on the port, and `kvbm_pull` between the
two packages.

- On the port (one in-process runtime): a worker that never saw a prompt
  onboards its blocks from a peer's host tier and gives the same stream;
  the advert lives under `v1/kvbm/<ns>/<component>/<worker_id>` and dies
  with the lease; a fetch with no peers is a no-op; a wedged peer times
  out into a cache miss; frames of the wrong shape are dropped.
- Across packages (one coordinator over TCP, a JAX-package worker and a
  port worker, the same fp32 weights): each side onboards the other's
  blocks and gives the other's stream, and the frames one side reads over
  the wire are byte for byte the producer's own `_handle_pull` output.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu import kvbm as rkvbm
from dynamo_tpu.engine import attention as jattn
from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.models import llama as jl
from dynamo_tpu.runtime import config as ref_config
from dynamo_tpu.runtime import distributed as ref_dist
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.kvbm import KvbmConfig, KvbmDistributed, KvbmManager
from dynamo_tpu_torch.kvbm.distributed import KVBM_PULL_ENDPOINT, registry_key
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.runtime import config as t_config
from dynamo_tpu_torch.runtime import distributed as t_dist
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.tokens import compute_seq_hashes

KW = dict(num_pages=10, max_batch_size=2, prefill_chunk=32,
          min_prefill_bucket=8, default_max_tokens=4,
          decode_steps_per_sync=2)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)
PROMPT = list(range(1, 13))                 # 3 complete blocks


def make_engine(model=None):
    eng = TorchEngine(TorchEngineConfig(model=TCFG, device="cpu", **KW),
                      model=model)
    return eng, KvbmManager(eng, KvbmConfig(host_blocks=64))


def req(tokens, max_tokens=4):
    return {"token_ids": list(tokens), "model": "m",
            "sampling": {"temperature": 0.0},
            "stop": {"max_tokens": max_tokens}}


async def collect(eng, r):
    ctx = JaxContext() if isinstance(eng, TpuEngine) else Context()
    return [t async for o in eng.generate(r, ctx)
            for t in o.get("token_ids", ())]


async def serve_and_churn(eng, prompt=PROMPT):
    """Serve `prompt`, then push its pages to the host tier."""
    out = await collect(eng, req(prompt))
    for base in (50, 80, 110):
        await collect(eng, req(list(range(base, base + 12))))
    return out


async def _runtime():
    return await DistributedRuntime.create(
        RuntimeConfig(store_url="memory", lease_ttl=30.0))


class _FnEngine:
    def __init__(self, fn):
        self.fn = fn

    def generate(self, request, context=None):
        return self.fn(request, context)


async def test_remote_onboard_from_peer_tier():
    rt = await _runtime()
    eng_a, mgr_a = make_engine()
    eng_b, mgr_b = make_engine(eng_a.model)
    dist_a = KvbmDistributed(mgr_a, rt, "dyn", "backend", worker_id=1,
                             publish_debounce=0.01)
    dist_b = KvbmDistributed(mgr_b, rt, "dyn", "backend", worker_id=2,
                             publish_debounce=0.01)
    try:
        await dist_a.start()
        await dist_b.start()
        out_a = await serve_and_churn(eng_a)
        assert mgr_a.stats.offloaded >= 3
        await dist_a._publish()
        assert await collect(eng_b, req(PROMPT)) == out_a
        assert mgr_b.stats.remote_onboarded >= 2
        assert mgr_b.status()["g4"] == {"advertised_blocks": 0}
        assert mgr_a.status()["g4"]["advertised_blocks"] >= 3
    finally:
        for x in (dist_a, dist_b, eng_a, eng_b, rt):
            await x.close()


async def test_registry_advertises_and_dies_with_lease():
    rt = await _runtime()
    eng, mgr = make_engine()
    dist = KvbmDistributed(mgr, rt, "dyn", "backend", worker_id=7,
                           publish_debounce=0.01)
    try:
        await dist.start()
        await serve_and_churn(eng)
        await dist._publish()
        kv = await rt.store.get(registry_key("dyn", "backend", 7))
        assert kv is not None
        adv = json.loads(kv.value)
        assert adv["worker_id"] == 7 and len(adv["blocks"]) >= 3
        assert kv.key == "v1/kvbm/dyn/backend/7"
    finally:
        await dist.close()
        await eng.close()
        store = rt.store
        await rt.close()
    assert (await store.get(registry_key("dyn", "backend", 7))) is None


async def test_fetch_with_no_peers_is_noop():
    rt = await _runtime()
    eng, mgr = make_engine()
    dist = KvbmDistributed(mgr, rt, "dyn", "backend", worker_id=3)
    try:
        await dist.start()
        assert len(await collect(eng, req(PROMPT))) == 4
        assert mgr.stats.remote_onboarded == 0
        assert dist.fetch_timeout == 2.0        # the reference's default
    finally:
        await dist.close()
        await eng.close()
        await rt.close()


async def test_fetch_timeout_degrades_to_miss():
    rt = await _runtime()
    eng_a, mgr_a = make_engine()
    eng_b, mgr_b = make_engine(eng_a.model)
    dist_a = KvbmDistributed(mgr_a, rt, "dyn", "backend", worker_id=1,
                             publish_debounce=0.01)
    dist_b = KvbmDistributed(mgr_b, rt, "dyn", "backend", worker_id=2,
                             publish_debounce=0.01, fetch_timeout=0.2)
    try:
        await dist_a.start()
        await dist_b.start()
        out_a = await serve_and_churn(eng_a)
        await dist_a._publish()

        async def wedged(request, context=None):   # accepts, never streams
            await asyncio.sleep(60)
            yield {}

        subject = dist_a._served.instance.subject
        rt.transport_server.register(subject, _FnEngine(wedged))
        rt.register_local(subject, _FnEngine(wedged))
        assert await collect(eng_b, req(PROMPT)) == out_a
        assert mgr_b.stats.remote_onboarded == 0
    finally:
        for x in (dist_a, dist_b, eng_a, eng_b, rt):
            await x.close()


async def test_shape_mismatch_frames_dropped():
    rt = await _runtime()
    eng_b, mgr_b = make_engine()
    dist_b = KvbmDistributed(mgr_b, rt, "dyn", "backend", worker_id=2,
                             publish_debounce=0.01)
    try:
        await dist_b.start()
        hashes = compute_seq_hashes(PROMPT, TCFG.page_size)

        async def bad_peer(request, context=None):
            for h in request["seq_hashes"]:
                bad = np.zeros((2, 99, 2, 4, 16), np.float32)
                yield {"seq_hash": h, "dtype": "float32",
                       "shape": list(bad.shape), "data": bad.tobytes()}

        ep = (rt.namespace("dyn").component("backend")
              .endpoint(KVBM_PULL_ENDPOINT))
        served = await ep.serve(bad_peer, instance_id=9)
        await rt.store.put(
            registry_key("dyn", "backend", 9),
            json.dumps({"worker_id": 9, "blocks": hashes}).encode(),
            rt.lease_id)
        assert len(await collect(eng_b, req(PROMPT))) == 4
        assert mgr_b.stats.remote_onboarded == 0
        await served.shutdown()
    finally:
        await dist_b.close()
        await eng_b.close()
        await rt.close()


# -- between the two packages -------------------------------------------------------

@pytest.fixture
def xla_impl():
    prev = jattn._impl
    jattn.set_attention_impl("xla")
    yield
    jattn.set_attention_impl(prev)


@pytest.mark.parametrize("producer", ["jax", "torch"])
def test_kvbm_pull_interoperates_with_the_jax_package(xla_impl, producer):
    """The producer package's worker serves the prompt and offloads it;
    the other package's worker (same weights, never saw the prompt)
    onboards the blocks over `kvbm_pull` through one coordinator and
    gives the producer's stream. The frames the consumer's runtime reads
    over TCP are the producer's own `_handle_pull` frames, byte for
    byte."""
    from tests.test_torch_serving import StoreThread

    async def main(url):
        jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
        params = jl.init_params(jax.random.PRNGKey(0), jcfg)
        jax_eng = TpuEngine(TpuEngineConfig(model=jcfg, **KW),
                            params=params)
        jmgr = rkvbm.KvbmManager(jax_eng, rkvbm.KvbmConfig(host_blocks=64))
        model = params_from_jax(jax.tree.map(np.asarray, params), TCFG,
                                "cpu")
        torch_eng, tmgr = make_engine(model)
        ref_rt = await ref_dist.DistributedRuntime.create(
            ref_config.RuntimeConfig(store_url=url, lease_ttl=30.0))
        t_rt = await t_dist.DistributedRuntime.create(
            t_config.RuntimeConfig(store_url=url, lease_ttl=30.0))
        jdist = rkvbm.KvbmDistributed(jmgr, ref_rt, "dyn", "backend",
                                      worker_id=1, publish_debounce=0.01)
        tdist = KvbmDistributed(tmgr, t_rt, "dyn", "backend", worker_id=2,
                                publish_debounce=0.01)
        try:
            await jdist.start()
            await tdist.start()
            if producer == "jax":
                p_eng, p_dist, c_eng, c_mgr, c_dist, p_id, ctx = (
                    jax_eng, jdist, torch_eng, tmgr, tdist, 1, Context)
            else:
                p_eng, p_dist, c_eng, c_mgr, c_dist, p_id, ctx = (
                    torch_eng, tdist, jax_eng, jmgr, jdist, 2, JaxContext)
            out_p = await serve_and_churn(p_eng)
            await p_dist._publish()
            out_c = await collect(c_eng, req(PROMPT))
            hashes = compute_seq_hashes(PROMPT, TCFG.page_size)[:2]
            remote = [f async for f in c_dist._router.direct(
                {"seq_hashes": hashes}, p_id, ctx())]
            local = [f async for f in p_dist._handle_pull(
                {"seq_hashes": hashes})]
            return out_p, out_c, c_mgr.stats.remote_onboarded, remote, local
        finally:
            for x in (jdist, tdist, jax_eng, torch_eng, ref_rt, t_rt):
                await x.close()

    with StoreThread() as store:
        out_p, out_c, onboarded, remote, local = asyncio.run(
            asyncio.wait_for(main(store.url), 90))
    assert out_c == out_p and len(out_p) == 4
    assert onboarded == 2
    assert len(remote) == len(local) == 2
    for r, lo in zip(remote, local):
        assert bytes(r["data"]) == bytes(lo["data"])
        assert {k: v for k, v in r.items() if k != "data"} == \
            {k: v for k, v in lo.items() if k != "data"}
        assert r["dtype"] == "float32"
        assert r["shape"] == [2, TCFG.num_layers, TCFG.num_kv_heads,
                              TCFG.page_size, TCFG.head_dim]
