"""The port's durable work queue (`runtime/queue.py`) and prefill queue
(`disagg/prefill_queue.py`), held against the JAX package's.

- The cases of tests/test_work_queue.py on the port: FIFO enqueue,
  dequeue and ack; no double claim across consumers; nack redelivers; a
  dead consumer's lease expiry redelivers; a timed dequeue waits for the
  producer; and the keys and payload bytes are the reference's.
- The queue cases of tests/test_disagg.py on the port's engines: the
  pull-model disagg stream equals aggregated serving; no consumer means a
  timeout and a local fallback; a poison job retries at the tail, then
  dead-letters; a timed-out or hard-cancelled job is retracted; an idle
  dequeuer wakes on a claim's expiry; the first token's logprob and top
  logprobs ride the queue; the consumer's job counts reach the scrape.
- Across packages, over one coordinator: a job that the JAX package's
  `QueuePrefillClient` enqueues is taken by the port's consumer, and the
  reverse; the decode handler's stream equals aggregated serving.

Leases in the redelivery cases are 0.1-0.3 s, and no case sleeps 1 s.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.disagg import handlers as ref_handlers
from dynamo_tpu.disagg import prefill_queue as ref_pq
from dynamo_tpu.disagg.disagg_router import DisaggRouter as RefDisaggRouter
from dynamo_tpu.engine import attention as jattn
from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.models import llama as jl
from dynamo_tpu.runtime import config as ref_config
from dynamo_tpu.runtime import distributed as ref_dist
from dynamo_tpu.runtime import queue as ref_queue
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu.runtime.push import PushRouter as RefPushRouter
from dynamo_tpu_torch.disagg.disagg_router import DisaggRouter
from dynamo_tpu_torch.disagg.handlers import (
    KV_PULL_ENDPOINT,
    DecodeWorkerHandler,
    PrefillWorkerHandler,
)
from dynamo_tpu_torch.disagg.prefill_queue import (
    PrefillQueueConsumer,
    QueuePrefillClient,
)
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.runtime import config as t_config
from dynamo_tpu_torch.runtime import distributed as t_dist
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.push import PushRouter
from dynamo_tpu_torch.runtime.queue import WorkQueue


async def _rt():
    return await DistributedRuntime.create(RuntimeConfig(store_url="memory"))


# -- the work queue ----------------------------------------------------------------


async def test_fifo_enqueue_dequeue_ack():
    rt = await _rt()
    try:
        q = WorkQueue(rt, "prefill")
        for i in range(3):
            await q.enqueue({"job": i})
        assert await q.depth() == 3
        got = []
        while (item := await q.try_dequeue()) is not None:
            got.append(item.payload["job"])
            await item.ack()
        assert got == [0, 1, 2]
        assert await q.depth() == 0
        assert await q.try_dequeue() is None
    finally:
        await rt.close()


async def test_no_double_claim_across_consumers():
    rt1, rt2 = await _rt(), await _rt()
    rt2.store = rt1.store
    rt2.lease_id = await rt1.store.create_lease(5.0)
    try:
        q1, q2 = WorkQueue(rt1, "q"), WorkQueue(rt2, "q")
        for i in range(20):
            await q1.enqueue(i)
        claimed: list[int] = []

        async def consume(q):
            while (item := await q.try_dequeue()) is not None:
                claimed.append(item.payload)
                await asyncio.sleep(0)
                await item.ack()

        await asyncio.gather(consume(q1), consume(q2))
        assert sorted(claimed) == list(range(20))
        assert len(claimed) == 20
    finally:
        await rt2.close()
        await rt1.close()


async def test_nack_redelivers():
    rt = await _rt()
    try:
        q = WorkQueue(rt, "q")
        await q.enqueue("x")
        item = await q.try_dequeue()
        assert await q.try_dequeue() is None
        await item.nack()
        again = await q.try_dequeue()
        assert again is not None and again.payload == "x"
        await again.ack()
    finally:
        await rt.close()


class _DeadRt:
    """A consumer with its own short lease that it never renews."""

    def __init__(self, store, lease_id):
        self.store = store
        self.lease_id = lease_id


async def test_dead_consumer_lease_expiry_redelivers():
    rt = await _rt()
    try:
        q = WorkQueue(rt, "q")
        await q.enqueue({"prompt": [1, 2, 3]})
        dead = WorkQueue(_DeadRt(rt.store, await rt.store.create_lease(0.1)),
                         "q")
        assert await dead.try_dequeue() is not None
        assert await q.try_dequeue() is None
        for _ in range(100):
            if (again := await q.try_dequeue()) is not None:
                break
            await asyncio.sleep(0.05)
        assert again.payload == {"prompt": [1, 2, 3]}
        await again.ack()
        assert await q.depth() == 0
    finally:
        await rt.close()


async def test_dequeue_with_timeout_waits_for_producer():
    rt = await _rt()
    try:
        q = WorkQueue(rt, "q")

        async def later():
            await asyncio.sleep(0.1)
            await q.enqueue("late")

        t = asyncio.get_running_loop().create_task(later())
        item = await q.dequeue(timeout=2.0)
        assert item is not None and item.payload == "late"
        await item.ack()
        await t
        assert await q.dequeue(timeout=0.1) is None
    finally:
        await rt.close()


async def test_queue_keys_and_payload_bytes_match_reference():
    """Items the port enqueues sit under the reference's keys with the
    reference's JSON bytes; the reference's queue claims and acks them on
    the same store, and the reverse."""
    rt = await _rt()
    try:
        ours = WorkQueue(rt, "prefill", "ns")
        ref = ref_queue.WorkQueue(rt, "prefill", "ns")
        payload = {"job_id": "ab", "request": {"token_ids": [1, 2]}}
        item_id = await ours.enqueue(payload)
        kv = await rt.store.get(f"v1/queue/ns/prefill/items/{item_id}")
        assert kv.value == json.dumps(payload, separators=(",", ":")).encode()
        got = await ref.try_dequeue()
        assert (got.item_id, got.payload) == (item_id, payload)
        assert await rt.store.get(
            f"v1/queue/ns/prefill/claims/{item_id}") is not None
        await got.ack()
        await ref.enqueue(payload)
        mine = await ours.try_dequeue()
        assert mine.payload == payload
        await mine.ack()
        assert await ours.depth() == await ref.depth() == 0
    finally:
        await rt.close()


async def test_queue_redelivery_wakes_idle_dequeuer():
    rt = await _rt()
    try:
        q = WorkQueue(rt, "rq")
        await q.enqueue("job")
        dead = WorkQueue(_DeadRt(rt.store, await rt.store.create_lease(0.3)),
                         "rq")
        assert await dead.try_dequeue() is not None
        t0 = asyncio.get_running_loop().time()
        item = await q.dequeue(timeout=10.0)
        waited = asyncio.get_running_loop().time() - t0
        assert item is not None and item.payload == "job"
        assert waited < 5.0       # woke on the claim's expiry
        await item.ack()
    finally:
        await rt.close()


# -- the prefill queue on the port's engines ------------------------------------------

KW = dict(num_pages=64, max_batch_size=4, prefill_chunk=32,
          min_prefill_bucket=8, default_max_tokens=8,
          decode_steps_per_sync=2)
PROMPT = list(range(1, 14))


def make_engine(model=None):
    return TorchEngine(TorchEngineConfig(
        model=tl.LlamaConfig.tiny(dtype=torch.float32), device="cpu", **KW),
        model=model)


def req(tokens, max_tokens=6):
    return {"token_ids": list(tokens), "model": "m",
            "sampling": {"temperature": 0.0},
            "stop": {"max_tokens": max_tokens}}


async def stream(gen_fn, request, ctx):
    return [o async for o in gen_fn(request, ctx)]


def tokens_of(outs):
    return [t for o in outs for t in o.get("token_ids", ())]


async def _queue_stack(rt, component, consume=True, timeout=15.0):
    """A prefill engine behind its kv_pull endpoint (and a queue consumer
    unless `consume` is False), a decode engine behind a queue-mode
    DecodeWorkerHandler; the engines share one set of weights."""
    pe = make_engine()
    de = make_engine(pe.model)
    ph = PrefillWorkerHandler(pe, instance_id=21)
    ep = rt.namespace("ns").component(component).endpoint(KV_PULL_ENDPOINT)
    await ep.serve(ph.kv_pull, instance_id=21)
    pull = await ep.client()
    await pull.start()
    await pull.wait_ready()
    consumer = PrefillQueueConsumer(rt, ph, "ns").start() if consume \
        else None
    handler = DecodeWorkerHandler(
        de, kv_pull_router=PushRouter(pull),
        disagg_router=DisaggRouter(max_local_prefill_length=0),
        prefill_queue_client=QueuePrefillClient(rt, "ns", timeout=timeout))
    return pe, de, consumer, handler


async def test_disagg_prefill_queue_mode():
    rt = await _rt()
    pe, de, consumer, handler = await _queue_stack(rt, "pfq")
    consumer.register(rt.metrics)
    agg = make_engine(pe.model)
    try:
        want = await stream(agg.generate, req(PROMPT), Context())
        assert handler._can_prefill_remote()
        got = await stream(handler.generate, req(PROMPT), Context())
        assert tokens_of(got) == tokens_of(want)
        assert 'dynamo_prefill_queue_jobs{outcome="done"} 1' in \
            rt.metrics.render()
        assert consumer.jobs_done == 1
        assert pe.pool.active_pages == 0        # transfer released
        assert handler.last_pull_path in ("device", "wire")
        # logprobs: N tokens, N logprobs, the first from the queue result
        lps = [l for o in got for l in (o.get("log_probs") or ())]
        want_lps = [l for o in want for l in (o.get("log_probs") or ())]
        assert len(lps) == len(tokens_of(got)) == 6
        np.testing.assert_allclose(lps, want_lps, rtol=1e-5, atol=1e-5)
        got2 = await stream(handler.generate, req(PROMPT), Context())
        assert tokens_of(got2) == tokens_of(want)
        assert consumer.jobs_done == 2
        # top logprobs: the first token's list rides the queue result too
        r = req(PROMPT)
        r["sampling"]["top_logprobs"] = 3
        want3 = await stream(agg.generate, r, Context())
        got3 = await stream(handler.generate, r, Context())
        tops = [t for o in got3 for t in (o.get("top_logprobs") or ())]
        want_tops = [t for o in want3 for t in (o.get("top_logprobs") or ())]
        assert len(tops) == len(want_tops) == 6
        assert [[i for i, _ in t] for t in tops] == \
            [[i for i, _ in t] for t in want_tops]
        np.testing.assert_allclose([[v for _, v in t] for t in tops],
                                   [[v for _, v in t] for t in want_tops],
                                   rtol=1e-5, atol=1e-5)
    finally:
        await consumer.stop()
        await rt.close()
        for e in (pe, de, agg):
            await e.close()


async def test_prefill_queue_timeout_falls_back_local():
    rt = await _rt()
    pe, de, _, handler = await _queue_stack(rt, "pfq2", consume=False,
                                            timeout=0.2)
    try:
        want = tokens_of(await stream(de.generate, req(PROMPT), Context()))
        got = tokens_of(await stream(handler.generate, req(PROMPT),
                                     Context()))
        assert got == want
        assert await WorkQueue(rt, "prefill", "ns").depth() == 0
    finally:
        await rt.close()
        await pe.close()
        await de.close()


async def test_prefill_queue_poison_job_retries_then_dead_letters():
    rt = await _rt()

    class BoomHandler:
        calls = 0

        async def generate(self, request, context):
            BoomHandler.calls += 1
            raise RuntimeError("poison")
            yield {}

    consumer = PrefillQueueConsumer(rt, BoomHandler(), "ns",
                                    max_attempts=3).start()
    client = QueuePrefillClient(rt, "ns", timeout=10.0)
    try:
        assert await client.prefill({"token_ids": [1, 2]}) is None
        assert BoomHandler.calls == 3
        assert consumer.jobs_failed == 1
        assert await WorkQueue(rt, "prefill", "ns").depth() == 0
    finally:
        await consumer.stop()
        await rt.close()


async def test_prefill_queue_timeout_retracts_job():
    rt = await _rt()
    try:
        client = QueuePrefillClient(rt, "ns", timeout=0.2)
        assert await client.prefill({"token_ids": [1]}) is None
        assert await WorkQueue(rt, "prefill", "ns").depth() == 0
        # the result key is tombstoned for a consumer that took a copy
        kvs = await rt.store.get_prefix("v1/queue/ns/prefill/results/")
        assert [json.loads(kv.value) for kv in kvs] == [{"cancelled": True}]
    finally:
        await rt.close()


async def test_prefill_queue_hard_cancel_retracts():
    rt = await _rt()
    try:
        client = QueuePrefillClient(rt, "ns", timeout=30.0)
        task = asyncio.get_running_loop().create_task(
            client.prefill({"token_ids": [1]}))
        await asyncio.sleep(0.1)
        assert await WorkQueue(rt, "prefill", "ns").depth() == 1
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        assert await WorkQueue(rt, "prefill", "ns").depth() == 0
    finally:
        await rt.close()


async def test_consumer_skips_a_cancelled_job():
    """A job whose requester tombstoned it is acked without a prefill."""
    rt = await _rt()

    class CountingHandler:
        calls = 0

        async def generate(self, request, context):
            CountingHandler.calls += 1
            yield {}

    consumer = PrefillQueueConsumer(rt, CountingHandler(), "ns")
    try:
        await rt.store.put("v1/queue/ns/prefill/results/j1",
                           json.dumps({"cancelled": True}).encode())
        await consumer._run_job({"job_id": "j1", "request": {}})
        assert CountingHandler.calls == 0
    finally:
        await rt.close()


# -- between the two packages ----------------------------------------------------------

@pytest.fixture
def xla_impl():
    prev = jattn._impl
    jattn.set_attention_impl("xla")
    yield
    jattn.set_attention_impl(prev)


@pytest.mark.parametrize("producer", ["jax", "torch"])
def test_queue_jobs_interoperate_with_the_jax_package(xla_impl, producer):
    """`producer`'s decode handler enqueues the job with its own package's
    QueuePrefillClient; the other package's PrefillQueueConsumer takes it
    over one coordinator, prefills, and serves the KV on its kv_pull; the
    decode stream equals aggregated serving."""
    from tests.test_torch_serving import StoreThread

    port_decodes = producer == "torch"

    async def main(url):
        jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
        params = jl.init_params(jax.random.PRNGKey(0), jcfg)
        model = params_from_jax(jax.tree.map(np.asarray, params),
                                tl.LlamaConfig.tiny(dtype=torch.float32),
                                "cpu")
        jax_pe = TpuEngine(TpuEngineConfig(model=jcfg, **KW), params=params)
        jax_de = TpuEngine(TpuEngineConfig(model=jcfg, **KW), params=params)
        torch_pe, torch_de = make_engine(model), make_engine(model)
        agg = make_engine(model)
        want = tokens_of(await stream(agg.generate, req(PROMPT), Context()))
        await agg.close()
        ref_rt = await ref_dist.DistributedRuntime.create(
            ref_config.RuntimeConfig(store_url=url))
        t_rt = await t_dist.DistributedRuntime.create(
            t_config.RuntimeConfig(store_url=url))
        try:
            if port_decodes:
                p_rt, d_rt = ref_rt, t_rt
                ph = ref_handlers.PrefillWorkerHandler(jax_pe, 31)
                consumer = ref_pq.PrefillQueueConsumer(
                    ref_rt, ph, "ns", queue="pf").start()
            else:
                p_rt, d_rt = t_rt, ref_rt
                ph = PrefillWorkerHandler(torch_pe, 31)
                consumer = PrefillQueueConsumer(t_rt, ph, "ns",
                                                queue="pf").start()
            await (p_rt.namespace("ns").component("pf")
                   .endpoint(KV_PULL_ENDPOINT).serve(ph.kv_pull,
                                                     instance_id=31))
            pull = await (d_rt.namespace("ns").component("pf")
                          .endpoint(KV_PULL_ENDPOINT).client())
            await pull.start()
            await pull.wait_ready(10)
            if port_decodes:
                dh = DecodeWorkerHandler(
                    torch_de, kv_pull_router=PushRouter(pull),
                    disagg_router=DisaggRouter(max_local_prefill_length=0),
                    prefill_queue_client=QueuePrefillClient(
                        t_rt, "ns", queue="pf", timeout=30.0))
                ctx = Context
            else:
                dh = ref_handlers.DecodeWorkerHandler(
                    jax_de, kv_pull_router=RefPushRouter(pull),
                    disagg_router=RefDisaggRouter(max_local_prefill_length=0),
                    prefill_queue_client=ref_pq.QueuePrefillClient(
                        ref_rt, "ns", queue="pf", timeout=30.0))
                ctx = JaxContext
            got = tokens_of(await stream(dh.generate, req(PROMPT), ctx()))
            path = dh.last_pull_path
            await consumer.stop()
            await pull.stop()
            return got, want, consumer.jobs_done, path
        finally:
            await ref_rt.close()
            await t_rt.close()
            for e in (jax_pe, jax_de, torch_pe, torch_de):
                await e.close()

    with StoreThread() as store:
        got, want, jobs, path = asyncio.run(
            asyncio.wait_for(main(store.url), 90))
    assert got == want and len(got) == 6
    assert jobs == 1 and path == "wire"
