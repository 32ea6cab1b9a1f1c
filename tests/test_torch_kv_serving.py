"""The port served behind its KV router, held against the JAX package's.

- Affinity: two port `TorchEngine` workers behind the port's frontend in
  `kv` mode (over the port's coordinator, so the KV events ride its
  event bus), and two `TpuEngine` workers behind the reference's `kv`
  frontend, on the same fp32 weights. A request whose prefix one worker
  holds goes to that worker, in both fleets; the HTTP bodies are equal.
- Cross-wired, over one port coordinator: the reference's `KvPushRouter`
  routes over port workers on their KV events, and the port's over
  `TpuEngine` workers; with the selectors seeded alike, every placement
  equals the one each router makes over its own package's workers.
- The reference's frontend in `kv` mode in front of port workers, over
  one port coordinator: the reference's indexer, fed by the port's KV
  events, sends a request with a held prefix to the worker that holds
  it, and the bodies and token streams equal the port's own frontend's
  over fresh port workers in process.
- Replica sync and snapshot: two port routers with replica sync converge
  on one predicted load; a router started after the snapshot threshold
  restores the snapshot plus the bus's retained tail into the same index.
- Worker death: a worker that leaves discovery leaves the router's index
  and load. An event the router cannot apply is counted as dropped and
  the consumer lives; `gap_resync` rebuilds a gapped worker's slice of
  the index as the reference's router does.
- Knobs: `--no-kv-events` serves through `ApproxKvIndexer`;
  `DYN_KV_RECORD` / `kv_record_path` (and the router CLI's `--kv-record`)
  capture the consumed events and `DYN_PREFIX_HEAT` arms the prefix-heat
  recorder.
- Subprocesses: the coordinator, a `--router-mode kv` worker, a `kv`
  frontend, `python -m dynamo_tpu_torch.router` and `run in=http
  --router-mode kv` serve on the CPU and load no jax, no `dynamo_tpu`, no
  msgpack and no aiohttp.

Every test builds its engines first and bounds the rest with
`asyncio.wait_for`; servers bind port 0 where they can."""

import asyncio
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.llm import entrypoint as ref_entry
from dynamo_tpu.llm import model_card as ref_card
from dynamo_tpu.models import llama as jl
from dynamo_tpu.router import kv_router as ref_router
from dynamo_tpu.runtime import config as ref_config
from dynamo_tpu.runtime import context as ref_context
from dynamo_tpu.runtime import distributed as ref_dist
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.llm import entrypoint as t_entry
from dynamo_tpu_torch.llm import model_card as t_card
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.router import kv_router as t_router
from dynamo_tpu_torch.router.indexer import ApproxKvIndexer
from dynamo_tpu_torch.runtime import config as t_config
from dynamo_tpu_torch.runtime import context as t_context
from dynamo_tpu_torch.runtime import distributed as t_dist
from tests.test_torch_serving import (
    ENGINE_KW,
    StoreThread,
    Tap,
    _renew_lease,
    call,
    default_impl,  # noqa: F401  (fixture)
    normalized,
    same_bodies,
)

BS = 4                                  # LlamaConfig.tiny's page size
IDS = (1, 2)


def _weights():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    params = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    return jcfg, params, tcfg, params_from_jax(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


class PromptTap(Tap):
    """Tap, also recording each request's prompt token ids. While `hold`
    is an unset event, a request that arrives waits for it before the
    engine sees it, so the router keeps it booked as active."""

    def __init__(self, inner) -> None:
        super().__init__(inner)
        self.prompts: list[list[int]] = []
        self.hold: asyncio.Event | None = None

    async def generate(self, request, context):
        self.prompts.append(list(request["token_ids"]))
        if self.hold is not None:
            await self.hold.wait()
        async for out in super().generate(request, context):
            yield out


def _torch_workers(tcfg, model):
    return [PromptTap(TorchEngine(TorchEngineConfig(
        model=tcfg, device="cpu", worker_id=i, **ENGINE_KW), model=model))
        for i in IDS]


def _jax_workers(jcfg, params):
    return [PromptTap(TpuEngine(TpuEngineConfig(model=jcfg, worker_id=i,
                                          **ENGINE_KW), params=params))
            for i in IDS]


def _kv_card(mod, name="tiny", component="backend"):
    return mod.ModelDeploymentCard(
        name=name, component=component, tokenizer_kind="byte",
        context_length=64, kv_block_size=BS, router_mode="kv")


async def _serve(entry, rt, taps, card):
    """Serve each tapped engine as its own instance (id = its worker id),
    its KV events and metrics wired onto the runtime's bus."""
    handles = []
    for tap in taps:
        ev, ms = entry.wire_engine_events(rt, card)
        eng = tap.inner
        if isinstance(eng, TorchEngine):
            eng.attach_sinks(ev, ms)
        else:
            eng.pool.event_sink, eng.metrics_sink = ev, ms
        handles.append(await entry.serve_engine(
            rt, tap, card, instance_id=eng.config.worker_id))
    return handles


async def _close(taps, handles, *rest):
    for h in handles:
        await h.stop()
    for tap in taps:
        await tap.inner.close()
    for obj in rest:
        await (obj.stop() if hasattr(obj, "stop") else obj.close())


def _served_by(taps) -> list[int]:
    """Requests each worker has taken (counted as they arrive)."""
    return [len(t.prompts) for t in taps]


# byte tokenizer, chat template "user: <text>\nassistant:": a 26-byte
# prefix is the first 8 blocks of 4 tokens of each prompt that starts
# with it
PREFIX = "abcdefghijklmnopqrstuvwxyz"
OTHER = "zyxwvutsrqponmlkjihgfedcba"


def _chat(model, text):
    return {"model": model, "max_tokens": 6, "temperature": 0,
            "messages": [{"role": "user", "content": text}]}


def _who(taps, text) -> int:
    """The index of the worker whose last request carried `text`."""
    want = list(text.encode())
    hits = [i for i, t in enumerate(taps) for p in t.prompts[-2:]
            if any(p[j:j + len(want)] == want for j in range(len(p)))]
    assert len(hits) == 1, hits
    return hits[0]


async def _settled(router, taps, holder=None, prompt=None) -> None:
    """Wait until the router's index holds every block the workers
    registered and, with `holder` (a tap) and `prompt` (token ids it
    served), credits that tap's worker with every full block of the
    prompt; and until no request is still booked as active load (a stream
    the client has read to its end may free its booking a moment later,
    and booked load can outweigh a prefix's overlap)."""
    r = router.router
    want = sum(len(t.inner.pool._registered) for t in taps)
    for _ in range(1000):
        booked = [r.sequences.peek(w) for w in r.worker_keys()]
        if (sum(r.index_stats()["index_blocks"].values()) >= want
                and (holder is None or r.indexer.find_matches_for_tokens(
                    prompt).scores.get((holder.inner.config.worker_id, 0),
                                       0) >= len(prompt) // BS)
                and not any(s is not None and (s.active_blocks
                                               or s.active_prefill_tokens)
                            for s in booked)):
            return
        await asyncio.sleep(0.01)
    raise AssertionError("the KV events never reached the index")


async def _kv_round(port, model, taps, router) -> tuple:
    """Prefixes A and B at once (the second decision sees the first's
    blocks booked as active load, so they part), then A + a suffix
    (A's worker holds its prefix): (bodies, the worker of each).

    A and B are held in the taps until both have been routed: however
    slow the host, the first cannot finish (and give up its booked load)
    before the second decision is made."""
    hold = asyncio.Event()
    arrived = sum(len(t.prompts) for t in taps)
    for t in taps:
        t.hold = hold
    both_f = asyncio.gather(*(
        call(port, "POST", "/v1/chat/completions", _chat(model, text))
        for text in (PREFIX, OTHER)))
    try:
        while sum(len(t.prompts) for t in taps) < arrived + 2:
            await asyncio.sleep(0.005)
    finally:
        hold.set()
        for t in taps:
            t.hold = None
    both = await both_f
    who = [_who(taps, PREFIX), _who(taps, OTHER)]
    holder = taps[who[0]]
    a_bytes = list(PREFIX.encode())
    a_prompt = next(p for p in reversed(holder.prompts)
                    if any(p[j:j + len(a_bytes)] == a_bytes
                           for j in range(len(p))))
    await _settled(router, taps, holder, a_prompt)
    third = await call(port, "POST", "/v1/chat/completions",
                       _chat(model, PREFIX + " and more"))
    who.append(_who(taps, PREFIX + " and more"))
    bodies = [(st, ct, normalized(raw)) for st, ct, raw in (*both, third)]
    return bodies, who


def test_kv_fleet_affinity_and_bodies_match_reference(default_impl):  # noqa: F811
    jcfg, params, tcfg, model = _weights()
    t_taps, j_taps = _torch_workers(tcfg, model), _jax_workers(jcfg, params)

    async def main(url):
        t_rt = await t_dist.DistributedRuntime.create(
            t_config.RuntimeConfig(store_url=url))
        r_rt = await ref_dist.DistributedRuntime.create(
            ref_config.RuntimeConfig())
        renew = asyncio.ensure_future(_renew_lease(r_rt))
        th = await _serve(t_entry, t_rt, t_taps, _kv_card(t_card))
        rh = await _serve(ref_entry, r_rt, j_taps, _kv_card(ref_card))
        t_fe = await t_entry.start_frontend(t_rt, port=0)
        r_fe = await ref_entry.start_frontend(r_rt, port=0)
        try:
            for fe in (t_fe, r_fe):
                while not fe.manager.get("tiny") or len(
                        fe.manager.get("tiny").client.instances()) < 2:
                    await asyncio.sleep(0.02)
            t_kv = t_fe.manager.kv_routers()["tiny"]
            r_kv = r_fe.manager.kv_routers()["tiny"]
            assert t_kv.router.worker_keys() == [(1, 0), (2, 0)]
            got = await _kv_round(t_fe.http.port, "tiny", t_taps, t_kv)
            want = await _kv_round(r_fe.http.port, "tiny", j_taps, r_kv)
            metrics = (await call(t_fe.http.port, "GET", "/metrics"))[2]
            saved = t_kv.router.metrics.prefill_tokens_saved.get()
            return got, want, metrics, saved, t_kv.router.index_stats()
        finally:
            renew.cancel()
            await t_fe.stop()
            await r_fe.stop()
            await _close(t_taps, th, t_rt)
            await _close(j_taps, rh, r_rt)

    with StoreThread() as store:
        got, want, metrics, saved, stats = asyncio.run(
            asyncio.wait_for(main(store.url), 100))
    (g_bodies, g_who), (w_bodies, w_who) = got, want
    same_bodies(g_bodies, w_bodies)
    assert [st for st, _, _ in g_bodies] == [200] * 3
    # A and B on different workers (the second decision sees A booked as
    # active load: the taps hold both until both are routed), A + suffix
    # on A's worker
    for who in (g_who, w_who):
        assert who[0] != who[1] and who[2] == who[0]
    assert saved >= BS * 8                  # the shared prefix's blocks
    assert stats["index_workers"] == 2
    for name in (b"dynamo_router_decisions_total",
                 b"dynamo_router_prefill_tokens_saved_total",
                 b"dynamo_router_index_blocks",
                 b"dynamo_router_kv_event_gaps_total"):
        assert name in metrics
    assert b'dynamo_router_events_total{stream="kv"}' in metrics
    assert b"dynamo_router_kv_event_gaps_total 0" in metrics


def test_reference_kv_frontend_routes_port_workers(default_impl):  # noqa: F811
    """The JAX package's frontend and KV router in front of two port
    workers: A and B at once part, A + a suffix lands on A's worker by
    the reference's indexer over the port's KV events; the same round
    through the port's frontend over fresh port workers in one process
    gives the same bodies, the same placements up to which worker took
    A first, and the same token streams."""
    _, _, tcfg, model = _weights()
    remote, local = _torch_workers(tcfg, model), _torch_workers(tcfg, model)

    async def main(url):
        t_rt = await t_dist.DistributedRuntime.create(
            t_config.RuntimeConfig(store_url=url))
        r_rt = await ref_dist.DistributedRuntime.create(
            ref_config.RuntimeConfig(store_url=url))
        l_rt = await t_dist.DistributedRuntime.create(
            t_config.RuntimeConfig())
        th = await _serve(t_entry, t_rt, remote, _kv_card(t_card))
        lh = await _serve(t_entry, l_rt, local, _kv_card(t_card))
        r_fe = await ref_entry.start_frontend(r_rt, port=0)
        l_fe = await t_entry.start_frontend(l_rt, port=0)
        try:
            for fe in (r_fe, l_fe):
                while not fe.manager.get("tiny") or len(
                        fe.manager.get("tiny").client.instances()) < 2:
                    await asyncio.sleep(0.02)
            r_kv = r_fe.manager.kv_routers()["tiny"]
            l_kv = l_fe.manager.kv_routers()["tiny"]
            got = await _kv_round(r_fe.http.port, "tiny", remote, r_kv)
            want = await _kv_round(l_fe.http.port, "tiny", local, l_kv)
            return got, want, r_kv.router.index_stats()
        finally:
            await r_fe.stop()
            await l_fe.stop()
            await _close(remote, th, t_rt)
            await _close(local, lh, l_rt)
            await r_rt.close()

    with StoreThread() as store:
        got, want, stats = asyncio.run(asyncio.wait_for(main(store.url),
                                                        100))
    (g_bodies, g_who), (w_bodies, w_who) = got, want
    same_bodies(g_bodies, w_bodies)
    assert [st for st, _, _ in g_bodies] == [200] * 3
    # which worker takes A first is a tie drawn at random: the placements
    # agree in shape (A and B part, A + suffix joins A), not by index
    for who in (g_who, w_who):
        assert who[0] != who[1] and who[2] == who[0]
    assert stats["index_workers"] == 2      # the port's events, indexed
    assert sorted(map(tuple, sum((t.streams for t in remote), []))) == \
        sorted(map(tuple, sum((t.streams for t in local), [])))


PROMPTS = [list(range(10, 30)), list(range(40, 57)), list(range(10, 34)),
           list(range(40, 61)), list(range(70, 85)), list(range(10, 26)),
           list(range(70, 91)), list(range(100, 109))]


def _preq(tokens):
    return {"token_ids": tokens, "model": "tiny",
            "sampling": {"temperature": 0.0}, "stop": {"max_tokens": 5}}


async def _placements(router, taps, published, ctx_mod) -> list[int]:
    """Route PROMPTS one after another through `router` (a started
    KvPushRouter of either package); before each decision, wait until the
    router has applied every KV event the workers published."""
    out = []
    for tokens in PROMPTS:
        for _ in range(500):
            if router.router.indexer.events_applied >= published[0]:
                break
            await asyncio.sleep(0.01)
        assert router.router.indexer.events_applied == published[0]
        before = _served_by(taps)
        async for _ in router.generate(_preq(tokens), ctx_mod.Context()):
            pass
        after = _served_by(taps)
        out.append([a - b for a, b in zip(after, before)].index(1))
    return out


def _counting(sink, published):
    def call_(ev):
        published[0] += 1
        sink(ev)
    return call_


async def _fleet(entry, rt, taps, card, published):
    handles = []
    for tap in taps:
        ev, ms = entry.wire_engine_events(rt, card)
        ev = _counting(ev, published)
        eng = tap.inner
        if isinstance(eng, TorchEngine):
            eng.attach_sinks(ev, ms)
        else:
            eng.pool.event_sink, eng.metrics_sink = ev, ms
        handles.append(await entry.serve_engine(
            rt, tap, card, instance_id=eng.config.worker_id))
    return handles


async def _router(mod, rt, component, seed):
    client = await (rt.namespace("dynamo").component(component)
                    .endpoint("generate").client())
    await client.start()
    r = await mod.KvPushRouter(client, rt.events,
                               mod.KvRouterConfig(block_size=BS)).start()
    r.router.selector.rng = random.Random(seed)
    while len(r.router.worker_keys()) < 2:
        await asyncio.sleep(0.02)
    return r, client


@pytest.mark.parametrize("seed", [0, 3])
def test_cross_wired_routers_place_alike(default_impl, seed):  # noqa: F811
    """Four (router, workers) pairs over one port coordinator; each pair
    gets fresh workers (empty caches) and a selector seeded with `seed`.
    Every pair places the eight requests on the same workers."""
    jcfg, params, tcfg, model = _weights()
    fleets = {"torch": [_torch_workers(tcfg, model) for _ in range(2)],
              "jax": [_jax_workers(jcfg, params) for _ in range(2)]}

    async def main(url):
        t_rt = await t_dist.DistributedRuntime.create(
            t_config.RuntimeConfig(store_url=url))
        r_rt = await ref_dist.DistributedRuntime.create(
            ref_config.RuntimeConfig(store_url=url))
        out = {}
        try:
            for i, (router_mod, rt_r, ctx_mod) in enumerate(
                    ((t_router, t_rt, t_context),
                     (ref_router, r_rt, ref_context))):
                for kind in ("torch", "jax"):
                    taps = fleets[kind][i]
                    comp = f"{kind}{i}"
                    published = [0]
                    if kind == "torch":
                        handles = await _fleet(
                            t_entry, t_rt, taps,
                            _kv_card(t_card, comp, comp), published)
                    else:
                        handles = await _fleet(
                            ref_entry, r_rt, taps,
                            _kv_card(ref_card, comp, comp), published)
                    router, client = await _router(router_mod, rt_r, comp,
                                                   seed)
                    try:
                        label = ("port" if router_mod is t_router
                                 else "ref") + " router / " + kind
                        out[label] = await _placements(router, taps,
                                                       published, ctx_mod)
                    finally:
                        await router.stop()
                        await client.stop()
                        await _close(taps, handles)
            return out
        finally:
            await t_rt.close()
            await r_rt.close()

    with StoreThread() as store:
        out = asyncio.run(asyncio.wait_for(main(store.url), 110))
    want = out["ref router / jax"]
    assert out == {k: want for k in out}, out
    # the prefix families stay together once placed
    assert want[2] == want[0] and want[3] == want[1] and want[6] == want[4]


def test_replica_sync_converges_and_a_restarted_router_restores():
    _, _, tcfg, model = _weights()
    taps = _torch_workers(tcfg, model)

    async def main():
        rt = await t_dist.DistributedRuntime.create(t_config.RuntimeConfig())
        card = _kv_card(t_card)
        handles = await _serve(t_entry, rt, taps, card)
        ep = rt.namespace("dynamo").component("backend").endpoint("generate")
        cfg = t_router.KvRouterConfig(block_size=BS, replica_sync=True,
                                      snapshot_threshold=3)
        c1, c2 = await ep.client(), await ep.client()
        r1 = await t_router.KvPushRouter(c1, rt.events, cfg).start()
        r2 = await t_router.KvPushRouter(c2, rt.events, cfg).start()
        r3 = c3 = None
        try:
            gen = r1.generate(dict(_preq(list(range(5, 30))),
                                   stop={"max_tokens": 20}),
                              t_context.Context())
            await gen.__anext__()               # prefill done on r1
            await asyncio.sleep(0.05)
            busy = [r2.router.sequences.worker(w).num_active
                    for w in r2.router.worker_keys()]
            async for _ in gen:
                pass
            await asyncio.sleep(0.05)
            idle = [r2.router.sequences.worker(w).num_active
                    for w in r2.router.worker_keys()]
            for tokens in PROMPTS[:4]:
                async for _ in r1.generate(_preq(tokens),
                                           t_context.Context()):
                    pass
            await asyncio.sleep(0.1)
            snap = await rt.store.get(r1._snapshot_key)
            # a router started now: the snapshot, then the retained tail
            c3 = await ep.client()
            r3 = await t_router.KvPushRouter(c3, rt.events, cfg).start()
            await asyncio.sleep(0.1)
            return (busy, idle, snap is not None,
                    sorted(map(repr, r1.router.dump_snapshot())),
                    sorted(map(repr, r3.router.dump_snapshot())),
                    r1.router.index_stats(), r3.router.metrics.events.items(),
                    r3.router.metrics.snapshot_restore.count)
        finally:
            for r in (r1, r2, r3):
                if r is not None:
                    await r.stop()
            for c in (c1, c2, c3):
                if c is not None:
                    await c.stop()
            await _close(taps, handles, rt)

    (busy, idle, has_snap, dump1, dump3, stats, events,
     restores) = asyncio.run(asyncio.wait_for(main(), 90))
    assert sorted(busy) == [0, 1] and idle == [0, 0]
    assert has_snap and restores == 1
    assert dump3 == dump1 and stats["total_blocks"] > 0


def test_dead_worker_leaves_the_index_and_the_load():
    _, _, tcfg, model = _weights()
    taps = _torch_workers(tcfg, model)

    async def main():
        rt = await t_dist.DistributedRuntime.create(t_config.RuntimeConfig())
        handles = await _serve(t_entry, rt, taps, _kv_card(t_card))
        fe = await t_entry.start_frontend(rt, port=0)
        try:
            while not fe.manager.get("tiny") or len(
                    fe.manager.get("tiny").client.instances()) < 2:
                await asyncio.sleep(0.02)
            kv = fe.manager.kv_routers()["tiny"]
            # sent at once, the two part (the second decision sees the
            # first's load)
            for st, _, raw in await asyncio.gather(*(
                    call(fe.http.port, "POST", "/v1/chat/completions",
                         _chat("tiny", text)) for text in (PREFIX, OTHER))):
                assert st == 200, raw
            while kv.router.index_stats()["index_workers"] < 2:
                await asyncio.sleep(0.02)
            before = kv.router.index_stats()
            await handles[0].stop()             # worker 1 leaves
            while kv.router.worker_keys() != [(2, 0)]:
                await asyncio.sleep(0.02)
            after = kv.router.index_stats()
            st, _, _ = await call(fe.http.port, "POST",
                                  "/v1/chat/completions",
                                  _chat("tiny", "alpha beta gamma"))
            return before, after, st, _served_by(taps)
        finally:
            await fe.stop()
            await _close(taps, handles[1:], rt)

    before, after, st, served = asyncio.run(asyncio.wait_for(main(), 60))
    assert set(before["index_blocks"]) == {"1:0", "2:0"}
    assert set(after["index_blocks"]) == {"2:0"}
    assert after["workers"] == 1 and st == 200
    assert served == [1, 2]


def test_no_kv_events_serves_through_the_approx_indexer():
    """`--no-kv-events`: the router predicts each worker's cache from its
    own decisions (the workers publish nothing); a repeated prefix still
    goes to the worker it went to."""
    _, _, tcfg, model = _weights()
    taps = _torch_workers(tcfg, model)

    async def main():
        rt = await t_dist.DistributedRuntime.create(t_config.RuntimeConfig())
        handles = []
        for tap in taps:                   # no sinks: no KV events
            handles.append(await t_entry.serve_engine(
                rt, tap, _kv_card(t_card),
                instance_id=tap.inner.config.worker_id))
        fe = await t_entry.start_frontend(
            rt, port=0, router_config=t_router.KvRouterConfig(
                use_kv_events=False))
        try:
            while not fe.manager.get("tiny") or len(
                    fe.manager.get("tiny").client.instances()) < 2:
                await asyncio.sleep(0.02)
            kv = fe.manager.kv_routers()["tiny"]
            who = []
            for text in (PREFIX, PREFIX + "again", PREFIX + "and more"):
                before = _served_by(taps)
                st, _, raw = await call(fe.http.port, "POST",
                                        "/v1/chat/completions",
                                        _chat("tiny", text))
                assert st == 200, raw
                who.append([a - b for a, b in
                            zip(_served_by(taps), before)].index(1))
            return (type(kv.router.indexer), who,
                    kv.router.metrics.events.items(),
                    kv.router.config.block_size)
        finally:
            await fe.stop()
            await _close(taps, handles, rt)

    kind, who, events, block = asyncio.run(asyncio.wait_for(main(), 60))
    assert kind is ApproxKvIndexer and block == BS
    assert who[1] == who[2] == who[0]
    assert not [n for lab, n in events if lab.get("stream") == "kv"]


@pytest.mark.parametrize("env,config,name", [
    ({"DYN_KV_RECORD": "{path}"}, {}, "DYN_KV_RECORD"),
    ({}, {"kv_record_path": "{path}"}, "kv_record_path"),
    ({"DYN_PREFIX_HEAT": "1"}, {}, "DYN_PREFIX_HEAT"),
])
def test_router_options_are_served(monkeypatch, tmp_path, env, config,
                                   name):
    """The router options the port refused before its recorders were
    ported arm them: `kv_record_path` / `DYN_KV_RECORD` capture the KV
    events the router consumes (one JSONL row per event), and
    `DYN_PREFIX_HEAT` the prefix-heat recorder."""
    from dynamo_tpu_torch.protocols import KvCacheEvent, StoredBlock

    path = str(tmp_path / "cap.jsonl")
    monkeypatch.delenv("DYN_KV_RECORD", raising=False)
    monkeypatch.delenv("DYN_PREFIX_HEAT", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v.format(path=path))
    config = {k: v.format(path=path) for k, v in config.items()}

    async def main():
        rt = await t_dist.DistributedRuntime.create(t_config.RuntimeConfig())
        client = await rt.namespace("dynamo").component("backend") \
            .endpoint("generate").client()
        kv = await t_router.KvPushRouter(client, rt.events,
                                         t_router.KvRouterConfig(
                                             block_size=BS, **config)).start()
        ev_sink, _ = t_entry.wire_engine_events(rt, _kv_card(t_card))
        ev_sink(KvCacheEvent(kind="stored", worker_id=1, event_id=1,
                             blocks=[StoredBlock(11, 12)]))
        while kv.router.indexer.events_applied < 1:
            await asyncio.sleep(0.01)
        rec = kv.kv_recorder
        await kv.stop()
        await client.stop()
        await rt.close()
        return kv.router.prefix_heat, rec

    heat, rec = asyncio.run(asyncio.wait_for(main(), 30))
    if name == "DYN_PREFIX_HEAT":
        assert heat is not None and rec is None
    else:
        assert heat is None and rec is not None and rec.event_count == 1
        with open(path) as f:
            assert len(f.readlines()) == 1


def test_router_cli_serves_kv_record(monkeypatch):
    from dynamo_tpu_torch.router import __main__ as router_main

    started = []
    monkeypatch.setattr(router_main, "run_until_signal",
                        lambda *a, **k: started.append(a))
    router_main.main(["--kv-record", "/tmp/x.jsonl"])
    assert len(started) == 1
    assert router_main.parse_args(
        ["--kv-record", "/tmp/x.jsonl"]).kv_record == "/tmp/x.jsonl"


def test_deployment_with_the_kv_router_loads_no_foreign_module(tmp_path):
    """The coordinator, a `--router-mode kv` worker (`--device cpu`), a
    `kv` frontend, the standalone router and `run in=http --router-mode
    kv` as subprocesses: the frontend and the run CLI answer, the router
    reports ready, and none of them loaded jax, any dynamo_tpu module,
    msgpack or aiohttp."""
    from dynamo_tpu.models.synth_ckpt import write_synthetic_hf_checkpoint
    from dynamo_tpu_torch.runtime.distributed import free_port
    from tests.test_torch_run import _chat as run_chat
    from tests.test_torch_run import _Proc

    ckpt = write_synthetic_hf_checkpoint(str(tmp_path / "tiny"),
                                         preset="tiny")
    procs = []
    try:
        coord = _Proc(tmp_path, "coordinator",
                      "dynamo_tpu_torch.coordinator", "--port",
                      str(free_port()))
        procs.append(coord)
        store = coord.wait_line("COORDINATOR_READY")
        procs.append(_Proc(
            tmp_path, "worker", "dynamo_tpu_torch.worker", "--model", ckpt,
            "--device", "cpu", "--store", store, "--num-pages", "32",
            "--served-model-name", "tiny"))      # --router-mode kv: default
        frontend = _Proc(tmp_path, "frontend", "dynamo_tpu_torch.frontend",
                         "--store", store, "--host", "127.0.0.1",
                         "--port", "0", "--router-mode", "kv",
                         "--router-temperature", "0.5")
        procs.append(frontend)
        router = _Proc(tmp_path, "router", "dynamo_tpu_torch.router",
                       "--store", store)
        procs.append(router)
        run = _Proc(tmp_path, "run", "dynamo_tpu_torch.run", "in=http",
                    f"out=torch:{ckpt}", "--device", "cpu", "--num-pages",
                    "32", "--model-name", "tiny-run", "--port", "0",
                    "--router-mode", "kv")
        procs.append(run)
        assert procs[1].wait_line("WORKER_READY").startswith(
            "dynamo/backend/generate/")
        url = frontend.wait_line("FRONTEND_READY")
        assert router.wait_line("ROUTER_READY") == "dynamo/router"
        import time

        deadline = time.monotonic() + 30
        while True:                 # the frontend discovers the card
            status, body = run_chat(url, "tiny")
            if status != 404 or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        assert status == 200, body
        assert body["usage"]["completion_tokens"] == 4
        run_url = run.wait_line("RUN_READY")
        for _ in range(2):          # the second finds the first's prefix
            status, body = run_chat(run_url, "tiny-run")
            assert status == 200, body
    finally:
        rcs = [p.stop() for p in reversed(procs)]
    for p, rc in zip(reversed(procs), rcs):
        assert rc == 0, p.err_path.read_text()[-3000:]
        assert "FOREIGN []\n" in p.out, (p.out, p.err_path.read_text())


def test_unappliable_events_are_counted_and_the_consumers_live():
    """A KV event or metrics payload the router cannot apply is counted
    under `dynamo_router_events_dropped_total{stream}`, and the consumer
    goes on applying the next one."""
    from dynamo_tpu_torch.engines import EchoEngine
    from dynamo_tpu_torch.protocols import KV_STORED, KvCacheEvent, StoredBlock

    async def main():
        rt = await t_dist.DistributedRuntime.create(t_config.RuntimeConfig())
        ep = rt.namespace("dynamo").component("backend").endpoint("generate")
        served = await ep.serve(EchoEngine(), instance_id=5)
        client = await ep.client()
        router = await t_router.KvPushRouter(
            client, rt.events, t_router.KvRouterConfig(block_size=BS)).start()
        try:
            kv_subject = t_router.kv_events_subject("dynamo", "backend")
            m_subject = t_router.metrics_subject("dynamo", "backend")
            rt.events.publish_nowait(kv_subject, {"kind": "stored"})
            rt.events.publish_nowait(m_subject, {"worker_stats": 3})
            rt.events.publish_nowait(kv_subject, KvCacheEvent(
                kind=KV_STORED, worker_id=5, event_id=1,
                blocks=[StoredBlock(11, 12)]).to_dict())
            m = router.router.metrics
            for _ in range(200):
                if m.events.get(stream="kv") >= 1:
                    break
                await asyncio.sleep(0.01)
            return (m.events_dropped.get(stream="kv"),
                    m.events_dropped.get(stream="metrics"),
                    m.events.get(stream="kv"),
                    router.router.index_stats()["index_blocks"])
        finally:
            await router.stop()
            await client.stop()
            await served.shutdown()
            await rt.close()

    dropped_kv, dropped_m, applied, blocks = asyncio.run(
        asyncio.wait_for(main(), 20))
    assert (dropped_kv, dropped_m, applied) == (1.0, 1.0, 1.0)
    assert blocks == {"5:0": 1}


def test_gap_resync_rebuilds_the_index_slice_as_the_reference():
    """`gap_resync`: a KV-event gap drops the gapped worker's blocks and
    replays the bus's retained tail for it, the other worker untouched.
    The same stream through both packages' routers, each on its own
    runtime: the same gap and resync counts and the same index. (A hole
    that is still in the retained tail is met again by the replay and
    counted again, in the reference as here.)"""
    from dynamo_tpu import protocols as rp
    from dynamo_tpu.engines import EchoEngine as RefEcho
    from dynamo_tpu_torch import protocols as tp
    from dynamo_tpu_torch.engines import EchoEngine

    def stored(mod, wid, eid, h, parent=None):
        return mod.KvCacheEvent(kind=mod.KV_STORED, worker_id=wid,
                                event_id=eid, parent_seq_hash=parent,
                                blocks=[mod.StoredBlock(h, h + 1)]).to_dict()

    async def run(dist, config, router_mod, proto, echo):
        rt = await dist.DistributedRuntime.create(config.RuntimeConfig())
        ep = rt.namespace("dynamo").component("backend").endpoint("generate")
        served = [await ep.serve(echo(), instance_id=i) for i in IDS]
        client = await ep.client()
        router = await router_mod.KvPushRouter(
            client, rt.events, router_mod.KvRouterConfig(
                block_size=BS, gap_resync=True)).start()
        try:
            subject = router_mod.kv_events_subject("dynamo", "backend")
            for ev in (stored(proto, 1, 1, 100), stored(proto, 2, 1, 200),
                       stored(proto, 1, 2, 101, 100),
                       # event 3 of worker 1 is lost on the way
                       stored(proto, 1, 4, 103, 101),
                       stored(proto, 1, 5, 104, 103)):
                rt.events.publish_nowait(subject, ev)
            m = router.router.metrics
            for _ in range(300):
                if m.index_resyncs.get(worker="1:0") >= 1 and \
                        not router._resyncing:
                    break
                await asyncio.sleep(0.01)
            return (m.kv_event_gaps.get(worker="1:0"),
                    m.index_resyncs.get(worker="1:0"),
                    router.router.index_stats()["index_blocks"],
                    router.router.indexer.gaps)
        finally:
            await router.stop()
            await client.stop()
            for s in served:
                await s.shutdown()
            await rt.close()

    ours = asyncio.run(asyncio.wait_for(
        run(t_dist, t_config, t_router, tp, EchoEngine), 20))
    ref = asyncio.run(asyncio.wait_for(
        run(ref_dist, ref_config, ref_router, rp, RefEcho), 20))
    assert ours == ref
    assert ours[1] == 1.0 and ours[0] >= 1.0
    assert ours[2] == {"1:0": 4, "2:0": 1}
