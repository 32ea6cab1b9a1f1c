"""Request tracing through the port's deployment, held against the JAX
package's (`tests/test_trace_smoke.py` pins the reference).

- One traced chat through a port frontend and a port worker over a TCP
  coordinator lands in ONE trace: http → serve → engine.request →
  {engine.queue_wait, engine.prefill.chunk, engine.prefill,
  engine.decode}, every parent id resolving, the lifecycle events on the
  engine root; `/debug/requests` lists the request with that trace id;
  the armed fleet's greedy streams equal an unarmed port deployment's and
  the JAX package's on the same weights.
- The `traceparent` survives a PushRouter dial retry and a Migration
  replay.
- Across packages (one coordinator, each package's tracer writing its own
  file): a port frontend in front of a JAX-package worker, and a
  JAX-package frontend in front of a port worker, each give one trace id
  in both files, the worker's spans under the frontend's.
- The port's kv-mode frontend writes a `router.decide` span naming the
  worker the decision log records; a KVBM engine writes `kvbm.offload`
  and `kvbm.onboard` spans whose block counts equal the manager's stats,
  and the request roots carry the `kvbm.onboard` events.
- Off (`DYN_TRACE` unset), `RequestTrace.begin` is None.
"""

import asyncio
import json

import pytest

from dynamo_tpu.llm import entrypoint as ref_entry
from dynamo_tpu.llm import model_card as ref_card
from dynamo_tpu.runtime import config as ref_config
from dynamo_tpu.runtime import distributed as ref_dist
from dynamo_tpu.runtime import tracing as ref_tracing
from dynamo_tpu.runtime.recorder import Recorder as RefRecorder
from dynamo_tpu_torch.llm import entrypoint as t_entry
from dynamo_tpu_torch.llm import model_card as t_card
from dynamo_tpu_torch.runtime import config as t_config
from dynamo_tpu_torch.runtime import distributed as t_dist
from dynamo_tpu_torch.runtime import tracing as t_tracing
from dynamo_tpu_torch.runtime.recorder import Recorder
from tests.test_torch_serving import (  # noqa: F401
    StoreThread,
    _card,
    _engines,
    _renew_lease,
    call,
    default_impl,
)

ENGINE_STAGES = {"engine.request", "engine.queue_wait",
                 "engine.prefill.chunk", "engine.prefill", "engine.decode"}
PROMPTS = ("hello there", "spans pages of four")


def _chat(model, text, stream=False):
    return {"model": model, "max_tokens": 6, "temperature": 0,
            "stream": stream,
            "messages": [{"role": "user", "content": text}]}


def _rows(path) -> list:
    return [e for _, e in Recorder.iter_events(path)]


def _attr(span, key):
    return next(a["value"]["stringValue"] for a in span["attributes"]
                if a["key"] == key)


def _check_tree(rows, trace_id) -> dict:
    """The spans of one trace: every parent resolves, the engine root
    sits under the transport's serve span, each stage under the root.
    Returns {name: [spans]}."""
    ours = [r for r in rows if r["traceId"] == trace_id]
    ids = {r["spanId"] for r in ours}
    for r in ours:
        assert not r["parentSpanId"] or r["parentSpanId"] in ids, r["name"]
    by: dict = {}
    for r in ours:
        by.setdefault(r["name"], []).append(r)
    assert ENGINE_STAGES <= set(by), sorted(by)
    (root,) = by["engine.request"]
    serve = [r for r in ours if r["name"].startswith("serve ")]
    assert len(serve) == 1 and root["parentSpanId"] == serve[0]["spanId"]
    for stage in ENGINE_STAGES - {"engine.request"}:
        assert all(r["parentSpanId"] == root["spanId"] for r in by[stage])
    assert {"enqueued", "admitted", "first_token"} <= {
        e["name"] for e in root["events"]}
    assert root["status"]["code"] == "OK"
    return by


async def _port_fleet(url, torch_eng, card_name="tiny"):
    """A port worker and a port frontend, each its own runtime over the
    coordinator at `url`."""
    rt_w = await t_dist.DistributedRuntime.create(
        t_config.RuntimeConfig(store_url=url))
    rt_f = await t_dist.DistributedRuntime.create(
        t_config.RuntimeConfig(store_url=url))
    handle = await t_entry.serve_engine(
        rt_w, torch_eng, _card(t_card, card_name, "backend"), instance_id=1)
    fe = await t_entry.start_frontend(rt_f, port=0)
    for _ in range(500):
        if card_name in fe.manager.model_names():
            break
        await asyncio.sleep(0.01)
    return rt_w, rt_f, handle, fe


def test_trace_is_one_tree_and_armed_streams_equal_unarmed(default_impl,
                                                           tmp_path):
    jax_eng, torch_eng = _engines()
    _, unarmed = _engines()
    path = tmp_path / "trace.jsonl"

    async def armed(url):
        tr = t_tracing.Tracer(enabled=True, path=str(path))
        t_tracing.set_tracer(tr)
        rt_w, rt_f, handle, fe = await _port_fleet(url, torch_eng)
        try:
            got = [await call(fe.http.port, "POST", "/v1/chat/completions",
                              _chat("tiny", text, stream=i == 1))
                   for i, text in enumerate(PROMPTS)]
            _, _, dbg = await call(fe.http.port, "GET",
                                   "/debug/requests?limit=5")
            metrics = rt_f.metrics.render()
        finally:
            t_tracing.set_tracer(None)
            await fe.stop()
            await handle.stop()
            await torch_eng.close()
            await rt_f.close()
            await rt_w.close()
        await tr.close()
        return got, json.loads(dbg), metrics, tr

    async def plain():
        ref_rt = await ref_dist.DistributedRuntime.create(
            ref_config.RuntimeConfig())
        renew = asyncio.ensure_future(_renew_lease(ref_rt))
        t_rt = await t_dist.DistributedRuntime.create(
            t_config.RuntimeConfig())
        handles, fes = [], []
        try:
            handles.append(await ref_entry.serve_engine(
                ref_rt, jax_eng, _card(ref_card, "tiny", "backend")))
            handles.append(await t_entry.serve_engine(
                t_rt, unarmed, _card(t_card, "tiny", "backend")))
            fes.append(await ref_entry.start_frontend(ref_rt, port=0))
            fes.append(await t_entry.start_frontend(t_rt, port=0))
            for fe in fes:
                for i, text in enumerate(PROMPTS):
                    st, _, _ = await call(fe.http.port, "POST",
                                          "/v1/chat/completions",
                                          _chat("tiny", text, i == 1))
                    assert st == 200
        finally:
            renew.cancel()
            for fe in fes:
                await fe.stop()
            for h in handles:
                await h.stop()
            await jax_eng.close()
            await unarmed.close()
            await ref_rt.close()
            await t_rt.close()

    with StoreThread() as store:
        got, dbg, metrics, tr = asyncio.run(
            asyncio.wait_for(armed(store.url), 100))
    asyncio.run(asyncio.wait_for(plain(), 100))
    assert [g[0] for g in got] == [200, 200]
    # the armed fleet's greedy streams are the unarmed port's and the
    # JAX package's
    assert torch_eng.streams == unarmed.streams == jax_eng.streams
    assert len(torch_eng.streams) == len(PROMPTS)
    rows = _rows(path)
    http = [r for r in rows if r["name"] == "http chat_completions"]
    assert len(http) == len(PROMPTS)
    recent = dbg["recent"]
    assert dbg["in_flight"] == [] and len(recent) == len(PROMPTS)
    assert [r["trace_id"] for r in reversed(recent)] == [
        r["traceId"] for r in http]
    for rec, span in zip(reversed(recent), http):
        by = _check_tree(rows, span["traceId"])
        serve = next(r for r in rows if r["traceId"] == span["traceId"]
                     and r["name"].startswith("serve "))
        assert serve["parentSpanId"] == span["spanId"]
        assert rec["status"] == "200" and rec["usage"]["completion_tokens"]
        # the chunks prefilled what the prefix cache did not hold
        chunk_tokens = sum(int(_attr(c, "tokens"))
                           for c in by["engine.prefill.chunk"])
        (wait,) = by["engine.queue_wait"]
        assert chunk_tokens + int(_attr(wait, "cached_len")) == \
            rec["usage"]["prompt_tokens"] == int(_attr(wait,
                                                       "prompt_tokens"))
    assert recent[0]["stream"] is True and recent[1]["stream"] is False
    assert tr.dropped == 0 and tr.exported == len(rows)
    assert "dynamo_trace_dropped_total 0" in metrics


def test_traceparent_through_push_router_retries(tmp_path):
    """A dial failure on the first candidate retries the next one; the
    request that lands still carries the caller's traceparent, and the
    healthy worker's serve span joins the caller's trace."""
    from dynamo_tpu_torch.runtime.component import Instance
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.push import PushRouter

    path = tmp_path / "t.jsonl"
    t = t_tracing.Tracer(enabled=True, path=str(path))

    async def main():
        t_tracing.set_tracer(t)
        rt_srv = await t_dist.DistributedRuntime.create(
            t_config.RuntimeConfig())
        rt_cli = await t_dist.DistributedRuntime.create(
            t_config.RuntimeConfig())
        seen: list[dict] = []
        try:
            async def handler(req, ctx):
                seen.append(dict(ctx.headers))
                yield {"ok": True}

            ep = rt_srv.namespace("ns").component("c").endpoint("e")
            served = await ep.serve(handler, instance_id=2)
            dead = Instance(namespace="ns", component="c", endpoint="e",
                            instance_id=1, address="127.0.0.1:1")
            client = await rt_cli.namespace("ns").component("c").endpoint(
                "e").client(static_instances=[dead, served.instance])
            await client.start()
            router = PushRouter(client, mode="round_robin")
            with t.start_span("caller") as root:
                items = [x async for x in router.generate({"q": 1},
                                                          Context())]
            assert items == [{"ok": True}]
            retries = rt_cli.transport_client.stats["route_retries"]
            await client.stop()
        finally:
            t_tracing.set_tracer(None)
            await rt_cli.close()
            await rt_srv.close()
        await t.close()
        return seen, root, retries

    seen, root, retries = asyncio.run(asyncio.wait_for(main(), 30))
    assert retries >= 1
    assert seen and root.trace_id in seen[0][t_tracing.TRACEPARENT]
    serve = next(r for r in _rows(path) if r["name"].startswith("serve "))
    assert serve["traceId"] == root.trace_id
    assert serve["parentSpanId"] == root.span_id


def test_migration_replay_keeps_the_traceparent():
    """Migration replays reuse the request's Context: every attempt
    presents the same traceparent, so the retried stream stays one
    trace."""
    from dynamo_tpu_torch.llm.migration import Migration
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.transport import STREAM_ERR_MSG

    attempts: list[str] = []

    class Flaky:
        calls = 0

        async def generate(self, request, context):
            Flaky.calls += 1
            attempts.append(context.headers.get(t_tracing.TRACEPARENT, ""))
            yield {"token_ids": [Flaky.calls]}
            if Flaky.calls == 1:
                raise ConnectionError(STREAM_ERR_MSG)
            yield {"token_ids": [99], "finish_reason": "stop"}

    async def main():
        tp = "00-" + "e" * 32 + "-" + "f" * 16 + "-01"
        ctx = Context(headers={t_tracing.TRACEPARENT: tp})
        mig = Migration(migration_limit=2).link(Flaky())
        toks = [t async for out in mig.generate(
            {"token_ids": [5], "stop": {"max_tokens": 8}}, ctx)
            for t in out.get("token_ids", ())]
        return tp, toks, mig.stats

    tp, toks, stats = asyncio.run(main())
    assert stats["migrations"] == 1 and toks == [1, 2, 99]
    assert attempts == [tp, tp]


@pytest.mark.parametrize("direction", ["torch->jax", "jax->torch"])
def test_cross_package_request_is_one_trace(default_impl, tmp_path,
                                            direction):
    """Each package's tracer writes its own file; the frontend of one
    package routes to a worker of the other over one coordinator. The
    frontend's http span and the worker's serve and engine spans share one
    trace id, the worker's serve span the child of the http span."""
    jax_eng, torch_eng = _engines()
    ref_path, t_path = tmp_path / "ref.jsonl", tmp_path / "torch.jsonl"
    fe_entry, fe_dist, fe_cfg = ((t_entry, t_dist, t_config)
                                 if direction == "torch->jax"
                                 else (ref_entry, ref_dist, ref_config))
    w_entry, w_dist, w_cfg, w_card, eng = (
        (ref_entry, ref_dist, ref_config, ref_card, jax_eng)
        if direction == "torch->jax"
        else (t_entry, t_dist, t_config, t_card, torch_eng))

    async def main(url):
        ref_tr = ref_tracing.Tracer(enabled=True, path=str(ref_path))
        t_tr = t_tracing.Tracer(enabled=True, path=str(t_path))
        ref_tracing.set_tracer(ref_tr)
        t_tracing.set_tracer(t_tr)
        rt_w = await w_dist.DistributedRuntime.create(
            w_cfg.RuntimeConfig(store_url=url))
        rt_f = await fe_dist.DistributedRuntime.create(
            fe_cfg.RuntimeConfig(store_url=url))
        handle = fe = None
        try:
            handle = await w_entry.serve_engine(
                rt_w, eng, _card(w_card, "tiny", "backend"), instance_id=1)
            fe = await fe_entry.start_frontend(
                rt_f, port=0, router_mode_override="round_robin")
            for _ in range(500):
                if "tiny" in fe.manager.model_names():
                    break
                await asyncio.sleep(0.01)
            st, _, body = await call(fe.http.port, "POST",
                                     "/v1/chat/completions",
                                     _chat("tiny", PROMPTS[0]))
            assert st == 200, body
        finally:
            ref_tracing.set_tracer(None)
            t_tracing.set_tracer(None)
            if fe is not None:
                await fe.stop()
            if handle is not None:
                await handle.stop()
            await jax_eng.close()
            await torch_eng.close()
            await rt_f.close()
            await rt_w.close()
        await ref_tr.close()
        await t_tr.close()

    with StoreThread() as store:
        asyncio.run(asyncio.wait_for(main(store.url), 100))
    fe_path, w_path = ((t_path, ref_path) if direction == "torch->jax"
                       else (ref_path, t_path))
    fe_rows = [e for _, e in Recorder.iter_events(fe_path)]
    w_rows = [e for _, e in RefRecorder.iter_events(w_path)]
    (http,) = [r for r in fe_rows if r["name"].startswith("http ")]
    assert {r["traceId"] for r in fe_rows} == {http["traceId"]}
    assert {r["traceId"] for r in w_rows} == {http["traceId"]}
    (serve,) = [r for r in w_rows if r["name"].startswith("serve ")]
    assert serve["parentSpanId"] == http["spanId"]
    _check_tree(w_rows + fe_rows, http["traceId"])


def test_router_decide_span_names_the_logged_worker(default_impl, tmp_path,
                                                    monkeypatch):
    """A kv-mode port frontend over two port workers: each request's
    `router.decide` span (under its http span) names the worker the
    router's decision log recorded for it."""
    from tests.test_torch_kv_serving import (
        _kv_card,
        _serve,
        _torch_workers,
        _weights,
    )

    monkeypatch.setenv("DYN_ROUTER_LOG", "1")
    tcfg, model = _weights()[2:]
    taps = _torch_workers(tcfg, model)
    path = tmp_path / "trace.jsonl"
    tr = t_tracing.Tracer(enabled=True, path=str(path))

    async def main(url):
        t_tracing.set_tracer(tr)
        rt = await t_dist.DistributedRuntime.create(
            t_config.RuntimeConfig(store_url=url))
        handles = await _serve(t_entry, rt, taps, _kv_card(t_card))
        fe = await t_entry.start_frontend(rt, port=0)
        try:
            for _ in range(500):
                if "tiny" in fe.manager.model_names():
                    break
                await asyncio.sleep(0.01)
            for text in PROMPTS:
                st, _, _ = await call(fe.http.port, "POST",
                                      "/v1/chat/completions",
                                      _chat("tiny", text))
                assert st == 200
            _, _, raw = await call(fe.http.port, "GET", "/debug/router")
        finally:
            t_tracing.set_tracer(None)
            await fe.stop()
            for h in handles:
                await h.stop()
            for tap in taps:
                await tap.inner.close()
            await rt.close()
        await tr.close()
        return json.loads(raw)

    with StoreThread() as store:
        router = asyncio.run(asyncio.wait_for(main(store.url), 100))
    rows = _rows(path)
    decide = [r for r in rows if r["name"] == "router.decide"]
    records = router["models"][0]["records"]
    assert len(decide) == len(records) == len(PROMPTS)
    http = {r["spanId"]: r for r in rows if r["name"].startswith("http ")}

    for span, rec in zip(decide, records):
        assert span["parentSpanId"] in http
        assert _attr(span, "router.worker") == rec["worker"]
        assert int(_attr(span, "router.overlap_blocks")) == \
            rec["overlap_blocks"]


@pytest.mark.parametrize("pipelined", [False, True])
def test_kvbm_spans_count_the_managers_blocks(tmp_path, pipelined):
    """KVBM under the tracer: the onboard spans' block counts sum to the
    manager's onboarded blocks, the offload spans' (the pipelined worker's
    batches) to its offloaded blocks, and the request roots carry one
    `kvbm.onboard` event per onboard."""
    from tests.test_torch_kvbm import churn, collect, drain_pipeline, \
        make_engine, req

    path = tmp_path / "trace.jsonl"
    tr = t_tracing.Tracer(enabled=True, path=str(path))
    knobs = ({"offload_queue_depth": 64, "offload_workers": 1}
             if pipelined else {})

    async def main():
        t_tracing.set_tracer(tr)
        try:
            eng, mgr = make_engine(**knobs)
            prompt = list(range(1, 13))
            await collect(eng, req(prompt))
            await churn(eng)
            if pipelined:
                await drain_pipeline(mgr)
            await collect(eng, req(prompt))
            stats = mgr.stats
            await eng.close()
        finally:
            t_tracing.set_tracer(None)
        await tr.close()
        return stats

    stats = asyncio.run(asyncio.wait_for(main(), 60))
    rows = _rows(path)

    def blocks(name, **want):
        out = 0
        for r in rows:
            if r["name"] != name:
                continue
            a = {x["key"]: x["value"]["stringValue"] for x in r["attributes"]}
            if all(a.get(k) == v for k, v in want.items()):
                out += int(a["kvbm.blocks"])
        return out

    assert stats.onboarded > 0
    assert blocks("kvbm.onboard", **{"kvbm.source": "local"}) == \
        stats.onboarded
    if pipelined:
        assert stats.offloaded > 0
        assert blocks("kvbm.offload") == stats.offloaded
    events = [e for r in rows if r["name"] == "engine.request"
              for e in r["events"] if e["name"] == "kvbm.onboard"]
    assert sum(int(next(a["value"]["stringValue"] for a in e["attributes"]
                        if a["key"] == "blocks")) for e in events) == \
        stats.onboarded


def test_request_trace_is_none_when_off(monkeypatch):
    """The scheduler's zero-cost-off contract: with the tracer off,
    begin() is None and the engine's sequences carry no trace."""
    monkeypatch.delenv("DYN_TRACE", raising=False)
    t_tracing.set_tracer(None)
    try:
        assert t_tracing.RequestTrace.begin(
            "engine.request", {"traceparent": "x"}) is None
        assert t_tracing.tracer().enabled is False
    finally:
        t_tracing.set_tracer(None)
