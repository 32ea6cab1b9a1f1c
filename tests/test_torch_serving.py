"""The port served as a deployment, held against the JAX package's.

- End to end: a tiny fp32 Llama (2 layers, hidden 64) served by the
  reference's frontend over a `TpuEngine` worker, and by the port's
  frontend over a `TorchEngine` worker with the same weights
  (`params_from_jax`). The same requests go to both over HTTP: greedy
  chat and completions, streamed and not, with logprobs, a stop string,
  `max_tokens` and `n` = 1. The token ids each engine emitted are
  identical, and so are the response bodies after normalizing `id` and
  `created` (SSE framing and `data: [DONE]` included), usage and
  finish_reason with them.
- Cross-wired: one coordinator, the reference frontend sending to the port
  worker and the port frontend to the reference worker, both routing
  round-robin: the same bodies.
- Routing and failure: two port workers share round-robin traffic; a
  worker killed mid-stream (lease revoked, transport gone) ends the stream
  with STREAM_ERR_MSG and `Migration` replays it on the survivor within
  `migration_limit` (and past it the SSE stream carries an error event,
  counted as a 500); an unknown model is a 404, no live worker a 503; a
  `kv` card (the cards' default) and a `kv` frontend are served through
  the KV router (tests/test_torch_kv_serving.py holds its placements).
- A worker whose engine build outlasts the lease TTL stays discoverable
  (the engine is built before the lease is taken).

Every test bounds itself with `asyncio.wait_for`; frontends bind port 0,
coordinators take theirs from `free_port()`."""

import asyncio
import http.client
import json
import re
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import attention as jattn
from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.llm import entrypoint as ref_entry
from dynamo_tpu.llm import model_card as ref_card
from dynamo_tpu.models import llama as jl
from dynamo_tpu.runtime import config as ref_config
from dynamo_tpu.runtime import distributed as ref_dist
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engines import EchoEngine
from dynamo_tpu_torch.llm import entrypoint as t_entry
from dynamo_tpu_torch.llm import model_card as t_card
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.runtime import config as t_config
from dynamo_tpu_torch.runtime import distributed as t_dist
from dynamo_tpu_torch.runtime.distributed import free_port
from dynamo_tpu_torch.runtime.store_net import StoreServer
from dynamo_tpu_torch.runtime.transport import STREAM_ERR_MSG
from dynamo_tpu_torch.worker import main as worker_main

ENGINE_KW = dict(num_pages=64, max_batch_size=4, prefill_chunk=32,
                 min_prefill_bucket=8, default_max_tokens=8,
                 decode_steps_per_sync=2)
CONTEXT = 64            # LlamaConfig.tiny: 16 pages of 4 tokens
# logprobs in the bodies: fp32 logits of XLA and of PyTorch differ in the
# last bits (7.2e-7 seen), so the numbers are held to this, the text
# around them byte for byte
LOGPROB_TOL = 1e-5
_FLOAT = re.compile(rb"-?\d+\.\d+(?:e-?\d+)?")


@pytest.fixture
def default_impl():
    """The reference's default attention impl ("auto": on the CPU, the
    phase path), restored afterwards."""
    prev = jattn._impl
    jattn.set_attention_impl("auto")
    yield
    jattn.set_attention_impl(prev)


class Tap:
    """An engine that records the token ids each request emitted."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.streams: list[list[int]] = []
        self.outputs: list[int] = []        # token-bearing outputs

    async def generate(self, request, context):
        toks: list[int] = []
        n = 0
        try:
            async for out in self.inner.generate(request, context):
                toks.extend(out.get("token_ids") or ())
                n += bool(out.get("token_ids"))
                yield out
        finally:
            self.streams.append(toks)
            self.outputs.append(n)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _engines():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    params = jl.init_params(jax.random.PRNGKey(0), jcfg)
    jax_eng = TpuEngine(TpuEngineConfig(model=jcfg, **ENGINE_KW),
                        params=params)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    torch_eng = TorchEngine(TorchEngineConfig(model=tcfg, device="cpu",
                                              **ENGINE_KW), model=model)
    return Tap(jax_eng), Tap(torch_eng)


def _card(mod, name, component, **kw):
    return mod.ModelDeploymentCard(
        name=name, component=component, tokenizer_kind="byte",
        context_length=CONTEXT, kv_block_size=4, router_mode="round_robin",
        **kw)


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


async def call(port, method, path, body=None):
    return await asyncio.wait_for(
        asyncio.to_thread(_http, port, method, path, body), 60)


def normalized(body: bytes) -> bytes:
    body = re.sub(rb'"id": ?"(chatcmpl|cmpl)-[0-9a-f]+"', b'"id":"ID"', body)
    body = re.sub(rb'"created": ?\d+', b'"created":0', body)
    return re.sub(rb'"model": ?"tiny-[a-z]+"', b'"model":"M"', body)


def same_bodies(got: list, want: list) -> None:
    """(status, content type, normalized body) lists equal, the floats in
    the bodies (logprobs) within LOGPROB_TOL."""
    assert len(got) == len(want)
    for (gs, gt, gb), (ws, wt, wb) in zip(got, want):
        assert (gs, gt) == (ws, wt)
        assert _FLOAT.sub(b"F", gb) == _FLOAT.sub(b"F", wb), (gb, wb)
        gf = [float(x) for x in _FLOAT.findall(gb)]
        wf = [float(x) for x in _FLOAT.findall(wb)]
        assert np.allclose(gf, wf, rtol=0, atol=LOGPROB_TOL), (gf, wf)


def sse_events(body: bytes) -> list:
    assert body.endswith(b"data: [DONE]\n\n"), body[-80:]
    events = body.split(b"\n\n")[:-1]
    assert all(e.startswith(b"data: ") for e in events)
    return [json.loads(e[6:]) for e in events[:-1]]


def requests_for(model: str, stop: str = "") -> list:
    msgs = [{"role": "user", "content": "hello world"}]
    reqs = [
        ("/v1/chat/completions", {"model": model, "messages": msgs,
                                  "max_tokens": 12, "temperature": 0}),
        ("/v1/chat/completions", {"model": model, "messages": msgs,
                                  "max_tokens": 12, "temperature": 0,
                                  "stream": True, "logprobs": True,
                                  "top_logprobs": 3, "n": 1}),
        ("/v1/completions", {"model": model, "prompt": "the quick brown",
                             "max_tokens": 10, "temperature": 0}),
        ("/v1/completions", {"model": model, "prompt": "the quick brown",
                             "max_tokens": 10, "temperature": 0,
                             "stream": True, "logprobs": 2}),
    ]
    if stop:
        reqs.append(("/v1/chat/completions", {
            "model": model, "messages": msgs, "max_tokens": 12,
            "temperature": 0, "stream": True, "stop": [stop]}))
    return reqs


def stop_string_of(body: bytes) -> str:
    """Two characters from the middle of a streamed chat's text: a stop
    string the greedy stream is known to reach."""
    text = "".join(c["choices"][0]["delta"].get("content") or ""
                   for c in sse_events(body) if c.get("choices"))
    assert len(text) >= 6, text
    return text[3:5]


async def serve_pair(port_a: int, port_b: int, requests) -> tuple:
    """The same requests, in order, to two frontends: lists of (status,
    content type, normalized body)."""
    a, b = [], []
    for path, body in requests:
        ra = await call(port_a, "POST", path, body)
        rb = await call(port_b, "POST", path, body)
        a.append((ra[0], ra[1], normalized(ra[2])))
        b.append((rb[0], rb[1], normalized(rb[2])))
    return a, b


def check_bodies(results, requests) -> None:
    """Statuses, content types and the shape of each body."""
    assert [st for st, _, _ in results] == [200] * len(requests)
    for (_, ctype, body), (_, req) in zip(results, requests):
        if req.get("stream"):
            assert ctype == "text/event-stream"
            events = sse_events(body)
            assert events[-1]["usage"]["completion_tokens"] >= 1
            assert events[-1]["choices"][0]["finish_reason"] in (
                "length", "stop")
        else:
            assert ctype.startswith("application/json")
            assert json.loads(body)["choices"][0]["finish_reason"] == \
                "length"


async def _renew_lease(rt) -> None:
    """Keep an in-process reference runtime's lease alive. The
    reference's runtime never renews a lease on its memory store (the
    port's does), so there the model's card and instance vanish
    `lease_ttl` (10 s) after start: a run slowed by a loaded machine
    then met a 404 halfway through."""
    while True:
        await asyncio.sleep(rt.config.lease_ttl / 3)
        await rt.store.keep_alive(rt.lease_id)


def test_http_end_to_end_identical_to_jax_package(default_impl):
    jax_eng, torch_eng = _engines()     # built before the bound

    async def main():
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
                t_rt, torch_eng, _card(t_card, "tiny", "backend")))
            # both frontends bind port 0 and report the port they got
            fes.append(await ref_entry.start_frontend(ref_rt, port=0))
            fes.append(await t_entry.start_frontend(t_rt, port=0))
            ports = (fes[0].http.port, fes[1].http.port)
            reqs = requests_for("tiny")
            want, got = await serve_pair(*ports, reqs)
            stop = stop_string_of(want[1][2])
            more = requests_for("tiny", stop)[len(reqs):]
            w2, g2 = await serve_pair(*ports, more)
            # the port's own field: logprobs tokens as ids, one chunk per
            # engine output
            _, _, ids_body = await call(ports[1], "POST",
                                        "/v1/chat/completions", dict(
                                            reqs[1][1],
                                            return_tokens_as_token_ids=True))
            return (reqs + more, want + w2, got + g2, jax_eng.streams,
                    torch_eng.streams, torch_eng.outputs,
                    ids_body)
        finally:
            renew.cancel()
            for fe in fes:
                await fe.stop()
            for h in handles:
                await h.stop()
            await jax_eng.close()
            await torch_eng.close()
            await ref_rt.close()
            await t_rt.close()

    (reqs, want, got, jax_eng_streams, torch_eng_streams, outputs,
     ids_body) = asyncio.run(asyncio.wait_for(main(), 100))
    check_bodies(want, reqs)
    same_bodies(got, want)
    assert torch_eng_streams[:-1] == jax_eng_streams
    assert len(jax_eng_streams) == len(reqs)
    chunks = [c for c in sse_events(ids_body)
              if c["choices"][0].get("logprobs")]
    entries = [e for c in chunks
               for e in c["choices"][0]["logprobs"]["content"]]
    assert [e["token"] for e in entries] == [
        f"token_id:{t}" for t in torch_eng_streams[-1]]
    assert torch_eng_streams[-1] == torch_eng_streams[1]
    assert all(a["token"].startswith("token_id:")
               for e in entries for a in e["top_logprobs"])
    assert len(chunks) == outputs[-1] > 1
    # the stop string cut the last stream short of max_tokens
    last = sse_events(want[-1][2])[-1]
    assert last["choices"][0]["finish_reason"] == "stop"


class StoreThread:
    """A coordinator (`StoreServer`) on its own event loop in a thread, so
    that a test's loop may block without stopping it."""

    def __init__(self) -> None:
        self.port = free_port()
        self._loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._server = StoreServer(port=self.port)
        self._loop.run_until_complete(self._server.start())
        self._started.set()
        self._loop.run_forever()
        self._loop.run_until_complete(self._server.stop())
        self._loop.close()

    @property
    def url(self) -> str:
        return f"tcp://127.0.0.1:{self.port}"

    def __enter__(self) -> "StoreThread":
        self._thread.start()
        assert self._started.wait(10)
        return self

    def __exit__(self, *exc) -> None:
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(10)
        assert not self._thread.is_alive()


def test_cross_wired_frontends_and_workers(default_impl):
    """Over one coordinator: the reference frontend → the port worker and
    the port frontend → the reference worker, each routing round-robin,
    beside each frontend → its own package's worker. All four give the
    same bodies and the engines the same tokens."""
    async def main(url):
        jax_eng, torch_eng = _engines()
        ref_rt = await ref_dist.DistributedRuntime.create(
            ref_config.RuntimeConfig(store_url=url))
        t_rt = await t_dist.DistributedRuntime.create(
            t_config.RuntimeConfig(store_url=url))
        handles, fes = [], []
        try:
            handles.append(await ref_entry.serve_engine(
                ref_rt, jax_eng, _card(ref_card, "tiny-jax", "jax_backend")))
            handles.append(await t_entry.serve_engine(
                t_rt, torch_eng, _card(t_card, "tiny-torch",
                                       "torch_backend")))
            fes.append(await ref_entry.start_frontend(
                ref_rt, port=free_port(), router_mode_override="round_robin"))
            fes.append(await t_entry.start_frontend(
                t_rt, port=free_port(), router_mode_override="round_robin"))
            ref_port, t_port = fes[0].http.port, fes[1].http.port

            async def names(port):
                while True:
                    _, _, body = await call(port, "GET", "/v1/models")
                    got = sorted(m["id"] for m in json.loads(body)["data"])
                    if got == ["tiny-jax", "tiny-torch"]:
                        return
                    await asyncio.sleep(0.05)

            await asyncio.wait_for(asyncio.gather(names(ref_port),
                                                  names(t_port)), 10)
            out = {}
            for label, port, model in (
                    ("ref->torch", ref_port, "tiny-torch"),
                    ("torch->jax", t_port, "tiny-jax"),
                    ("ref->jax", ref_port, "tiny-jax"),
                    ("torch->torch", t_port, "tiny-torch")):
                out[label] = []
                for path, body in requests_for(model)[:2]:
                    st, ctype, raw = await call(port, "POST", path, body)
                    out[label].append((st, ctype, normalized(raw)))
            return out, jax_eng.streams, torch_eng.streams
        finally:
            for fe in fes:
                await fe.stop()
            for h in handles:
                await h.stop()
            await jax_eng.close()
            await torch_eng.close()
            await ref_rt.close()
            await t_rt.close()

    with StoreThread() as store:
        out, jax_streams, torch_streams = asyncio.run(
            asyncio.wait_for(main(store.url), 100))
    check_bodies(out["ref->jax"], requests_for("tiny-jax")[:2])
    for label in ("ref->torch", "torch->jax", "torch->torch"):
        same_bodies(out[label], out["ref->jax"])
    # each engine served two requests per frontend, the same tokens
    assert len(jax_streams) == len(torch_streams) == 4
    assert torch_streams == jax_streams


class Counted(EchoEngine):
    """The echo engine, counting its requests and marking its first
    token of each."""

    def __init__(self, delay_ms: float = 1.0) -> None:
        super().__init__(delay_ms)
        self.requests = 0
        self.emitted = 0
        self.started = asyncio.Event()
        self.cancelled = asyncio.Event()

    async def generate(self, request, context):
        self.requests += 1
        try:
            async for out in super().generate(request, context):
                self.started.set()
                self.emitted += len(out["token_ids"])
                yield out
        except asyncio.CancelledError:
            self.cancelled.set()
            raise


async def _echo_fleet(url, n, migration_limit=0, delay_ms=1.0):
    """n port workers serving `Counted` echo engines behind one model,
    and a port frontend: (frontend, [(runtime, engine, handle)])."""
    workers = []
    for i in range(n):
        rt = await t_dist.DistributedRuntime.create(
            t_config.RuntimeConfig(store_url=url))
        eng = Counted(delay_ms)
        card = t_card.ModelDeploymentCard(
            name="echo", tokenizer_kind="word", tokenizer_path="echo",
            router_mode="round_robin", migration_limit=migration_limit)
        handle = await t_entry.serve_engine(rt, eng, card,
                                            instance_id=i + 1)
        workers.append((rt, eng, handle))
    fe_rt = await t_dist.DistributedRuntime.create(
        t_config.RuntimeConfig(store_url=url))
    fe = await t_entry.start_frontend(fe_rt, port=free_port())

    async def ready():
        while not fe.manager.get("echo") or len(
                fe.manager.get("echo").client.instances()) < n:
            await asyncio.sleep(0.05)

    await asyncio.wait_for(ready(), 10)
    return fe, workers


async def _stop_fleet(fe, workers) -> None:
    await fe.stop()
    await fe.runtime.close()
    for rt, _, handle in workers:
        try:
            await handle.stop()
        except ConnectionError:
            pass
        await rt.close()


def test_round_robin_spreads_requests_over_two_workers():
    async def main(url):
        fe, workers = await _echo_fleet(url, 2)
        try:
            body = {"model": "echo", "max_tokens": 3,
                    "messages": [{"role": "user", "content": "a b c d"}]}
            for _ in range(6):
                st, _, raw = await call(fe.http.port, "POST",
                                        "/v1/chat/completions", body)
                assert st == 200, raw
            return [eng.requests for _, eng, _ in workers]
        finally:
            await _stop_fleet(fe, workers)

    with StoreThread() as store:
        assert asyncio.run(asyncio.wait_for(main(store.url), 30)) == [3, 3]


@pytest.mark.parametrize("migration_limit", [1, 0])
def test_worker_killed_mid_stream_migrates_or_errors(migration_limit):
    """A worker dies mid-stream: its lease is revoked and its transport
    closes. Within `migration_limit` the stream continues on the other
    worker and completes with every token once; past it the SSE stream
    ends in an error event and the frontend counts a 500."""
    prompt = " ".join(f"w{i}" for i in range(16))
    body = {"model": "echo", "max_tokens": 16, "stream": True,
            "messages": [{"role": "user", "content": prompt}]}

    async def main(url):
        fe, workers = await _echo_fleet(url, 2, migration_limit,
                                        delay_ms=40.0)
        try:
            resp = asyncio.ensure_future(call(fe.http.port, "POST",
                                              "/v1/chat/completions", body))
            first = workers[0][1]      # round-robin starts at instance 1
            await asyncio.wait_for(first.started.wait(), 10)
            await asyncio.sleep(0.1)
            rt = workers[0][0]
            await rt.store.revoke_lease(rt.lease_id)
            await rt.transport_server.stop()
            st, _, raw = await asyncio.wait_for(resp, 20)
            metrics = (await call(fe.http.port, "GET", "/metrics"))[2]
            return (st, raw, [e.requests for _, e, _ in workers],
                    first.emitted, metrics)
        finally:
            await _stop_fleet(fe, workers)

    with StoreThread() as store:
        st, raw, served, before_kill, metrics = asyncio.run(
            asyncio.wait_for(main(store.url), 40))
    assert st == 200
    events = raw.split(b"\n\n")[:-1]
    chunks = [json.loads(e[6:]) for e in events if e != b"data: [DONE]"]
    if migration_limit:
        assert served == [1, 1]
        text = "".join(c["choices"][0]["delta"].get("content") or ""
                       for c in chunks if c.get("choices"))
        # the echo engine streams its prompt back; the replay's prompt is
        # the original plus the tokens that reached the client, and its
        # max_tokens what is left of the 16
        words = ("user: " + prompt).split()
        assert 0 < before_kill < 16
        assert text.split() == words[:before_kill] + words[:16 - before_kill]
        assert events[-1] == b"data: [DONE]"
        assert chunks[-1]["usage"]["completion_tokens"] == 16
    else:
        assert served == [1, 0]
        assert "error" in chunks[-1], chunks[-1]
        assert STREAM_ERR_MSG in chunks[-1]["error"]["message"]
        assert events[-1] != b"data: [DONE]"
        assert b'dynamo_http_requests_total{endpoint="chat_completions",' \
               b'status="500"} 1.0' in metrics


def test_unknown_model_404_and_no_instances_503():
    async def main(url):
        fe, workers = await _echo_fleet(url, 1)
        try:
            body = {"model": "nope", "messages": [
                {"role": "user", "content": "x"}]}
            missing = await call(fe.http.port, "POST",
                                 "/v1/chat/completions", body)
            # the model's last worker leaves its transport: its card is
            # still published, so the router finds no live instance
            rt = workers[0][0]
            await workers[0][2].served.shutdown()
            body["model"] = "echo"

            async def gone():
                while fe.manager.get("echo").client.instances():
                    await asyncio.sleep(0.05)

            await asyncio.wait_for(gone(), 10)
            none_left = await call(fe.http.port, "POST",
                                   "/v1/chat/completions", body)
            del rt
            return missing, none_left
        finally:
            await _stop_fleet(fe, workers)

    with StoreThread() as store:
        missing, none_left = asyncio.run(asyncio.wait_for(main(store.url),
                                                          30))
    assert missing[0] == 404
    assert json.loads(missing[2])["error"]["type"] == "model_not_found"
    assert none_left[0] == 503, none_left
    assert json.loads(none_left[2])["error"]["type"] == \
        "service_unavailable"


def test_kv_router_mode_is_served():
    """A card's default router mode is kv: the manager builds a
    KvPushRouter over its endpoint (block size the card's), a frontend
    overriding every card to kv does the same, and each answers a
    request through it."""
    async def main():
        rt = await t_dist.DistributedRuntime.create(t_config.RuntimeConfig())
        fes = []
        try:
            card = t_card.ModelDeploymentCard(
                name="kv-model", tokenizer_kind="word",
                tokenizer_path="kv-model", kv_block_size=4)
            assert card.router_mode == "kv"
            handle = await t_entry.serve_engine(rt, EchoEngine(), card,
                                                instance_id=3)
            rr = t_card.ModelDeploymentCard(
                name="rr", tokenizer_kind="word", tokenizer_path="rr",
                component="rr", router_mode="round_robin")
            handle_rr = await t_entry.serve_engine(rt, EchoEngine(), rr,
                                                   instance_id=4)
            fes.append(await t_entry.start_frontend(rt, port=0))
            fes.append(await t_entry.start_frontend(
                rt, port=0, router_mode_override="kv"))
            out = []
            for fe in fes:
                routers = fe.manager.kv_routers()
                body = {"model": "kv-model", "max_tokens": 2,
                        "messages": [{"role": "user", "content": "a b c"}]}
                st, _, raw = await call(fe.http.port, "POST",
                                        "/v1/chat/completions", body)
                out.append((sorted(routers), st,
                            [type(r).__name__ for r in routers.values()],
                            [r.config.block_size for r in routers.values()]))
            await handle.stop()
            await handle_rr.stop()
            return out
        finally:
            for fe in fes:
                await fe.stop()
            await rt.close()

    default, override = asyncio.run(asyncio.wait_for(main(), 20))
    assert default == (["kv-model"], 200, ["KvPushRouter"], [4])
    assert override[0] == ["kv-model", "rr"] and override[1] == 200
    assert override[2] == ["KvPushRouter"] * 2


def test_worker_start_outlasting_the_lease_ttl_stays_discoverable(
        monkeypatch):
    """The worker's engine build holds its event loop for 2.2 s, more
    than twice its 1 s lease TTL; the worker takes its lease after the
    build, so its instance is discoverable and stays so."""
    orig = worker_main.build_engine_and_card

    def slow_build(args):
        time.sleep(2.2)             # a blocking build, as an 8B init is
        return orig(args)

    monkeypatch.setattr(worker_main, "build_engine_and_card", slow_build)

    async def main(url):
        args = worker_main.parse_args([
            "--echo", "--router-mode", "round_robin", "--store", url,
            "--lease-ttl", "1", "--instance-id", "7"])
        worker_main.check_args(args)
        objs = await worker_main.start_worker(args)
        watcher = await t_dist.DistributedRuntime.create(
            t_config.RuntimeConfig(store_url=url))
        try:
            seen = []
            for _ in range(12):         # 3 s: three TTLs
                kvs = await watcher.store.get_prefix("v1/instances/")
                seen.append([kv.key for kv in kvs])
                await asyncio.sleep(0.25)
            return seen
        finally:
            await watcher.close()
            await worker_main.stop_worker(objs)

    with StoreThread() as store:
        seen = asyncio.run(asyncio.wait_for(main(store.url), 30))
    assert all(keys == ["v1/instances/dynamo/backend/generate/7"]
               for keys in seen), seen


def test_run_cli_routes_text_and_batch_to_remote_workers(tmp_path):
    """`run in=batch:<file> out=dyn://dynamo.backend.generate --store
    tcp://...` finds the worker and its published card through the
    coordinator and routes the batch to it."""
    from dynamo_tpu_torch.run import main as run_main

    jobs = tmp_path / "jobs.jsonl"
    jobs.write_text('{"text": "alpha beta gamma"}\n'
                    '{"text": "one two", "max_tokens": 2}\n')
    out = tmp_path / "out.jsonl"

    async def main(url):
        fe, workers = await _echo_fleet(url, 1)
        try:
            _, _, rest = run_main.parse_io(["--store", url, "--max-tokens",
                                            "3", "--batch-output",
                                            str(out)])
            await run_main.amain(f"batch:{jobs}",
                                 "dyn://dynamo.backend.generate",
                                 run_main.parse_args(rest))
            return workers[0][1].requests
        finally:
            await _stop_fleet(fe, workers)

    with StoreThread() as store:
        served = asyncio.run(asyncio.wait_for(main(store.url), 30))
    assert served == 2
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    # the echo engine streams the templated prompt back
    assert [r["text"] for r in rows] == ["user: alpha beta", "user: one"]
    assert [r["completion_tokens"] for r in rows] == [3, 2]
    assert [r["finish_reason"] for r in rows] == ["length", "length"]


def test_https_frontend(tmp_path):
    """`--tls-cert-path` / `--tls-key-path`: the frontend serves HTTPS
    through the standard `ssl` module; half a TLS configuration is
    refused."""
    import ssl
    import subprocess

    cert, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048",
                    "-nodes", "-keyout", str(key), "-out", str(cert),
                    "-days", "1", "-subj", "/CN=localhost"],
                   check=True, capture_output=True, timeout=60)

    def get(port):
        ctx = ssl.create_default_context(cafile=str(cert))
        conn = http.client.HTTPSConnection("localhost", port, context=ctx,
                                           timeout=30)
        try:
            conn.request("GET", "/live")
            r = conn.getresponse()
            return r.status, json.loads(r.read())
        finally:
            conn.close()

    async def main():
        rt = await t_dist.DistributedRuntime.create(t_config.RuntimeConfig())
        try:
            with pytest.raises(ValueError, match="together"):
                await t_entry.start_frontend(rt, port=free_port(),
                                             tls_cert=str(cert))
            fe = await t_entry.start_frontend(rt, port=free_port(),
                                              tls_cert=str(cert),
                                              tls_key=str(key))
            try:
                assert fe.url.startswith("https://")
                return await asyncio.wait_for(
                    asyncio.to_thread(get, fe.http.port), 30)
            finally:
                await fe.stop()
        finally:
            await rt.close()

    assert asyncio.run(asyncio.wait_for(main(), 60)) == (200,
                                                         {"status": "live"})


def test_client_disconnect_cancels_the_worker_stream():
    """A client that closes its connection mid-stream cancels the
    request's context; the cancel frame stops the worker's engine."""
    import socket

    body = json.dumps({"model": "echo", "max_tokens": 16, "stream": True,
                       "messages": [{"role": "user", "content": " ".join(
                           f"w{i}" for i in range(16))}]}).encode()

    def read_two_chunks_and_hang_up(port):
        with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
            s.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Type: application/json\r\nContent-Length: "
                      + str(len(body)).encode() + b"\r\n\r\n" + body)
            got = b""
            while got.count(b"data: ") < 3:
                got += s.recv(65536)
        return got

    async def main(url):
        fe, workers = await _echo_fleet(url, 1, delay_ms=50.0)
        try:
            head = await asyncio.wait_for(asyncio.to_thread(
                read_two_chunks_and_hang_up, fe.http.port), 30)
            eng = workers[0][1]
            await asyncio.wait_for(eng.cancelled.wait(), 10)
            emitted = eng.emitted
            await asyncio.sleep(0.2)
            metrics = (await call(fe.http.port, "GET", "/metrics"))[2]
            return head, emitted, eng.emitted, metrics
        finally:
            await _stop_fleet(fe, workers)

    with StoreThread() as store:
        head, emitted, later, metrics = asyncio.run(
            asyncio.wait_for(main(store.url), 30))
    assert head.startswith(b"HTTP/1.1 200 OK\r\n")
    assert b"Transfer-Encoding: chunked" in head
    assert emitted == later < 16
    assert b'dynamo_http_requests_total{endpoint="chat_completions",' \
           b'status="disconnect"} 1.0' in metrics
