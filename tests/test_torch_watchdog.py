"""The port's dispatch watchdog, quarantine, progress token and adaptive
idle timeout held against the JAX package's.

- `tests/test_healing.py` cases on both packages: the watchdog is off by
  default (`:75`); it trips exactly once on a wedged dispatch (`:103`:
  the reference's mocker under its seeded `dispatch_wedge`, the port's
  tiny `TorchEngine` with one dispatch held in its device thread) with
  the same event keys, cause, event-plane message and counter; an idle
  engine never trips (`:151`); quarantine deregisters and flags (`:167`),
  and a stream in flight gets the err frame `Migration` replays.
- The two adaptive-idle cases of `tests/test_runtime_transport.py`
  (`:163`, `:208`) on both packages.
- `TorchEngine.progress_token` advances as `TpuEngine`'s does over the
  same requests.
- `DYN_WATCHDOG_PREFLIGHT` is refused by the port (the device preflight
  waits with the doctor); the worker CLI refuses it before building.
"""

import asyncio
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynamo_tpu.engine.watchdog as ref_wd
import dynamo_tpu.runtime.config as ref_config
import dynamo_tpu.runtime.context as ref_ctx
import dynamo_tpu.runtime.distributed as ref_dist
import dynamo_tpu.runtime.engine as ref_engine
import dynamo_tpu.runtime.metrics as ref_metrics
import dynamo_tpu.runtime.transport as ref_transport
import dynamo_tpu.worker.quarantine as ref_q
import dynamo_tpu_torch.engine.watchdog as port_wd
import dynamo_tpu_torch.runtime.config as port_config
import dynamo_tpu_torch.runtime.context as port_ctx
import dynamo_tpu_torch.runtime.distributed as port_dist
import dynamo_tpu_torch.runtime.engine as port_engine
import dynamo_tpu_torch.runtime.metrics as port_metrics
import dynamo_tpu_torch.runtime.transport as port_transport
import dynamo_tpu_torch.worker.quarantine as port_q
from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.mocker.engine import MockEngine, MockEngineConfig
from dynamo_tpu.models import llama as jl
from dynamo_tpu.runtime.faults import FaultInjector
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_jax

PKGS = {
    "ref": types.SimpleNamespace(
        wd=ref_wd, config=ref_config, ctx=ref_ctx, dist=ref_dist,
        eng=ref_engine, metrics=ref_metrics, transport=ref_transport,
        q=ref_q, itl="dynamo_engine_itl_ms"),
    "port": types.SimpleNamespace(
        wd=port_wd, config=port_config, ctx=port_ctx, dist=port_dist,
        eng=port_engine, metrics=port_metrics, transport=port_transport,
        q=port_q, itl="dynamo_engine_itl_ms"),
}
ENGINE_KW = dict(num_pages=64, max_batch_size=4, prefill_chunk=32,
                 min_prefill_bucket=8, default_max_tokens=8,
                 decode_steps_per_sync=2)
BS = 16


def request(tokens, max_tokens=4):
    return {"token_ids": tokens, "model": "m",
            "stop": {"max_tokens": max_tokens, "ignore_eos": True},
            "sampling": {"temperature": 0.0}}


def tiny_models():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    params = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return jcfg, params, tcfg, model


def torch_engine():
    _, _, tcfg, model = tiny_models()
    return TorchEngine(TorchEngineConfig(model=tcfg, device="cpu",
                                         **ENGINE_KW), model=model)


def mock_engine(worker_id=1):
    return MockEngine(MockEngineConfig(
        block_size=BS, worker_id=worker_id, speedup=200.0,
        total_kv_blocks=64))


class Wedge:
    """Holds the engine's `after`-th dispatch in its device thread until
    released: the port's counterpart of the mocker's dispatch_wedge."""

    def __init__(self, engine, after=0):
        self.release = threading.Event()
        self.fired = 0
        self.calls = 0
        run = engine.graphs.run

        def wedged(key, fn, inputs):
            self.calls += 1
            if self.calls > after and not self.fired:
                self.fired += 1
                self.release.wait(30)
            return run(key, fn, inputs)

        engine.graphs.run = wedged


# -- off by default (test_healing.py:75) -------------------------------------

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_watchdog_off_by_default(pkg, monkeypatch):
    P = PKGS[pkg]
    monkeypatch.delenv(P.wd.ENV_STALL, raising=False)
    monkeypatch.delenv(P.wd.ENV_PREFLIGHT, raising=False)
    eng = object()
    assert P.wd.watchdog_from_env(eng) is None
    monkeypatch.setenv(P.wd.ENV_STALL, "0")
    assert P.wd.watchdog_from_env(eng) is None
    monkeypatch.setenv(P.wd.ENV_STALL, "banana")
    assert P.wd.watchdog_from_env(eng) is None
    monkeypatch.setenv(P.wd.ENV_STALL, "2.5")
    wd = P.wd.watchdog_from_env(eng, instance="x")
    assert wd is not None and wd.stall_s == 2.5 and wd._thread is None
    assert (P.wd.ENV_STALL, P.wd.ENV_PREFLIGHT,
            P.wd.WATCHDOG_EVENTS_SUBJECT) == (
        ref_wd.ENV_STALL, ref_wd.ENV_PREFLIGHT,
        ref_wd.WATCHDOG_EVENTS_SUBJECT)


def test_watchdog_preflight_is_refused(monkeypatch):
    """The reference runs its device preflight on a trip when
    DYN_WATCHDOG_PREFLIGHT is truthy; the port refuses the variable (the
    doctor is not ported) and never ignores it; the worker CLI refuses it
    before anything is built."""
    from dynamo_tpu_torch.worker import main as worker_main

    monkeypatch.setenv(port_wd.ENV_STALL, "2")
    monkeypatch.setenv(port_wd.ENV_PREFLIGHT, "1")
    assert ref_wd.watchdog_from_env(object()).run_preflight is True
    with pytest.raises(ValueError, match="doctor"):
        port_wd.watchdog_from_env(object())
    monkeypatch.delenv(port_wd.ENV_STALL)
    with pytest.raises(ValueError, match="DYN_WATCHDOG_PREFLIGHT"):
        port_wd.watchdog_from_env(object())
    with pytest.raises(SystemExit, match="DYN_WATCHDOG_PREFLIGHT"):
        worker_main.check_args(worker_main.parse_args(
            ["--echo", "--router-mode", "round_robin"]))
    monkeypatch.setenv(port_wd.ENV_PREFLIGHT, "0")
    assert port_wd.watchdog_from_env(object()) is None


# -- trip on a wedged dispatch (test_healing.py:103) -------------------------

async def _trip(P, eng, wedge_release=None):
    rt = await P.dist.DistributedRuntime.create(
        P.config.RuntimeConfig(store_url="memory"))
    sub = await rt.events.subscribe(P.wd.WATCHDOG_EVENTS_SUBJECT)
    trips: list[dict] = []
    wd = P.wd.DispatchWatchdog(eng, 0.25, runtime=rt, instance="1",
                               on_trip=trips.append)
    consume = None
    try:
        wd.start()

        async def _consume():
            async for _ in eng.generate(request(list(range(BS))),
                                        P.ctx.Context()):
                pass

        consume = asyncio.get_running_loop().create_task(_consume())
        for _ in range(200):
            if wd.tripped is not None and trips:
                break
            await asyncio.sleep(0.05)
        assert wd.tripped is not None, "watchdog never tripped"
        ev = wd.tripped
        assert ev["instance"] == "1" and ev["pending"] >= 1
        assert ev["stalled_s"] >= 0.25
        assert "dispatch watchdog" in ev["detail"]
        msg = await asyncio.wait_for(sub.queue.get(), 2.0)
        assert msg["payload"] == ev
        assert trips == [ev]
        assert wd._counter.get(cause=ev["cause"]) == 1
        assert "dynamo_watchdog_trips_total" in rt.metrics.render()
        await asyncio.sleep(0.6)        # trips once, then stands down
        assert trips == [ev]
        return ev, wd
    finally:
        wd.stop()
        if wedge_release is not None:
            wedge_release.set()
        if consume is not None:
            consume.cancel()
            await asyncio.gather(consume, return_exceptions=True)
        await eng.close()
        await rt.close()


async def test_watchdog_trips_on_wedged_dispatch():
    """The reference's mocker under dispatch_wedge and the port's engine
    with one dispatch held in its device thread: one trip each, the same
    event keys and diagnosed cause, published on the event plane and
    counted; the port's watchdog records the stall it saw."""
    ref_eng = mock_engine()
    ref_eng.fault_injector = FaultInjector.from_spec("kind=dispatch_wedge")
    want, _ = await _trip(PKGS["ref"], ref_eng)
    eng = torch_engine()
    wedge = Wedge(eng)
    got, wd = await _trip(PKGS["port"], eng, wedge.release)
    assert wedge.fired == 1
    assert set(got) == set(want)
    assert got["cause"] == want["cause"]
    assert got["detail"].split(" for ")[0] == want["detail"].split(
        " for ")[0]
    assert round(wd.longest_stall_s, 3) >= got["stalled_s"]


@pytest.mark.parametrize("pkg", sorted(PKGS))
async def test_watchdog_idle_engine_never_trips(pkg):
    """No work pending ⇒ silence is idleness, not a wedge (the port on a
    tiny TorchEngine). The engine serves a request first and the watchdog
    arms once it is idle: a first dispatch on a loaded host may itself
    outlast the 0.1 s threshold, which is a stall, not idleness."""
    P = PKGS[pkg]
    eng = mock_engine() if pkg == "ref" else torch_engine()
    wd = P.wd.DispatchWatchdog(eng, 0.1, instance="idle")
    try:
        async for _ in eng.generate(request([1, 2, 3], 2), P.ctx.Context()):
            pass
        while eng._running or eng._waiting:
            await asyncio.sleep(0.01)
        wd.start()
        await asyncio.sleep(0.5)   # many stall windows, zero work
        assert wd.tripped is None
    finally:
        wd.stop()
        await eng.close()


# -- quarantine (test_healing.py:167) -----------------------------------------

async def _quarantine(P, eng, wedge=None):
    rt = await P.dist.DistributedRuntime.create(
        P.config.RuntimeConfig(store_url="memory"))
    try:
        ep = rt.namespace("ns").component("c").endpoint("gen")
        served = await ep.serve(eng, instance_id=7)
        client = await ep.client()
        await client.start()
        await client.wait_ready()
        assert len(client.instances()) == 1
        # a stream in flight over the wire, held by the engine
        got: list = []

        async def stream():
            async for item in rt.transport_client.request(
                    rt.transport_address, served.instance.subject,
                    request(list(range(BS)), 32)):
                got.append(item)

        task = asyncio.get_running_loop().create_task(stream())
        for _ in range(200):
            if wedge is None or wedge.fired:
                break
            await asyncio.sleep(0.02)
        await asyncio.sleep(0.1)
        await P.q.quarantine_worker(rt, served, eng, reason="test",
                                    exit_process=False)
        if wedge is not None:
            wedge.release.set()
        with pytest.raises(ConnectionError) as err:
            await asyncio.wait_for(task, 10)
        assert getattr(eng, "_quarantined", False) is True
        for _ in range(100):
            if not client.instances():
                break
            await asyncio.sleep(0.02)
        assert client.instances() == []
        assert P.q.QUARANTINE_EXIT_CODE == 44
        await client.stop()
        return str(err.value)
    finally:
        await eng.close()
        await rt.close()


async def test_quarantine_deregisters_and_flags_engine():
    """Deregistered, flagged, and the in-flight stream answered with the
    err frame Migration replays: in the reference (mocker, slow) and in
    the port (TorchEngine with a held dispatch)."""
    ref_eng = mock_engine(worker_id=7)
    ref_eng.config.speedup = 0.05       # the stream is still running
    want = await _quarantine(PKGS["ref"], ref_eng)
    eng = torch_engine()
    wedge = Wedge(eng, after=1)
    got = await _quarantine(PKGS["port"], eng, wedge)
    assert want == got == port_transport.STREAM_ERR_MSG
    assert ref_transport.STREAM_ERR_MSG == port_transport.STREAM_ERR_MSG


# -- adaptive idle (test_runtime_transport.py:163, :208) ----------------------

async def slow_then_fast(request, context):
    yield {"i": 0}
    await asyncio.sleep(request["stall_s"])
    yield {"i": 1}


@pytest.mark.parametrize("pkg", sorted(PKGS))
async def test_adaptive_idle_provider_widens_static_timeout(pkg):
    P = PKGS[pkg]
    T = P.transport
    server = T.TransportServer()
    server.register("s.c.slow", P.eng.FnEngine(slow_then_fast))
    addr = await server.start()
    tight = T.TransportClient(idle_timeout=0.05)
    try:
        with pytest.raises(ConnectionError):
            _ = [x async for x in tight.request(
                addr, "s.c.slow", {"stall_s": 0.3})]
        assert tight.stats["idle_timeouts"] == 1
    finally:
        await tight.close()
    adaptive = T.TransportClient(idle_timeout=0.05,
                                 idle_timeout_provider=lambda: 1.0)
    try:
        out = [x async for x in adaptive.request(
            addr, "s.c.slow", {"stall_s": 0.3})]
        assert [o["i"] for o in out] == [0, 1]
        with pytest.raises(ConnectionError):
            _ = [x async for x in adaptive.request(
                addr, "s.c.slow", {"stall_s": 0.3}, idle_timeout=0.05)]
    finally:
        await adaptive.close()
    broken = T.TransportClient(
        idle_timeout=0.0,
        idle_timeout_provider=lambda: (_ for _ in ()).throw(ValueError()))
    try:
        out = [x async for x in broken.request(
            addr, "s.c.slow", {"stall_s": 0.05})]
        assert len(out) == 2
    finally:
        await broken.close()
        await server.stop()


async def _derived(P, margin, samples, value_ms):
    rt = await P.dist.DistributedRuntime.create(P.config.RuntimeConfig(
        store_url="memory", stream_idle_adaptive_margin=margin))
    try:
        wired = rt.transport_client.idle_timeout_provider is not None
        out = [rt._adaptive_idle_timeout()]
        h = P.metrics.Histogram(P.itl, "itl ms",
                                buckets=[1.0, 4.0, 16.0, 64.0, 256.0])
        rt.metrics.register(h)
        for i in range(samples):
            h.observe(value_ms)
            if i + 2 >= rt.ADAPTIVE_IDLE_MIN_SAMPLES:
                out.append(rt._adaptive_idle_timeout())
        return wired, out
    finally:
        await rt.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
async def test_runtime_adaptive_idle_from_observed_gaps(pkg):
    """p99.9 of the engine's ITL histogram × margin, only past 100
    samples and only with the margin set; the port derives what the
    reference derives from the same samples."""
    P = PKGS[pkg]
    wired, out = await _derived(P, 3.0, 100, 8.0)
    assert wired and out[0] == 0.0
    assert out[1] == 0.0                         # below the sample gate
    assert 0.008 * 3 * 0.5 < out[2] < 0.2
    wired0, out0 = await _derived(P, 0.0, 100, 8.0)
    assert not wired0 and all(v == 0.0 for v in out0)
    assert out == (await _derived(PKGS["ref"], 3.0, 100, 8.0))[1]


async def test_frontend_http_itl_feeds_the_adaptive_timeout():
    """Without an engine in the process (a frontend), the HTTP
    inter-token histogram feeds it, in seconds, as in the reference."""
    outs = []
    for P in (PKGS["ref"], PKGS["port"]):
        rt = await P.dist.DistributedRuntime.create(P.config.RuntimeConfig(
            store_url="memory", stream_idle_adaptive_margin=2.0))
        try:
            h = rt.metrics.child("http").histogram(
                "inter_token_latency_seconds", "ITL",
                buckets=(0.0001, 0.001, 0.005, 0.01, 0.025, 0.05, 0.1))
            for _ in range(150):
                h.observe(0.02)
            outs.append(rt._adaptive_idle_timeout())
        finally:
            await rt.close()
    assert outs[0] == outs[1] == pytest.approx(0.05)


# -- the progress token --------------------------------------------------------

async def _progress(eng, reqs):
    async def one(toks, n):
        async for _ in eng.generate(request(toks, n), ref_ctx.Context()
                                    if isinstance(eng, TpuEngine)
                                    else port_ctx.Context()):
            pass

    seen = [eng.progress_token()]
    for wave in reqs:
        await asyncio.gather(*(one(t, n) for t, n in wave))
        seen.append(eng.progress_token())
    await eng.close()
    return seen


async def test_progress_token_advances_as_tpu_engine():
    """The same waves of greedy requests through both engines: the token
    counts each scheduler iteration that dispatched work, the same number
    in the port as in the reference, and never moves while idle."""
    jcfg, params, tcfg, model = tiny_models()
    waves = [[([5, 6, 7], 3)],
             [([1] * 20, 5), ([2] * 9, 2)],
             [([3] * 40, 6), ([4] * 5, 1), ([9] * 12, 4)]]
    want = await _progress(TpuEngine(TpuEngineConfig(model=jcfg,
                                                     **ENGINE_KW),
                                     params=params), waves)
    eng = TorchEngine(TorchEngineConfig(model=tcfg, device="cpu",
                                        **ENGINE_KW), model=model)
    got = await _progress(eng, waves)
    assert got == want
    assert got[0] == 0 and all(b > a for a, b in zip(got, got[1:]))
