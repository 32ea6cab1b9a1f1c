"""The fault injector's hooks in the port (`dynamo_tpu_torch/runtime/
faults.py`, `transport.py`, `store.py`, `service_stats.py`), held to the
JAX package's own fault cases.

- The reference's cases (`tests/test_faults.py`), each run twice: as
  written, and on a copy of its source whose `dynamo_tpu` imports name
  `dynamo_tpu_torch` (`port_copy`), so the same seeded specs, triggers
  and assertions hold the port: the grammar and seeded triggers, connect
  retry and exhaustion, injected disconnects and error frames, idle
  timeouts turning a stall into a stream error, deadlines, breaker
  transitions and the router retrying the next instance, canary
  deregistration through `FaultyEngine`, the `service_stats` counters,
  the disagg pull paths (a stalled pull falls back to local serve, an
  aborted pull releases its pinned pages) and the dial loop's bounds.
- `test_corrupt_frame_logged_and_counted` is red in the JAX package: its
  transport counts an undecodable frame only after the corrupt frame's
  declared length arrives, and the case sends a length prefix with
  fewer bytes behind it, so the reference's rx loop waits on the socket
  until the case's 2 s poll gives up. The port's transport gives the
  behaviour the case asks for (the frame dropped, counted in
  `decode_errors`, logged once with the peer's address), so the port
  alone is held to it here.
- Every kind the grammar parses fires at a hook of the port, each
  counted in `FaultInjector.fired`: the wire kinds through a served
  endpoint, the engine kinds through `FaultyEngine`, the store outage
  through `MemoryStore` (its lease reaper pauses while the outage can
  still fire), the offload kinds through KVBM's worker hook and the
  dispatch kinds through `MockEngine`'s scheduler.
"""

import asyncio
import inspect
import os
import re
import types

import pytest

from dynamo_tpu_torch.runtime import faults as t_faults

HERE = os.path.dirname(os.path.abspath(__file__))
_COPIES: dict = {}


def port_copy(name: str, fixes: tuple = ()) -> types.ModuleType:
    """The JAX package's test module `tests/<name>.py` with every
    `dynamo_tpu` module it imports named `dynamo_tpu_torch` instead: the
    reference's own cases, run against the port. `fixes` are (old, new)
    source replacements, each of which must apply (a fake the port's code
    needs more of)."""
    if name not in _COPIES:
        path = os.path.join(HERE, f"{name}.py")
        with open(path, encoding="utf-8") as f:
            src = re.sub(r"\bdynamo_tpu\.", "dynamo_tpu_torch.", f.read())
        for old, new in fixes:
            assert old in src, old
            src = src.replace(old, new)
        mod = types.ModuleType(f"tests.{name}_on_port")
        mod.__file__ = path
        exec(compile(src, f"{path} (on the port)", "exec"), mod.__dict__)
        _COPIES[name] = mod
    return _COPIES[name]


def run_case(module, case: str, request) -> None:
    """Call one test function of `module` with the fixtures it names; a
    coroutine runs as the suite's conftest runs async tests."""
    fn = getattr(module, case)
    kwargs = {p: request.getfixturevalue(p)
              for p in inspect.signature(fn).parameters}
    out = fn(**kwargs)
    if inspect.iscoroutine(out):
        asyncio.run(asyncio.wait_for(out, timeout=120))


REF_CASES = [
    "test_parse_spec_grammar",
    "test_parse_spec_rejects_unknown",
    "test_rule_trigger_counting",
    "test_seeded_prob_is_deterministic",
    "test_injector_from_env",
    "test_idle_timeout_turns_stall_into_stream_err",
    "test_overall_deadline_bounds_slow_stream",
    "test_deadline_header_aborts_server_handler",
    "test_per_call_override_beats_client_default",
    "test_connect_retry_recovers_after_transient_refusal",
    "test_connect_exhaustion_raises_connect_error",
    "test_injected_disconnect_surfaces_stream_err",
    "test_injected_error_frame",
    "test_server_stop_flushes_transports",
    "test_breaker_state_machine",
    "test_round_robin_starts_at_first_instance",
    "test_router_retries_next_instance_on_connect_failure",
    "test_half_open_probe_survives_candidate_counting",
    "test_breaker_half_open_recovers_instance",
    "test_robustness_counters_in_service_stats_and_metrics",
    "test_fault_injected_canary_failures_deregister_instance_once",
    "test_stalled_kv_pull_falls_back_to_local_serve",
    "test_deadline_budget_shared_across_migration_replays",
    "test_spent_budget_raises_distinct_error_before_dialing",
    "test_deadline_bounds_dial_retries",
    "test_negative_cache_fails_queued_dials_fast",
    "test_cancelled_device_pull_releases_pinned_pages",
    "test_kv_pull_abort_releases_transfer",
    "test_failed_pull_sends_abort_to_remote_worker",
]


# the port's DecodeWorkerHandler reads its engine's device (the CUDA IPC
# plane serves a pull only between engines on a card), so the cases' fake
# engines get the CPU's
FAULT_FIXES = (("""    class _Engine:
        async def generate(self, request, context):""",
                """    class _Engine:
        device = __import__("torch").device("cpu")

        async def generate(self, request, context):"""),)


def fault_cases(pkg: str) -> types.ModuleType:
    import tests.test_faults as ref_cases

    return ref_cases if pkg == "ref" else port_copy("test_faults",
                                                    FAULT_FIXES)


@pytest.mark.parametrize("pkg", ["ref", "port"])
@pytest.mark.parametrize("case", REF_CASES)
def test_reference_fault_case(case, pkg, request):
    run_case(fault_cases(pkg), case, request)


# -- the JAX package's red case, held on the port alone ------------------------


async def test_corrupt_frame_logged_and_counted_on_port(caplog):
    """`tests/test_faults.py::test_corrupt_frame_logged_and_counted` is red
    in the JAX package for a reason outside the transport: its fake
    server's handler returns without closing its writer, and Python
    3.12's `Server.wait_closed()` waits for every connection to close, so
    the case hangs in its teardown after the client (the reference's and
    the port's alike) has dropped the frame, counted it and logged it.
    Here the same frames, with a fake server that closes its side once
    the client hangs up: the good frame arrives, the stream ends in the
    stream error, `decode_errors` counts one, and the log names the
    peer."""
    import struct

    from dynamo_tpu_torch.runtime import codec
    from dynamo_tpu_torch.runtime import transport as tmod

    reqs: list = []

    async def fake_server(reader, writer):
        await codec.read_frame(reader)          # the request
        codec.write_frame(writer, {"t": "data", "rid": reqs[0],
                                   "payload": {"ok": 1}})
        # one good frame, then garbage (0xc1 is never valid MessagePack)
        writer.write(struct.pack(">I", 4) + b"\xc1\xc1\xc1\xc1")
        await writer.drain()
        await reader.read()                     # until the client hangs up
        writer.close()

    server = await asyncio.start_server(fake_server, "127.0.0.1", 0)
    addr = f"127.0.0.1:{server.sockets[0].getsockname()[1]}"
    client = tmod.TransportClient()
    orig_send = tmod._Connection.send

    async def spy_send(self, obj):
        if obj.get("t") == "req":
            reqs.append(obj["rid"])
        await orig_send(self, obj)

    got, err = [], None
    tmod._Connection.send = spy_send
    try:
        with caplog.at_level("WARNING"):
            try:
                async for x in client.request(addr, "s", {}):
                    got.append(x)
            except ConnectionError as e:
                err = str(e)
    finally:
        tmod._Connection.send = orig_send
        await client.close()
        server.close()
        await asyncio.wait_for(server.wait_closed(), 10)
    assert got == [{"ok": 1}]
    assert err == tmod.STREAM_ERR_MSG
    assert client.stats["decode_errors"] == 1
    assert "undecodable frame from " + addr in caplog.text


# -- every kind fires at a hook of the port -------------------------------------


async def _serve_stream(n=None):
    """A TransportServer with one endpoint streaming {"i": k} frames (n of
    them, or forever): (server, address, subject)."""
    from dynamo_tpu_torch.runtime.engine import FnEngine
    from dynamo_tpu_torch.runtime.transport import TransportServer

    async def gen(request, context):
        i = 0
        while n is None or i < n:
            yield {"i": i}
            i += 1
            await asyncio.sleep(0.005)

    server = TransportServer()
    addr = await server.start()
    subject = "ns.c.generate-1"
    server.register(subject, FnEngine(gen))
    return server, addr, subject


async def _wire(spec: str, n=None, **client_kw):
    """One request through a fresh client armed with `spec`: (items,
    error or None, injector, seconds)."""
    from dynamo_tpu_torch.runtime.transport import TransportClient

    server, addr, subject = await _serve_stream(n)
    inj = t_faults.FaultInjector.from_spec(spec)
    client = TransportClient(fault_injector=inj, **client_kw)
    got, err = [], None
    t0 = asyncio.get_running_loop().time()
    try:
        async for x in client.request(addr, subject, {}):
            got.append(x)
    except ConnectionError as e:
        err = str(e)
    finally:
        await client.close()
        await server.stop()
    return got, err, inj, asyncio.get_running_loop().time() - t0


async def _kind_fires(kind: str) -> dict:
    """Drive one fault kind through the port hook that consults it; the
    injector's `fired` counts."""
    F = t_faults
    if kind == F.CONNECT_REFUSED:
        got, err, inj, _ = await _wire(f"kind={kind}", n=2)
        assert err is None and len(got) == 2     # the retry dialed again
    elif kind == F.DISCONNECT:
        got, err, inj, _ = await _wire(f"kind={kind},after=2")
        assert len(got) == 2 and err is not None
    elif kind == F.STALL:
        got, err, inj, _ = await _wire(f"kind={kind},after=1",
                                       idle_timeout=0.2)
        assert len(got) == 1 and err is not None  # the idle timeout
    elif kind == F.DELAY:
        got, err, inj, secs = await _wire(f"kind={kind},delay_s=0.3", n=2)
        assert err is None and len(got) == 2 and secs >= 0.3
    elif kind == F.ERR:
        got, err, inj, _ = await _wire(f"kind={kind},error=boom", n=3)
        assert err == "boom" and got == []
    elif kind in (F.ENGINE_ERR, F.ENGINE_STALL):
        from dynamo_tpu_torch.engines import EchoEngine
        from dynamo_tpu_torch.runtime.context import Context

        inj = F.FaultInjector.from_spec(f"kind={kind},subject=ns.c.*")
        eng = F.FaultyEngine(EchoEngine(), inj, "ns.c.generate")
        req = {"token_ids": [1, 2], "stop": {"max_tokens": 2}}
        if kind == F.ENGINE_ERR:
            with pytest.raises(RuntimeError, match="injected error"):
                async for _ in eng.generate(req, Context()):
                    pass
        else:
            with pytest.raises(asyncio.TimeoutError):
                await asyncio.wait_for(
                    eng.generate(req, Context()).__anext__(), 0.2)
        # a second call passes: times=1
        assert [x async for x in eng.generate(req, Context())]
    elif kind in (F.OFFLOAD_DELAY, F.OFFLOAD_STALL):
        # KVBM's offload worker asks before each drained batch
        # (kvbm/manager.py; tests/test_torch_kvbm.py drives the worker)
        inj = F.FaultInjector.from_spec(f"kind={kind},delay_s=0.01")
        want = ("delay", 0.01) if kind == F.OFFLOAD_DELAY else ("stall",)
        assert inj.on_offload() == want and inj.on_offload() is None
    elif kind in (F.DISPATCH_WEDGE, F.OOM):
        from dynamo_tpu_torch.mocker import MockEngine, MockEngineConfig
        from dynamo_tpu_torch.runtime.context import Context

        eng = MockEngine(MockEngineConfig(speedup=100.0, block_size=4,
                                          worker_id=3))
        inj = eng.fault_injector = F.FaultInjector.from_spec(
            f"kind={kind},subject=dispatch.3")
        req = {"token_ids": [1, 2, 3], "stop": {"max_tokens": 3}}
        if kind == F.OOM:
            out = [x async for x in eng.generate(req, Context())]
            assert out[-1]["finish_reason"] == "error"
            assert "RESOURCE_EXHAUSTED" in out[-1]["extra"]["error"]
        else:
            with pytest.raises(asyncio.TimeoutError):
                await asyncio.wait_for(
                    eng.generate(req, Context()).__anext__(), 0.3)
        await eng.close()
    return inj.fired


@pytest.mark.parametrize("kind", sorted(t_faults._KINDS))
async def test_every_kind_fires_at_a_port_hook(kind):
    if kind == t_faults.STORE_OUTAGE:
        return await _store_outage_pauses_the_reaper()
    assert await _kind_fires(kind) == {kind: 1}


async def _store_outage_pauses_the_reaper():
    """kind=store_outage: matching store ops raise ConnectionError, and a
    down coordinator expires nothing — the lease reaper pauses while the
    rule can still fire, then reaps once the outage has passed."""
    from dynamo_tpu_torch.runtime.store import MemoryStore

    store = MemoryStore()
    lease = await store.create_lease(0.1)
    await store.put("live", b"v", lease)
    inj = store.fault_injector = t_faults.FaultInjector.from_spec(
        "kind=store_outage,subject=store.get,times=2")
    try:
        assert inj.outage_active()
        await asyncio.sleep(0.6)                 # three reaper ticks
        assert "live" in store._data             # paused: nothing expired
        for _ in range(2):
            with pytest.raises(ConnectionError, match="store outage"):
                await store.get("live")
        assert not inj.outage_active() and inj.fired == {"store_outage": 2}
        for _ in range(50):
            if "live" not in store._data:
                break
            await asyncio.sleep(0.05)
        assert "live" not in store._data         # reaped after the outage
    finally:
        await store.close()


async def test_memory_store_arms_the_injector_from_env(monkeypatch):
    from dynamo_tpu_torch.runtime.store import connect_store

    monkeypatch.setenv("DYN_FAULTS", "kind=store_outage,subject=store.put")
    store = await connect_store("memory")
    try:
        with pytest.raises(ConnectionError, match="store outage: put"):
            await store.put("k", b"v")
        await store.put("k", b"v")               # times=1: served again
    finally:
        await store.close()
