"""The port's mocker (`dynamo_tpu_torch/mocker/`) held to the JAX
package's, byte for byte: it is host logic, so events, tokens, metrics and
bodies are equal.

- The JAX package's own mocker cases (`tests/test_mocker.py`: prefix
  reuse, LRU eviction, capacity refusal, echo then count, batching,
  events and metrics, preemption under KV pressure, cancellation, the
  echo engine), as written and on the port (`port_copy`).
- `MockKvManager`: seeded op sequences (allocate, append, free, clear)
  into both packages' managers give the same results, the same events and
  the same usage after every op.
- `MockEngine` on scripted requests (all queued before the scheduler's
  first iteration, so its iterations are the same in both packages): the
  same streams, KV events and ForwardPassMetrics; the same under KV
  pressure (preemption), with a cancelled request, and with the step
  recorder, the KV lifecycle recorder and the memory ledger armed (their
  per-entry counts, lifecycle summaries and ledger classes equal).
- The environment planes: with `DYN_TENANCY` both packages' quota gates
  refuse an over-quota tenant's second request, and the port's
  `MockEngine`, `TorchEngine` and HTTP frontend arm the tenancy plane
  (and `DYN_CLASSES` the serving-class plane) as the reference's do;
  `DYN_MESH_RECORDER` is still refused by name, and `DYN_SERVING_CLASSES`
  (a name the reference never reads) is no plane at all.
- Mock workers behind a KV-routed frontend, each package's behind the
  other's (over one coordinator): the same bodies, and A + a suffix lands
  on A's worker.
- The port's `MockEngine` and `TorchEngine` publish the same `stored` seq
  hashes for the same prompt, so a router cannot tell them apart.
- `python -m dynamo_tpu_torch.mocker` serves as a subprocess with no jax
  and no `dynamo_tpu` module loaded.
"""

import asyncio
import os
import random

import pytest

from dynamo_tpu import mocker as r_mock
from dynamo_tpu import protocols as rp
from dynamo_tpu import tokens as r_tokens
from dynamo_tpu.llm import entrypoint as r_entry
from dynamo_tpu.llm import model_card as r_card
from dynamo_tpu.runtime import config as r_config
from dynamo_tpu.runtime import context as r_ctx
from dynamo_tpu.runtime import distributed as r_dist
from dynamo_tpu_torch import mocker as t_mock
from dynamo_tpu_torch import protocols as tp
from dynamo_tpu_torch import tokens as t_tokens
from dynamo_tpu_torch.llm import entrypoint as t_entry
from dynamo_tpu_torch.llm import model_card as t_card
from dynamo_tpu_torch.runtime import config as t_config
from dynamo_tpu_torch.runtime import context as t_ctx
from dynamo_tpu_torch.runtime import distributed as t_dist
from tests.test_torch_faults import port_copy, run_case

PKGS = {"ref": (r_mock, rp, r_tokens, r_ctx),
        "port": (t_mock, tp, t_tokens, t_ctx)}
REF_CASES = ["test_kv_manager_prefix_reuse_and_events",
             "test_kv_manager_lru_eviction_emits_removed",
             "test_kv_manager_capacity_refusal",
             "test_mock_engine_echo_then_counts",
             "test_mock_engine_concurrent_batching",
             "test_mock_engine_publishes_events_and_metrics",
             "test_mock_engine_kv_pressure_preemption",
             "test_mock_engine_cancellation",
             "test_echo_engine"]


@pytest.mark.parametrize("pkg", ["ref", "port"])
@pytest.mark.parametrize("case", REF_CASES)
def test_reference_mocker_case(case, pkg, request):
    import tests.test_mocker as ref_cases

    run_case(ref_cases if pkg == "ref" else port_copy("test_mocker"),
             case, request)


# -- MockKvManager -----------------------------------------------------------

def _kv_ops(pkg: str, seed: int) -> list:
    mock, proto, tokens, _ = PKGS[pkg]
    rng = random.Random(seed)
    events = []
    kv = mock.MockKvManager(total_blocks=12, block_size=2, worker_id=4,
                            event_sink=events.append)
    prompts = [[rng.randrange(6) for _ in range(rng.randint(2, 12))]
               for _ in range(8)]
    held, log = [], []
    for _ in range(120):
        op = rng.random()
        if op < 0.45:
            seq = tokens.TokenBlockSequence(2, rng.choice(prompts))
            ok = kv.allocate_sequence(seq)
            if ok:
                held.append(seq)
            res = ("alloc", ok, kv.prefix_match_blocks(seq),
                   kv.blocks_to_activate(seq))
        elif op < 0.65 and held:
            seq = rng.choice(held)
            blk = seq.append(rng.randrange(6))
            seq.append(rng.randrange(6))
            blk = seq.blocks[-1]
            res = ("append", kv.append_block(blk.seq_hash, blk.local_hash,
                                             blk.parent_seq_hash))
        elif op < 0.95 and held:
            seq = held.pop(rng.randrange(len(held)))
            kv.free_sequence(seq.seq_hashes())
            res = ("free",)
        else:
            kv.clear()
            res = ("clear",)
        log.append((res, kv.active_blocks, kv.used_blocks, kv.free_blocks,
                    kv.usage(), [e.to_dict() for e in events]))
        events.clear()
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kv_manager_ops_match_reference(seed):
    got, want = _kv_ops("port", seed), _kv_ops("ref", seed)
    assert got == want
    assert any(e for *_, e in got)


# -- MockEngine --------------------------------------------------------------

def _req(proto, tokens, max_tokens):
    r = proto.PreprocessedRequest(token_ids=list(tokens), model="m")
    r.stop.max_tokens = max_tokens
    return r.to_dict()


async def _script(pkg: str, cfg_kw: dict, prompts, max_tokens=6,
                  cancel_at=None):
    """All `prompts` queued before the scheduler's first iteration;
    (streams, KV events, ForwardPassMetrics, engine)."""
    mock, proto, _, ctxmod = PKGS[pkg]
    events, fpms = [], []
    eng = mock.MockEngine(mock.MockEngineConfig(**cfg_kw),
                          event_sink=events.append,
                          metrics_sink=fpms.append)

    async def one(i, toks):
        ctx = ctxmod.Context()
        out = []
        async for d in eng.generate(_req(proto, toks, max_tokens), ctx):
            out.append(d)
            if cancel_at is not None and i == 0 and len(out) == cancel_at:
                ctx.cancel()
        return out

    streams = await asyncio.gather(*(one(i, p) for i, p in
                                     enumerate(prompts)))
    await eng.close()
    return (streams, [e.to_dict() for e in events],
            [m.to_dict() for m in fpms], eng)


PROMPTS = [list(range(10, 30)), list(range(10, 22)) + [5, 6, 7],
           list(range(40, 47)), list(range(10, 30)) + [9]]
SCRIPTS = {
    "batch": (dict(speedup=1000.0, block_size=4, total_kv_blocks=64,
                   worker_id=7), PROMPTS, 6, None),
    "pressure": (dict(speedup=1000.0, block_size=2, total_kv_blocks=14,
                      watermark=1.0, worker_id=2),
                 [[1, 2], [3, 4], [5, 6, 7]], 12, None),
    "cancel": (dict(speedup=1000.0, block_size=4, total_kv_blocks=64),
               PROMPTS[:2], 40, 3),
    "lookahead": (dict(speedup=1000.0, block_size=4, total_kv_blocks=12,
                       admit_lookahead=2, worker_id=3), PROMPTS, 6, None),
    "ragged": (dict(speedup=1000.0, block_size=4, total_kv_blocks=64,
                    ragged=True, worker_id=4), PROMPTS, 6, None),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
async def test_mock_engine_matches_reference(script):
    cfg, prompts, max_tokens, cancel_at = SCRIPTS[script]
    got = await _script("port", cfg, prompts, max_tokens, cancel_at)
    want = await _script("ref", cfg, prompts, max_tokens, cancel_at)
    assert got[0] == want[0]            # streams
    assert got[1] == want[1]            # KV events
    assert got[2] == want[2]            # ForwardPassMetrics
    assert got[1] and got[2]
    if script == "cancel":
        assert got[0][0][-1]["finish_reason"] == "cancelled"
    if script == "pressure":
        assert any(e["kind"] == "removed" for e in got[1])


async def test_armed_recorders_match_reference(monkeypatch):
    """DYN_STEP_PROFILE, DYN_KV_LIFECYCLE and DYN_MEM_LEDGER armed: the
    step recorder's per-entry dispatches, good and work tokens, the KV
    lifecycle summary's counts, and the ledger's classes, workspace and
    residual (the analytic model reconciles exactly) are equal, on the
    pow2 rectangles and on the ragged cost model (`ragged_step` entries
    sized by `_ragged_bucket`)."""
    for var in ("DYN_STEP_PROFILE", "DYN_KV_LIFECYCLE", "DYN_MEM_LEDGER"):
        monkeypatch.setenv(var, "1")
    for ragged in (False, True):
        cfg = dict(speedup=1000.0, block_size=4, total_kv_blocks=64,
                   unattributed_bytes=1 << 20, ragged=ragged)
        views = []
        for pkg in ("port", "ref"):
            *_, eng = await _script(pkg, cfg, PROMPTS + PROMPTS[:2], 5)
            s = eng.step_recorder.summary()
            kv = eng.kv_lifecycle.summary()
            eng.memory_ledger.poll()
            led = eng.memory_ledger.summary()["last"]
            views.append((
                {e: (v["count"], v["good_tokens"], v["work_tokens"])
                 for e, v in s["entries"].items()},
                s["totals"]["good_tokens"], s["totals"]["padded_tokens"],
                {k: kv[k] for k in ("allocations", "hits", "tokens_saved")},
                led["classes"], led["workspace_bytes"],
                led["unattributed_bytes"]))
        assert views[0] == views[1]
        assert views[0][6] == 1 << 20
        assert ("ragged_step" in views[0][0]) == ragged


# -- the environment planes -------------------------------------------------

TENANCY = ('{"tenants": [{"name": "slow", "token_rate": 1.0, '
           '"token_burst": 1.0}]}')


def test_tenancy_plane_served_by_port_as_by_reference(monkeypatch):
    """With DYN_TENANCY both packages' frontends bounce an over-quota
    tenant (the QuotaGate refuses the second request of a 1-token
    bucket), and the port's mocker, engine and frontend arm the plane at
    construction as the reference's mocker does."""
    from dynamo_tpu.tenancy import QuotaGate, TenantMetrics, tenancy_from_env
    from dynamo_tpu_torch import tenancy as t_ten
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.llm.http_service import HttpService
    from dynamo_tpu_torch.models import llama as tl
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

    monkeypatch.setenv("DYN_TENANCY", TENANCY)
    decisions = []
    for ten_env, gate_cls, metrics_cls in (
            (tenancy_from_env, QuotaGate, TenantMetrics),
            (t_ten.tenancy_from_env, t_ten.QuotaGate, t_ten.TenantMetrics)):
        cfg = ten_env()
        gate = gate_cls(cfg, metrics_cls())
        slow = cfg.get("slow")
        decisions.append((gate.try_admit(slow, 10)[:2],
                          gate.try_admit(slow, 10)[:2]))
    assert decisions[0] == decisions[1] == ((True, ""),
                                            (False, "token_rate"))
    assert r_mock.MockEngine().tenancy is not None
    assert t_mock.MockEngine().fair is not None
    eng = TorchEngine(TorchEngineConfig(model=tl.LlamaConfig.tiny(),
                                        device="cpu", num_pages=16))
    assert eng.tenancy.get("slow").token_rate == 1.0
    manager = type("M", (), {"runtime": type("R", (), {
        "metrics": MetricsRegistry()})()})()
    assert HttpService(manager).quota is not None


@pytest.mark.parametrize("var,value,served", [
    ("DYN_CLASSES", "1", "classes"), ("DYN_SERVING_CLASSES", "1", None),
    ("DYN_MESH_RECORDER", "1", "refused")])
def test_planes_served_or_refused_by_name(monkeypatch, var, value, served):
    from dynamo_tpu_torch.runtime.planes import (
        PlaneUnavailable,
        refuse_unported_planes,
    )

    refuse_unported_planes("here", env={var: "0"})      # off: accepted
    monkeypatch.setenv(var, value)
    if served == "refused":
        with pytest.raises(PlaneUnavailable,
                           match=f"{var} .*ROADMAP queue 1 item 6"):
            t_mock.MockEngine()
        return
    eng = t_mock.MockEngine()
    ref = r_mock.MockEngine()
    # the reference never reads DYN_SERVING_CLASSES: neither package
    # arms anything for it
    assert (eng.classes is not None) == (ref.classes is not None) \
        == (served == "classes")


# -- mock fleets behind KV-routed frontends, cross-wired ----------------------

class _Tap:
    """A mock engine that records the prompts it is given."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.prompts: list = []

    async def generate(self, request, context):
        self.prompts.append(list(request["token_ids"]))
        async for out in self.inner.generate(request, context):
            yield out


async def _settled(kv, taps) -> None:
    """Until the router has indexed every block the mock workers hold and
    no request is still booked as load on a worker."""
    r = kv.router
    want = sum(len(t.inner.kv._active) + len(t.inner.kv._inactive)
               for t in taps)
    for _ in range(1000):
        booked = [r.sequences.peek(w) for w in r.worker_keys()]
        if sum(r.index_stats()["index_blocks"].values()) >= want and not any(
                b is not None and (b.active_blocks or b.active_prefill_tokens)
                for b in booked):
            return
        await asyncio.sleep(0.01)
    raise AssertionError("the router never settled")


async def _fleet_round(entry, rt, fe_rt, mock, ids):
    """Two mock workers (instance ids `ids`) of package `mock` served on
    `rt`, a KV-routed frontend of `entry`'s package on `fe_rt`: chat A,
    then (A's blocks indexed) A + a suffix, then B. (bodies, worker of
    each)."""
    from tests.test_torch_serving import call, normalized

    taps = [_Tap(mock.MockEngine(mock.MockEngineConfig(
        block_size=16, worker_id=i, speedup=100.0))) for i in ids]
    w_entry = t_entry if mock is t_mock else r_entry
    w_card = t_card if mock is t_mock else r_card
    card = w_card.ModelDeploymentCard(
        name="mock-model", component="backend", tokenizer_kind="word",
        tokenizer_path="mock-model", router_mode="kv")
    handles = []
    for tap in taps:
        ev, ms = w_entry.wire_engine_events(rt, card)
        tap.inner.kv.event_sink, tap.inner.metrics_sink = ev, ms
        handles.append(await w_entry.serve_engine(
            rt, tap, card, instance_id=tap.inner.config.worker_id))
    fe = await entry.start_frontend(fe_rt, port=0)
    try:
        while not fe.manager.get("mock-model") or len(
                fe.manager.get("mock-model").client.instances()) < 2:
            await asyncio.sleep(0.02)
        kv = fe.manager.kv_routers()["mock-model"]
        a = " ".join(f"w{i}" for i in range(40))
        texts = [a, a + " and then some more words", "other " * 20]
        bodies, who = [], []
        for text in texts:
            st, ct, raw = await call(fe.http.port, "POST",
                                     "/v1/chat/completions",
                                     {"model": "mock-model", "max_tokens": 4,
                                      "messages": [{"role": "user",
                                                    "content": text}]})
            bodies.append((st, ct, normalized(raw)))
            who.append([len(t.prompts) for t in taps])
            await _settled(kv, taps)
        return bodies, who
    finally:
        await fe.stop()
        for h in handles:
            await h.stop()
        for t in taps:
            await t.inner.close()


def _placements(counts: list) -> list:
    """The worker index each request went to, from the per-worker request
    counts after each request."""
    out, prev = [], [0, 0]
    for c in counts:
        out.append([i for i in range(2) if c[i] > prev[i]][0])
        prev = c
    return out


@pytest.mark.parametrize("workers", ["port", "ref"])
def test_mock_fleets_behind_either_frontend(workers):
    """Mock workers of one package behind the other package's KV-routed
    frontend, and behind their own, over one coordinator each: the same
    bodies, and A + a suffix follows A to its worker."""
    from tests.test_torch_serving import StoreThread

    mock = t_mock if workers == "port" else r_mock
    w_dist, w_config = ((t_dist, t_config) if workers == "port"
                        else (r_dist, r_config))

    async def main(url, fe_entry, fe_dist, fe_config):
        rt = await w_dist.DistributedRuntime.create(
            w_config.RuntimeConfig(store_url=url))
        fe_rt = await fe_dist.DistributedRuntime.create(
            fe_config.RuntimeConfig(store_url=url))
        try:
            return await _fleet_round(fe_entry, rt, fe_rt, mock,
                                      (1, 2))
        finally:
            await fe_rt.close()
            await rt.close()

    results = []
    for fe in [(t_entry, t_dist, t_config), (r_entry, r_dist, r_config)]:
        with StoreThread() as store:
            results.append(asyncio.run(asyncio.wait_for(
                main(store.url, *fe), 60)))
    (g_bodies, g_counts), (w_bodies, w_counts) = results
    assert g_bodies == w_bodies
    assert [st for st, _, _ in g_bodies] == [200] * 3
    for counts in (g_counts, w_counts):
        who = _placements(counts)
        assert who[1] == who[0]


# -- a router cannot tell a mock worker from a real one ------------------------

async def test_mock_and_torch_engine_store_the_same_seq_hashes():
    """The same prompt through the port's MockEngine and a tiny CPU
    TorchEngine of the same block size: the `stored` events carry the same
    seq-hash chain over the prompt's full blocks (the engines hash with
    one `TokenBlockSequence`), with the same parents."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.models import llama as tl

    cfg = tl.LlamaConfig.tiny(dtype=__import__("torch").float32)
    bs = cfg.page_size
    prompt = [(7 * i + 3) % 200 for i in range(5 * bs + 2)]
    chains = []
    for make in (
            lambda sink: t_mock.MockEngine(t_mock.MockEngineConfig(
                block_size=bs, speedup=1000.0), event_sink=sink),
            lambda sink: TorchEngine(TorchEngineConfig(
                model=cfg, device="cpu", num_pages=64), event_sink=sink)):
        events = []
        eng = make(events.append)
        async for _ in eng.generate(_req(tp, prompt, 1), t_ctx.Context()):
            pass
        await eng.close()
        stored = []                 # (parent, seq hash, local hash)
        for e in events:
            parent = e.parent_seq_hash
            for blk in e.blocks if e.kind == tp.KV_STORED else ():
                stored.append((parent, blk.seq_hash, blk.local_hash))
                parent = blk.seq_hash
        chains.append(stored[:len(prompt) // bs])
    assert [s for _, s, _ in chains[0]] == \
        t_tokens.compute_seq_hashes(prompt, bs)
    assert chains[0] == chains[1]
    assert chains[0][0][0] == t_tokens.SEED_HASH


def test_mocker_module_serves_without_jax(tmp_path):
    """`python -m dynamo_tpu_torch.mocker` (the worker's --mock) as a
    subprocess beside a port coordinator: it registers, serves a request
    through the port's transport, and loads no jax and no dynamo_tpu
    module."""
    from dynamo_tpu_torch.runtime.distributed import free_port
    from tests.test_torch_run import _Proc

    procs = []
    try:
        coord = _Proc(tmp_path, "coordinator",
                      "dynamo_tpu_torch.coordinator", "--port",
                      str(free_port()))
        procs.append(coord)
        store = coord.wait_line("COORDINATOR_READY")
        mock = _Proc(tmp_path, "mocker", "dynamo_tpu_torch.mocker",
                     "--store", store, "--mock-speedup", "50",
                     "--instance-id", "9")
        procs.append(mock)
        assert mock.wait_line("WORKER_READY").endswith("/9")

        async def ask():
            rt = await t_dist.DistributedRuntime.create(
                t_config.RuntimeConfig(store_url=store))
            try:
                client = await rt.namespace("dynamo").component(
                    "backend").endpoint("generate").client()
                await client.start()
                await client.wait_ready()
                from dynamo_tpu_torch.runtime.push import PushRouter

                out = [x async for x in PushRouter(client).generate(
                    _req(tp, [1, 2, 3], 3), t_ctx.Context())]
                await client.stop()
                return out
            finally:
                await rt.close()

        out = asyncio.run(asyncio.wait_for(ask(), 60))
        assert [t for o in out for t in o["token_ids"]] == [1, 2, 3]
        assert mock.stop() == 0
        assert "FOREIGN []\n" in mock.out, mock.err_path.read_text()
    finally:
        for p in procs:
            p.stop()
