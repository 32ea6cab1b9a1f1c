"""The port's tenancy plane (`dynamo_tpu_torch/tenancy/`) held to the JAX
package's (`dynamo_tpu/tenancy/`): it is host logic, so decisions,
records and payloads are equal.

- The JAX package's own tenancy cases (`tests/test_tenancy.py`: config
  parsing and rejection, the env gate, token-bucket math under an
  injected clock, `estimate_request_tokens`, the quota gate's streams and
  release, the hand-traced 3 : 1 fair order and the idle catch-up, the
  mocker's legacy order, lookahead, fair interleave and per-tenant KV
  budget, the HTTP 429 with `Retry-After`, `/debug/tenants`, the unarmed
  frontend, the tenant attribute on the engine's request span, the
  telemetry summaries), as written and on the port (`port_copy`). Its
  doctor, trafficgen and noisy-neighbor cases wait for those slices.
- Seeded decision streams: the same tenant queues, weights, classes and
  costs through both packages' `FairScheduler`, and the same request
  stream under one injected clock through both `QuotaGate`s, give the
  same candidate orders, services, grants, retry hints and payloads.
- 2-layer fp32 `TorchEngine` and `TpuEngine` with the same weights: the
  head-only order pinned unarmed, `admit_lookahead` overtaking a
  page-starved head, the fair interleave and the per-tenant KV budget
  give the same admission sequences and the same greedy streams; the
  port's `MockEngine` gives the reference mocker's admission sequence.
- The tenant across the wire: a tenanted frontend of either package in
  front of mock workers of the other, over one coordinator, attributes
  the same tenant's goodput and answers the same 429.
"""

import asyncio
import json
import random

import pytest

from dynamo_tpu import mocker as r_mock
from dynamo_tpu import tenancy as r_ten
from dynamo_tpu.engine import attention as jattn
from dynamo_tpu.runtime import context as r_ctx
from dynamo_tpu_torch import mocker as t_mock
from dynamo_tpu_torch import tenancy as t_ten
from dynamo_tpu_torch.runtime import context as t_ctx
from tests.test_torch_faults import port_copy, run_case

REF_CASES = [
    "test_parse_and_resolve_precedence",
    "test_parse_rejects_bad_configs",
    "test_tenancy_env_off_by_default",
    "test_token_bucket_math_injected_clock",
    "test_estimate_request_tokens",
    "test_quota_gate_streams_and_release",
    "test_fair_scheduler_hand_traced_3_to_1",
    "test_fair_scheduler_idle_catch_up",
    "test_legacy_admission_order_pinned_unarmed",
    "test_admit_lookahead_overtakes_blocked_head",
    "test_fair_admission_interleave_in_mock_engine",
    "test_per_tenant_kv_budget",
    "test_http_quota_429_with_retry_after",
    "test_debug_tenants_surface_and_request_attribution",
    "test_unarmed_frontend_has_no_tenancy_surface",
    "test_tenant_attribute_on_engine_request_span",
    "test_tenant_summary_merges_and_absent_when_untenanted",
    "test_fleet_status_carries_tenant_block",
]


@pytest.fixture(autouse=True)
def _no_planes(monkeypatch):
    for var in ("DYN_TENANCY", "DYN_CLASSES", "DYN_CONTROL"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("pkg", ["ref", "port"])
@pytest.mark.parametrize("case", REF_CASES)
def test_reference_tenancy_case(case, pkg, request):
    import tests.test_tenancy as ref_cases

    run_case(ref_cases if pkg == "ref" else port_copy("test_tenancy"),
             case, request)


# -- seeded decision streams --------------------------------------------------

def _fair_trace(ten, classes_mod, seed: int) -> list:
    """A seeded admission stream through one package's FairScheduler:
    tenants with random weights, a waiting list that random arrivals
    extend, a candidate order per round, the head admitted at a random
    cost and class; with odd seeds the class weights are armed."""
    rng = random.Random(seed)
    names = ["t0", "t1", "t2", "t3"]
    doc = {"tenants": [{"name": n, "weight": rng.choice([0.5, 1, 2, 3])}
                       for n in names[:3]]}
    fair = ten.FairScheduler(ten.parse_tenancy(doc))
    if seed % 2:
        fair.classes = classes_mod.default_classes_config()
    waiting, out = [], []
    for _ in range(120):
        for _ in range(rng.randint(0, 3)):
            waiting.append(rng.choice(names + [None]))
        if not waiting:
            continue
        order = fair.candidate_indexes(waiting)
        # the engine admits the first candidate whose pages fit: model a
        # page-starved candidate by skipping one at random
        pick = order[1] if len(order) > 1 and rng.random() < 0.2 \
            else order[0]
        tenant = waiting.pop(pick)
        cls = rng.choice(["interactive", "standard", "batch", None])
        fair.on_admit(tenant, rng.choice([0.0, 3.0, 17.0, 120.0]), cls=cls)
        out.append((order, tenant, dict(fair.service)))
    return out + [fair.payload()]


class _Classes:
    """The serving-class config each package's FairScheduler reads."""

    def __init__(self, mod):
        self.mod = mod

    def default_classes_config(self):
        return self.mod.ServingClassesConfig()


@pytest.mark.parametrize("seed", range(6))
def test_fair_scheduler_decisions_match_reference(seed):
    from dynamo_tpu import serving_classes as r_cls
    from dynamo_tpu_torch import serving_classes as t_cls

    want = _fair_trace(r_ten, _Classes(r_cls), seed)
    got = _fair_trace(t_ten, _Classes(t_cls), seed)
    assert got == want
    assert len(want) > 60


def _quota_trace(ten, seed: int) -> list:
    """A seeded request stream through one package's QuotaGate under an
    injected clock: admits, refusals with their reasons and retry hints,
    releases, and the payload at the end."""
    rng = random.Random(seed)
    doc = {"tenants": [
        {"name": "rate", "token_rate": 20.0, "token_burst": 40.0},
        {"name": "streams", "max_concurrent_streams": 2},
        {"name": "both", "token_rate": 5.0, "max_concurrent_streams": 3},
        {"name": "free", "api_keys": ["sk-free"]}]}
    cfg = ten.parse_tenancy(doc)
    now = [0.0]
    gate = ten.QuotaGate(cfg, clock=lambda: now[0])
    live, out = [], []
    for _ in range(200):
        now[0] += rng.choice([0.0, 0.05, 0.3, 1.5])
        if live and rng.random() < 0.4:
            name = live.pop(rng.randrange(len(live)))
            gate.release(name)
            out.append(("release", name))
            continue
        body = {"messages": [{"role": "user", "content":
                              " ".join("w" * rng.randint(0, 30))}],
                "max_tokens": rng.choice([None, 4, 64])}
        hdr = rng.choice(["rate", "streams", "both", None, "stranger"])
        tenant = cfg.resolve(hdr, rng.choice([None, "Bearer sk-free"]))
        tokens = ten.estimate_request_tokens(body)
        ok, reason, retry = gate.try_admit(tenant, tokens)
        if ok:
            live.append(tenant.name)
        out.append((tenant.name, tokens, ok, reason, retry,
                    ten.retry_after_header(retry)))
    return out + [gate.payload()]


@pytest.mark.parametrize("seed", range(4))
def test_quota_gate_decisions_match_reference(seed):
    want = _quota_trace(r_ten, seed)
    got = _quota_trace(t_ten, seed)
    assert got == want
    assert any(r[2] is False for r in want[:-1] if len(r) == 6)


def test_tenant_metrics_render_like_reference():
    """The `dynamo_tenant_*` series the port's telemetry summaries read
    carry the reference's names, labels and renders."""
    from dynamo_tpu.runtime.metrics import MetricsRegistry as RReg
    from dynamo_tpu_torch.runtime.metrics import MetricsRegistry as TReg

    out = []
    for ten, reg in ((r_ten, RReg()), (t_ten, TReg())):
        tm = ten.TenantMetrics()
        tm.register(reg, role="frontend")
        tm.register(reg, role="engine")
        for i, name in enumerate(["a", "b", "a"]):
            tm.observe_ttft(name, 0.01 * (i + 1))
            tm.observe_queue_wait(name, 0.002 * (i + 1))
            tm.goodput.inc(3, tenant=name)
            tm.kv_blocks.set(i, tenant=name)
        tm.rejected.inc(tenant="b", reason="streams")
        out.append(reg.render())
    assert out[0] == out[1]
    assert 'dynamo_tenant_goodput_tokens_total{tenant="a"} 6' in out[1]


# -- the engines: admission sequences and streams -----------------------------

class _Admissions(list):
    """An engine's `_running` list that records, for every admitted
    request, its label (its first prompt token) and how many requests
    were running beside it."""

    def __init__(self, log: list) -> None:
        super().__init__()
        self.log = log

    def append(self, seq) -> None:
        self.log.append((seq.prompt[0], len(self)))
        super().append(seq)


def _ctx_for(eng, tenant):
    mod = t_ctx if type(eng).__module__.startswith("dynamo_tpu_torch") \
        else r_ctx
    return mod.Context(headers={t_ten.TENANT_HEADER: tenant}
                       if tenant else None)


async def _admit_run(eng, reqs) -> tuple[list, list]:
    """Queue every request before the scheduler's first iteration (so
    both engines see the same rounds); the admission labels in order and
    each request's (tokens, finish)."""
    from tests.test_torch_engine import req

    log: list = []
    eng._running = _Admissions(log)

    async def one(first, n, max_tokens, tenant):
        toks, finish = [], None
        async for o in eng.generate(
                req(range(first, first + n), max_tokens),
                _ctx_for(eng, tenant)):
            toks.extend(o.get("token_ids") or [])
            finish = o.get("finish_reason") or finish
        return toks, finish

    try:
        streams = await asyncio.gather(*(one(*r) for r in reqs))
    finally:
        await eng.close()
    return log, streams


@pytest.fixture
def phase_impl():
    prev = jattn._impl
    jattn.set_attention_impl("auto")
    yield
    jattn.set_attention_impl(prev)


def _engine_pair(**kw):
    """(TpuEngine, TorchEngine) with the same 2-layer fp32 weights on the
    phase path, prefill-all, `kw` over test_torch_engine's config."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
    from dynamo_tpu.models import llama as jl
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.models import llama as tl
    from dynamo_tpu_torch.models.convert import params_from_jax
    from tests.test_torch_engine import ENGINE_KW

    kw = {**ENGINE_KW, **kw}
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    params = jl.init_params(jax.random.PRNGKey(0), jcfg)
    jax_eng = TpuEngine(TpuEngineConfig(model=jcfg, **kw), params=params)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    torch_eng = TorchEngine(TorchEngineConfig(model=tcfg, device="cpu", **kw),
                            model=model)
    return jax_eng, torch_eng


# (first token, prompt length, max_tokens, tenant); first tokens label
# the requests. A holds 8 of 15 pages (10 with its decode), B needs 8
# more and cannot fit beside it, C needs 2.
STARVED = [(10, 32, 4, None), (50, 32, 4, None), (90, 8, 4, None)]


@pytest.mark.parametrize("lookahead,order", [(0, [10, 50, 90]),
                                             (1, [10, 90, 50])],
                         ids=["legacy", "lookahead"])
async def test_engine_admission_order_matches_tpu_engine(
        phase_impl, lookahead, order):
    kw = dict(num_pages=16, watermark=1.0)
    if lookahead:
        kw["admit_lookahead"] = lookahead
    jax_eng, torch_eng = _engine_pair(**kw)
    want = await _admit_run(jax_eng, STARVED)
    got = await _admit_run(torch_eng, STARVED)
    assert torch_eng.fair is None and torch_eng.tenancy is None
    assert got == want
    assert [x for x, _ in got[0]] == order
    assert [f for _, f in got[1]] == ["length"] * 3
    assert torch_eng.pool.active_pages == 0


FAIR_DOC = {"tenants": [{"name": "a", "weight": 3.0},
                        {"name": "b", "weight": 1.0},
                        {"name": "budgeted", "kv_block_budget": 2}]}


async def test_engine_fair_interleave_matches_tpu_engine(phase_impl,
                                                         monkeypatch):
    """3 b's queued ahead of 9 a's admit in the hand-traced a b a a a b
    ... order in both engines (weights 3 : 1, equal costs), with equal
    greedy streams and per-tenant goodput."""
    monkeypatch.setenv("DYN_TENANCY", json.dumps(FAIR_DOC))
    jax_eng, torch_eng = _engine_pair(num_pages=64)
    reqs = ([(100 + 10 * i, 4, 2, "b") for i in range(3)]
            + [(1 + 10 * i, 4, 2, "a") for i in range(9)])
    want = await _admit_run(jax_eng, reqs)
    got = await _admit_run(torch_eng, reqs)
    assert got == want
    tenant_of = {r[0]: r[3] for r in reqs}
    assert "".join(tenant_of[x] for x, _ in got[0]) == "abaaabaaabaa"
    for t in ("a", "b"):
        assert torch_eng.tenant_metrics.goodput.get(tenant=t) == \
            jax_eng.tenant_metrics.goodput.get(tenant=t) == \
            2 * (9 if t == "a" else 3)
        assert torch_eng.tenant_metrics.admissions.get(tenant=t) == \
            (9 if t == "a" else 3)
    assert torch_eng.fair.payload() == jax_eng.fair.payload()


async def test_engine_tenant_kv_budget_matches_tpu_engine(phase_impl,
                                                          monkeypatch):
    """A tenant at its page budget is skipped while another tenant's head
    admits; unarmed, the same queue admits in FIFO order."""
    reqs = [(10, 8, 3, "budgeted"), (50, 8, 3, "budgeted"), (90, 8, 3, "a")]
    unarmed = await _admit_run(_engine_pair(num_pages=64)[1], reqs)
    monkeypatch.setenv("DYN_TENANCY", json.dumps(FAIR_DOC))
    jax_eng, torch_eng = _engine_pair(num_pages=64)
    want = await _admit_run(jax_eng, reqs)
    got = await _admit_run(torch_eng, reqs)
    assert got == want
    # unarmed all three run together; armed, "a" leads on the name tie
    # and the second budgeted request waits until the first has finished
    assert unarmed[0] == [(10, 0), (50, 1), (90, 2)]
    assert got[0][:2] == [(90, 0), (10, 1)] and got[0][2][0] == 50
    assert got[0][2][1] < 2
    assert got[1] == unarmed[1]
    assert torch_eng.tenant_metrics.kv_blocks.get(tenant="budgeted") == 0


class _MockAdmissions(_Admissions):
    """`_Admissions` for a MockEngine's requests."""

    def append(self, r) -> None:
        self.log.append((r.req.token_ids[0], len(self)))
        list.append(self, r)


def _mock_admissions(mock, reqs, **cfg) -> list:
    """The admission labels of one package's MockEngine on `reqs`, all
    queued before its first scheduler iteration."""
    ctx_mod = t_ctx if mock is t_mock else r_ctx
    proto = __import__(mock.__name__.split(".")[0] + ".protocols",
                       fromlist=["PreprocessedRequest"])

    async def main():
        eng = mock.MockEngine(mock.MockEngineConfig(
            block_size=4, speedup=1000.0, **cfg))
        log: list = []
        eng._running = _MockAdmissions(log)

        async def one(first, n, max_tokens, tenant):
            req = proto.PreprocessedRequest(
                token_ids=list(range(first, first + n)), model="m")
            req.stop.max_tokens = max_tokens
            async for _ in eng.generate(req.to_dict(), ctx_mod.Context(
                    headers={t_ten.TENANT_HEADER: tenant}
                    if tenant else None)):
                pass

        try:
            await asyncio.gather(*(one(*r) for r in reqs))
        finally:
            await eng.close()
        return log

    return asyncio.run(asyncio.wait_for(main(), 60))


@pytest.mark.parametrize("armed", [False, True], ids=["fifo", "fair"])
def test_mock_engine_admission_order_matches_reference(armed, monkeypatch):
    if armed:
        monkeypatch.setenv("DYN_TENANCY", json.dumps(FAIR_DOC))
    reqs = ([(100 + 10 * i, 4, 3, "b") for i in range(3)]
            + [(1 + 10 * i, 4, 3, "a") for i in range(9)]
            + [(300, 8, 3, "budgeted"), (400, 8, 3, "budgeted")])
    orders = [_mock_admissions(mock, reqs, max_batch_size=4,
                               total_kv_blocks=64)
               for mock in (r_mock, t_mock)]
    assert orders[0] == orders[1]
    labels = [x for x, _ in orders[1]]
    assert sorted(labels) == sorted(r[0] for r in reqs)
    assert (labels == [r[0] for r in reqs]) == (not armed)


# -- the tenant across the wire, both directions ------------------------------

def _http(port, method, path, body=None, headers=None):
    """(status, headers lower-cased, JSON body or raw bytes)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        r = conn.getresponse()
        raw = r.read()
        hdrs = {k.lower(): v for k, v in r.getheaders()}
        return r.status, hdrs, (json.loads(raw) if raw[:1] in (b"{", b"[")
                                else raw)
    finally:
        conn.close()


async def http_call(port, method, path, body=None, headers=None):
    return await asyncio.wait_for(asyncio.to_thread(
        _http, port, method, path, body, headers), 60)


WIRE_DOC = {"tenants": [{"name": "heavy", "weight": 3.0},
                        {"name": "slow", "token_rate": 1.0,
                         "token_burst": 1.0}]}


@pytest.mark.parametrize("frontend", ["port", "ref"])
def test_tenant_rides_the_wire_between_packages(frontend, monkeypatch):
    """A tenanted frontend of one package in front of a tenanted mock
    worker of the other, over one coordinator: the worker attributes the
    frontend's resolved tenant (goodput, admissions), and the frontend
    answers an over-quota tenant 429 with `Retry-After` before any engine
    work."""
    from dynamo_tpu.llm import entrypoint as r_entry
    from dynamo_tpu.llm import model_card as r_card
    from dynamo_tpu.runtime import config as r_config
    from dynamo_tpu.runtime import distributed as r_dist
    from dynamo_tpu_torch.llm import entrypoint as t_entry
    from dynamo_tpu_torch.llm import model_card as t_card
    from dynamo_tpu_torch.runtime import config as t_config
    from dynamo_tpu_torch.runtime import distributed as t_dist
    from tests.test_torch_serving import StoreThread

    monkeypatch.setenv("DYN_TENANCY", json.dumps(WIRE_DOC))
    port_fe = frontend == "port"
    fe_mods = (t_entry, t_dist, t_config) if port_fe \
        else (r_entry, r_dist, r_config)
    w_mods = (r_entry, r_card, r_dist, r_config, r_mock) if port_fe \
        else (t_entry, t_card, t_dist, t_config, t_mock)

    async def main(url):
        w_entry, w_card, w_dist, w_config, mock = w_mods
        fe_entry, fe_dist, fe_config = fe_mods
        rt = await w_dist.DistributedRuntime.create(
            w_config.RuntimeConfig(store_url=url))
        fe_rt = await fe_dist.DistributedRuntime.create(
            fe_config.RuntimeConfig(store_url=url))
        eng = mock.MockEngine(mock.MockEngineConfig(speedup=100.0))
        card = w_card.ModelDeploymentCard(
            name="mock-model", component="backend", tokenizer_kind="word",
            tokenizer_path="mock-model", router_mode="round_robin")
        handle = await w_entry.serve_engine(rt, eng, card, instance_id=5)
        fe = await fe_entry.start_frontend(fe_rt, port=0)
        try:
            while not fe.manager.get("mock-model") or not \
                    fe.manager.get("mock-model").client.instances():
                await asyncio.sleep(0.02)
            body = {"model": "mock-model", "max_tokens": 4,
                    "messages": [{"role": "user", "content": "hi there"}]}
            out = []
            for tenant in ("heavy", "slow", "slow"):
                st, hdrs, resp = await http_call(
                    fe.http.port, "POST", "/v1/chat/completions", body,
                    {"x-dyn-tenant": tenant})
                out.append((st, hdrs.get("retry-after"),
                            resp["error"]["type"] if st != 200 else None))
            st, _, dbg = await http_call(fe.http.port, "GET",
                                         "/debug/tenants")
            tm = eng.tenant_metrics
            return (out, st, dbg["tenants"]["slow"]["live_streams"],
                    tm.goodput.get(tenant="heavy"),
                    tm.admissions.get(tenant="slow"), eng.fair.payload())
        finally:
            await fe.stop()
            await handle.stop()
            await eng.close()
            await fe_rt.close()
            await rt.close()

    with StoreThread() as store:
        out, st, live, goodput, slow_admits, fair = asyncio.run(
            asyncio.wait_for(main(store.url), 60))
    assert out == [(200, None, None), (200, None, None),
                   (429, "6", "rate_limit_exceeded")]
    assert st == 200 and live == 0
    assert goodput == 4 and slow_admits == 1
    assert set(fair) == {"heavy", "slow"}
