"""The port's serving-class plane (`dynamo_tpu_torch/serving_classes/`)
held to the JAX package's (`dynamo_tpu/serving_classes/`): host logic, so
decisions, records and payloads are equal.

- The JAX package's own cases (`tests/test_serving_classes.py`: the class
  table and resolution order, config validation, the env gate, deadline
  admission at its boundary, brownout escalation and walk-back
  hysteresis, class weights in the fair scheduler, the expired-deadline
  drop, the HTTP class surface, the unarmed frontend, the brownout shed,
  cap and deadline gate over HTTP, the telemetry blocks), as written and
  on the port (`port_copy`). Its doctor and trafficgen cases wait for
  those slices.
- Seeded streams: the same SLO transitions and ticks under one clock
  through both packages' `BrownoutMachine`s give the same actions, stages
  and published events; the same synthetic engine histograms and budgets
  through both `AdmissionEstimator`s give the same verdicts.
- Both frontends (tenancy and classes armed, a mock worker each) on the
  same request sequence: the same status codes, `Retry-After` values,
  error types, `/debug/tenants`, `/debug/classes` and `/debug/control`
  payload keys, and each `/debug` route's 503 body when its plane is
  unarmed.
"""

import asyncio
import json
import random

import pytest

from dynamo_tpu import serving_classes as r_cls
from dynamo_tpu_torch import serving_classes as t_cls
from tests.test_torch_faults import port_copy, run_case
from tests.test_torch_tenancy import http_call

REF_CASES = [
    "test_default_classes_and_resolution_precedence",
    "test_parse_classes_validation",
    "test_classes_env_off_by_default",
    "test_deadline_admission_decision_boundary",
    "test_brownout_escalation_and_walkback_hysteresis",
    "test_fair_scheduler_class_weights",
    "test_expired_deadline_dropped_before_admission",
    "test_http_class_resolution_metrics_and_debug_surface",
    "test_unarmed_frontend_has_no_classes_surface",
    "test_http_brownout_shed_cap_and_deadline_gate",
    "test_class_and_rejection_summaries_and_fleet_blocks",
]


@pytest.fixture(autouse=True)
def _no_planes(monkeypatch):
    for var in ("DYN_TENANCY", "DYN_CLASSES", "DYN_CONTROL"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("pkg", ["ref", "port"])
@pytest.mark.parametrize("case", REF_CASES)
def test_reference_classes_case(case, pkg, request):
    import tests.test_serving_classes as ref_cases

    run_case(ref_cases if pkg == "ref"
             else port_copy("test_serving_classes"), case, request)


# -- seeded decision streams --------------------------------------------------

class _Bus:
    def __init__(self) -> None:
        self.events: list = []

    def publish_nowait(self, subject, data) -> None:
        self.events.append((subject, data))


class _Eng:
    spec_shrink = False


def _brownout_trace(mod, seed: int) -> list:
    """A seeded stream of SLO transitions and walk-back ticks under one
    clock through one package's BrownoutMachine."""
    rng = random.Random(seed)
    cfg = mod.ServingClassesConfig(brownout_hold_s=rng.choice([0.0, 1, 5]),
                                   brownout_recover_s=rng.choice([1, 3, 15]))
    t = [0.0]
    bus, engines, m = _Bus(), [_Eng()], mod.ClassMetrics()
    bo = mod.BrownoutMachine(cfg, engines=lambda: engines, bus=bus,
                             metrics=m, clock=lambda: t[0])
    out = []
    objectives = ["ttft:interactive", "itl:interactive", "ttft:standard",
                  "ttft", "itl"]
    for _ in range(150):
        t[0] += rng.choice([0.0, 0.5, 1.0, 2.5, 6.0])
        if rng.random() < 0.45:
            ev = {"objective": rng.choice(objectives), "from": "ok",
                  "to": rng.choice(["ok", "slow_burn", "fast_burn",
                                    "breach"]),
                  "fast_burn": rng.random(), "threshold_s": 0.5}
            acts = bo.on_slo_event(ev)
        else:
            acts = bo.tick()
        out.append((acts, bo.state(), engines[0].spec_shrink,
                    [bo.sheds(c) for c in cfg.classes.values()],
                    [bo.cap_for(c) for c in cfg.classes.values()]))
    return out + [bus.events, m.payload(),
                  m.brownout_state.get(), m.brownout_actions.items()]


@pytest.mark.parametrize("seed", range(6))
def test_brownout_decisions_match_reference(seed):
    want = _brownout_trace(r_cls, seed)
    got = _brownout_trace(t_cls, seed)
    assert got == want
    assert want[-4], "the stream made no transition"


class _Hist:
    def __init__(self, q, count):
        self.q, self.count = q, count

    def quantile(self, q):
        return self.q * (1.0 + q)


class _M:
    def __init__(self, ttft, qw):
        self.ttft, self.queue_wait = ttft, qw


class _HistEng:
    def __init__(self, ttft, qw):
        self.metrics = _M(ttft, qw)


def test_deadline_admission_verdicts_match_reference():
    rng = random.Random(0)
    rows = []
    for _ in range(200):
        engines = [_HistEng(_Hist(rng.choice([0.0, 0.2, 1.3, 4.0]),
                                  rng.choice([0, 5])),
                            _Hist(rng.choice([0.0, 0.7, 2.2]),
                                  rng.choice([0, 3])))
                   for _ in range(rng.randint(0, 3))]
        q = rng.choice([0.5, 0.9, 0.99])
        budget = rng.choice([0.0, -1.0, 0.1, 0.9, 2.0, 10.0])
        got = [mod.AdmissionEstimator(lambda e=engines: e, q).check(budget)
               for mod in (r_cls, t_cls)]
        assert got[0] == got[1]
        rows.append(got[1][0])
    assert True in rows and False in rows


# -- both frontends on one request sequence -----------------------------------

CLASSES_DOC = {"classes": [
    {"name": "interactive", "weight": 4.0, "ttft_objective_s": 0.5},
    {"name": "standard", "weight": 2.0, "deadline_s": 0.5, "cap_stage": 2,
     "cap_tokens": 5, "downgrade_to": "batch"},
    {"name": "batch", "shed_stage": 1}], "brownout_hold_s": 1,
    "brownout_recover_s": 3}
TENANCY_DOC = {"tenants": [
    {"name": "gold", "weight": 3.0, "default_class": "interactive"},
    {"name": "capped", "token_rate": 1.0, "token_burst": 1.0},
    {"name": "one", "max_concurrent_streams": 1}]}


async def _frontend_script(mod) -> list:
    """One package's frontend (over its own mock worker) through a fixed
    request sequence; per request (status, Retry-After, error type or
    the completion token count, downgrade header), then the debug
    payloads' keys."""
    rt, fe, hs, es = await mod.setup_stack()
    out = []
    port = fe.http.port
    try:
        bo = fe.http.brownout

        async def chat(headers, max_tokens=32, stream=False):
            body = {"model": "mock-model", "max_tokens": max_tokens,
                    "stream": stream,
                    "messages": [{"role": "user", "content": "go now"}]}
            st, hdrs, resp = await http_call(
                port, "POST", "/v1/chat/completions", body, headers)
            if st != 200:
                detail = resp["error"]["type"]
            elif stream:
                detail = resp.count(b'"content"')
            else:
                detail = resp["usage"]["completion_tokens"]
            out.append((st, hdrs.get("retry-after"), detail,
                        hdrs.get("x-dyn-class-downgraded")))

        await chat({"x-dyn-tenant": "gold"})
        await chat({"x-dyn-tenant": "capped"})
        await chat({"x-dyn-tenant": "capped"})
        await chat({"x-dyn-tenant": "one"})
        bo.stage = 1
        await chat({"x-dyn-class": "batch"})
        await chat({"x-dyn-class": "interactive"})
        bo.stage = 2
        await chat({"x-dyn-class": "standard"})
        await chat({"x-dyn-class": "standard"}, stream=True)
        bo.stage = 0
        fe.http.admission = mod._StubAdmission(est=5.0)
        await chat({"x-dyn-class": "interactive",
                    "x-dyn-deadline-s": "1.0"})
        await chat({"x-dyn-class": "standard"}, stream=True)
        bo.stage = 1
        await chat({"x-dyn-class": "standard"})
        bo.stage = 0
        # the class gate's refusals released their quota slots
        await chat({"x-dyn-tenant": "one", "x-dyn-class": "batch"})
        debug = {}
        for path in ("/debug/tenants", "/debug/classes", "/debug/control"):
            st, _, body = await http_call(port, "GET", path)
            debug[path] = (st, sorted(body))
            if path == "/debug/tenants":
                # all but the clock-dependent bucket level and TTFT
                debug["tenants"] = {
                    name: {k: v for k, v in row.items()
                           if k not in ("bucket_level", "ttft_p90_s")}
                    for name, row in body["tenants"].items()}
                debug["engines"] = [
                    {name: {k: v for k, v in row.items()
                            if k != "queue_wait_mean_s"}
                     for name, row in e["tenants"].items()}
                    for e in body["engines"]]
            elif path == "/debug/classes":
                debug["counters"] = body["counters"]
                debug["brownout"] = body["brownout"]
        st, _, body = await http_call(port, "GET", "/debug")
        debug["index"] = {p: (r["arm"], r["armed"], r["available"])
                          for p, r in body["surfaces"].items()
                          if p in ("/debug/tenants", "/debug/classes",
                                   "/debug/control")}
    finally:
        await mod.teardown_stack(rt, fe, hs, es)
    return out + [debug]


def test_frontends_answer_the_same_sequence(monkeypatch):
    import tests.test_serving_classes as ref_cases

    monkeypatch.setenv("DYN_CLASSES", json.dumps(CLASSES_DOC))
    monkeypatch.setenv("DYN_TENANCY", json.dumps(TENANCY_DOC))
    port_cases = port_copy("test_serving_classes")
    want = asyncio.run(asyncio.wait_for(_frontend_script(ref_cases), 60))
    got = asyncio.run(asyncio.wait_for(_frontend_script(port_cases), 60))
    for w, g in zip(want[:-1], got[:-1]):
        assert g == w
    dbg, ref_dbg = got[-1], want[-1]
    # the one difference, a fault of the reference the port repairs: its
    # chat route does not release the quota slot of a request that the
    # class gate refuses after the quota gate admitted it (here the
    # brownout shed, the deadline 503 and the shed downgrade), so those
    # stream slots leak for good; the port releases on every exit path
    live = {n: t.pop("live_streams") for n, t in dbg["tenants"].items()}
    ref_live = {n: t.pop("live_streams")
                for n, t in ref_dbg["tenants"].items()}
    assert live == {"anonymous": 0, "gold": 0, "capped": 0, "one": 0}
    assert ref_live == {**live, "anonymous": 3}
    assert dbg == ref_dbg
    statuses = [s for s, _, _, _ in got[:-1]]
    assert statuses == [200, 200, 429, 200, 503, 200, 200, 200, 503, 200,
                        503, 200]
    # the stage-2 cap: 5 completion tokens instead of 32
    assert got[6][2] == 5
    assert got[9][3] == "standard"
    assert dbg["/debug/control"][0] == 503


@pytest.mark.parametrize("path", ["/debug/tenants", "/debug/classes",
                                  "/debug/control"])
def test_unarmed_debug_routes_answer_like_reference(path):
    import tests.test_serving_classes as ref_cases

    async def one(mod):
        rt, fe, hs, es = await mod.setup_stack()
        try:
            return await http_call(fe.http.port, "GET", path)
        finally:
            await mod.teardown_stack(rt, fe, hs, es)

    want = asyncio.run(asyncio.wait_for(one(ref_cases), 60))
    got = asyncio.run(asyncio.wait_for(
        one(port_copy("test_serving_classes")), 60))
    assert got[0] == want[0] == 503
    assert got[2] == want[2]
    assert got[1]["content-type"].startswith("application/json")
