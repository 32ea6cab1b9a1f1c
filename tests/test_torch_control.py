"""The port's flight-control plane (`dynamo_tpu_torch/control/`) held to
the JAX package's (`dynamo_tpu/control/`): host logic, so actions,
evidence and payloads are equal.

- The JAX package's own cases (`tests/test_control.py`: `DYN_CONTROL`
  parsing, the unarmed plane, the engines' absent ladder, the ladder's
  mechanics, the bucket autotuner's rungs and churn bound, the KVBM
  tuner's pressure and rollback, the router tuner, the plane's tick,
  stamps and exception isolation, `/debug/control` unarmed), as written
  and on the port (`port_copy`). The forecast case imports the planner,
  which waits for its slice: the same guard is held here on a stub
  planner in both packages. The doctor, perf and loop cases wait for
  their slices.
- Seeded evidence streams through both packages' controllers (bucket,
  KVBM, router) and through both planes: the same actions, evidence,
  stamps, counts and states.
- `DYN_CONTROL` on both frontends over a mock worker: `/debug/control`,
  the `control` and `brownout` blocks of `/fleet/status`, and the
  brownout's transitions in the action ring.
- The bucket autotuner on real phase engines (2-layer fp32 `TpuEngine`
  and `TorchEngine`, `DYN_STEP_PROFILE`): prompts of 257-287 tokens burn
  over 25 % padding in the 384-token prefill bucket, yet the engines
  label a prefill dispatch (width, tokens, aligned), three dims, and the
  tuner takes only two-dim labels: it proposes nothing in either
  package. A rung proposed by hand is adopted at the scheduler's safe
  point in both, the next prompts run at its shape with less padding, and
  the streams are unchanged. A ragged engine (`ragged_active`) gets the
  tuner's one-time handoff action instead.
"""

import asyncio
import json
import random
from dataclasses import dataclass
from types import SimpleNamespace

import pytest

from dynamo_tpu.control import controllers as r_ctl
from dynamo_tpu.control import plane as r_plane
from dynamo_tpu_torch.control import controllers as t_ctl
from dynamo_tpu_torch.control import plane as t_plane
from tests.test_torch_faults import port_copy, run_case
from tests.test_torch_tenancy import http_call

REF_CASES = [
    "test_control_enabled_parsing",
    "test_unarmed_is_inert",
    "test_engines_default_to_no_ladder",
    "test_bucket_ladder_mechanics",
    "test_bucket_autotuner_inserts_rungs_with_churn_bound",
    "test_kvbm_tuner_pressure_then_rollback",
    "test_kvbm_tuner_rollback_emits_action",
    "test_router_tuner_temperature_and_overlap",
    "test_plane_tick_stamps_counts_and_guards",
    "test_debug_control_unarmed_503",
]


@pytest.fixture(autouse=True)
def _no_planes(monkeypatch):
    for var in ("DYN_TENANCY", "DYN_CLASSES", "DYN_CONTROL",
                "DYN_CONTROL_INTERVAL_S", "DYN_STEP_PROFILE"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("pkg", ["ref", "port"])
@pytest.mark.parametrize("case", REF_CASES)
def test_reference_control_case(case, pkg, request):
    import tests.test_control as ref_cases

    run_case(ref_cases if pkg == "ref" else port_copy("test_control"),
             case, request)


# -- seeded evidence streams --------------------------------------------------

def _shape_rows(rng) -> list:
    rows = []
    for _ in range(rng.randint(0, 6)):
        entry = rng.choice(["prefill", "decode", "mixed_step",
                            "decode_burst", "ragged_step"])
        dims = rng.choice([(1, rng.choice([64, 128, 384])),
                           (rng.choice([4, 8]), 1),
                           (1, 384, 1), (8, 2, 64)])
        count = rng.randint(0, 20)
        size = dims[0] * dims[1]
        good = rng.randint(0, size * max(count, 1))
        padded = size * count - min(good, size * count)
        rows.append({"entry": entry, "shape": "x".join(map(str, dims)),
                     "count": count, "good_tokens": good,
                     "padded_tokens": padded,
                     "padded_pct": round(100.0 * padded
                                         / max(size * count, 1), 1)})
    return rows


def _bucket_trace(ctl, seed: int) -> list:
    rng = random.Random(seed)
    rows = [[]]
    engs = [SimpleNamespace(
        step_recorder=SimpleNamespace(summary=lambda: {"shapes": rows[0]}),
        bucket_ladder=None, config=SimpleNamespace(worker_id=w))
        for w in (3, None)]
    tuner = ctl.BucketAutotuner(lambda: engs)
    out = []
    for t in range(40):
        rows[0] = _shape_rows(rng)
        out.append(tuner.tick(now=float(t)))
        for e in engs:
            if e.bucket_ladder is not None and rng.random() < 0.5:
                e.bucket_ladder.maybe_apply()
    return out + [tuner.state()]


def _kvbm_trace(ctl, seed: int) -> list:
    rng = random.Random(seed)
    s = {"allocations": 0, "premature_evictions": 0,
         "reuse_distance": {"samples": 0, "p90": None}}
    kv_cfg = SimpleNamespace(prefetch_blocks=0, offload_queue_depth=8)
    engs = [SimpleNamespace(
        config=SimpleNamespace(worker_id=1, watermark=0.95),
        kv_lifecycle=SimpleNamespace(summary=lambda: dict(s)),
        kvbm=SimpleNamespace(config=kv_cfg))]
    tuner = ctl.KvbmTuner(lambda: engs)
    out = []
    for t in range(60):
        s["allocations"] += rng.choice([0, 5, 40, 200])
        s["premature_evictions"] += rng.choice([0, 0, 1, 6])
        s["reuse_distance"] = {"samples": rng.choice([0, 3]),
                               "p90": rng.choice([None, 7])}
        out.append((tuner.tick(now=float(t)), engs[0].config.watermark,
                    kv_cfg.prefetch_blocks, kv_cfg.offload_queue_depth))
    return out + [tuner.state()]


def _router_trace(ctl, metrics_mod, seed: int) -> list:
    rng = random.Random(seed)
    m = metrics_mod.RouterMetrics()
    r = SimpleNamespace(
        selector=SimpleNamespace(config=SimpleNamespace(
            overlap_weight=1.0, temperature=0.0)),
        config=SimpleNamespace(overlap_weight=1.0, temperature=0.0),
        metrics=m)
    tuner = ctl.RouterTuner(lambda: {"m": SimpleNamespace(router=r)})
    out = []
    for t in range(40):
        for _ in range(rng.choice([0, 10, 30])):
            m.logit_margin.observe(rng.choice([0.1, 0.9, 3.0, 12.0]))
            if rng.random() < 0.7:
                m.load_error.observe(rng.choice([0.01, 0.2, 0.8, 3.0]))
        out.append((tuner.tick(now=float(t)), r.config.temperature,
                    r.selector.config.overlap_weight))
    return out + [tuner.state()]


@pytest.mark.parametrize("seed", range(4))
def test_controllers_act_like_reference(seed):
    from dynamo_tpu.router import decision_log as r_dlog
    from dynamo_tpu_torch.router import decision_log as t_dlog

    for trace in (_bucket_trace, _kvbm_trace):
        want, got = trace(r_ctl, seed), trace(t_ctl, seed)
        assert got == want, trace.__name__
        assert any(want[:-1]), trace.__name__
    want = _router_trace(r_ctl, r_dlog, seed)
    got = _router_trace(t_ctl, t_dlog, seed)
    assert got == want
    assert any(a for a, _, _ in want[:-1])


@dataclass(frozen=True)
class _Interval:
    """The planner's interval metrics as the forecast guard reads them
    (a frozen dataclass it rewrites with `replace`)."""
    num_req: float = float("nan")
    isl: float = float("nan")
    osl: float = float("nan")


def _forecast_trace(ctl, seed: int) -> list:
    rng = random.Random(seed)
    planner = SimpleNamespace(observation_guard=None)
    events: list = []
    f = ctl.ScaleAwareForecast(planner, lambda: events,
                               hold_intervals=rng.choice([1, 2, 3]))
    out = []
    for t in range(50):
        if rng.random() < 0.15:
            events.append({"direction": rng.choice(["up", "down"]),
                           "to": rng.randint(1, 4)})
        acts = f.tick(now=float(t))
        obs = _Interval(num_req=rng.choice([float("nan"), 3.0, 40.0,
                                            rng.random() * 100]),
                        isl=rng.random())
        held = planner.observation_guard(obs)
        out.append((acts, None if held is None else
                    (held.num_req, held.isl), f.state()))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_forecast_guard_on_a_stub_planner_like_reference(seed):
    want = _forecast_trace(r_ctl, seed)
    got = _forecast_trace(t_ctl, seed)
    assert json.dumps(got) == json.dumps(want)
    assert any(h is not None for _, h, _ in want)


class _Sick:
    name = "kvbm"

    def tick(self, now):
        raise RuntimeError("boom")

    def state(self):
        return {"sick": True}


class _Bus:
    def __init__(self) -> None:
        self.events: list = []

    def publish_nowait(self, subject, data) -> None:
        self.events.append((subject, data))


def _plane_trace(plane_mod, ctl, classes_mod, monkeypatch) -> list:
    """`control_plane_from_env` with every controller armed over stub
    engines, routers and a brownout machine; a sick controller is
    skipped; ticks at injected times."""
    monkeypatch.setenv("DYN_CONTROL", "all")
    monkeypatch.setenv("DYN_CONTROL_INTERVAL_S", "0.25")
    shapes = [{"entry": "prefill", "shape": "1x64", "count": 10,
               "good_tokens": 300, "padded_tokens": 340,
               "padded_pct": 53.1}]
    eng = SimpleNamespace(
        step_recorder=SimpleNamespace(summary=lambda: {"shapes": shapes}),
        bucket_ladder=None, config=SimpleNamespace(worker_id=2,
                                                   watermark=0.95))
    t = [0.0]
    bo = classes_mod.BrownoutMachine(
        classes_mod.ServingClassesConfig(brownout_hold_s=0.0,
                                         brownout_recover_s=1.0),
        clock=lambda: t[0])
    bus = _Bus()
    runtime = SimpleNamespace(metrics=None, events=bus)
    plane = plane_mod.control_plane_from_env(
        runtime, engines=lambda: [eng], routers=lambda: {},
        brownout=bo, now=lambda: t[0])
    plane.controllers.insert(0, _Sick())
    out = [sorted(c.name for c in plane.controllers), plane.interval_s]
    bo.on_slo_event({"objective": "ttft:interactive", "to": "breach"},
                    now=0.0)
    bo.on_slo_event({"objective": "ttft:interactive", "to": "ok"}, now=0.5)
    for now in (1.0, 2.0, 3.5):
        t[0] = now
        out.append(plane.tick())
    out.append(plane.payload(limit=3))
    out.append([s for s, _ in bus.events])
    return out


def test_plane_from_env_ticks_like_reference(monkeypatch):
    from dynamo_tpu import serving_classes as r_cls
    from dynamo_tpu_torch import serving_classes as t_cls

    want = _plane_trace(r_plane, r_ctl, r_cls, monkeypatch)
    got = _plane_trace(t_plane, t_ctl, t_cls, monkeypatch)
    assert got == want
    assert got[0] == ["brownout", "bucket", "kvbm", "kvbm", "router"]
    assert got[1] == 0.25
    assert [e["controller"] for tick in got[2:5] for e in tick] == \
        ["bucket", "brownout"]
    assert got[-2]["actions"] == {"bucket": 1, "kvbm": 0, "router": 0,
                                  "forecast": 0, "brownout": 1}
    assert set(got[-1]) == {"control_events"}


# -- DYN_CONTROL on both frontends --------------------------------------------

async def _control_frontend(mod) -> dict:
    """One package's stack with DYN_CONTROL and DYN_CLASSES armed: walk
    the brownout up one stage through its SLO entry point, let the
    plane's tick walk it back, and read the control surfaces."""
    rt, fe, hs, es = await mod.setup_stack()
    port = fe.http.port
    try:
        plane = fe.control
        bo = fe.http.brownout
        assert fe.http.control_plane is plane and bo in plane.controllers
        bo.on_slo_event({"objective": "ttft:interactive", "to": "breach"})
        bo.on_slo_event({"objective": "ttft:interactive", "to": "ok"})
        for _ in range(400):
            if bo.stage == 0:
                break
            await asyncio.sleep(0.01)
        st, _, ctl = await http_call(port, "GET", "/debug/control?limit=8")
        _, _, fleet = await http_call(port, "GET", "/fleet/status")
        _, _, idx = await http_call(port, "GET", "/debug")
        return {
            "status": st, "keys": sorted(ctl),
            "enabled": ctl["enabled"],
            "controllers": sorted(ctl["controllers"]),
            "moves": [(e["controller"], e["knob"], e["from"], e["to"])
                      for e in ctl["events"]],
            "fleet_control": sorted(fleet["control"]),
            "fleet_brownout": fleet["brownout"]["stage_name"],
            "row": idx["surfaces"]["/debug/control"],
            "ticks": plane.ticks > 0,
        }
    finally:
        await mod.teardown_stack(rt, fe, hs, es)


def test_armed_frontends_serve_control_like_reference(monkeypatch):
    import tests.test_serving_classes as ref_cases

    monkeypatch.setenv("DYN_CONTROL", "all")
    monkeypatch.setenv("DYN_CONTROL_INTERVAL_S", "0.05")
    monkeypatch.setenv("DYN_CLASSES", json.dumps(
        {"brownout_hold_s": 0.0, "brownout_recover_s": 0.1}))
    want = asyncio.run(asyncio.wait_for(_control_frontend(ref_cases), 60))
    got = asyncio.run(asyncio.wait_for(
        _control_frontend(port_copy("test_serving_classes")), 60))
    assert got == want
    assert got["status"] == 200 and got["ticks"]
    assert got["moves"] == [("brownout", "brownout_stage", "shed_batch",
                             "ok")]
    assert got["fleet_brownout"] == "ok"
    assert got["row"]["armed"] and got["row"]["available"]


# -- the bucket autotuner on real phase engines -------------------------------

def _long_engines(**kw):
    """(TpuEngine, TorchEngine), 2-layer fp32, contexts of 512 tokens and
    one prefill chunk of 512 (so a 257-287-token prompt lands in the
    384 bucket of the {16·2^k, 16·3·2^(k-1)} ladder)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
    from dynamo_tpu.models import llama as jl
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.models import llama as tl
    from dynamo_tpu_torch.models.convert import params_from_jax

    cfg = dict(num_pages=160, max_batch_size=2, prefill_chunk=512,
               min_prefill_bucket=16, default_max_tokens=4,
               decode_steps_per_sync=2, **kw)
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, max_pages_per_seq=128)
    params = jl.init_params(jax.random.PRNGKey(0), jcfg)
    jax_eng = TpuEngine(TpuEngineConfig(model=jcfg, **cfg), params=params)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, max_pages_per_seq=128)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    torch_eng = TorchEngine(TorchEngineConfig(model=tcfg, device="cpu",
                                              **cfg), model=model)
    return jax_eng, torch_eng


PROMPT_LENS = [257 + 3 * i for i in range(10)]      # 257..284


async def _serve_prompts(eng, lens, base):
    from tests.test_torch_engine import _consume, req

    return [await _consume(eng, req([(base + 7 * j + n) % 250 + 1
                                      for j in range(n)], 3), "x", [])
            for n in lens]


def _prefill_rows(eng) -> dict:
    return {r["shape"]: (r["count"], r["good_tokens"], r["padded_pct"])
            for r in eng.step_recorder.summary()["shapes"]
            if r["entry"] == "prefill"}


async def test_bucket_autotuner_on_real_engine_labels(monkeypatch):
    from dynamo_tpu.engine import attention as jattn

    monkeypatch.setenv("DYN_STEP_PROFILE", "1")
    prev = jattn._impl
    jattn.set_attention_impl("auto")
    try:
        engines = _long_engines()
        results = []
        for eng, ctl in zip(engines, (r_ctl, t_ctl)):
            try:
                before = await _serve_prompts(eng, PROMPT_LENS, 0)
                rows = _prefill_rows(eng)
                tuner = ctl.BucketAutotuner(lambda e=eng: [e])
                actions = tuner.tick(now=1.0)
                # the mechanism the tuner would actuate, by hand: a rung
                # of 288 staged now is adopted at the next safe point
                assert eng.bucket_ladder is not None
                assert eng.bucket_ladder.propose([288])
                after = await _serve_prompts(eng, PROMPT_LENS, 0)
                rows_after = _prefill_rows(eng)
                results.append((before, after, rows, rows_after, actions,
                                eng.bucket_ladder.state()))
            finally:
                await eng.close()
    finally:
        jattn.set_attention_impl(prev)
    want, got = results
    assert got == want
    before, after, rows, rows_after, actions, ladder = got
    # 1 x 384 x aligned: ten dispatches, a third of the bucket padding
    assert rows == {"1x384x1": (10, sum(PROMPT_LENS), rows["1x384x1"][2])}
    assert rows["1x384x1"][2] >= 25.0
    # the finding: three-dim labels never reach a proposal
    assert actions == []
    # the hand-proposed rung: adopted, the next prompts run at 288
    assert ladder["rungs"] == [288] and ladder["applied"] == 1
    assert rows_after["1x288x1"][0] == 10
    assert rows_after["1x288x1"][2] < rows["1x384x1"][2]
    assert after == before


async def test_ragged_engine_gets_the_handoff_action(monkeypatch):
    from dynamo_tpu.engine import attention as jattn
    from tests.test_torch_engine import _engines

    monkeypatch.setenv("DYN_STEP_PROFILE", "1")
    prev = jattn._impl
    jattn.set_attention_impl("ragged")
    jax_eng, torch_eng = _engines(0, impl="ragged")
    try:
        assert jax_eng.ragged_active and torch_eng.ragged_active
        got = [ctl.BucketAutotuner(lambda e=e: [e]).tick(now=0.0)
               for e, ctl in ((jax_eng, r_ctl), (torch_eng, t_ctl))]
    finally:
        jattn.set_attention_impl(prev)
        await jax_eng.close()
        await torch_eng.close()
    assert got[0] == got[1]
    assert [(a["knob"], a["to"]) for a in got[1]] == \
        [("bucket_ladder/w0", "retired")]


def _mixed_clocks(plane_mod, classes_mod, monkeypatch) -> tuple:
    """The frontend's wiring with both defaults: the plane ticks the
    brownout with `time.time` while the machine stamps SLO events with
    `time.monotonic`."""
    monkeypatch.setenv("DYN_CONTROL", "brownout")
    bo = classes_mod.BrownoutMachine(classes_mod.ServingClassesConfig(
        brownout_hold_s=5.0, brownout_recover_s=15.0))
    plane = plane_mod.control_plane_from_env(None, brownout=bo)
    bo.on_slo_event({"objective": "ttft", "to": "breach"})
    bo.on_slo_event({"objective": "ttft", "to": "ok"})
    walked = plane.tick()              # at once: no recover_s waited
    again = bo.on_slo_event({"objective": "ttft", "to": "breach"},
                            now=bo._clock() + 3600.0)
    return ([(e["from"], e["to"]) for e in walked], again, bo.stage,
            walked[0]["evidence"]["clean_s"] > 1e6)


def test_plane_and_brownout_clocks_mix_as_in_reference(monkeypatch):
    """A fault of the reference's frontend wiring (ROADMAP queue 3): with
    both modules' default clocks, the plane's first walk-back tick after
    an SLO event compares a wall-clock stamp with a monotonic one, so it
    steps down without waiting recover_s; and once the plane has stamped
    a transition, the next breach (an hour later on the machine's clock)
    is still inside hold_s, so the ladder cannot climb again. The two
    packages' modules keep the same defaults and give the same result;
    the port's `start_frontend` does not wire them so (next test)."""
    from dynamo_tpu import serving_classes as r_cls
    from dynamo_tpu_torch import serving_classes as t_cls

    want = _mixed_clocks(r_plane, r_cls, monkeypatch)
    got = _mixed_clocks(t_plane, t_cls, monkeypatch)
    assert got == want == ([("shed_batch", "ok")], [], 0, True)


async def _port_brownout_on_the_plane(mod) -> dict:
    """The port's frontend with DYN_CONTROL and DYN_CLASSES armed: the
    brownout's SLO-event stamps and the plane's ticks, each on its own
    default clock, in real time."""
    import time

    rt, fe, hs, es = await mod.setup_stack()
    try:
        plane, bo = fe.control, fe.http.brownout
        out = {"on_plane": bo in plane.controllers}
        hot = {"objective": "ttft:interactive", "to": "breach"}
        bo.on_slo_event(hot)
        bo.on_slo_event({"objective": "ttft:interactive", "to": "ok"})
        out["at_once"] = plane.tick()          # inside recover_s: holds
        await asyncio.sleep(0.35)
        walked = plane.tick()                  # past recover_s: one down
        out["walked"] = [(e["controller"], e["from"], e["to"])
                         for e in walked]
        out["clean_s"] = [e["evidence"]["clean_s"] for e in walked]
        await asyncio.sleep(0.15)              # past hold_s
        out["again"] = [(e["from"], e["to"]) for e in bo.on_slo_event(hot)]
        out["stage"] = bo.stage
        out["same_clock"] = abs(bo._clock() - time.time()) < 1.0
        return out
    finally:
        await mod.teardown_stack(rt, fe, hs, es)


def test_port_frontend_runs_brownout_on_the_plane_clock(monkeypatch):
    """The port's departure from the reference's wiring: the machine and
    the plane share one clock, so the first step down after a breach
    waits recover_s, and a breach after a plane-driven step down moves
    the ladder up again."""
    monkeypatch.setenv("DYN_CONTROL", "brownout")
    monkeypatch.setenv("DYN_CONTROL_INTERVAL_S", "3600")
    monkeypatch.setenv("DYN_CLASSES", json.dumps(
        {"brownout_hold_s": 0.1, "brownout_recover_s": 0.3}))
    got = asyncio.run(asyncio.wait_for(_port_brownout_on_the_plane(
        port_copy("test_serving_classes")), 60))
    assert got["on_plane"] and got["same_clock"]
    assert got["at_once"] == []
    assert got["walked"] == [("brownout", "shed_batch", "ok")]
    assert 0.3 <= got["clean_s"][0] < 5.0
    assert got["again"] == [("ok", "shed_batch")] and got["stage"] == 1
