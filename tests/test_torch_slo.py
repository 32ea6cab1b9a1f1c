"""The port's SLO burn-rate monitor (`dynamo_tpu_torch/runtime/slo.py`)
held against the JAX package's (`dynamo_tpu/runtime/slo.py`).

- One seeded sample sequence (TTFT and ITL values at advancing clock
  readings, evaluations between them) goes into both monitors with their
  clocks and wall times pinned alike: every `evaluate()` returns the same
  transition events, `status()` the same view, and the burn-rate gauges
  and transition counters render the same lines.
- The frontend's eight `--slo-*` flags parse into the same `RuntimeConfig`
  values as the reference frontend's, and a port frontend started with
  them serves the SLO monitor: its samples come from the HTTP path, its
  states reach `/fleet/status` and its gauges `/metrics`.
"""

import asyncio
import json

import numpy as np
import pytest

from dynamo_tpu.cli_util import runtime_config_from_args as ref_cfg_of
from dynamo_tpu.frontend import __main__ as ref_frontend
from dynamo_tpu.runtime import metrics as ref_metrics
from dynamo_tpu.runtime import slo as ref_slo
from dynamo_tpu_torch.cli_util import runtime_config_from_args as t_cfg_of
from dynamo_tpu_torch.frontend import __main__ as t_frontend
from dynamo_tpu_torch.runtime import metrics as t_metrics
from dynamo_tpu_torch.runtime import slo as t_slo

PKGS = {"ref": (ref_slo, ref_metrics), "torch": (t_slo, t_metrics)}


class Clock:
    def __init__(self) -> None:
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


class Wall:
    """`time` stand-in for the events' wall-clock stamp."""

    @staticmethod
    def time() -> float:
        return 1_700_000_000.0

    monotonic = staticmethod(lambda: 0.0)


def _run(pkg, seed, objectives, kw, monkeypatch):
    slo, metrics = PKGS[pkg]
    monkeypatch.setattr(slo, "time", Wall)
    clock = Clock()
    mon = slo.SloMonitor([slo.SloObjective(*o) for o in objectives],
                         clock=clock, **kw)
    reg = metrics.MetricsRegistry("dynamo")
    mon.register(reg)
    rng = np.random.default_rng(seed)
    events, statuses = [], []
    for step in range(60):
        clock.now += float(rng.uniform(0.5, 4.0))
        # bursts of slow samples come and go
        bad = (step // 12) % 2 == 1
        for _ in range(int(rng.integers(1, 12))):
            name = "ttft" if rng.random() < 0.5 else "itl"
            scale = 0.4 if bad else 0.02
            mon.observe(name, float(rng.exponential(scale)))
        mon.observe("unknown", 1.0)
        if step % 3 == 2:
            events.append(mon.evaluate())
            statuses.append(mon.status())
    return events, statuses, reg.render()


CASES = {
    "both_default": ([("ttft", 0.1), ("itl", 0.05)], {}),
    "ttft_tight": ([("ttft", 0.05, 0.9)],
                   dict(fast_window=10.0, slow_window=60.0, fast_burn=4.0,
                        slow_burn=2.0)),
    "itl_loose": ([("itl", 0.5, 0.95)],
                  dict(fast_window=5.0, slow_window=30.0, fast_burn=2.0,
                       slow_burn=1.0, max_samples=64)),
    "zero_budget": ([("ttft", 0.2, 1.0)], dict(fast_window=8.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_monitor_events_and_status_match_reference(case, seed, monkeypatch):
    objectives, kw = CASES[case]
    want = _run("ref", seed, objectives, kw, monkeypatch)
    got = _run("torch", seed, objectives, kw, monkeypatch)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    # the sequence moves the states: some transition happened
    assert any(got[0]) or case == "itl_loose"


SLO_ARGV = ["--slo-ttft", "0.25", "--slo-itl", "0.04",
            "--slo-target-ratio", "0.95", "--slo-fast-window", "30",
            "--slo-slow-window", "300", "--slo-fast-burn", "10",
            "--slo-slow-burn", "3", "--slo-check-interval", "0.5",
            "--telemetry-interval", "2"]
SLO_FIELDS = ("slo_ttft", "slo_itl", "slo_target_ratio", "slo_fast_window",
              "slo_slow_window", "slo_fast_burn", "slo_slow_burn",
              "slo_check_interval", "telemetry_interval")


def test_slo_flags_parse_as_the_reference_frontend():
    ref = ref_cfg_of(ref_frontend.parse_args(SLO_ARGV))
    got = t_cfg_of(t_frontend.parse_args(SLO_ARGV))
    assert [getattr(got, f) for f in SLO_FIELDS] == \
        [getattr(ref, f) for f in SLO_FIELDS] == \
        [0.25, 0.04, 0.95, 30.0, 300.0, 10.0, 3.0, 0.5, 2.0]
    # unset, the defaults are the reference's
    ref0 = ref_cfg_of(ref_frontend.parse_args([]))
    got0 = t_cfg_of(t_frontend.parse_args([]))
    assert [getattr(got0, f) for f in SLO_FIELDS] == \
        [getattr(ref0, f) for f in SLO_FIELDS]


def test_frontend_serves_the_monitor_from_http_samples():
    """A port frontend with a TTFT objective no request can meet and an
    ITL objective none can miss: after traffic its SLO loop reports
    `ttft` breached and `itl` ok on /fleet/status, and the burn-rate
    gauges render on /metrics."""
    from dynamo_tpu_torch.engines import EchoEngine
    from dynamo_tpu_torch.llm import entrypoint as t_entry
    from dynamo_tpu_torch.llm import model_card as t_card
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from tests.test_torch_serving import call

    cfg = RuntimeConfig(slo_ttft=1e-6, slo_itl=60.0, slo_check_interval=0.1,
                        slo_fast_window=60.0, slo_slow_window=600.0)

    async def main():
        rt = await DistributedRuntime.create(cfg)
        card = t_card.ModelDeploymentCard(
            name="echo", component="backend", tokenizer_kind="byte",
            router_mode="round_robin")
        handle = await t_entry.serve_engine(rt, EchoEngine(2.0), card)
        fe = await t_entry.start_frontend(rt, port=0)
        try:
            for _ in range(200):
                if "echo" in fe.manager.model_names():
                    break
                await asyncio.sleep(0.01)
            for i in range(4):
                st, _, _ = await call(fe.http.port, "POST",
                                      "/v1/chat/completions", {
                                          "model": "echo", "stream": True,
                                          "max_tokens": 5,
                                          "messages": [{"role": "user",
                                                        "content": f"hi {i}"}]})
                assert st == 200
            for _ in range(100):
                st, _, raw = await call(fe.http.port, "GET", "/fleet/status")
                fleet = json.loads(raw)
                if fleet["slo"]["ttft"]["state"] == "breach":
                    break
                await asyncio.sleep(0.05)
            _, _, text = await call(fe.http.port, "GET", "/metrics")
            return st, fleet, text.decode()
        finally:
            await fe.stop()
            await handle.stop()
            await rt.close()

    st, fleet, text = asyncio.run(asyncio.wait_for(main(), 60))
    assert st == 200
    assert fleet["slo"]["ttft"]["state"] == "breach"
    assert fleet["slo"]["itl"]["state"] == "ok"
    assert fleet["slo"]["ttft"]["samples"] == 4
    assert fleet["slo"]["itl"]["samples"] > 0
    burn = {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1])
            for line in text.splitlines()
            if line.startswith("dynamo_slo_burn_rate{")}
    # every TTFT sample is bad: 1 / (1 - 0.99); no ITL sample is
    assert burn['dynamo_slo_burn_rate{objective="ttft",window="fast"}'] == \
        pytest.approx(100.0)
    assert burn['dynamo_slo_burn_rate{objective="itl",window="slow"}'] == 0.0
    assert 'dynamo_slo_transitions_total{objective="ttft",to="breach"} 1.0' \
        in text


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_gauges_and_counters_render_alike(pkg):
    slo, metrics = PKGS[pkg]
    clock = Clock()
    mon = slo.SloMonitor([slo.SloObjective("ttft", 0.1, 0.9)], clock=clock,
                         fast_window=10.0, slow_window=100.0,
                         fast_burn=4.0, slow_burn=2.0)
    reg = metrics.MetricsRegistry("dynamo")
    mon.register(reg)
    clock.now = 1.0
    mon.observe("ttft", 0.5)
    clock.now = 2.0
    (ev,) = mon.evaluate()
    assert ev["to"] == "breach"
    text = reg.render()
    assert 'dynamo_slo_burn_rate{objective="ttft",window="fast"} 10.0' \
        in text
    assert 'dynamo_slo_transitions_total{objective="ttft",to="breach"} 1.0' \
        in text
