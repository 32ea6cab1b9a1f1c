"""The port's `/debug` routes (`dynamo_tpu_torch/llm/http_service.py`)
held against the JAX package's frontend (`dynamo_tpu/llm/http_service.py`
`_debug_index` `:794`, `_debug_profile` `:905`, `_debug_kv`,
`_debug_memory` `:979`, `_debug_router`, `_debug_prefixes` `:1125`).

- In process (the worker and the frontend on one runtime, as `run
  in=http` deploys them), a tiny fp32 model with the same weights on both
  packages (`params_from_jax`), `DYN_STEP_PROFILE`, `DYN_MEM_LEDGER`,
  `DYN_KV_LIFECYCLE`, `DYN_ROUTER_LOG` and `DYN_PREFIX_HEAT` armed, `kv`
  routing: the same
  chat requests, one at a time, through each frontend. Then every route
  answers 200 on both; the port's index lists exactly the routes it
  serves, each row equal to the reference's (the memory row's text says
  "device" where the reference's says "HBM"); the step recorders'
  per-entry dispatch counts and good and work tokens are equal, and so
  are the ledgers' classes, the KV lifecycle bodies' keys and the router
  bodies' decision counters and ring lengths, and the prefix planes'
  decision counts and record keys;
  `?format=chrome` is a Chrome trace of the same events; `?limit` bounds
  the rings; `?capture_s=0.2` runs a `torch.profiler` window on the CPU
  and writes its trace while a chat streams; a bad `capture_s` is a 400.
- Without `profile_engines` (an `HttpService` no deployment wired) the
  engine routes answer 503, as the reference's, while `/debug/requests`
  (always on) stays available; so do `/debug/control`, `/debug/tenants`
  and `/debug/classes` with their planes unarmed (the latter two listed
  available, as the reference lists them); the reference's route the
  port does not serve (mesh) is a 404.
- In a fresh interpreter with both recorders, the tracer, the audit bus,
  the SLO monitor, the telemetry publisher and the tenancy, serving-class
  and flight-control planes armed, `run in=text`
  serves and an in-process deployment answers `/debug/profile`,
  `/debug/memory`, `/debug/requests` and `/fleet/status`, writes its
  trace and audit files, with no jax and no `dynamo_tpu` module loaded.
"""

import asyncio
import json
import os
import subprocess
import sys

import pytest

from dynamo_tpu.engine import attention as jattn
from dynamo_tpu.llm import entrypoint as ref_entry
from dynamo_tpu.llm import model_card as ref_card
from dynamo_tpu.models.synth_ckpt import write_synthetic_hf_checkpoint
from dynamo_tpu.runtime import config as ref_config
from dynamo_tpu.runtime import distributed as ref_dist
from dynamo_tpu_torch.llm import entrypoint as t_entry
from dynamo_tpu_torch.llm import model_card as t_card
from dynamo_tpu_torch.llm.http_service import HttpService
from dynamo_tpu_torch.llm.model_manager import ModelManager
from dynamo_tpu_torch.runtime import config as t_config
from dynamo_tpu_torch.runtime import distributed as t_dist
from tests.test_torch_serving import _engines, _renew_lease, call

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ROUTES = {"/debug/requests", "/debug/profile", "/debug/router",
               "/debug/kv", "/debug/memory", "/debug/prefixes",
               "/debug/control", "/debug/tenants", "/debug/classes"}
# the admission and control planes, unarmed in these deployments
PLANES = {"/debug/control", "/debug/tenants", "/debug/classes"}
UNSERVED = ("/debug/mesh",)
PROMPTS = ["profile me please", "a much longer prompt that spans pages",
           "hi"]


@pytest.fixture
def armed(monkeypatch):
    prev = jattn._impl
    jattn.set_attention_impl("auto")
    for var in ("DYN_STEP_PROFILE", "DYN_MEM_LEDGER", "DYN_KV_LIFECYCLE",
                "DYN_ROUTER_LOG", "DYN_PREFIX_HEAT"):
        monkeypatch.setenv(var, "1")
    monkeypatch.delenv("DYN_OOM_EXIT", raising=False)
    yield
    jattn.set_attention_impl(prev)


def _card(mod, name):
    return mod.ModelDeploymentCard(
        name=name, component="backend", tokenizer_kind="byte",
        context_length=64, kv_block_size=4, router_mode="kv")


async def _deploy(entry, rt, eng, card):
    ev, ms = entry.wire_engine_events(rt, card)
    if entry is t_entry:
        eng.attach_sinks(ev, ms)
    else:
        eng.inner.pool.event_sink, eng.inner.metrics_sink = ev, ms
    handle = await entry.serve_engine(rt, eng, card, instance_id=1)
    fe = await entry.start_frontend(rt, port=0)
    for _ in range(200):
        if card.name in fe.manager.model_names():
            break
        await asyncio.sleep(0.01)
    return handle, fe


async def _get(port, path):
    status, _, raw = await call(port, "GET", path)
    return status, (json.loads(raw) if raw[:1] in (b"{", b"[") else raw)


async def _serve_and_read(port, model, capture: bool):
    for text in PROMPTS:
        body = {"model": model, "max_tokens": 6, "temperature": 0.0,
                "messages": [{"role": "user", "content": text}]}
        st, _, _ = await call(port, "POST", "/v1/chat/completions", body)
        assert st == 200
    out = {}
    for path in ("/debug", "/debug/profile", "/debug/profile?limit=2",
                 "/debug/profile?format=chrome", "/debug/memory",
                 "/debug/memory?limit=1", "/debug/kv", "/debug/router",
                 "/debug/prefixes", "/debug/profile?capture_s=nope"):
        out[path] = await _get(port, path)
    if capture:
        # a capture window while a chat streams
        body = {"model": model, "max_tokens": 30, "temperature": 0.0,
                "stream": True,
                "messages": [{"role": "user", "content": "during"}]}
        chat = asyncio.ensure_future(
            call(port, "POST", "/v1/chat/completions", body))
        out["capture"] = await _get(port, "/debug/profile?capture_s=0.2")
        assert (await chat)[0] == 200
    return out


def _entries(profile_body):
    s = profile_body["engines"][0]["summary"]["entries"]
    return {e: (v["count"], v["good_tokens"], v["work_tokens"])
            for e, v in s.items()}


def test_debug_routes_in_process_match_jax_package(armed, tmp_path,
                                                   monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    jax_eng, torch_eng = _engines()

    async def main():
        ref_rt = await ref_dist.DistributedRuntime.create(
            ref_config.RuntimeConfig())
        renew = asyncio.ensure_future(_renew_lease(ref_rt))
        t_rt = await t_dist.DistributedRuntime.create(
            t_config.RuntimeConfig())
        deployed = []
        try:
            deployed.append(await _deploy(ref_entry, ref_rt, jax_eng,
                                          _card(ref_card, "tiny")))
            deployed.append(await _deploy(t_entry, t_rt, torch_eng,
                                          _card(t_card, "tiny")))
            want = await _serve_and_read(deployed[0][1].http.port, "tiny",
                                         capture=False)
            got = await _serve_and_read(deployed[1][1].http.port, "tiny",
                                        capture=True)
            missing = {p: (await _get(deployed[1][1].http.port, p))[0]
                       for p in UNSERVED}
            planes = [{p: await _get(fe.http.port, p) for p in PLANES}
                      for _, fe in deployed]
            return want, got, missing, planes
        finally:
            renew.cancel()
            for handle, fe in deployed:
                await fe.stop()
                await handle.stop()
            await jax_eng.close()
            await torch_eng.close()
            await ref_rt.close()
            await t_rt.close()

    want, got, missing, planes = asyncio.run(asyncio.wait_for(main(), 120))
    assert set(missing.values()) == {404}
    # unarmed planes: the reference's 503 and body
    assert planes[1] == planes[0]
    assert {st for st, _ in planes[1].values()} == {503}
    for path in got:
        if path.endswith("nope"):
            assert got[path][0] == want[path][0] == 400
        else:
            assert got[path][0] == 200, (path, got[path])
    for path in want:
        assert want[path][0] == got[path][0], path
    # the index: only what the port serves, each row the reference's
    idx, ref_idx = got["/debug"][1]["surfaces"], want["/debug"][1]["surfaces"]
    assert set(idx) == PORT_ROUTES
    for p in PORT_ROUTES:
        row, ref_row = dict(idx[p]), dict(ref_idx[p])
        if p == "/debug/memory":
            assert row.pop("what").replace("device memory", "HBM memory") \
                .replace("the device's memory stats",
                         "device memory_stats") == ref_row.pop("what")
        assert row == ref_row, p
    assert all(row["armed"] and row["available"]
               for p, row in idx.items() if p not in PLANES)
    assert not any(idx[p]["armed"] for p in PLANES)
    # the step recorders saw the same dispatches
    prof = got["/debug/profile"][1]
    assert prof["enabled"] is True
    assert _entries(prof) == _entries(want["/debug/profile"][1])
    assert prof["engines"][0]["summary"]["totals"]["good_tokens"] > 0
    assert len(got["/debug/profile?limit=2"][1]["engines"][0]["records"]) \
        == 2
    trace = got["/debug/profile?format=chrome"][1]
    steps = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert len(steps) == prof["engines"][0]["summary"]["recorded"] == len(
        [e for e in want["/debug/profile?format=chrome"][1]["traceEvents"]
         if e.get("ph") == "X"])
    # the ledgers book the same weights and KV pool
    mem = got["/debug/memory"][1]["engines"][0]
    ref_m = want["/debug/memory"][1]["engines"][0]
    assert mem["enabled"] and mem["worker_id"] == ref_m["worker_id"]
    assert mem["summary"]["last"]["classes"] == \
        ref_m["summary"]["last"]["classes"]
    assert mem["summary"]["last"]["device"] is None
    assert len(got["/debug/memory?limit=1"][1]["engines"][0][
        "snapshots"]) == 1
    assert mem["oom"] is False
    # the KV lifecycle and the router bodies
    kv, ref_kv = got["/debug/kv"][1], want["/debug/kv"][1]
    assert kv["enabled"] and set(kv["engines"][0]) == set(
        ref_kv["engines"][0])
    router = got["/debug/router"][1]["models"][0]
    ref_router = want["/debug/router"][1]["models"][0]
    assert set(router) == set(ref_router)
    assert router["counters"]["decisions"] == \
        ref_router["counters"]["decisions"]
    assert router["mode"] == "kv_events" and router["enabled"] is True
    assert len(router["records"]) == len(ref_router["records"]) == 3
    assert set(router["summary"]) == set(ref_router["summary"])
    pfx = got["/debug/prefixes"][1]["models"][0]
    ref_pfx = want["/debug/prefixes"][1]["models"][0]
    assert pfx["enabled"] is True and set(pfx) == set(ref_pfx)
    assert pfx["summary"]["decisions"] == ref_pfx["summary"]["decisions"] \
        == 3
    assert [set(r) for r in pfx["records"]] == \
        [set(r) for r in ref_pfx["records"]]
    # the capture wrote its trace while the chat streamed
    cap = got["capture"][1]["capture"]
    assert cap["captured_s"] == 0.2 and cap["bytes"] > 0
    assert cap["trace"].startswith(str(tmp_path))
    with open(cap["trace"]) as f:
        assert json.load(f)["traceEvents"]


def test_engine_routes_are_503_without_profile_engines():
    async def main():
        rt = await t_dist.DistributedRuntime.create(t_config.RuntimeConfig())
        manager = ModelManager(rt)
        http = HttpService(manager, port=0)
        await http.start()
        try:
            got = {p: (await _get(http.port, p))
                   for p in ("/debug", "/debug/profile", "/debug/memory",
                             "/debug/kv", "/debug/router",
                             "/debug/prefixes", "/debug/control",
                             "/debug/tenants", "/debug/classes")}
            got["post"] = await call(http.port, "POST", "/debug/profile")
        finally:
            await http.stop()
            await manager.close()
            await rt.close()
        return got

    got = asyncio.run(asyncio.wait_for(main(), 30))
    assert got["/debug"][0] == 200
    idx = got["/debug"][1]["surfaces"]
    # the reference lists its tenancy and class routes available always
    always = {"/debug/requests", "/debug/tenants", "/debug/classes"}
    assert not any(row["available"] for p, row in idx.items()
                   if p not in always)
    assert not any(row["armed"] for p, row in idx.items()
                   if p != "/debug/requests")
    assert all(idx[p]["available"] for p in always)
    for p in ("/debug/profile", "/debug/memory", "/debug/kv",
              "/debug/router", "/debug/prefixes", "/debug/control",
              "/debug/tenants", "/debug/classes"):
        assert got[p][0] == 503 and got[p][1]["status"] == "unavailable"
    assert got["post"][0] == 405


def test_armed_serving_loads_no_jax(tmp_path):
    ckpt = write_synthetic_hf_checkpoint(str(tmp_path / "tiny"),
                                         preset="tiny")
    trace, audit = tmp_path / "trace.jsonl", tmp_path / "audit.jsonl"
    probe = (
        "import asyncio, json, runpy, sys, time, urllib.request\n"
        "sys.argv = ['dynamo_tpu_torch.run', 'in=text:hi', "
        f"'out=torch:{ckpt}', '--device', 'cpu', '--max-tokens', '4']\n"
        "runpy.run_module('dynamo_tpu_torch.run', run_name='__main__')\n"
        "import dynamo_tpu_torch.llm.perf, dynamo_tpu_torch.llm.audit\n"
        "import dynamo_tpu_torch.tenancy, dynamo_tpu_torch.serving_classes\n"
        "import dynamo_tpu_torch.control\n"
        "import dynamo_tpu_torch.runtime.logging_util\n"
        "from dynamo_tpu_torch.llm import entrypoint as e\n"
        "from dynamo_tpu_torch.runtime.config import RuntimeConfig\n"
        "from dynamo_tpu_torch.runtime.distributed import "
        "DistributedRuntime\n"
        "from dynamo_tpu_torch.runtime.recorder import Recorder\n"
        "from dynamo_tpu_torch.runtime.tracing import tracer\n"
        "async def main():\n"
        "    rt = await DistributedRuntime.create(RuntimeConfig.from_env())\n"
        f"    eng, card = e.build_torch_engine({ckpt!r}, 'tiny', "
        "num_pages=16, device='cpu')\n"
        "    assert eng.step_recorder is not None\n"
        "    assert eng.memory_ledger is not None\n"
        "    h = await e.serve_engine(rt, eng, card, instance_id=1)\n"
        "    fe = await e.start_frontend(rt, port=0)\n"
        "    assert h.publisher is not None and fe.slo is not None\n"
        "    assert fe.control is not None and fe.http.quota is not None\n"
        "    assert fe.http.brownout is not None and eng.fair is not None\n"
        "    def get(p):\n"
        "        with urllib.request.urlopen(fe.url + p) as r:\n"
        "            return json.loads(r.read())\n"
        "    def chat():\n"
        "        body = json.dumps({'model': 'tiny', 'max_tokens': 4, "
        "'stream': True, 'messages': [{'role': 'user', 'content': 'hi'}]}"
        ").encode()\n"
        "        r = urllib.request.Request(fe.url + '/v1/chat/completions',"
        " body, {'Content-Type': 'application/json'})\n"
        "        with urllib.request.urlopen(r) as resp:\n"
        "            return resp.read()\n"
        "    try:\n"
        "        prof = await asyncio.to_thread(get, "
        "'/debug/profile?capture_s=0.1')\n"
        "        mem = await asyncio.to_thread(get, '/debug/memory')\n"
        "        await asyncio.to_thread(chat)\n"
        "        reqs = await asyncio.to_thread(get, '/debug/requests')\n"
        "        await asyncio.sleep(0.5)\n"
        "        fleet = await asyncio.to_thread(get, '/fleet/status')\n"
        "    finally:\n"
        "        await fe.stop(); await h.stop(); await eng.close()\n"
        "        await rt.close(); await tracer().close()\n"
        "    return prof, mem, reqs, fleet\n"
        "prof, mem, reqs, fleet = asyncio.run(main())\n"
        "print('CAPTURE', prof['capture']['bytes'] > 0)\n"
        "print('WEIGHTS', mem['engines'][0]['summary']['last']['classes']"
        "['weights'] > 0)\n"
        "(rec,) = reqs['recent']\n"
        f"spans = [ev for _, ev in Recorder.iter_events({str(trace)!r})]\n"
        "names = {s['name'] for s in spans "
        "if s['traceId'] == rec['trace_id']}\n"
        "print('TRACE', {'http chat_completions', 'engine.request', "
        "'engine.decode'} <= names)\n"
        f"print('AUDIT', len(list(Recorder.iter_events({str(audit)!r}))))\n"
        "print('SLO', fleet['slo']['ttft']['state'])\n"
        "print('FLEET', sorted(c['role'] for c in fleet['components']))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dynamo_tpu'))\n"
        "print('LOADED', bad)\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "DYN_ATTENTION_IMPL")}
    env.update(PYTHONPATH=REPO, DYN_STEP_PROFILE="1", DYN_MEM_LEDGER="1",
               TMPDIR=str(tmp_path), DYN_TRACE="1", DYN_TRACE_PATH=str(trace),
               DYN_AUDIT="1", DYN_AUDIT_SINKS="jsonl",
               DYN_AUDIT_PATH=str(audit), DYN_TELEMETRY_INTERVAL="0.1",
               DYN_SLO_TTFT="0.000001", DYN_SLO_CHECK_INTERVAL="0.1",
               DYN_LOG_FORMAT="jsonl", DYN_CLASSES="1", DYN_CONTROL="all",
               DYN_TENANCY='{"tenants": [{"name": "t"}]}')
    proc = subprocess.run([sys.executable, "-c", probe], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    for line in ("CAPTURE True", "WEIGHTS True", "TRACE True", "AUDIT 1",
                 "SLO breach", "FLEET ['frontend', 'worker']", "LOADED []"):
        assert line in proc.stdout, proc.stdout
