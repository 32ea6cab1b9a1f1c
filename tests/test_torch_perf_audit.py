"""The port's stream perf capture (`dynamo_tpu_torch/llm/perf.py`), audit
bus (`llm/audit.py`) and `/debug/requests`, held against the JAX
package's.

- The ITL histogram helpers, `StreamPerf.summary` and
  `LogprobAnalysis.summary` (engine outputs and OpenAI chunks) are equal
  on the same recorded items; `python -m dynamo_tpu_torch.llm.perf`
  prints what the reference's CLI prints for one capture, in a fresh
  interpreter that loads no jax.
- The audit tap emits one record per stream, equal to the reference's
  tap's record for the same stream (text, reasoning, tool calls, finish
  reason, usage, error); `audit_bus_from_env` arms alike; a port
  frontend with `DYN_AUDIT=1` writes one JSONL record per request whose
  text and usage are the response's.
- `/debug/requests` on the port's frontend has the reference's shape:
  the same chats, one streamed, through both packages' frontends give
  entries with the same keys, statuses, usage and order, and `?limit`
  bounds them alike.
"""

import asyncio
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from dynamo_tpu.llm import audit as ref_audit
from dynamo_tpu.llm import http_service as ref_http
from dynamo_tpu.llm import perf as ref_perf
from dynamo_tpu.runtime.recorder import Recorder as RefRecorder
from dynamo_tpu_torch.llm import audit as t_audit
from dynamo_tpu_torch.llm import http_service as t_http
from dynamo_tpu_torch.llm import perf as t_perf
from dynamo_tpu_torch.runtime.recorder import Recorder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERF = {"ref": ref_perf, "torch": t_perf}


def _engine_items(seed: int) -> list:
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(12):
        n = int(rng.integers(0, 4))
        toks = [int(t) for t in rng.integers(0, 100, n)]
        lps = [float(-x) for x in rng.exponential(0.5, n)]
        tops = [[[t, lp]] + [[int(a), float(lp - abs(d))] for a, d in zip(
            rng.integers(0, 100, 2), rng.normal(0, 0.3, 2))]
            for t, lp in zip(toks, lps)]
        item = {"token_ids": toks, "log_probs": lps, "top_logprobs": tops}
        if rng.random() < 0.2:
            item["top_logprobs"] = tops[:1]
        items.append(item)
    items.append({"token_ids": [], "finish_reason": "length"})
    return items


def _openai_chunks(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(8):
        lp = float(-rng.exponential(0.4))
        alt = float(lp - rng.normal(0.2, 0.5))
        out.append({"choices": [{"index": 0, "delta": {"content": f"t{i}"},
                                 "logprobs": {"content": [{
                                     "token": f"t{i}", "logprob": lp,
                                     "top_logprobs": [
                                         {"token": f"t{i}", "logprob": lp},
                                         {"token": "x", "logprob": alt}]}]}}]})
    out.append({"choices": [{"index": 0, "delta": {},
                             "finish_reason": "stop"}]})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_itl_helpers_and_stream_perf_match_reference(seed):
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(40.0, 200)
    hists = {}
    for pkg, mod in PERF.items():
        h = mod.itl_new_hist()
        for g in gaps:
            mod.itl_observe(h, float(g))
        hists[pkg] = (h, [mod.itl_percentile(h, q)
                          for q in (0.0, 0.5, 0.9, 0.99, 1.0)])
    assert hists["torch"] == hists["ref"]
    assert t_perf.ITL_BUCKET_EDGES_MS == ref_perf.ITL_BUCKET_EDGES_MS
    items = _engine_items(seed) + _openai_chunks(seed)
    ats = np.cumsum(rng.exponential(0.02, len(items)))
    summaries = {}
    for pkg, mod in PERF.items():
        perf = mod.StreamPerf(started_at=0.0)
        for at, it in zip(ats, items):
            perf.items.append(mod.RecordedItem(
                at=float(at), n_tokens=mod.count_tokens(it)))
        summaries[pkg] = perf.summary()
    assert json.dumps(summaries["torch"]) == json.dumps(summaries["ref"])
    assert summaries["torch"]["total_tokens"] > 0


def test_record_stream_passes_items_through():
    async def gen():
        for it in _engine_items(3):
            yield it

    async def main():
        perf = t_perf.StreamPerf()
        return [i async for i in t_perf.record_stream(gen(), perf)], perf

    items, perf = asyncio.run(main())
    assert items == _engine_items(3)
    assert perf.total_tokens() == sum(len(i["token_ids"]) for i in items)


@pytest.mark.parametrize("kind", ["engine", "openai", "both"])
@pytest.mark.parametrize("seed", [0, 1])
def test_logprob_analysis_matches_reference(kind, seed):
    items = {"engine": _engine_items(seed), "openai": _openai_chunks(seed),
             "both": _engine_items(seed) + _openai_chunks(seed)}[kind]
    a = {pkg: mod.LogprobAnalysis.from_items(items)
         for pkg, mod in PERF.items()}
    b = {pkg: mod.LogprobAnalysis.from_items(items[::-1])
         for pkg, mod in PERF.items()}
    got, want = a["torch"], a["ref"]
    assert json.dumps(got.summary()) == json.dumps(want.summary())
    for thr in (0.05, 0.1, 0.5):
        assert got.close_positions(thr) == want.close_positions(thr)
    assert json.dumps(got.topk_overlap(b["torch"])) == json.dumps(
        want.topk_overlap(b["ref"]))
    assert len(got.positions) > 0


def test_perf_cli_matches_reference(tmp_path):
    """The port's CLI (in a fresh interpreter: no jax, no dynamo_tpu
    module loads) prints what the reference's prints for one capture."""
    path = tmp_path / "cap.jsonl"

    async def write():
        rec = Recorder(path)
        for it in _engine_items(5):
            rec.record(it)
        await rec.close()

    asyncio.run(write())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    outs = {}
    for pkg in PERF:
        probe = (
            "import sys, runpy\n"
            f"sys.argv = ['perf', {str(path)!r}, '--close-threshold', "
            "'0.2']\n"
            f"runpy.run_module('dynamo_tpu{'' if pkg == 'ref' else '_torch'}"
            ".llm.perf', run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dynamo_tpu'))\n"
            "print('LOADED', bad, file=sys.stderr)\n")
        proc = subprocess.run([sys.executable, "-c", probe], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        outs[pkg] = (json.loads(proc.stdout), proc.stderr)
    assert outs["torch"][0] == outs["ref"][0]
    assert outs["torch"][0]["latency"]["total_tokens"] > 0
    assert "LOADED []" in outs["torch"][1]


# -- the audit tap -------------------------------------------------------------


def _chat_chunks(with_error: bool) -> list:
    return [
        {"choices": [{"index": 0, "delta": {"role": "assistant"}}]},
        {"choices": [{"index": 0, "delta": {"reasoning_content": "plan "}}]},
        {"choices": [{"index": 0, "delta": {"content": "Hello"}}]},
        {"choices": [{"index": 0, "delta": {"tool_calls": [{
            "index": 0, "id": "call_1", "type": "function",
            "function": {"name": "f", "arguments": "{}"}}]}}]},
        {"choices": [{"index": 0, "text": " world"}]},
        {"choices": [{"index": 0, "delta": {},
                      "finish_reason": "tool_calls"}],
         "usage": {"prompt_tokens": 7, "completion_tokens": 4,
                   "total_tokens": 11}},
    ] + ([{"boom": True}] if with_error else [])


class ChunkEngine:
    def __init__(self, chunks) -> None:
        self.chunks = chunks

    async def generate(self, request, context):
        for ch in self.chunks:
            if ch.get("boom"):
                raise RuntimeError("engine failed mid-stream")
            yield ch


class ListBus:
    def __init__(self) -> None:
        self.records = []

    def publish(self, rec) -> None:
        self.records.append(rec)


@pytest.mark.parametrize("with_error", [False, True])
def test_audit_tap_record_matches_reference(with_error):
    chunks = _chat_chunks(with_error)
    recs = {}
    for pkg, (http_mod, audit_mod) in (("ref", (ref_http, ref_audit)),
                                       ("torch", (t_http, t_audit))):
        bus = ListBus()
        rec = audit_mod.AuditRecord(request_id="r", endpoint="chat",
                                    model="m", request={"a": 1})
        tap = http_mod._AuditTap(ChunkEngine(chunks), rec, bus)

        async def main(tap=tap):
            out = []
            try:
                async for item in tap.generate({}, None):
                    out.append(item)
            except RuntimeError:
                pass
            return out

        out = asyncio.run(main())
        assert out == [c for c in chunks if not c.get("boom")]
        assert len(bus.records) == 1
        d = bus.records[0].to_dict()
        assert d.pop("finished_at") >= d.pop("created_at")
        recs[pkg] = d
    assert recs["torch"] == recs["ref"]
    assert recs["torch"]["response_text"] == "Hello world"
    assert (recs["torch"]["error"] is not None) is with_error


@pytest.mark.parametrize("env", [
    {}, {"DYN_AUDIT": "1"}, {"DYN_AUDIT": "yes", "DYN_AUDIT_SINKS": "log"},
    {"DYN_AUDIT": "true", "DYN_AUDIT_SINKS": "jsonl,log"},
    {"DYN_AUDIT": "1", "DYN_AUDIT_SINKS": "stderr,bogus"},
    {"DYN_AUDIT": "0", "DYN_AUDIT_SINKS": "jsonl"}])
def test_audit_bus_from_env_matches_reference(env, monkeypatch, tmp_path):
    for var in ("DYN_AUDIT", "DYN_AUDIT_SINKS", "DYN_AUDIT_PATH"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("DYN_AUDIT_PATH", str(tmp_path / "a.jsonl"))
    buses = {"ref": ref_audit.audit_bus_from_env(),
             "torch": t_audit.audit_bus_from_env()}
    shape = {pkg: None if b is None else [s.name for s in b.sinks]
             for pkg, b in buses.items()}
    assert shape["torch"] == shape["ref"]

    async def close():
        for b in buses.values():
            if b is not None:
                await b.close()

    asyncio.run(close())


def test_audit_bus_counts_and_jsonl_sink(tmp_path):
    path = tmp_path / "audit.jsonl"

    async def main():
        bus = t_audit.AuditBus([t_audit.JsonlSink(str(path))])
        for i in range(3):
            bus.publish(t_audit.AuditRecord(request_id=f"r{i}",
                                            endpoint="chat"))
        await bus.close()
        bus.publish(t_audit.AuditRecord(request_id="late", endpoint="chat"))
        return bus.published, bus.dropped

    assert asyncio.run(main()) == (3, 1)
    # the reference's reader reads the port's file
    assert [e["request_id"] for _, e in RefRecorder.iter_events(path)] == \
        ["r0", "r1", "r2"]


# -- through the frontends -------------------------------------------------------


def test_debug_requests_and_audit_through_frontends(tmp_path, monkeypatch):
    """The same three chats (the second streamed) through the reference's
    frontend over a TpuEngine and the port's over a TorchEngine with the
    same weights, the port's with DYN_AUDIT=1 writing JSONL:
    /debug/requests entries have the reference's keys, statuses, stream
    flags, usage and order; `?limit=2` keeps the newest two; the audit
    file has one record per chat whose text and usage are the
    response's."""
    from dynamo_tpu.engine import attention as jattn
    from dynamo_tpu.llm import entrypoint as ref_entry
    from dynamo_tpu.llm import model_card as ref_card
    from dynamo_tpu.runtime import config as ref_config
    from dynamo_tpu.runtime import distributed as ref_dist
    from dynamo_tpu_torch.llm import entrypoint as t_entry
    from dynamo_tpu_torch.llm import model_card as t_card
    from dynamo_tpu_torch.runtime import config as t_config
    from dynamo_tpu_torch.runtime import distributed as t_dist
    from tests.test_torch_serving import (
        _card,
        _engines,
        _renew_lease,
        call,
        sse_events,
    )

    prev = jattn._impl
    jattn.set_attention_impl("auto")
    audit_path = tmp_path / "audit.jsonl"
    monkeypatch.setenv("DYN_AUDIT", "1")
    monkeypatch.setenv("DYN_AUDIT_SINKS", "jsonl")
    monkeypatch.setenv("DYN_AUDIT_PATH", str(audit_path))
    jax_eng, torch_eng = _engines()
    chats = [{"model": "tiny", "max_tokens": 5, "temperature": 0,
              "stream": i == 1,
              "messages": [{"role": "user", "content": f"audit me {i}"}]}
             for i in range(3)]

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
            # the reference's bus off (its own env gating is the same)
            fes.append(await ref_entry.start_frontend(ref_rt, port=0))
            fes[0].http.audit = None
            fes.append(await t_entry.start_frontend(t_rt, port=0))
            out = {}
            for label, fe in zip(("ref", "torch"), fes):
                bodies = [await call(fe.http.port, "POST",
                                     "/v1/chat/completions", c)
                          for c in chats]
                dbg = {q: json.loads((await call(
                    fe.http.port, "GET", f"/debug/requests{q}"))[2])
                    for q in ("", "?limit=2")}
                out[label] = (bodies, dbg)
            return out
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
            jattn.set_attention_impl(prev)

    out = asyncio.run(asyncio.wait_for(main(), 100))
    (ref_bodies, ref_dbg), (bodies, dbg) = out["ref"], out["torch"]
    for q in ("", "?limit=2"):
        got, want = dbg[q], ref_dbg[q]
        assert set(got) == set(want) == {"in_flight", "recent"}
        assert got["in_flight"] == want["in_flight"] == []
        assert len(got["recent"]) == len(want["recent"]) == \
            (2 if q else 3)
        for g, w in zip(got["recent"], want["recent"]):
            assert set(g) == set(w)
            for key in ("endpoint", "model", "stream", "status", "usage",
                        "tenant", "trace_id"):
                assert g[key] == w[key], key
            assert g["duration_s"] >= 0
    streamed = next(r for r in dbg[""]["recent"] if r["stream"])
    assert streamed["first_token_s"] is not None
    assert streamed["duration_s"] >= streamed["last_token_s"] >= \
        streamed["first_token_s"]
    # the audit records: one per chat, the response's text and usage
    recs = [e for _, e in Recorder.iter_events(audit_path)]
    assert len(recs) == len(chats)
    by_id = {r["request_id"]: r for r in recs}
    for chat, (st, _, raw), dbg_rec in zip(
            chats, bodies, reversed(dbg[""]["recent"])):
        assert st == 200
        rec = by_id[dbg_rec["request_id"]]
        if chat["stream"]:
            events = sse_events(raw)
            text = "".join(c["choices"][0]["delta"].get("content") or ""
                           for c in events if c.get("choices"))
            usage = [c["usage"] for c in events if c.get("usage")][-1]
        else:
            body = json.loads(raw)
            text, usage = body["choices"][0]["message"]["content"], \
                body["usage"]
        assert rec["response_text"] == text
        assert rec["usage"] == usage == dbg_rec["usage"]
        assert rec["endpoint"] == "chat_completions" and rec["model"] == \
            "tiny"
        assert rec["request"]["messages"] == chat["messages"]
        assert rec["finish_reason"] in ("length", "stop")
