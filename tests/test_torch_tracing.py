"""The port's tracer and recorder (`dynamo_tpu_torch/runtime/tracing.py`,
`runtime/recorder.py`) held against the JAX package's on the same inputs.

- `head_sampled` is the same pure function of the trace id (2000 seeded
  ids at each of four ratios), so a mixed fleet makes one decision per
  trace; `traceparent` strings parse and format alike, flags included.
- `Span.to_otlp` gives equal records for fixed ids and times.
- Whole scenarios (the sampling soak with errors, the tail keep of ERROR
  and slow traces, the per-trace buffer bounds, queue drops, request
  traces, nesting) run on both packages with the same seeded ids and one
  fake clock: the exported rows and the exported / dropped / sampled-out
  counters are equal.
- Rotation keeps the same generations; each package's `iter_events`
  reads the other's file; the env knobs configure both alike; a disabled
  tracer gives no request trace in either.
"""

import asyncio
import random
import time

import pytest

from dynamo_tpu.runtime import recorder as ref_recorder
from dynamo_tpu.runtime import tracing as ref_tracing
from dynamo_tpu_torch.runtime import recorder as t_recorder
from dynamo_tpu_torch.runtime import tracing as t_tracing
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

PKGS = {"ref": (ref_tracing, ref_recorder), "torch": (t_tracing, t_recorder)}


class FakeSecrets:
    """Seeded stand-in for the secrets module: the same ids in both
    packages."""

    def __init__(self, seed: int) -> None:
        self._rng = random.Random(seed)

    def token_hex(self, n: int) -> str:
        return f"{self._rng.getrandbits(8 * n):0{2 * n}x}"


class FakeClock:
    """A `time` stand-in whose time_ns advances 1 ms per read."""

    def __init__(self) -> None:
        self.t = 1_700_000_000_000_000_000

    def time_ns(self) -> int:
        self.t += 1_000_000
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


def _ids(seed: int, n: int) -> list[str]:
    fake = FakeSecrets(seed)
    return [fake.token_hex(16) for _ in range(n)]


@pytest.mark.parametrize("ratio", [0.0, 0.1, 0.5, 1.0])
def test_head_sampled_matches_reference(ratio):
    ids = _ids(7, 2000)
    got = [t_tracing.head_sampled(t, ratio) for t in ids]
    assert got == [ref_tracing.head_sampled(t, ratio) for t in ids]
    if 0 < ratio < 1:
        assert abs(sum(got) / len(got) - ratio) < 0.04


TRACEPARENTS = [
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-00",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-xx",     # garbage flags
    "00-" + "a" * 32 + "-" + "b" * 16 + "-03",     # other bits set
    "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",     # forbidden version
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",     # short trace id
    "00-" + "a" * 32 + "-" + "b" * 15 + "-01",     # short span id
    " 00-" + "c" * 32 + "-" + "d" * 16 + "-01\n",  # whitespace
    "not a traceparent",
    "",
]


@pytest.mark.parametrize("tp", TRACEPARENTS)
def test_traceparent_parsing_matches_reference(tp):
    assert t_tracing.parse_traceparent_ex(tp) == \
        ref_tracing.parse_traceparent_ex(tp)
    assert t_tracing.parse_traceparent(tp) == \
        ref_tracing.parse_traceparent(tp)
    # a span continued from it: same identity, flags and header
    spans = [mod.Tracer(enabled=False, sample=0.5).start_span(
        "x", traceparent=tp) for mod in (ref_tracing, t_tracing)]
    if t_tracing.parse_traceparent(tp) is not None:
        assert spans[0].trace_id == spans[1].trace_id
        assert spans[0].parent_span_id == spans[1].parent_span_id
        assert spans[0].sampled == spans[1].sampled
        assert spans[0].traceparent()[:-21] == spans[1].traceparent()[:-21]
        assert spans[0].traceparent()[-2:] == spans[1].traceparent()[-2:]


def test_span_to_otlp_matches_reference():
    kw = dict(name="engine.prefill.chunk", trace_id="1" * 32,
              span_id="2" * 16, parent_span_id="3" * 16, start_ns=5,
              end_ns=9, attributes={"tokens": 7, "entry": "prefill",
                                    "mixed": False, "ratio": 0.25},
              events=[{"name": "compile", "timeUnixNano": 6,
                       "attributes": []}], status="ERROR")
    assert t_tracing.Span(**kw).to_otlp() == ref_tracing.Span(**kw).to_otlp()
    root = dict(kw, parent_span_id=None)
    assert t_tracing.Span(**root).to_otlp() == \
        ref_tracing.Span(**root).to_otlp()


# -- whole scenarios, run on both packages -----------------------------------


def _soak(mod, t):
    for i in range(400):
        with t.start_span("http request"):
            child = t.start_span("engine.request")
            if i % 50 == 7:
                child.record_error(RuntimeError("injected"))
            child.end()


def _tail_error(mod, t):
    with t.start_span("bad request"):
        child = t.start_span("engine.request")
        child.record_error(RuntimeError("kaboom"))
        child.end()
    with t.start_span("fine request"):
        pass


def _tail_slow(mod, t):
    slow = t.start_span("slow op")
    slow.start_ns -= int(80e6)
    slow.end()
    t.start_span("fast op").end()


def _buffer_bound(mod, t):
    # more open unsampled traces than the buffer holds, and more spans
    # per trace than it keeps; an evicted trace loses its ERROR
    roots = [t.start_span(f"root {i}") for i in range(6)]
    for i, r in enumerate(roots):
        for j in range(5):
            s = t.start_span(f"child {i}.{j}",
                             traceparent=r.traceparent())
            if j == 1 and i % 2:
                s.record_error(RuntimeError("late"))
            s.end()
    for r in roots:
        r.end()


def _queue_drops(mod, t):
    real = t._recorder.record
    calls = {"n": 0}

    def flaky(event):
        calls["n"] += 1
        return False if calls["n"] % 3 == 1 else real(event)

    t._recorder.record = flaky
    for i in range(10):
        t.start_span(f"s{i}").end()


def _request_traces(mod, t):
    with t.start_span("serve dynamo.backend.generate"):
        rt = mod.RequestTrace.begin("engine.request", None,
                                    {"request.id": "r1"})
    rt.event("enqueued", waiting=0, running=1)
    rt.stage("engine.queue_wait", 10, 20, cached_len=4, prompt_tokens=9)
    rt.stage("engine.prefill.chunk", 20, 30, tokens=5, compiled=True)
    rt.event("first_token")
    rt.end(status="OK", finish_reason="length", tokens=6)
    rt.end(status="ERROR")                  # ends once
    # no current span: the header is the parent
    hdr = {mod.TRACEPARENT: "00-" + "9" * 32 + "-" + "8" * 16 + "-01"}
    rt2 = mod.RequestTrace.begin("engine.request", hdr)
    rt2.end(status="ERROR", finish_reason="error")


def _nesting(mod, t):
    with t.start_span("outer") as outer:
        with t.start_span("inner"):
            headers = mod.inject_headers({})
        t.start_span("explicit", traceparent=headers[mod.TRACEPARENT]).end()
        assert mod.current_span() is outer
    assert mod.current_span() is None


SCENARIOS = {
    "soak": (_soak, dict(sample=0.1)),
    "tail_error": (_tail_error, dict(sample=0.0)),
    "tail_slow": (_tail_slow, dict(sample=0.0, slow_ms=50.0)),
    "buffer_bound": (_buffer_bound, dict(sample=0.0, max_buffered_traces=4,
                                         max_spans_per_trace=3)),
    "queue_drops": (_queue_drops, dict(sample=1.0)),
    "request_traces": (_request_traces, dict(sample=1.0)),
    "nesting": (_nesting, dict(sample=1.0)),
}


def _run(pkg, name, tmp_path, monkeypatch):
    mod, rec_mod = PKGS[pkg]
    fn, kw = SCENARIOS[name]
    monkeypatch.setattr(mod, "secrets", FakeSecrets(1234))
    monkeypatch.setattr(mod, "time", FakeClock())
    path = tmp_path / f"{pkg}-{name}.jsonl"
    t = mod.Tracer(enabled=True, path=str(path), service="svc", **kw)
    mod.set_tracer(t)
    try:
        fn(mod, t)
    finally:
        mod.set_tracer(None)
    asyncio.run(t.close())
    rows = [e for _, e in rec_mod.Recorder.iter_events(path)]
    return rows, (t.exported, t.dropped, t.sampled_out_total.get())


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_rows_and_counters_match_reference(name, tmp_path,
                                                    monkeypatch):
    want, want_n = _run("ref", name, tmp_path, monkeypatch)
    got, got_n = _run("torch", name, tmp_path, monkeypatch)
    assert got == want
    assert got_n == want_n
    assert got_n[0] == len(got)
    if name == "soak":
        assert 0 < len(got) < 800
        assert got_n[1] == 0
    if name == "queue_drops":
        assert got_n[1] == 4
    if name == "buffer_bound":
        assert got and got_n[2] > 0


@pytest.mark.parametrize("writer,reader", [("torch", "ref"),
                                           ("ref", "torch")])
def test_recorder_files_read_across_packages(writer, reader, tmp_path):
    path = tmp_path / "r.jsonl"
    events = [{"i": i, "span": {"name": f"s{i}", "attrs": [1, "x"]}}
              for i in range(20)]

    async def write():
        rec = PKGS[writer][1].Recorder(path)
        for e in events:
            assert rec.record(e)
        await rec.close()
        return rec.event_count

    assert asyncio.run(write()) == len(events)
    rows = list(PKGS[reader][1].Recorder.iter_events(path))
    assert [e for _, e in rows] == events
    assert all(isinstance(ts, float) for ts, _ in rows)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_rotation_keeps_the_same_generations(pkg, tmp_path):
    rec_mod = PKGS[pkg][1]
    path = tmp_path / "trace.jsonl"

    async def main():
        rec = rec_mod.Recorder(path, max_bytes=1000, keep=2)
        for i in range(60):
            assert rec.record({"i": i, "pad": "x" * 100})
        await rec.close()
        return rec.rotations

    rotations = asyncio.run(main())
    assert rotations >= 2 and path.stat().st_size <= 1000
    assert (tmp_path / "trace.jsonl.1").exists()
    assert (tmp_path / "trace.jsonl.2").exists()
    assert not (tmp_path / "trace.jsonl.3").exists()
    kept = [e["i"] for g in ("trace.jsonl.2", "trace.jsonl.1", "trace.jsonl")
            for _, e in rec_mod.Recorder.iter_events(tmp_path / g)]
    assert kept == list(range(60 - len(kept), 60))


def test_rotation_sizes_match_reference(tmp_path, monkeypatch):
    """With one fixed clock (each line's timestamp has the same width),
    both packages rotate at the same lines."""
    sizes = {}
    for pkg in PKGS:
        monkeypatch.setattr(PKGS[pkg][1], "time", FakeClock())
        monkeypatch.setattr(PKGS[pkg][1].time, "time", lambda: 1.5,
                            raising=False)
        d = tmp_path / pkg
        d.mkdir()

        async def main(rec_mod=PKGS[pkg][1], d=d):
            rec = rec_mod.Recorder(d / "t.jsonl", max_bytes=700, keep=3)
            for i in range(40):
                rec.record({"i": i, "pad": "y" * (i % 7) * 10})
            await rec.close()
            return rec.rotations

        rot = asyncio.run(main())
        sizes[pkg] = (rot, sorted(
            sum(1 for _ in PKGS[pkg][1].Recorder.iter_events(p))
            for p in d.iterdir()))
    assert sizes["torch"] == sizes["ref"]


def test_failed_writer_counts_what_it_lost(tmp_path):
    """A trace file that cannot be opened fails the drain: the spans
    after the failure count as dropped, in both packages alike."""
    counts = {}
    for pkg, (mod, _) in PKGS.items():
        bad = tmp_path / pkg / "dir-not-file"
        bad.mkdir(parents=True)
        t = mod.Tracer(enabled=True, path=str(bad))

        async def main(t=t):
            t.start_span("first").end()
            for _ in range(200):
                if t._recorder.failed:
                    break
                await asyncio.sleep(0.01)
            for i in range(3):
                t.start_span(f"after {i}").end()
            await t.close()

        asyncio.run(main())
        counts[pkg] = (t.exported, t.dropped, bool(t._recorder.failed))
    assert counts["torch"] == counts["ref"] == (1, 3, True)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_env_knobs_and_disabled_tracer(pkg, monkeypatch, tmp_path):
    mod = PKGS[pkg][0]
    for var, val in (("DYN_TRACE", "1"),
                     ("DYN_TRACE_PATH", str(tmp_path / "t.jsonl")),
                     ("DYN_TRACE_SAMPLE", "0.25"),
                     ("DYN_TRACE_SLOW_MS", "150"),
                     ("DYN_TRACE_MAX_MB", "2"), ("DYN_TRACE_KEEP", "5")):
        monkeypatch.setenv(var, val)
    mod.set_tracer(None)
    try:
        t = mod.tracer()
        assert (t.enabled, t.sample, t.slow_ms, t._recorder.max_bytes,
                t._recorder.keep, str(t._recorder.path)) == (
            True, 0.25, 150.0, 2 * 1024 * 1024, 5,
            str(tmp_path / "t.jsonl"))
        monkeypatch.delenv("DYN_TRACE")
        mod.set_tracer(None)
        assert mod.tracer().enabled is False
        assert mod.RequestTrace.begin("engine.request", {}) is None
        reg = MetricsRegistry("dynamo")
        mod.tracer().register_metrics(reg)
        text = reg.render()
        for name in ("dynamo_trace_exported_total 0",
                     "dynamo_trace_dropped_total 0",
                     "dynamo_trace_sampled_out_total 0"):
            assert name in text
    finally:
        mod.set_tracer(None)
