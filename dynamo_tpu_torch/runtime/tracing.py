"""Distributed tracing: request spans + W3C propagation + OTLP-file export.

Port of `dynamo_tpu/runtime/tracing.py` (the port keeps its own copy):
the same head-sampling function of the trace id, `traceparent` header
and OTLP span records, so a fleet that mixes both packages' processes
keeps one trace per request and makes one sampling decision for it.
Span attributes are host values only (ints and strings): the drain
thread writes JSON and never touches the card.

Reference: `lib/runtime/src/logging.rs:72-106` — tracing spans with
OpenTelemetry export and W3C `traceparent` context propagation; HTTP
requests wrapped in `make_request_span` (`http/service/service_v2.rs:21`);
span context rides every network hop so a request is one trace across
frontend → router → worker.

This build has zero egress, so the exporter writes OTLP-shaped span JSON
to a local JSONL file (the Tempo-compose analog is a file tail) via the
shared off-loop BackgroundDrain. The current span lives in a contextvar —
asyncio tasks inherit it, so nesting works without threading span objects
through every call.

Sampling (docs/observability.md "Sampling"): head sampling is
trace-id-ratio — the keep/drop decision is a pure function of the
trace_id (`head_sampled`), so every process that sees the same trace
makes the same call, and the decision additionally rides the W3C flags
byte (``…-01`` sampled / ``…-00`` not) so old/new senders interop.
Head-sampled-out traces are not discarded immediately: their spans
buffer per-trace (bounded) until the trace's last open span ends, and
the whole trace is kept anyway when any span ended ERROR or ran longer
than ``DYN_TRACE_SLOW_MS`` (tail-based keep). The export queue is
bounded; queue-bound drops count in ``dynamo_trace_dropped_total``.

Env: ``DYN_TRACE=1`` enables, ``DYN_TRACE_PATH`` (default trace.jsonl)
targets the file, ``DYN_TRACE_SAMPLE`` (0..1, default 1 = trace all)
sets the head ratio, ``DYN_TRACE_SLOW_MS`` (default 0 = off) the
tail-keep latency threshold, ``DYN_TRACE_MAX_MB``/``DYN_TRACE_KEEP``
size-based file rotation.
"""

from __future__ import annotations

import contextvars
import os
import secrets
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Optional

from dynamo_tpu_torch.runtime.metrics import Counter, MetricsRegistry
from dynamo_tpu_torch.runtime.recorder import Recorder

TRACEPARENT = "traceparent"

_current_span: contextvars.ContextVar[Optional["Span"]] = \
    contextvars.ContextVar("dyn_current_span", default=None)


def head_sampled(trace_id: str, ratio: float) -> bool:
    """Trace-id-ratio head decision: deterministic in the trace_id, so
    frontend and worker agree without coordination (OTel TraceIdRatioBased
    semantics: compare the low 64 bits against ratio * 2^64)."""
    if ratio >= 1.0:
        return True
    if ratio <= 0.0:
        return False
    try:
        low64 = int(trace_id[-16:], 16)
    except ValueError:
        return True
    return low64 < ratio * float(1 << 64)


@dataclass
class Span:
    name: str
    trace_id: str                   # 32 hex
    span_id: str                    # 16 hex
    parent_span_id: Optional[str] = None
    start_ns: int = 0
    end_ns: int = 0
    attributes: dict[str, Any] = field(default_factory=dict)
    events: list[dict] = field(default_factory=list)
    status: str = "OK"
    sampled: bool = True
    _tracer: Optional["Tracer"] = None
    _token: Optional[contextvars.Token] = None
    _counted: bool = False

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def record_error(self, err: BaseException) -> None:
        self.status = "ERROR"
        self.attributes["error"] = repr(err)

    def traceparent(self) -> str:
        """W3C: 00-<trace_id>-<span_id>-<flags>; flags bit 0 = sampled."""
        flags = "01" if self.sampled else "00"
        return f"00-{self.trace_id}-{self.span_id}-{flags}"

    # -- context manager -----------------------------------------------------

    def __enter__(self) -> "Span":
        self.start_ns = self.start_ns or time.time_ns()
        self._token = _current_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.record_error(exc)
        self.end(_reset=True)

    def end(self, _reset: bool = False) -> None:
        if self.end_ns:
            return
        self.end_ns = time.time_ns()
        if _reset and self._token is not None:
            _current_span.reset(self._token)
            self._token = None
        if self._tracer is not None:
            self._tracer._export(self)

    def to_otlp(self) -> dict:
        """One OTLP-ish span record (resourceSpans flattening omitted —
        a converter can lift these 1:1 into a real OTLP payload)."""
        return {
            "traceId": self.trace_id, "spanId": self.span_id,
            "parentSpanId": self.parent_span_id or "",
            "name": self.name,
            "startTimeUnixNano": self.start_ns,
            "endTimeUnixNano": self.end_ns,
            "attributes": [{"key": k, "value": {"stringValue": str(v)}}
                           for k, v in self.attributes.items()],
            "events": self.events,
            "status": {"code": self.status},
        }


def parse_traceparent(tp: str) -> Optional[tuple[str, str]]:
    """(trace_id, parent_span_id) from a W3C traceparent, else None."""
    ex = parse_traceparent_ex(tp)
    return None if ex is None else (ex[0], ex[1])


def parse_traceparent_ex(tp: str) -> Optional[tuple[str, str, bool]]:
    """(trace_id, parent_span_id, sampled) — also decodes the flags byte
    so the upstream head-sampling decision propagates across hops."""
    try:
        version, trace_id, span_id, flags = tp.strip().split("-")
    except ValueError:
        return None
    if len(trace_id) != 32 or len(span_id) != 16 or version == "ff":
        return None
    try:
        sampled = bool(int(flags, 16) & 0x01)
    except ValueError:
        sampled = True
    return trace_id, span_id, sampled


class Tracer:
    """Span factory + JSONL exporter. Disabled tracers hand out spans
    that never export (zero file I/O) so call sites stay unconditional.

    Export path: sampled spans go straight to the bounded Recorder
    drain; unsampled spans buffer per-trace until the trace's last
    tracked span ends, then either export anyway (tail keep: ERROR
    status or ≥ slow_ms duration anywhere in the trace) or drop,
    counted in `dynamo_trace_sampled_out_total`."""

    def __init__(self, enabled: bool = True,
                 path: Optional[str] = None,
                 service: str = "dynamo_tpu_torch",
                 sample: float = 1.0,
                 slow_ms: float = 0.0,
                 max_bytes: int = 0,
                 keep: int = 3,
                 max_buffered_traces: int = 256,
                 max_spans_per_trace: int = 512) -> None:
        self.enabled = enabled
        self.service = service
        self.sample = sample
        self.slow_ms = slow_ms
        self._recorder = Recorder(path or "trace.jsonl",
                                  max_bytes=max_bytes, keep=keep) \
            if enabled else None
        # registry-owned counters (`/metrics` renders them once the
        # process runtime calls register_metrics): mutated only via
        # Counter.inc, which has its own lock
        self.exported_total = Counter(
            "dynamo_trace_exported_total",
            "spans handed to the trace export drain")
        self.dropped_total = Counter(
            "dynamo_trace_dropped_total",
            "spans lost to the bounded export queue (drain full/failed)")
        self.sampled_out_total = Counter(
            "dynamo_trace_sampled_out_total",
            "spans discarded by head sampling (incl. buffer evictions)")
        self.max_buffered_traces = max_buffered_traces
        self.max_spans_per_trace = max_spans_per_trace
        self._lock = threading.Lock()
        self._pending: OrderedDict[str, list[Span]] = OrderedDict()
        self._open: dict[str, int] = {}

    @property
    def exported(self) -> int:
        """Back-compat int view of `dynamo_trace_exported_total`."""
        return int(self.exported_total.get())

    @property
    def dropped(self) -> int:
        return int(self.dropped_total.get())

    def register_metrics(self, registry: MetricsRegistry) -> None:
        """Adopt the tracer's counters into a scrape registry so
        `/metrics` owns them like every other counter."""
        registry.register(self.exported_total)
        registry.register(self.dropped_total)
        registry.register(self.sampled_out_total)

    def start_span(self, name: str,
                   traceparent: Optional[str] = None,
                   attributes: Optional[dict] = None) -> Span:
        """Child of (in priority order) the explicit traceparent, the
        contextvar's current span, or a fresh root. The sampled flag is
        inherited with the parent identity; fresh roots decide from
        their own trace_id."""
        parent_trace = parent_span = None
        sampled: Optional[bool] = None
        if traceparent:
            parsed = parse_traceparent_ex(traceparent)
            if parsed:
                parent_trace, parent_span, sampled = parsed
        if parent_trace is None:
            cur = _current_span.get()
            if cur is not None:
                parent_trace, parent_span = cur.trace_id, cur.span_id
                sampled = cur.sampled
        trace_id = parent_trace or secrets.token_hex(16)
        if sampled is None:
            sampled = head_sampled(trace_id, self.sample)
        span = Span(
            name=name,
            trace_id=trace_id,
            span_id=secrets.token_hex(8),
            parent_span_id=parent_span,
            start_ns=time.time_ns(),
            attributes={"service.name": self.service,
                        **(attributes or {})},
            sampled=sampled,
            _tracer=self if self.enabled else None)
        if self.enabled and not sampled:
            # tracked open span: the trace's tail buffer finalizes when
            # the count returns to zero
            span._counted = True
            with self._lock:
                self._open[trace_id] = self._open.get(trace_id, 0) + 1
        return span

    def _export(self, span: Span) -> None:
        if self._recorder is None:
            return
        if span.sampled:
            self._emit(span)
            return
        to_emit: Optional[list[Span]] = None
        with self._lock:
            buf = self._pending.get(span.trace_id)
            if buf is None:
                if len(self._pending) >= self.max_buffered_traces:
                    _tid, old = self._pending.popitem(last=False)
                    self._open.pop(_tid, None)
                    self.sampled_out_total.inc(len(old))
                buf = []
                self._pending[span.trace_id] = buf
            if len(buf) < self.max_spans_per_trace:
                buf.append(span)
            else:
                self.sampled_out_total.inc()
            if span._counted:
                n = self._open.get(span.trace_id, 1) - 1
                if n > 0:
                    self._open[span.trace_id] = n
                else:
                    self._open.pop(span.trace_id, None)
                    spans = self._pending.pop(span.trace_id, [])
                    if self._tail_keep(spans):
                        to_emit = spans
                    else:
                        self.sampled_out_total.inc(len(spans))
        if to_emit:
            for s in to_emit:
                self._emit(s)

    def _tail_keep(self, spans: list[Span]) -> bool:
        """Keep a head-sampled-out trace anyway when it is interesting:
        any ERROR span, or any span over the slow-latency threshold."""
        for s in spans:
            if s.status == "ERROR":
                return True
        if self.slow_ms > 0:
            thr_ns = self.slow_ms * 1e6
            for s in spans:
                if s.end_ns and s.start_ns \
                        and (s.end_ns - s.start_ns) >= thr_ns:
                    return True
        return False

    def _emit(self, span: Span) -> None:
        if self._recorder.record(span.to_otlp()):
            self.exported_total.inc()
        else:
            self.dropped_total.inc()

    async def close(self) -> None:
        if self._recorder is not None:
            with self._lock:
                leftover = sum(len(b) for b in self._pending.values())
                self._pending.clear()
                self._open.clear()
            if leftover:
                self.sampled_out_total.inc(leftover)
            await self._recorder.close()


def current_span() -> Optional[Span]:
    return _current_span.get()


class RequestTrace:
    """Per-request lifecycle trace handle for code that runs OUTSIDE the
    caller's task (the scheduler loop): the contextvar does not propagate
    there, so `generate()` captures the parent identity at enqueue time and
    the scheduler emits stage spans/events retroactively with explicit
    start/end timestamps.

    `begin()` returns **None when tracing is disabled** — the scheduler hot
    loop guards every touch with `if seq.trace is not None`, so a disabled
    tracer costs one `None` attribute read per site and zero allocations
    (the acceptance bar `Tracer.start_span` cannot meet, since its disabled
    spans still allocate for API compatibility)."""

    __slots__ = ("_tracer", "trace_id", "root", "_events")

    def __init__(self, tr: Tracer, name: str,
                 traceparent: Optional[str],
                 attributes: Optional[dict] = None) -> None:
        self._tracer = tr
        self.root = tr.start_span(name, traceparent=traceparent,
                                  attributes=attributes)
        self.trace_id = self.root.trace_id
        self._events: list[dict] = []

    @classmethod
    def begin(cls, name: str, headers: Optional[dict] = None,
              attributes: Optional[dict] = None) -> Optional["RequestTrace"]:
        """Start a request-lifecycle root span parented to the caller
        task's current span (the transport `serve` span on a worker, the
        http span in-proc), falling back to the incoming traceparent
        header when no span is current (scheduler-only embedders). None
        when the process tracer is disabled."""
        tr = tracer()
        if not tr.enabled:
            return None
        tp = None
        if _current_span.get() is None:
            tp = (headers or {}).get(TRACEPARENT)
        return cls(tr, name, tp, attributes)

    def stage(self, name: str, start_ns: int, end_ns: Optional[int] = None,
              **attributes: Any) -> None:
        """Emit one completed stage span (child of the request root) with
        explicit timestamps — routed through the tracer's sampling sink;
        the Recorder drain already moves the file I/O off the loop."""
        span = Span(name=name, trace_id=self.trace_id,
                    span_id=secrets.token_hex(8),
                    parent_span_id=self.root.span_id,
                    start_ns=start_ns,
                    sampled=self.root.sampled,
                    attributes={"service.name": self._tracer.service,
                                **attributes})
        span.end_ns = end_ns or time.time_ns()
        self._tracer._export(span)

    def event(self, name: str, **attributes: Any) -> None:
        """Point-in-time lifecycle event, recorded on the root span as an
        OTLP event (enqueued/admitted/first_token/prefetch_hit/...)."""
        self._events.append({
            "name": name, "timeUnixNano": time.time_ns(),
            "attributes": [{"key": k, "value": {"stringValue": str(v)}}
                           for k, v in attributes.items()]})

    def end(self, status: str = "OK", **attributes: Any) -> None:
        if self.root.end_ns:
            return
        self.root.attributes.update(attributes)
        self.root.status = status
        self.root.events = self._events
        self.root.end()


def inject_headers(headers: dict) -> dict:
    """Put the current span's traceparent into a headers dict (W3C)."""
    cur = _current_span.get()
    if cur is not None:
        headers[TRACEPARENT] = cur.traceparent()
    return headers


_global: Optional[Tracer] = None


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def tracer() -> Tracer:
    """Process tracer, env-configured once (logging.rs init analog)."""
    global _global
    if _global is None:
        enabled = os.environ.get("DYN_TRACE", "").lower() in (
            "1", "true", "yes")
        _global = Tracer(
            enabled=enabled,
            path=os.environ.get("DYN_TRACE_PATH", "trace.jsonl"),
            sample=_env_float("DYN_TRACE_SAMPLE", 1.0),
            slow_ms=_env_float("DYN_TRACE_SLOW_MS", 0.0),
            max_bytes=int(_env_float("DYN_TRACE_MAX_MB", 0.0)
                          * 1024 * 1024),
            keep=int(_env_float("DYN_TRACE_KEEP", 3)))
    return _global


def set_tracer(t: Optional[Tracer]) -> None:
    """Override the process tracer (tests / embedders)."""
    global _global
    _global = t
