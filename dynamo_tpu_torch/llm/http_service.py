"""OpenAI-compatible HTTP frontend on the standard library.

Port of `dynamo_tpu/llm/http_service.py`. The reference serves through
aiohttp; the machine the port serves on has no aiohttp, so this module is
its own HTTP/1.1 server on asyncio streams: keep-alive connections,
`Content-Length` request and response bodies, chunked transfer for SSE
streams, HTTPS through the standard `ssl` module. Routes, status codes,
error bodies and SSE framing are the reference's:

  POST /v1/chat/completions, POST /v1/completions (SSE when stream=true,
  ending in `data: [DONE]`), POST /v1/embeddings (unary), POST
  /v1/responses (typed-event SSE when stream=true, else the folded
  response object), GET /v1/models, GET /health, GET /live,
  GET /metrics, and the admin routes POST /clear_kv_blocks,
  GET /kvbm/status and POST /kvbm/reset (`_fanout_admin`: one request to
  every instance of every served model's admin endpoint, results keyed
  by model and instance id)
  GET /fleet/status (the telemetry collector's merged fleet view with
  the SLO monitor's states; 503 when no collector runs),
  GET /debug (the index of the debug surfaces this process has),
  /debug/requests (`?limit`: in-flight and recent requests with their
  timings, status, usage and trace id), /debug/profile (`?limit`,
  `?format=chrome`, `?capture_s=N`), /debug/memory, /debug/kv,
  /debug/router and /debug/prefixes: the engines' flight recorders
  (`engine/profiler.py`, `engine/memory.py`, `kvbm/lifecycle.py`), the
  KV router's decision log and its prefix-heat plane
  (`router/prefix_plane.py`, `DYN_PREFIX_HEAT`). The engine routes read
  `profile_engines`, which an in-process deployment wires to its engines
  (`llm/entrypoint.py`); without it they answer 503, as /debug/router
  and /debug/prefixes do with no kv-mode model; /debug/tenants,
  /debug/classes and /debug/control (the admission and control planes)

Each chat or completion request runs under an `http <endpoint>` span
(`runtime/tracing.py`; an incoming `traceparent` header is its parent),
which the transport carries to the worker; its TTFT and ITL samples also
feed the SLO monitor when one is wired; with `DYN_AUDIT` its stream is
recorded on the audit bus (`llm/audit.py`) when it ends.

The admission planes, as the reference's (`:127-375`): with
`DYN_TENANCY` every OpenAI route resolves the tenant (the `x-dyn-tenant`
header, a bearer API key, the default tenant) and applies its quota
before any engine work: over quota it answers 429 with `Retry-After`;
admitted, the request owes one `QuotaGate.release` on every exit path.
With `DYN_CLASSES` a chat or completion then resolves its serving class
(`x-dyn-class`, the tenant's default class, the config's) and, in the
reference's order, the brownout shed (503), the deadline gate (503 with
`Retry-After`, or a downgrade to a looser class) and the stage-2
`max_tokens` cap. The resolved tenant and class ride the request's
context headers to the workers. GET /debug/tenants, /debug/classes and
/debug/control show the planes (`start_frontend` wires the brownout
machine, the admission estimator and the flight-control plane) and
answer 503 with the reference's body when theirs is unarmed; the
reference's /debug/mesh waits with its recorder and answers 404, as any
unknown path does; a known path with another method is a 405.

Errors: a malformed request is a 400, an unknown model a 404, a model
whose workers are all gone a 503; any other failure of the pipeline (an
engine error, a worker lost past its migrations) is a 500 before the
stream starts, or an SSE error event after it, and is counted in
`dynamo_http_requests_total` under its status. A client that disconnects
cancels the request's context, which cancels the engine's work
(service/disconnect.rs).

Reference: `lib/llm/src/http/service/` — `/v1/chat/completions`
(openai.rs:540), `/v1/completions` (:274), `/v1/embeddings` (:1125),
`/v1/responses` (:766), `/v1/models`, health routes,
and HTTP metrics with TTFT/ITL histograms (service/metrics.rs:109-262).
"""

from __future__ import annotations

import asyncio
import http
import json
import logging
import math
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional
from urllib.parse import parse_qs, urlsplit

from dynamo_tpu_torch.llm.audit import AuditRecord, audit_bus_from_env
from dynamo_tpu_torch.llm.model_manager import ModelManager
from dynamo_tpu_torch.llm.preprocessor import (
    KIND_CHAT,
    KIND_COMPLETION,
    KIND_EMBEDDING,
    KIND_RESPONSES,
)
from dynamo_tpu_torch.llm.protocols_openai import (
    SSE_DONE,
    OpenAIError,
    aggregate_chat_stream,
    aggregate_completion_stream,
    aggregate_responses_stream,
    new_request_id,
    sse_encode,
    sse_encode_event,
)
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.push import NoInstancesError, PushRouter
from dynamo_tpu_torch.runtime.tracing import TRACEPARENT, tracer
from dynamo_tpu_torch.runtime.transport import DEADLINE_HEADER
from dynamo_tpu_torch.serving_classes import (
    CLASS_HEADER,
    ClassMetrics,
    classes_from_env,
)
from dynamo_tpu_torch.tenancy import (
    TENANT_HEADER,
    QuotaGate,
    TenantMetrics,
    estimate_request_tokens,
    retry_after_header,
    tenancy_from_env,
    tenant_state,
)

logger = logging.getLogger(__name__)


class _AuditTap:
    """Engine wrapper that accumulates the response into an AuditRecord
    and publishes it at stream end (audit/stream.rs analog). Items pass
    through untouched; publish() is non-blocking."""

    def __init__(self, inner, rec, bus) -> None:
        self.inner = inner
        self.rec = rec
        self.bus = bus

    async def generate(self, request, context):
        try:
            async for item in self.inner.generate(request, context):
                for ch in item.get("choices", ()):
                    delta = ch.get("delta", {})
                    if delta.get("content"):
                        self.rec.response_text += delta["content"]
                    elif ch.get("text"):
                        self.rec.response_text += ch["text"]
                    # tool calls are the most audit-sensitive output
                    # (model-initiated actions): never drop them
                    if delta.get("tool_calls"):
                        self.rec.tool_calls.extend(delta["tool_calls"])
                    if delta.get("reasoning_content"):
                        self.rec.reasoning_text += \
                            delta["reasoning_content"]
                    if ch.get("finish_reason"):
                        self.rec.finish_reason = ch["finish_reason"]
                if item.get("usage"):
                    self.rec.usage = item["usage"]
                yield item
        except BaseException as e:
            self.rec.error = repr(e)
            raise
        finally:
            self.rec.finished_at = time.time()
            self.bus.publish(self.rec)

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 64 * 1024 * 1024
JSON_TYPE = "application/json; charset=utf-8"


@dataclass
class Request:
    method: str
    path: str
    version: str
    headers: dict[str, str]     # lower-case names
    body: bytes = b""
    query: str = ""

    def arg(self, name: str) -> Optional[str]:
        """The first value of query parameter `name`, or None."""
        vals = parse_qs(self.query).get(name)
        return vals[0] if vals else None

    def int_arg(self, name: str, default: int) -> int:
        try:
            return int(self.arg(name) or default)
        except ValueError:
            return default

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"

    def json(self):
        return json.loads(self.body)


class _Conn:
    """One client connection: the stream pair plus bytes read ahead of
    the request being served (a pipelined next request)."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter) -> None:
        self.reader = reader
        self.writer = writer
        self.ahead = bytearray()
        # set by a handler while its request runs: what a disconnect
        # cancels (the request's context)
        self.on_disconnect: Optional[Callable[[], None]] = None

    async def read_head(self) -> Optional[bytes]:
        """Bytes up to and including the blank line; None at a clean EOF."""
        while True:
            end = self.ahead.find(b"\r\n\r\n")
            if end >= 0:
                head = bytes(self.ahead[:end + 4])
                del self.ahead[:end + 4]
                return head
            if len(self.ahead) > MAX_HEADER_BYTES:
                raise ValueError("request head too large")
            data = await self.reader.read(65536)
            if not data:
                if self.ahead.strip():
                    raise ValueError("connection closed mid-request")
                return None
            self.ahead += data

    async def read_body(self, n: int) -> bytes:
        while len(self.ahead) < n:
            data = await self.reader.read(max(65536, n - len(self.ahead)))
            if not data:
                raise ValueError("connection closed mid-body")
            self.ahead += data
        body = bytes(self.ahead[:n])
        del self.ahead[:n]
        return body


def _head(version: str, status: int, headers: dict) -> bytes:
    phrase = http.HTTPStatus(status).phrase
    lines = [f"{version} {status} {phrase}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class Response:
    """A whole response: status, body, its content type and any extra
    headers (a 429's or 503's `Retry-After`)."""

    def __init__(self, body: bytes, status: int = 200,
                 content_type: str = JSON_TYPE,
                 headers: Optional[dict] = None) -> None:
        self.body = body
        self.status = status
        self.content_type = content_type
        self.headers = headers or {}

    async def send(self, writer: asyncio.StreamWriter,
                   keep_alive: bool) -> None:
        writer.write(_head("HTTP/1.1", self.status, {
            "Content-Type": self.content_type,
            "Content-Length": str(len(self.body)),
            **self.headers,
            "Connection": "keep-alive" if keep_alive else "close"})
            + self.body)
        await writer.drain()


def json_response(obj, status: int = 200,
                  headers: Optional[dict] = None) -> Response:
    # the reference's aiohttp json_response: json.dumps with its defaults
    return Response(json.dumps(obj).encode(), status, headers=headers)


class StreamResponse:
    """An SSE response: chunked transfer on HTTP/1.1; on HTTP/1.0 the
    body runs to the end of the connection."""

    def __init__(self, req: Request, writer: asyncio.StreamWriter) -> None:
        self.req = req
        self.writer = writer
        self.chunked = req.version != "HTTP/1.0"
        self.prepared = False
        # set before prepare(): a downgraded request's class headers
        self.headers: dict[str, str] = {}
        # the connection ends with this response: HTTP/1.0 bodies run to
        # the end of it, and a client gone mid-stream left it broken
        self.close_after = not self.chunked

    async def prepare(self) -> None:
        headers = {"Content-Type": "text/event-stream",
                   "Cache-Control": "no-cache", **self.headers}
        if self.chunked:
            headers["Transfer-Encoding"] = "chunked"
            headers["Connection"] = ("keep-alive" if self.req.keep_alive
                                     else "close")
        else:
            headers["Connection"] = "close"
        self.writer.write(_head("HTTP/1.1", 200, headers))
        self.prepared = True

    async def write(self, data: bytes) -> None:
        if self.chunked:
            data = b"%x\r\n%s\r\n" % (len(data), data)
        self.writer.write(data)
        await self.writer.drain()

    async def write_eof(self) -> None:
        if self.chunked:
            self.writer.write(b"0\r\n\r\n")
        await self.writer.drain()

    async def send(self, writer, keep_alive) -> None:
        pass            # already written while the handler ran


class HttpService:
    def __init__(self, manager: ModelManager, host: str = "127.0.0.1",
                 port: int = 0, tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None,
                 request_template: Optional[dict] = None) -> None:
        self.manager = manager
        self.host = host
        self.port = port
        # defaults applied to requests that omit them (request_template.rs:
        # model, temperature, max_completion_tokens)
        self.request_template = request_template or {}
        # the audit bus DYN_AUDIT arms (None unless set)
        self.audit = audit_bus_from_env()
        if bool(tls_cert) != bool(tls_key):
            # half-configured TLS must not silently serve plaintext
            raise ValueError("tls_cert and tls_key must be set together")
        self.tls_cert = tls_cert
        self.tls_key = tls_key
        self.routes = {
            ("POST", "/v1/chat/completions"): self._chat,
            ("POST", "/v1/completions"): self._completions,
            ("POST", "/v1/embeddings"): self._embeddings,
            ("POST", "/v1/responses"): self._responses,
            ("GET", "/v1/models"): self._models,
            ("GET", "/health"): self._health,
            ("GET", "/live"): self._live,
            ("GET", "/metrics"): self._metrics,
            ("POST", "/clear_kv_blocks"): self._clear_kv_blocks,
            ("GET", "/kvbm/status"): self._kvbm_status,
            ("POST", "/kvbm/reset"): self._kvbm_reset,
            ("GET", "/fleet/status"): self._fleet_status,
            ("GET", "/debug"): self._debug_index,
            ("GET", "/debug/requests"): self._debug_requests,
            ("GET", "/debug/profile"): self._debug_profile,
            ("GET", "/debug/memory"): self._debug_memory,
            ("GET", "/debug/kv"): self._debug_kv,
            ("GET", "/debug/router"): self._debug_router,
            ("GET", "/debug/prefixes"): self._debug_prefixes,
            ("GET", "/debug/control"): self._debug_control,
            ("GET", "/debug/tenants"): self._debug_tenants,
            ("GET", "/debug/classes"): self._debug_classes,
        }
        # the tenancy quota plane: None unless DYN_TENANCY; over-quota
        # requests are 429s here, before any engine work, and the
        # resolved tenant rides ctx.headers[x-dyn-tenant] to the workers
        self.tenancy = tenancy_from_env()
        self.quota: Optional[QuotaGate] = None
        if self.tenancy is not None:
            tm = TenantMetrics()
            tm.register(manager.runtime.metrics, role="frontend")
            self.quota = QuotaGate(self.tenancy, tm)
        # the serving-class plane: None unless DYN_CLASSES; brownout-shed,
        # token-capped and deadline-infeasible requests are bounced (or
        # downgraded) here, and the resolved class rides
        # ctx.headers[x-dyn-class]; start_frontend wires the brownout
        # machine and the admission estimator over the live engines
        self.classes = classes_from_env()
        self.class_metrics: Optional[ClassMetrics] = None
        self.brownout = None               # BrownoutMachine | None
        self.admission = None              # AdmissionEstimator | None
        if self.classes is not None:
            self.class_metrics = ClassMetrics()
            self.class_metrics.register(manager.runtime.metrics)
        # the flight-control plane start_frontend wires when DYN_CONTROL
        # arms a controller; None keeps /debug/control a 503
        self.control_plane = None          # ControlPlane | None
        # the engines whose flight recorders the /debug routes read: an
        # in-process deployment wires a callable returning them
        # (`llm/entrypoint.py` start_frontend); None on a frontend-only
        # process
        self.profile_engines: Optional[Callable[[], list]] = None
        # start_frontend wires the telemetry collector's fleet_status and,
        # with an objective configured, the SLO monitor that the TTFT/ITL
        # observation points feed
        self.fleet_status_provider: Optional[Callable[[], dict]] = None
        self.slo = None                    # SloMonitor | None
        # request-lifecycle debug view: in-flight dicts keyed by request
        # id plus a bounded ring of finished ones, served verbatim by
        # /debug/requests (timings, status, trace id)
        self._dbg_inflight: dict[str, dict] = {}
        self._dbg_recent: deque = deque(maxlen=128)
        self._paths = {path for _, path in self.routes}
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: set[asyncio.StreamWriter] = set()
        self._tasks: set[asyncio.Task] = set()
        m = manager.runtime.metrics.child("http")
        self._req_counter = m.counter(
            "requests_total", "HTTP requests by endpoint/status")
        self._inflight = m.gauge("inflight_requests", "streams in flight")
        self._ttft = m.histogram(
            "time_to_first_token_seconds", "TTFT",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                     5.0, 10.0, 30.0))
        self._itl = m.histogram(
            "inter_token_latency_seconds", "ITL",
            buckets=(0.0001, 0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0))
        self._duration = m.histogram(
            "request_duration_seconds", "total request duration")
        # ISL/OSL from the pipeline's final-chunk usage
        self._isl = m.histogram(
            "request_input_tokens", "prompt tokens per request",
            buckets=(16, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384))
        self._osl = m.histogram(
            "request_output_tokens", "completion tokens per request",
            buckets=(1, 4, 16, 64, 128, 256, 512, 1024, 2048, 4096))

    def _observe_latency(self, kind: str, seconds: float,
                         cls: Optional[str] = None) -> None:
        """One TTFT/ITL sample into both the histogram and (when
        configured) the SLO monitor's rolling windows; with a class
        name, also into the per-class objective's ("ttft:interactive";
        the monitor ignores names it has no objective for)."""
        (self._ttft if kind == "ttft" else self._itl).observe(seconds)
        if self.slo is not None:
            self.slo.observe(kind, seconds)
            if cls:
                self.slo.observe(f"{kind}:{cls}", seconds)

    def _observe_usage(self, usage: Optional[dict]) -> None:
        if not usage:
            return
        if usage.get("prompt_tokens") is not None:
            self._isl.observe(usage["prompt_tokens"])
        if usage.get("completion_tokens") is not None:
            self._osl.observe(usage["completion_tokens"])

    @property
    def scheme(self) -> str:
        return "https" if self.tls_cert else "http"

    def _apply_template(self, body: dict) -> None:
        t = self.request_template
        if not t:
            return
        if not body.get("model") and t.get("model"):
            body["model"] = t["model"]
        if body.get("temperature") is None and \
                t.get("temperature") is not None:
            body["temperature"] = t["temperature"]
        if body.get("max_tokens") is None \
                and body.get("max_completion_tokens") is None \
                and t.get("max_completion_tokens") is not None:
            body["max_tokens"] = t["max_completion_tokens"]

    # -- admission planes ---------------------------------------------------

    def _tenant_gate(self, request: Request, body, endpoint: str):
        """Resolve the tenant and apply its quota before any engine work.
        (tenant_name, None) when admitted: the caller owes exactly one
        `quota.release(tenant_name)`; (tenant_name, the 429) over quota;
        (None, None) when tenancy is unarmed."""
        if self.quota is None:
            return None, None
        tenant = self.tenancy.resolve(request.headers.get(TENANT_HEADER),
                                      request.headers.get("authorization"))
        tokens = estimate_request_tokens(
            body if isinstance(body, dict) else {})
        ok, reason, retry = self.quota.try_admit(tenant, tokens)
        if ok:
            return tenant.name, None
        self._req_counter.inc(endpoint=endpoint, status="429")
        if self.class_metrics is not None:
            # shed load shows in the fleet picture beside served load
            cls_name = self.classes.resolve(
                request.headers.get(CLASS_HEADER), tenant).name
            self.class_metrics.on_rejected("quota", cls_name)
        err = OpenAIError(f"tenant {tenant.name!r} over {reason} quota",
                          status=429, err_type="rate_limit_exceeded")
        return tenant.name, json_response(
            err.body(), status=429,
            headers={"Retry-After": retry_after_header(retry)})

    def _class_gate(self, request: Request, body, endpoint: str,
                    tenant: Optional[str]):
        """Resolve the serving class and apply, before any engine work,
        the brownout shed, the deadline gate (a 503, or a downgrade when
        only the class's own deadline is unmeetable) and the stage-2
        `max_tokens` cap, which may rewrite `body`. (cls_name,
        downgraded_from, None) when admitted, (cls_name, "", the 503)
        when not, (None, "", None) when classes are unarmed."""
        if self.classes is None:
            return None, "", None
        tenant_rec = (self.tenancy.get(tenant)
                      if self.tenancy is not None and tenant else None)
        cls = self.classes.resolve(request.headers.get(CLASS_HEADER),
                                   tenant_rec)

        def shed(c):
            self._req_counter.inc(endpoint=endpoint, status="503")
            self.class_metrics.on_shed(c.name, reason="brownout")
            err = OpenAIError(
                f"class {c.name!r} shed: fleet in brownout stage "
                f"{self.brownout.state()['stage_name']!r}",
                status=503, err_type="overloaded")
            return c.name, "", json_response(
                err.body(), status=503,
                headers={"Retry-After":
                         retry_after_header(self.brownout.recover_s)})

        if self.brownout is not None and self.brownout.sheds(cls):
            return shed(cls)
        # deadline feasibility: an explicit remaining-budget header wins,
        # else the class's implicit deadline; 0 = none
        explicit = 0.0
        hdr = request.headers.get(DEADLINE_HEADER)
        if hdr:
            try:
                explicit = float(hdr)
            except ValueError:
                explicit = 0.0
        budget = explicit if explicit > 0 else cls.deadline_s
        downgraded_from = ""
        if budget > 0 and self.admission is not None:
            feasible, est, retry = self.admission.check(budget)
            if not feasible:
                if explicit <= 0 and cls.downgrade_to:
                    # only the class's implicit deadline is unmeetable:
                    # demote to the looser class instead of bouncing
                    downgraded_from = cls.name
                    self.class_metrics.on_downgraded(cls.name)
                    cls = self.classes.get(cls.downgrade_to)
                    if self.brownout is not None \
                            and self.brownout.sheds(cls):
                        return shed(cls)
                else:
                    self._req_counter.inc(endpoint=endpoint, status="503")
                    self.class_metrics.on_deadline_rejected(cls.name)
                    err = OpenAIError(
                        f"deadline unmeetable: estimated TTFT {est:.3f}s "
                        f"exceeds remaining budget {budget:.3f}s",
                        status=503, err_type="deadline_unmeetable")
                    return cls.name, "", json_response(
                        err.body(), status=503,
                        headers={"Retry-After": retry_after_header(retry)})
        # stage-2 brownout: cap the completion budget of new streams of a
        # cappable class (running streams are never touched)
        if self.brownout is not None and isinstance(body, dict):
            cap = self.brownout.cap_for(cls)
            if cap > 0:
                cur = (body.get("max_tokens")
                       or body.get("max_completion_tokens") or 0)
                if not cur or cur > cap:
                    body["max_tokens"] = cap
        self.class_metrics.on_admitted(cls.name)
        return cls.name, downgraded_from, None

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> tuple[str, int]:
        ssl_ctx = None
        if self.tls_cert and self.tls_key:
            import ssl

            ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ssl_ctx.load_cert_chain(self.tls_cert, self.tls_key)
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port, ssl=ssl_ctx)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("HTTP frontend on %s://%s:%d", self.scheme, self.host,
                    self.port)
        return self.host, self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        for t in list(self._tasks):
            t.cancel()
        for w in list(self._conns):
            w.close()
        if self._tasks:
            await asyncio.wait(list(self._tasks), timeout=2.0)
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), 2.0)
            except asyncio.TimeoutError:
                pass
        # handlers first (their _AuditTap finallys publish), THEN the bus
        if self.audit is not None:
            await self.audit.close()

    def _audit_begin(self, request_id: str, endpoint: str, body):
        if self.audit is None:
            return None
        return AuditRecord(request_id=request_id, endpoint=endpoint,
                           model=(body or {}).get("model", ""),
                           request=body)

    # -- connections --------------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._tasks.add(task)
        self._conns.add(writer)
        conn = _Conn(reader, writer)
        try:
            while True:
                try:
                    req = await self._read_request(conn)
                except ValueError as e:
                    await json_response(
                        OpenAIError(str(e)).body(), 400).send(writer, False)
                    break
                if req is None:
                    break
                keep = req.keep_alive
                try:
                    resp = await self._serve(req, conn)
                except Exception:
                    logger.exception("handler failed: %s %s", req.method,
                                     req.path)
                    resp = json_response(OpenAIError(
                        "internal server error", status=500,
                        err_type="internal_error").body(), 500)
                if resp is None:        # client went away mid-request
                    break
                await resp.send(writer, keep)
                if not keep or getattr(resp, "close_after", False):
                    break
        except ConnectionError:
            pass                        # the client went away
        finally:
            self._conns.discard(writer)
            self._tasks.discard(task)
            writer.close()

    async def _read_request(self, conn: _Conn) -> Optional[Request]:
        head = await conn.read_head()
        if head is None:
            return None
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, version = lines[0].split(" ")
        except ValueError:
            raise ValueError(f"bad request line {lines[0]!r}") from None
        if version not in ("HTTP/1.0", "HTTP/1.1"):
            raise ValueError(f"unsupported HTTP version {version!r}")
        headers = {}
        for line in lines[1:]:
            if not line:
                continue
            name, sep, value = line.partition(":")
            if not sep:
                raise ValueError(f"bad header line {line!r}")
            headers[name.strip().lower()] = value.strip()
        if "chunked" in headers.get("transfer-encoding", "").lower():
            raise ValueError("chunked request bodies are not supported; "
                             "send Content-Length")
        try:
            n = int(headers.get("content-length", "0"))
        except ValueError:
            raise ValueError("bad Content-Length") from None
        if not 0 <= n <= MAX_BODY_BYTES:
            raise ValueError(f"request body of {n} bytes refused")
        body = await conn.read_body(n) if n else b""
        url = urlsplit(target)
        return Request(method.upper(), url.path, version, headers, body,
                       url.query)

    async def _serve(self, req: Request, conn: _Conn):
        """Run the route's handler; a client that closes its connection
        meanwhile cancels it (and so its request context)."""
        handler = self.routes.get((req.method, req.path))
        if handler is None:
            status = 405 if req.path in self._paths else 404
            return Response(f"{status}: {http.HTTPStatus(status).phrase}"
                            .encode(), status, "text/plain; charset=utf-8")
        task = asyncio.ensure_future(handler(req, conn))
        eof = asyncio.ensure_future(conn.reader.read(65536))
        try:
            await asyncio.wait({task, eof},
                               return_when=asyncio.FIRST_COMPLETED)
            if eof.done() and not eof.exception() and not eof.result():
                # the client went away: cancel the request's context
                # first, and let its cancel frame go out to the worker
                # before the handler's task unwinds the stream
                if conn.on_disconnect is not None:
                    conn.on_disconnect()
                    await asyncio.sleep(0)
                task.cancel()
                await asyncio.wait({task})
                return None
            return await task
        finally:
            conn.on_disconnect = None
            if not task.done():
                task.cancel()
            eof.cancel()
            await asyncio.wait({eof})
            if not eof.cancelled() and not eof.exception():
                conn.ahead += eof.result()  # a pipelined next request

    # -- handlers -----------------------------------------------------------

    async def _chat(self, request: Request, conn: _Conn):
        return await self._serve_openai(request, conn, KIND_CHAT)

    async def _completions(self, request: Request, conn: _Conn):
        return await self._serve_openai(request, conn, KIND_COMPLETION)

    async def _serve_openai(self, request: Request, conn: _Conn,
                            kind: str):
        endpoint = ("chat_completions" if kind == KIND_CHAT
                    else "completions")
        try:
            body = request.json()
        except ValueError:
            return self._error(endpoint, OpenAIError("invalid JSON body"))
        if isinstance(body, dict):
            self._apply_template(body)
        model = body.get("model") if isinstance(body, dict) else None
        engine = self.manager.engine_for(model) if model else None
        if engine is None:
            return self._error(endpoint, OpenAIError(
                f"model {model!r} not found", status=404,
                err_type="model_not_found"))
        # the quota gate before any engine work: an over-quota tenant
        # costs the fleet a dict lookup and a 429
        tenant, reject = self._tenant_gate(request, body, endpoint)
        if reject is not None:
            return reject
        try:
            # the class gate after it: a shed or deadline-infeasible
            # request costs a histogram read and a 503
            cls, downgraded_from, reject = self._class_gate(
                request, body, endpoint, tenant)
            if reject is not None:
                return reject
            return await self._serve_admitted(
                request, conn, kind, endpoint, body, engine, tenant, cls,
                downgraded_from)
        finally:
            # the one release an admitted request owes, on every exit
            # path: finished, failed, disconnected, cancelled, or bounced
            # by the class gate
            if tenant is not None:
                self.quota.release(tenant)

    async def _serve_admitted(self, request: Request, conn: _Conn,
                              kind: str, endpoint: str, body: dict, engine,
                              tenant: Optional[str], cls: Optional[str],
                              downgraded_from: str):
        """A chat or completion past the admission planes: the stream or
        the aggregated response."""
        model = body.get("model")
        stream = bool(body.get("stream"))
        request_id = new_request_id(
            "chatcmpl" if kind == KIND_CHAT else "cmpl")
        ctx = Context(request_id=request_id)
        if tenant is not None:
            ctx.headers[TENANT_HEADER] = tenant
        if cls is not None:
            # the post-resolution (and post-downgrade) identity the
            # engines' fair-share accounting keys on
            ctx.headers[CLASS_HEADER] = cls
        conn.on_disconnect = ctx.cancel
        pipeline_request = {"_kind": kind, "body": body,
                            "request_id": request_id}
        audit_rec = self._audit_begin(request_id, endpoint, body)
        if audit_rec is not None:
            # capture deltas without perturbing the stream; the record is
            # published (off the hot path) when the stream finishes
            engine = _AuditTap(engine, audit_rec, self.audit)
        start = time.perf_counter()
        self._inflight.add(1)
        # request span (make_request_span analog): an incoming W3C
        # traceparent is its parent; it is current for this handler task,
        # so the transport hops downstream carry the trace; entered right
        # at the try so no exception path can leave it current
        span = tracer().start_span(
            f"http {endpoint}",
            traceparent=request.headers.get(TRACEPARENT),
            attributes={"http.target": request.path,
                        "request.id": request_id, "model": model})
        span.__enter__()
        rec = {"request_id": request_id, "endpoint": endpoint,
               "model": model, "stream": stream, "tenant": tenant,
               "received_at": time.time(),
               "trace_id": span.trace_id if tracer().enabled else None,
               "status": "in_flight", "first_token_s": None,
               "last_token_s": None, "duration_s": None, "usage": None}
        if cls is not None:
            rec["class"] = cls
            if downgraded_from:
                rec["downgraded_from"] = downgraded_from
        self._dbg_inflight[request_id] = rec
        try:
            chunks = engine.generate(pipeline_request, ctx)
            if stream:
                return await self._stream_sse(request, conn.writer, endpoint,
                                              chunks, ctx, start, rec)
            # unary: aggregate the stream
            try:
                full = await (aggregate_chat_stream(chunks)
                              if kind == KIND_CHAT
                              else aggregate_completion_stream(chunks))
            except asyncio.CancelledError:
                # client disconnected mid-aggregation: stop downstream work
                ctx.cancel()
                rec["status"] = "disconnect"
                self._req_counter.inc(endpoint=endpoint, status="disconnect")
                raise
            except Exception as e:
                err = _as_openai_error(e)
                rec["status"] = f"error:{err.status}"
                return self._error(endpoint, err)
            self._req_counter.inc(endpoint=endpoint, status="200")
            self._duration.observe(time.perf_counter() - start)
            self._observe_usage(full.get("usage"))
            rec["status"] = "200"
            rec["usage"] = full.get("usage")
            return json_response(full)
        except BaseException as e:
            span.record_error(e)
            if rec["status"] == "in_flight":
                rec["status"] = "error"
            raise
        finally:
            span.end(_reset=True)
            self._inflight.add(-1)
            rec["duration_s"] = round(time.perf_counter() - start, 6)
            self._dbg_inflight.pop(request_id, None)
            self._dbg_recent.append(rec)

    async def _stream_sse(self, request: Request, writer, endpoint: str,
                          chunks, ctx: Context, start: float,
                          rec: dict) -> StreamResponse:
        """The SSE stream of a chat or completion; `rec` is the request's
        /debug/requests entry, its timings and status filled in here."""
        resp = StreamResponse(request, writer)
        if rec.get("downgraded_from"):
            # tell the client its request was demoted (deadline-infeasible
            # at its own class) and to what
            resp.headers["x-dyn-class-downgraded"] = rec["downgraded_from"]
            resp.headers["x-dyn-class"] = str(rec.get("class", ""))
        error_event = b""
        first_token_at: Optional[float] = None
        last_token_at: Optional[float] = None
        try:
            async for chunk in chunks:
                if self._has_content(chunk):
                    now = time.perf_counter()
                    if first_token_at is None:
                        first_token_at = now
                        self._observe_latency("ttft", now - start,
                                              cls=rec.get("class"))
                        rec["first_token_s"] = round(now - start, 6)
                        if self.quota is not None and rec.get("tenant"):
                            self.quota.metrics.observe_ttft(
                                rec["tenant"], now - start)
                    elif last_token_at is not None:
                        self._observe_latency("itl", now - last_token_at,
                                              cls=rec.get("class"))
                    last_token_at = now
                    rec["last_token_s"] = round(now - start, 6)
                self._observe_usage(chunk.get("usage"))
                if chunk.get("usage"):
                    rec["usage"] = chunk["usage"]
                if not resp.prepared:
                    await resp.prepare()
                await resp.write(sse_encode(chunk))
            if not resp.prepared:
                await resp.prepare()
            await resp.write(SSE_DONE)
            self._req_counter.inc(endpoint=endpoint, status="200")
            rec["status"] = "200"
        except asyncio.CancelledError:
            # client went away: cancel downstream work (disconnect.rs)
            ctx.cancel()
            rec["status"] = "disconnect"
            self._req_counter.inc(endpoint=endpoint, status="disconnect")
            raise
        except (ConnectionResetError, BrokenPipeError):
            # same, but seen by a write on the dead transport
            ctx.cancel()
            rec["status"] = "disconnect"
            self._req_counter.inc(endpoint=endpoint, status="disconnect")
            resp.close_after = True
            return resp
        except Exception as e:
            err = _as_openai_error(e)
            rec["status"] = f"error:{err.status}"
            if not resp.prepared:
                return self._error(endpoint, err)
            # mid-stream: an error event ends the stream (no [DONE])
            self._req_counter.inc(endpoint=endpoint, status=str(err.status))
            error_event = sse_encode(err.body())
        finally:
            self._duration.observe(time.perf_counter() - start)
        try:
            if error_event:
                await resp.write(error_event)
            await resp.write_eof()
        except (ConnectionResetError, BrokenPipeError):
            ctx.cancel()
            resp.close_after = True
        return resp

    def _engine_of(self, endpoint: str, request: Request):
        """(body, engine) of a JSON request, or (None, the error
        response): a body that is not JSON is a 400, an unknown model a
        404."""
        try:
            body = request.json()
        except ValueError:
            return None, self._error(endpoint,
                                     OpenAIError("invalid JSON body"))
        model = body.get("model") if isinstance(body, dict) else None
        engine = self.manager.engine_for(model) if model else None
        if engine is None:
            return None, self._error(endpoint, OpenAIError(
                f"model {model!r} not found", status=404,
                err_type="model_not_found"))
        return body, engine

    async def _embeddings(self, request: Request, conn: _Conn):
        """/v1/embeddings: unary, the pipeline yields exactly one response
        object."""
        body, engine = self._engine_of("embeddings", request)
        if body is None:
            return engine
        tenant, reject = self._tenant_gate(request, body, "embeddings")
        if reject is not None:
            return reject
        ctx = Context(request_id=new_request_id("embd"))
        if tenant is not None:
            ctx.headers[TENANT_HEADER] = tenant
        conn.on_disconnect = ctx.cancel
        start = time.perf_counter()
        self._inflight.add(1)
        try:
            out = None
            async for item in engine.generate(
                    {"_kind": KIND_EMBEDDING, "body": body}, ctx):
                out = item
            self._req_counter.inc(endpoint="embeddings", status="200")
            self._duration.observe(time.perf_counter() - start)
            return json_response(out)
        except asyncio.CancelledError:
            ctx.cancel()        # the client went away: stop the work
            self._req_counter.inc(endpoint="embeddings", status="disconnect")
            raise
        except Exception as e:
            return self._error("embeddings", _as_openai_error(e))
        finally:
            self._inflight.add(-1)
            if tenant is not None:
                self.quota.release(tenant)

    async def _responses(self, request: Request, conn: _Conn):
        """/v1/responses: typed-event SSE, or the unary fold of the
        completed event."""
        body, engine = self._engine_of("responses", request)
        if body is None:
            return engine
        tenant, reject = self._tenant_gate(request, body, "responses")
        if reject is not None:
            return reject
        request_id = new_request_id("resp")
        ctx = Context(request_id=request_id)
        if tenant is not None:
            ctx.headers[TENANT_HEADER] = tenant
        conn.on_disconnect = ctx.cancel
        events = engine.generate({"_kind": KIND_RESPONSES, "body": body,
                                  "request_id": request_id}, ctx)
        start = time.perf_counter()
        self._inflight.add(1)
        try:
            if not body.get("stream"):
                try:
                    full = await aggregate_responses_stream(events)
                except asyncio.CancelledError:
                    ctx.cancel()
                    self._req_counter.inc(endpoint="responses",
                                          status="disconnect")
                    raise
                except Exception as e:
                    return self._error("responses", _as_openai_error(e))
                self._req_counter.inc(endpoint="responses", status="200")
                self._duration.observe(time.perf_counter() - start)
                self._observe_usage_responses(full.get("usage"))
                return json_response(full)
            return await self._stream_events(request, conn.writer, events,
                                             ctx, start, tenant)
        finally:
            self._inflight.add(-1)
            if tenant is not None:
                self.quota.release(tenant)

    async def _stream_events(self, request: Request, writer, events,
                             ctx: Context, start: float,
                             tenant: Optional[str] = None
                             ) -> StreamResponse:
        """The Responses API's typed SSE frames; an error after the stream
        started is an error event, and the stream ends."""
        resp = StreamResponse(request, writer)
        first_token_at: Optional[float] = None
        last_token_at: Optional[float] = None
        try:
            async for ev in events:
                if ev.get("type") == "response.output_text.delta":
                    now = time.perf_counter()
                    if first_token_at is None:
                        first_token_at = now
                        self._observe_latency("ttft", now - start)
                        if self.quota is not None and tenant:
                            self.quota.metrics.observe_ttft(
                                tenant, now - start)
                    elif last_token_at is not None:
                        self._observe_latency("itl", now - last_token_at)
                    last_token_at = now
                elif ev.get("type") == "response.completed":
                    self._observe_usage_responses(
                        (ev.get("response") or {}).get("usage"))
                if not resp.prepared:
                    await resp.prepare()
                await resp.write(sse_encode_event(ev.get("type", "message"),
                                                  ev))
            self._req_counter.inc(endpoint="responses", status="200")
        except asyncio.CancelledError:
            ctx.cancel()
            self._req_counter.inc(endpoint="responses", status="disconnect")
            raise
        except (ConnectionResetError, BrokenPipeError):
            ctx.cancel()
            self._req_counter.inc(endpoint="responses", status="disconnect")
            resp.close_after = True
            return resp
        except Exception as e:
            err = _as_openai_error(e)
            if not resp.prepared:
                return self._error("responses", err)
            self._req_counter.inc(endpoint="responses",
                                  status=str(err.status))
            await resp.write(sse_encode(err.body()))
        finally:
            self._duration.observe(time.perf_counter() - start)
        try:
            await resp.write_eof()
        except (ConnectionResetError, BrokenPipeError):
            ctx.cancel()
            resp.close_after = True
        return resp

    def _observe_usage_responses(self, usage: Optional[dict]) -> None:
        if not usage:
            return
        if usage.get("input_tokens") is not None:
            self._isl.observe(usage["input_tokens"])
        if usage.get("output_tokens") is not None:
            self._osl.observe(usage["output_tokens"])

    @staticmethod
    def _has_content(chunk: dict) -> bool:
        """True for any token-bearing delta."""
        for choice in chunk.get("choices", ()):
            delta = choice.get("delta", {})
            if (delta.get("content") or delta.get("reasoning_content")
                    or delta.get("tool_calls") or choice.get("text")):
                return True
        return False

    def _error(self, endpoint: str, e: OpenAIError) -> Response:
        self._req_counter.inc(endpoint=endpoint, status=str(e.status))
        return json_response(e.body(), status=e.status)

    async def _models(self, request: Request, conn) -> Response:
        return json_response({
            "object": "list",
            "data": [{"id": name, "object": "model",
                      "created": int(time.time()), "owned_by": "dynamo-tpu"}
                     for name in self.manager.model_names()],
        })

    async def _health(self, request: Request, conn) -> Response:
        ready = bool(self.manager.model_names())
        return json_response(
            {"status": "healthy" if ready else "no models",
             "models": self.manager.model_names()},
            status=200 if ready else 503)

    async def _live(self, request: Request, conn) -> Response:
        return json_response({"status": "live"})

    async def _metrics(self, request: Request, conn) -> Response:
        return Response(self.manager.runtime.metrics.render().encode(),
                        content_type="text/plain; charset=utf-8")

    async def _fleet_status(self, request: Request, conn) -> Response:
        """The fleet-merged telemetry view: per-component and merged
        TTFT/ITL percentiles from the event-plane MetricsSnapshots, plus
        the SLO monitor's live burn rates when one is configured. 503
        until a collector is wired (a frontend started without the
        telemetry plane)."""
        if self.fleet_status_provider is None:
            return json_response(
                {"status": "unavailable",
                 "reason": "telemetry collector not running"}, status=503)
        # histogram edges can be +Inf, which standard JSON cannot spell:
        # non-finite floats become strings

        def _clean(o):
            if isinstance(o, float) and not math.isfinite(o):
                return str(o)
            if isinstance(o, dict):
                return {k: _clean(v) for k, v in o.items()}
            if isinstance(o, (list, tuple)):
                return [_clean(v) for v in o]
            return o

        return json_response(_clean(self.fleet_status_provider()))


    async def _fanout_admin(self, endpoint: str, payload: dict) -> dict:
        """Send one admin request to every instance of every served
        model's `endpoint`; per-instance results keyed by model, then by
        instance id in hex."""
        results: dict[str, dict] = {}
        for name in self.manager.model_names():
            entry = self.manager.get(name)
            if entry is None:
                continue
            card = entry.card
            client = await (self.manager.runtime.namespace(card.namespace)
                            .component(card.component)
                            .endpoint(endpoint).client())
            await client.start()
            router = PushRouter(client)
            per_instance: dict[str, object] = {}
            try:
                for inst in client.instances():
                    try:
                        async for out in router.direct(
                                payload, inst.instance_id, Context()):
                            per_instance[f"{inst.instance_id:x}"] = out
                    except Exception as e:  # instance died mid-call
                        per_instance[f"{inst.instance_id:x}"] = {
                            "status": "error", "error": str(e)}
            finally:
                await client.stop()
            results[name] = per_instance
        return results

    async def _clear_kv_blocks(self, request: Request, conn) -> Response:
        """Admin route (service/clear_kv_blocks.rs): every worker instance
        of every served model drops its reusable KV cache."""
        results = await self._fanout_admin("clear_kv_blocks", {})
        return json_response({"status": "success", "results": results})

    async def _kvbm_status(self, request: Request, conn) -> Response:
        """KVBM controller status (block_manager/controller.rs
        ControlMessage::Status): per-tier occupancy, offload/onboard
        stats and the pipeline counters of every worker running KVBM;
        workers without KVBM serve no kvbm_controller and are absent."""
        results = await self._fanout_admin("kvbm_controller",
                                           {"op": "status"})
        return json_response({"status": "success", "results": results})

    async def _kvbm_reset(self, request: Request, conn) -> Response:
        """KVBM controller reset (ResetPool / ResetAll): body {"level":
        "g1" | "g2" | "g3" | "all"} (default all)."""
        try:
            body = request.json() if request.body else {}
        except ValueError:
            body = {}
        level = body.get("level", "all") if isinstance(body, dict) else "all"
        results = await self._fanout_admin(
            "kvbm_controller", {"op": "reset", "level": level})
        return json_response({"status": "success", "results": results})

    # -- /debug: the flight recorders --------------------------------------

    def _engines(self) -> Optional[list]:
        return (None if self.profile_engines is None
                else list(self.profile_engines() or []))

    @staticmethod
    def _unavailable(what: str) -> Response:
        return json_response(
            {"status": "unavailable",
             "reason": f"no in-proc engine wired for {what}"}, status=503)

    async def _debug_index(self, request: Request, conn) -> Response:
        """The debug surfaces this process serves: what each shows, the
        variable that arms its recorder, and whether it is armed here."""
        engines = self._engines()

        def armed(attr: str) -> bool:
            return any(getattr(e, attr, None) is not None
                       for e in engines or [])

        routers = self.manager.kv_routers()
        surfaces = {
            "/debug/requests": {
                "what": "in-flight + recent request lifecycle timings",
                "arm": None,                 # always on, bounded ring
                "armed": True,
                "available": True,
            },
            "/debug/profile": {
                "what": "engine step flight recorder "
                        "(goodput/padding, ?format=chrome, ?capture_s)",
                "arm": "DYN_STEP_PROFILE=1",
                "armed": armed("step_recorder"),
                "available": engines is not None,
            },
            "/debug/router": {
                "what": "router decision flight recorder "
                        "(placement, overlap, margins)",
                "arm": "DYN_ROUTER_LOG=1",
                "armed": any(getattr(getattr(r, "router", r),
                                     "recorder", None) is not None
                             for r in routers.values()),
                "available": bool(routers),
            },
            "/debug/kv": {
                "what": "KV lifecycle flight recorder "
                        "(tiers, evictions, reuse distance, hotness)",
                "arm": "DYN_KV_LIFECYCLE=1",
                "armed": armed("kv_lifecycle"),
                "available": engines is not None,
            },
            "/debug/memory": {
                "what": "device memory ledger: per-class occupancy vs "
                        "the device's memory stats, workspace shapes, "
                        "unattributed residual",
                "arm": "DYN_MEM_LEDGER=1",
                "armed": armed("memory_ledger"),
                "available": engines is not None,
            },
            "/debug/control": {
                "what": "flight-control plane: controller state + "
                        "knob-change actions with evidence",
                "arm": "DYN_CONTROL=all|bucket,kvbm,router,forecast",
                "armed": self.control_plane is not None,
                "available": self.control_plane is not None,
            },
            "/debug/tenants": {
                "what": "per-tenant quotas, streams, fair-share "
                        "deficits, KV blocks, goodput",
                "arm": "DYN_TENANCY=<path|inline json>",
                "armed": self.quota is not None,
                "available": True,
            },
            "/debug/classes": {
                "what": "serving-class table, admitted/shed/downgraded "
                        "counters, deadline-admission estimate, "
                        "brownout stage",
                "arm": "DYN_CLASSES=1|<path|inline json>",
                "armed": self.classes is not None,
                "available": True,
            },
            "/debug/prefixes": {
                "what": "fleet prefix heatmap: cross-worker duplication, "
                        "tier-blind misses, shadow routing "
                        "counterfactual (tokens a tier-aware index "
                        "would have saved)",
                "arm": "DYN_PREFIX_HEAT=1",
                "armed": any(getattr(getattr(r, "router", r),
                                     "prefix_heat", None) is not None
                             for r in routers.values()),
                "available": bool(routers),
            },
        }
        return json_response({"surfaces": surfaces})

    async def _debug_requests(self, request: Request, conn) -> Response:
        """Request-lifecycle debug view: every in-flight request plus a
        ring of recently finished ones, with their timings (first and
        last token offsets from receipt, total duration), final status,
        usage, and the trace id to look up in DYN_TRACE's file.
        `?limit=N` bounds the recent list (newest first)."""
        limit = request.int_arg("limit", 50)
        recent = list(self._dbg_recent)[-max(limit, 0):]
        recent.reverse()
        return json_response({
            "in_flight": list(self._dbg_inflight.values()),
            "recent": recent,
        })

    async def _debug_profile(self, request: Request, conn) -> Response:
        """The step recorders: each engine's ring snapshot and goodput /
        padding summary. `?limit=N` bounds each ring dump,
        `?format=chrome` returns one Chrome trace-event JSON instead, and
        `?capture_s=N` also runs a `torch.profiler` window of N seconds
        (the engines serve on through it, paused only while the profiler
        starts and stops) and says where its trace landed."""
        from dynamo_tpu_torch.engine.profiler import (
            capture_engines_profile,
            profile_payload,
        )

        engines = self._engines()
        if engines is None:
            return self._unavailable("profiling")
        if request.arg("format") == "chrome":
            events: list = []
            for eng in engines:
                rec = getattr(eng, "step_recorder", None)
                if rec is not None:
                    events.extend(rec.chrome_trace()["traceEvents"])
            return json_response({"traceEvents": events,
                                  "displayTimeUnit": "ms"})
        limit = request.int_arg("limit", 256)
        payloads = [profile_payload(e, limit) for e in engines]
        body = {"enabled": any(p.get("enabled") for p in payloads),
                "engines": payloads}
        cap = request.arg("capture_s")
        if cap is not None:
            try:
                secs = float(cap)
            except ValueError:
                return json_response(
                    {"error": "capture_s must be a number"}, status=400)
            body["capture"] = await capture_engines_profile(secs, engines)
        return json_response(body)

    async def _debug_memory(self, request: Request, conn) -> Response:
        """The memory ledgers: each engine's classes reconciled against
        the device's figures, workspace shapes, the unattributed residual
        and the headroom. `?limit=N` bounds each snapshot ring."""
        from dynamo_tpu_torch.engine.memory import memory_payload

        engines = self._engines()
        if engines is None:
            return self._unavailable("memory ledger")
        limit = request.int_arg("limit", 64)
        payloads = [memory_payload(e, limit) for e in engines]
        return json_response({
            "enabled": any(p.get("enabled") for p in payloads),
            "engines": payloads})

    async def _debug_kv(self, request: Request, conn) -> Response:
        """The KV lifecycle recorders: each engine's tier occupancy, and
        with `DYN_KV_LIFECYCLE` eviction causes, reuse distances, tier
        residency and prefix hotness. `?limit=N` bounds each ring."""
        from dynamo_tpu_torch.kvbm.lifecycle import kv_payload

        engines = self._engines()
        if engines is None:
            return self._unavailable("kv lifecycle")
        limit = request.int_arg("limit", 256)
        payloads = [kv_payload(e, limit) for e in engines]
        return json_response({
            "enabled": any(p.get("enabled") for p in payloads),
            "engines": payloads})

    async def _debug_router(self, request: Request, conn) -> Response:
        """The KV routers' decision logs, per kv-mode model: counters and
        index stats, and with `DYN_ROUTER_LOG` the decision ring and its
        summary. `?limit=N` bounds each ring; 503 with no kv-mode
        model."""
        from dynamo_tpu_torch.router.decision_log import router_payload

        return self._per_kv_model(request, router_payload)

    async def _debug_prefixes(self, request: Request, conn) -> Response:
        """The prefix-heat planes, per kv-mode model: duplication bytes
        by depth bucket, tier-blind misses, the hottest shared prefixes
        and the shadow-routing counterfactual ring, when
        `DYN_PREFIX_HEAT` arms them. `?limit=N` bounds each ring; 503
        with no kv-mode model (round-robin/random routing makes no
        placement decisions to shadow)."""
        from dynamo_tpu_torch.router.prefix_plane import prefix_payload

        return self._per_kv_model(request, prefix_payload)

    async def _debug_control(self, request: Request, conn) -> Response:
        """The flight-control plane: armed controllers, tick and action
        counts, each controller's state and the action ring (every knob
        change with its before and after values and its evidence).
        `?limit=N` bounds the ring; 503 unless DYN_CONTROL armed a
        controller in this process."""
        if self.control_plane is None:
            return json_response(
                {"status": "unavailable",
                 "reason": "flight control not armed "
                           "(set DYN_CONTROL=all or a controller list)"},
                status=503)
        return json_response(
            self.control_plane.payload(request.int_arg("limit", 64)))

    async def _debug_tenants(self, request: Request, conn) -> Response:
        """The tenancy plane: each tenant's quota and live usage at this
        frontend (streams, bucket level, admitted and rejected counts,
        TTFT p90) and each in-process engine's scheduler state (queue
        depths, KV pages held, fair-share service and deficit). 503
        unless DYN_TENANCY armed tenancy in this process."""
        if self.quota is None:
            return json_response(
                {"status": "unavailable",
                 "reason": "tenancy not configured (set DYN_TENANCY)"},
                status=503)
        body = {"enabled": True, **self.quota.payload()}
        body["engines"] = [st for st in (tenant_state(e)
                                         for e in self._engines() or [])
                           if st]
        return json_response(body)

    async def _debug_classes(self, request: Request, conn) -> Response:
        """The serving-class plane: the class table and its default, the
        admitted / shed / downgraded / rejection counters, the deadline
        gate's TTFT estimate and the brownout machine's stage. 503
        unless DYN_CLASSES armed classes in this process."""
        if self.classes is None:
            return json_response(
                {"status": "unavailable",
                 "reason": "serving classes not configured "
                           "(set DYN_CLASSES)"},
                status=503)
        body = {"enabled": True,
                "default_class": self.classes.default_class,
                "classes": self.classes.payload(),
                "counters": self.class_metrics.payload()}
        if self.admission is not None:
            body["admission"] = {
                "quantile": self.admission.quantile,
                "est_ttft_s": round(self.admission.estimate_s(), 6)}
        if self.brownout is not None:
            body["brownout"] = self.brownout.state()
        return json_response(body)

    def _per_kv_model(self, request: Request, payload) -> Response:
        """`payload(router, limit)` of each kv-mode model's router, or a
        503 when this frontend serves none."""
        routers = self.manager.kv_routers()
        if not routers:
            return json_response(
                {"status": "unavailable",
                 "reason": "no kv-mode model served by this frontend"},
                status=503)
        limit = request.int_arg("limit", 256)
        models = [{"model": name, **payload(r, limit)}
                  for name, r in routers.items()]
        return json_response({
            "enabled": any(m.get("enabled") for m in models),
            "models": models})


def _as_openai_error(e: BaseException) -> OpenAIError:
    """The response a pipeline failure becomes: the request's own error,
    a 503 when no worker serves the model, a 500 otherwise."""
    if isinstance(e, OpenAIError):
        return e
    if isinstance(e, NoInstancesError):
        return OpenAIError(str(e), status=503, err_type="service_unavailable")
    logger.error("request failed", exc_info=e)
    return OpenAIError(f"{type(e).__name__}: {e}", status=500,
                       err_type="internal_error")
