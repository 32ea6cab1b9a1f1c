"""Message plane: multiplexed request → response-stream over TCP.

Port of `dynamo_tpu/runtime/transport.py` over the port's own MessagePack
codec; its frames are byte-identical with the reference's, so the two
packages' clients and servers interoperate. A request's W3C
`traceparent` rides its frame's headers under the reference's key
(`runtime/tracing.py`): the client puts the caller's current span there,
and the server's `serve <subject>` span continues that trace, so a port
frontend in front of a JAX-package worker, or the reverse, gives one
trace. The fault injector (`runtime/faults.py`) hooks the client side
as the reference's does: each dial asks `check_connect`, each response
frame `on_frame` (drop, kill the connection, delay, or an error frame).

Reference analog: NATS service request + TCP response stream with prologue /
sentinel framing (`lib/runtime/src/pipeline/network/{egress,ingress}/`,
`tcp.rs`). We collapse the two transports into one: a worker process runs a
`TransportServer`; routers hold pooled `TransportClient` connections and
multiplex many in-flight requests per connection.

Frames (codec.py MessagePack):
  client→server: {t:"req", rid, subject, payload, headers}
                 {t:"cancel", rid}
  server→client: {t:"data", rid, payload}
                 {t:"end", rid} | {t:"err", rid, error}

Cancellation propagates: context cancel on the client side sends a cancel
frame; the server cancels the handler task (reference: context.rs kill signal).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import random
from typing import Any, AsyncIterator, Callable, Optional

from dynamo_tpu_torch.runtime import codec
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.runtime.faults import FaultInjector
from dynamo_tpu_torch.runtime.tracing import TRACEPARENT, inject_headers, tracer

logger = logging.getLogger(__name__)

STREAM_ERR_MSG = "stream disconnected"  # matched by Migration retry logic

# Raised when the request's shared budget is already spent before any
# bytes move. Deliberately distinct from STREAM_ERR_MSG: no instance was
# at fault, so routers must not feed their breaker, and Migration knows
# a replay would fail instantly.
DEADLINE_ERR_MSG = "request deadline exceeded"

# Remaining-budget header (seconds): the client stamps its overall deadline
# onto the request so the server aborts the handler when the client has
# already given up — otherwise a timed-out request keeps burning engine
# steps for a reader that left (reference: context.rs kill signal).
DEADLINE_HEADER = "x-dyn-deadline-s"


class ConnectError(ConnectionError):
    """Dial failed — no request bytes ever reached the instance, so a
    router may safely retry a different one (unlike a mid-stream death,
    where replay is the Migration operator's job)."""


class TransportServer:
    """Serves registered engines (by subject) to remote callers."""

    STATS_SUBJECT = "_sys.stats"  # builtin scrape endpoint (nats.rs:107)

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host = host
        self.port = port
        self._handlers: dict[str, AsyncEngine] = {}
        self._server: Optional[asyncio.base_events.Server] = None
        self._conn_tasks: set[asyncio.Task] = set()
        self._conn_writers: set[asyncio.StreamWriter] = set()
        # per-subject service stats, scrapable via STATS_SUBJECT
        # (the reference's NATS $SRV.STATS analog)
        self.stats: dict[str, dict] = {}
        # optional process-level extras merged into the stats scrape
        # (the runtime wires client/breaker counters here so routers'
        # failure handling is observable from the same endpoint)
        self.extra_stats: Optional[Callable[[], dict]] = None

    def _stat(self, subject: str) -> dict:
        return self.stats.setdefault(subject, {
            "requests": 0, "errors": 0, "items": 0, "inflight": 0,
            "total_processing_s": 0.0})

    def register(self, subject: str, engine: AsyncEngine) -> None:
        self._handlers[subject] = engine

    def unregister(self, subject: str) -> None:
        self._handlers.pop(subject, None)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self) -> str:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self.address

    def abort_streams(self) -> list[asyncio.Task]:
        """Abort every in-flight handler WITHOUT cancelling its Context.

        The cancellation handler in `run_request` tells the two apart: a
        cancelled task whose context is NOT cancelled means the server
        (not the user) killed the stream, so it sends the `STREAM_ERR_MSG`
        err frame on the still-open connection — the error `Migration`
        replays on a surviving instance with the accumulated tokens. This
        is quarantine's stream handoff (`worker/quarantine.py`). Returns
        the cancelled tasks so callers can await the err frames flushing
        before tearing down."""
        tasks = [t for t in self._conn_tasks if not t.done()]
        for t in tasks:
            t.cancel()
        return tasks

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        # Force-close live connections: wait_closed() blocks on connection
        # handlers, which block on reads from clients that may never close.
        writers = list(self._conn_writers)
        for w in writers:
            w.close()
        for t in list(self._conn_tasks):
            t.cancel()
        if writers:
            # bounded flush of the transports: without it every stop()
            # leaks half-closed sockets (test warnings, fd pressure); the
            # bound keeps a peer that never ACKs from wedging shutdown
            try:
                await asyncio.wait_for(
                    asyncio.gather(*(w.wait_closed() for w in writers),
                                   return_exceptions=True), timeout=2.0)
            except asyncio.TimeoutError:
                pass
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=2.0)
            except asyncio.TimeoutError:
                pass

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        inflight: dict[str, tuple[asyncio.Task, Context]] = {}
        write_lock = asyncio.Lock()
        self._conn_writers.add(writer)

        async def send(obj: dict) -> None:
            async with write_lock:
                codec.write_frame(writer, obj)
                await writer.drain()

        async def run_request(rid: str, subject: str, payload: Any,
                              headers: dict) -> None:
            import time as _time

            ctx = inflight[rid][1]
            if subject == self.STATS_SUBJECT:
                try:
                    # builtin scrape: snapshot of every subject's counters,
                    # plus process-level client/breaker counters when the
                    # runtime wired them in
                    extra = None
                    if self.extra_stats is not None:
                        try:
                            extra = self.extra_stats()
                        except Exception:
                            logger.exception("extra_stats callback failed")
                    await send({"t": "data", "rid": rid,
                                "payload": {"stats": self.stats,
                                            "address": self.address,
                                            "client": extra}})
                    await send({"t": "end", "rid": rid})
                finally:
                    inflight.pop(rid, None)
                return
            engine = self._handlers.get(subject)
            if engine is None:
                # don't create a stats entry for attacker-chosen subject
                # strings: one shared bucket counts the rejects
                try:
                    self._stat("_unknown")["errors"] += 1
                    await send({"t": "err", "rid": rid,
                                "error": f"no such endpoint: {subject}"})
                except ConnectionError:
                    pass
                finally:
                    inflight.pop(rid, None)
                return
            stat = self._stat(subject)
            stat["requests"] += 1
            stat["inflight"] += 1
            t0 = _time.perf_counter()
            # Server-side deadline: the client stamped its overall budget
            # on the request; once it passes, the client is gone (its own
            # timer fired first), so abort the handler instead of
            # generating into the void. Cancelling ctx first makes this
            # look like a user cancel — no error frame needed.
            timer: Optional[asyncio.TimerHandle] = None
            deadline_s = (headers or {}).get(DEADLINE_HEADER)
            if deadline_s:
                task_ref = asyncio.current_task()

                def _expire() -> None:
                    ctx.cancel()
                    if task_ref is not None:
                        task_ref.cancel()

                timer = asyncio.get_running_loop().call_later(
                    float(deadline_s) + 0.05, _expire)
            try:
                # server span: the request's trace continues across the
                # wire via the traceparent header
                with tracer().start_span(
                        f"serve {subject}",
                        traceparent=headers.get(TRACEPARENT),
                        attributes={"rpc.subject": subject,
                                    "request.id": rid}) as span:
                    n = 0
                    async for item in engine.generate(payload, ctx):
                        await send({"t": "data", "rid": rid,
                                    "payload": item})
                        n += 1
                    span.set_attribute("response.items", n)
                    stat["items"] += n
                await send({"t": "end", "rid": rid})
            except asyncio.CancelledError:
                if not ctx.is_cancelled():  # server shutdown, not user cancel
                    try:
                        await send({"t": "err", "rid": rid, "error": STREAM_ERR_MSG})
                    except Exception:
                        pass
                raise
            except ConnectionError:
                pass  # client went away; nothing to report to
            except Exception as e:
                stat["errors"] += 1
                logger.exception("handler error subject=%s rid=%s", subject, rid)
                try:
                    await send({"t": "err", "rid": rid, "error": repr(e)})
                except Exception:
                    pass
            finally:
                if timer is not None:
                    timer.cancel()
                stat["inflight"] -= 1
                stat["total_processing_s"] += _time.perf_counter() - t0
                inflight.pop(rid, None)

        try:
            while True:
                try:
                    msg = await codec.read_frame(reader)
                except ConnectionError:
                    break
                t = msg.get("t")
                if t == "req":
                    rid = msg["rid"]
                    ctx = Context(request_id=rid, headers=msg.get("headers") or {})
                    task = asyncio.get_running_loop().create_task(
                        run_request(rid, msg["subject"], msg.get("payload"),
                                    msg.get("headers") or {})
                    )
                    inflight[rid] = (task, ctx)
                    self._conn_tasks.add(task)
                    task.add_done_callback(self._conn_tasks.discard)
                elif t == "cancel":
                    entry = inflight.get(msg["rid"])
                    if entry is not None:
                        entry[1].cancel()
                        entry[0].cancel()
        finally:
            self._conn_writers.discard(writer)
            for task, ctx in list(inflight.values()):
                ctx.cancel()
                task.cancel()
            writer.close()


class _Connection:
    """One pooled client connection; demultiplexes response streams."""

    def __init__(self, address: str,
                 injector: Optional[FaultInjector] = None,
                 stats: Optional[dict] = None) -> None:
        self.address = address
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._streams: dict[str, asyncio.Queue] = {}
        self._subjects: dict[str, str] = {}  # rid → subject (fault matching)
        self._injector = injector
        self._rx_task: Optional[asyncio.Task] = None
        self._write_lock = asyncio.Lock()
        self._stats = stats
        self._decode_error_logged = False
        self.closed = False

    async def connect(self) -> None:
        if self._injector is not None:
            self._injector.check_connect(self.address)
        host, _, port = self.address.rpartition(":")
        self._reader, self._writer = await asyncio.open_connection(host, int(port))
        self._rx_task = asyncio.get_running_loop().create_task(self._rx_loop())

    async def _rx_loop(self) -> None:
        assert self._reader is not None
        try:
            while True:
                try:
                    msg = await codec.read_frame(self._reader)
                except ConnectionError:
                    break
                except Exception:
                    # Corrupt/undecodable frame: the framing state is
                    # suspect, so the only safe recovery is dropping the
                    # connection — but say which peer sent it (once per
                    # connection) and count it, or undecodable peers are
                    # undiagnosable.
                    if self._stats is not None:
                        self._stats["decode_errors"] = \
                            self._stats.get("decode_errors", 0) + 1
                    if not self._decode_error_logged:
                        self._decode_error_logged = True
                        logger.warning(
                            "undecodable frame from %s; dropping the "
                            "connection", self.address, exc_info=True)
                    break
                if self._stats is not None:
                    self._stats["frames"] += 1
                rid = msg.get("rid")
                if self._injector is not None:
                    action = self._injector.on_frame(
                        self.address, self._subjects.get(rid), rid, msg)
                    if action is not None:
                        if action[0] == "drop":
                            continue          # silently stalled stream
                        if action[0] == "kill":
                            break             # as if the peer vanished
                        if action[0] == "delay":
                            await asyncio.sleep(action[1])
                        elif action[0] == "err":
                            msg = {"t": "err", "rid": rid,
                                   "error": action[1]}
                q = self._streams.get(rid)
                if q is not None:
                    q.put_nowait(msg)
        except asyncio.CancelledError:
            pass
        finally:
            self.closed = True
            if self._writer is not None:
                self._writer.close()
            for q in list(self._streams.values()):
                q.put_nowait({"t": "err", "error": STREAM_ERR_MSG})

    async def send(self, obj: dict) -> None:
        if self._writer is None or self.closed:
            raise ConnectionError("connection closed")
        async with self._write_lock:
            codec.write_frame(self._writer, obj)
            await self._writer.drain()

    def open_stream(self, rid: str, subject: Optional[str] = None
                    ) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue()
        self._streams[rid] = q
        if subject is not None:
            self._subjects[rid] = subject
        return q

    def close_stream(self, rid: str) -> None:
        self._streams.pop(rid, None)
        self._subjects.pop(rid, None)

    def close(self) -> None:
        self.closed = True
        if self._rx_task is not None:
            self._rx_task.cancel()
        if self._writer is not None:
            self._writer.close()


class TransportClient:
    """Pooled connections keyed by address, with streaming request API.

    Robustness knobs (all default-off / conservative, usually set from
    `RuntimeConfig` by the runtime):

    - ``idle_timeout``: max seconds between response frames. A stream that
      goes silent longer raises ``ConnectionError(STREAM_ERR_MSG)`` — the
      exact signal the Migration operator replays on, turning a
      wedged-but-connected worker into a recovery instead of a hang.
    - ``deadline``: overall per-request wall clock. The first request()
      call on a context stamps the absolute expiry onto it
      (``Context.deadline``); retries and Migration replays reusing that
      context inherit the REMAINING time, so the budget is per request,
      not per attempt. The remaining time is also stamped onto the wire
      (`DEADLINE_HEADER`) so the server aborts the handler.
    - ``connect_retries`` + jittered exponential backoff on dial failure
      (bounded by the request's remaining deadline); exhaustion raises
      `ConnectError` so routers can try another instance, and briefly
      negative-caches the address so callers queued on the same dial
      lock fail fast instead of serially re-running the backoff cycle.
    """

    def __init__(self, *, idle_timeout: float = 0.0, deadline: float = 0.0,
                 connect_retries: int = 2,
                 connect_backoff_base: float = 0.05,
                 connect_backoff_max: float = 2.0,
                 connect_neg_cache: float = 0.25,
                 idle_timeout_provider=None,
                 fault_injector: Optional[FaultInjector] = None) -> None:
        self._conns: dict[str, _Connection] = {}
        self._rids = itertools.count(1)
        # Per-address locks: a black-holed host must not head-of-line-block
        # connection setup to healthy addresses.
        self._locks: dict[str, asyncio.Lock] = {}
        # address → (poisoned-until loop time, reason) after an exhausted
        # dial cycle; entries expire after connect_neg_cache seconds
        self._neg_cache: dict[str, tuple[float, str]] = {}
        self.idle_timeout = idle_timeout
        # optional () -> float consulted per request when no per-call
        # idle_timeout is given: lets the runtime derive the effective
        # idle timeout from observed inter-token gaps (the adaptive idle
        # timeout). Returning 0.0 defers to the static value.
        self.idle_timeout_provider = idle_timeout_provider
        self.deadline = deadline
        self.connect_retries = connect_retries
        self.connect_backoff_base = connect_backoff_base
        self.connect_backoff_max = connect_backoff_max
        self.connect_neg_cache = connect_neg_cache
        self._rng = random.Random()
        # seeded chaos seam (runtime/faults.py): dials and response frames
        # consult it; None (no DYN_FAULTS) costs one attribute check
        self.fault_injector = fault_injector or FaultInjector.from_env()
        # client-side robustness counters (scraped via the server's
        # `_sys.stats` extras + exported through runtime metrics), and
        # the response frames received: one per engine output item, the
        # codec's work on this side of the wire
        self.stats: dict[str, int] = {
            "connect_retries": 0, "connect_failures": 0,
            "idle_timeouts": 0, "deadline_exceeded": 0,
            "decode_errors": 0, "route_retries": 0, "frames": 0,
        }

    async def _conn(self, address: str,
                    deadline_at: Optional[float] = None) -> _Connection:
        loop = asyncio.get_running_loop()
        lock = self._locks.setdefault(address, asyncio.Lock())
        async with lock:
            conn = self._conns.get(address)
            if conn is not None and not conn.closed:
                return conn
            # Negative cache: the dial cycle below runs under the
            # per-address lock, so once it exhausts its retries every
            # caller already queued behind it would serially re-run the
            # whole backoff cycle against the same dead host. A briefly
            # poisoned address makes them fail fast instead, so routers
            # move to the next instance within the caller's deadline.
            neg = self._neg_cache.get(address)
            if neg is not None:
                until, why = neg
                if loop.time() < until:
                    self.stats["connect_failures"] += 1
                    raise ConnectError(
                        f"connect to {address} failed {why}; redial "
                        f"suppressed for {until - loop.time():.2f}s")
                del self._neg_cache[address]
            last: Optional[Exception] = None
            for attempt in range(self.connect_retries + 1):
                if attempt:
                    # full-jitter exponential backoff: desynchronises the
                    # redial herd when a popular worker restarts
                    delay = min(self.connect_backoff_max,
                                self.connect_backoff_base
                                * (2 ** (attempt - 1)))
                    delay *= 0.5 + self._rng.random()
                    if deadline_at is not None:
                        delay = min(delay, max(0.0, deadline_at - loop.time()))
                    self.stats["connect_retries"] += 1
                    await asyncio.sleep(delay)
                # the caller's remaining request budget bounds the whole
                # dial loop — backoff past it only delays router failover
                budget = (None if deadline_at is None
                          else deadline_at - loop.time())
                if budget is not None and budget <= 0:
                    if last is None:
                        last = asyncio.TimeoutError(
                            "request deadline elapsed while dialing")
                    break
                conn = _Connection(address, injector=self.fault_injector,
                                   stats=self.stats)
                try:
                    if budget is None:
                        await conn.connect()
                    else:
                        await asyncio.wait_for(conn.connect(), budget)
                except (ConnectionError, OSError,
                        asyncio.TimeoutError) as e:
                    conn.close()
                    last = e
                    continue
                self._conns[address] = conn
                return conn
            self.stats["connect_failures"] += 1
            # poison only on a genuinely exhausted cycle: a dial cut
            # short by the CALLER's deadline says nothing about the
            # host's health and must not fail other requests fast
            deadline_cut = (deadline_at is not None
                            and loop.time() >= deadline_at)
            if self.connect_neg_cache > 0 and not deadline_cut:
                self._neg_cache[address] = (
                    loop.time() + self.connect_neg_cache,
                    f"after {self.connect_retries + 1} attempts "
                    f"({last!r})")
            raise ConnectError(
                f"connect to {address} failed after "
                f"{self.connect_retries + 1} attempts: {last!r}") from last

    async def request(self, address: str, subject: str, payload: Any,
                      context: Optional[Context] = None, *,
                      idle_timeout: Optional[float] = None,
                      deadline: Optional[float] = None) -> AsyncIterator[Any]:
        """Send one request; yield response payloads until end.

        Raises ConnectionError(STREAM_ERR_MSG) if the stream dies mid-way
        OR stalls past the idle timeout / overall deadline — the signal the
        Migration operator retries on. Per-call timeouts override the
        client-level defaults; 0 disables.
        """
        ctx = context or Context()
        idle = self.idle_timeout if idle_timeout is None else idle_timeout
        if idle_timeout is None and self.idle_timeout_provider is not None:
            # adaptive idle: observed-gap-derived timeout, never tighter
            # than the configured static floor
            try:
                derived = float(self.idle_timeout_provider() or 0.0)
            except Exception:
                derived = 0.0
            if derived > 0:
                idle = max(idle, derived)
        total = self.deadline if deadline is None else deadline
        loop = asyncio.get_running_loop()
        # ONE budget per request, not per attempt: the first call stamps
        # the absolute expiry on the context; router retries and
        # Migration replays reuse the context and inherit the remaining
        # time, so worst-case wall clock stays ~deadline rather than
        # deadline × attempts.
        expires = ctx.deadline
        if expires is None and total:
            expires = ctx.deadline = loop.time() + total
        if expires is not None and loop.time() >= expires:
            self.stats["deadline_exceeded"] += 1
            raise ConnectionError(DEADLINE_ERR_MSG)
        conn = await self._conn(address, deadline_at=expires)
        rid = f"{ctx.request_id}.{next(self._rids)}"
        cancel_task = None
        try:
            q = conn.open_stream(rid, subject)
            headers = inject_headers(dict(ctx.headers))
            if expires is not None:
                # stamp the REMAINING time, not the configured total: the
                # server-side abort timer must share this request's budget
                headers[DEADLINE_HEADER] = max(0.0, expires - loop.time())
            await conn.send({"t": "req", "rid": rid, "subject": subject,
                             "payload": payload, "headers": headers})

            async def watch_cancel() -> None:
                await ctx.wait_cancelled()
                try:
                    await conn.send({"t": "cancel", "rid": rid})
                except ConnectionError:
                    pass
                q.put_nowait({"t": "end"})

            cancel_task = asyncio.get_running_loop().create_task(watch_cancel())
            while True:
                timeout = idle if idle else None
                if expires is not None:
                    remaining = expires - loop.time()
                    timeout = (remaining if timeout is None
                               else min(timeout, remaining))
                if timeout is None:
                    msg = await q.get()
                else:
                    try:
                        msg = (await asyncio.wait_for(q.get(), timeout)
                               if timeout > 0 else None)
                    except asyncio.TimeoutError:
                        msg = None
                if msg is None:
                    # Stalled stream or blown deadline: abort the server
                    # side (best effort) and surface the Migration-visible
                    # error so the request is replayed, not hung.
                    kind = ("deadline_exceeded"
                            if expires is not None
                            and loop.time() >= expires
                            else "idle_timeouts")
                    self.stats[kind] += 1
                    try:
                        await conn.send({"t": "cancel", "rid": rid})
                    except ConnectionError:
                        pass
                    raise ConnectionError(STREAM_ERR_MSG)
                t = msg.get("t")
                if t == "data":
                    yield msg["payload"]
                elif t == "end":
                    return
                elif t == "err":
                    raise ConnectionError(msg.get("error", STREAM_ERR_MSG))
        finally:
            if cancel_task is not None:
                cancel_task.cancel()
            conn.close_stream(rid)

    async def close(self) -> None:
        for conn in self._conns.values():
            conn.close()
        self._conns.clear()
