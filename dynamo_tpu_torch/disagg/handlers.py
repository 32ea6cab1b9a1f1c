"""Disaggregated worker handlers: decode-first orchestration and the KV
pull.

Port of `dynamo_tpu/disagg/handlers.py` (after the upstream
`components/src/dynamo/vllm/handlers.py`). The decode worker's
`DecodeWorkerHandler.generate` sends a long prompt to the prefill pool
with max_tokens = 1 and `kv_transfer_params.do_remote_decode` (router
first, round-robin after), pulls the pages the prefill engine pinned,
and decodes with them imported into its own engine. The KV moves by one
of three paths, in this order:

- **device**: the owning prefill engine lives in this process
  (`_LOCAL_PREFILL`): one gather on its card, handed to this engine as a
  device tensor;
- **plane**: another process on this card: the CUDA IPC staging plane
  (`disagg/transfer_plane.py`; `DYN_KV_PLANE=0` turns it off on either
  side);
- **wire**: chunked host frames over the runtime transport, byte for byte
  the reference's (`_tensor_bytes` / `_tensor_from` read and write the
  reference's bf16 bytes with `torch.frombuffer`, where the reference
  uses `ml_dtypes`).

Where a path that was tried fails, the pull goes on as the reference's
does (device → wire, plane → wire before staging, plane → local serve
after it) and the handler counts it: `fallbacks` and the engine's
`dynamo_kv_pull_fallbacks_total` by (path, to). Nothing falls back
uncounted. The prefill-queue dispatch (`--prefill-queue`) is a later
slice.
"""

from __future__ import annotations

import asyncio
import logging
import time
import warnings
from collections import deque
from typing import Any, AsyncIterator, Optional

import torch

from dynamo_tpu_torch.disagg.disagg_router import DisaggRouter
from dynamo_tpu_torch.disagg.transfer_plane import (
    PLANE_KIND,
    get_plane,
    plane_enabled,
)
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.runtime.push import PushRouter
from dynamo_tpu_torch.runtime.topology import link_for_pull_path
from dynamo_tpu_torch.tokens import TokenBlockSequence

logger = logging.getLogger(__name__)

KV_PULL_ENDPOINT = "kv_pull"

# same-process prefill handlers by instance id: a registry hit pulls the
# KV on the card (no host copy, no serialisation)
_LOCAL_PREFILL: dict[int, "PrefillWorkerHandler"] = {}

# pages per wire frame on the host path: bounds a frame's size and lets
# the consumer assemble while later frames are in flight
DEFAULT_PULL_CHUNK_PAGES = 64

# strong refs to in-flight fire-and-forget transfer aborts
_ABORT_TASKS: set = set()

# overall bound on one KV pull, every path: a stalled prefill worker
# degrades to local serving instead of hanging the request (0: none)
DEFAULT_PULL_DEADLINE_S = 60.0

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _tensor_bytes(t: torch.Tensor) -> tuple[bytes, list[int], str]:
    """A host tensor as the reference's wire frame fields: its bytes, its
    shape and its dtype's numpy name."""
    t = t.contiguous()
    raw = t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
    return raw, list(t.shape), str(t.dtype).removeprefix("torch.")


def _tensor_from(raw: bytes, shape: list[int], dtype: str) -> torch.Tensor:
    """The inverse of `_tensor_bytes` (and of the reference's
    `_bf16_bytes`): a host tensor over the frame's bytes, read only."""
    dt = _DTYPES[dtype]
    if not raw:
        return torch.empty(shape, dtype=dt)
    with warnings.catch_warnings():
        # the frame's bytes are immutable; nothing writes through the view
        warnings.simplefilter("ignore", UserWarning)
        return torch.frombuffer(raw, dtype=dt).reshape(shape)


class PrefillWorkerHandler:
    """Serves `generate` on the prefill pool; the engine does the work
    (max_tokens = 1, pages pinned). This wrapper stamps the instance id
    into `kv_transfer_params` so the decode side can address the owner's
    `kv_pull` endpoint."""

    def __init__(self, engine, instance_id: int) -> None:
        self.engine = engine
        self.instance_id = instance_id

    async def generate(self, request: dict, context: Context
                       ) -> AsyncIterator[dict]:
        async for out in self.engine.generate(request, context):
            ktp = out.get("kv_transfer_params")
            if ktp is not None:
                ktp["instance_id"] = self.instance_id
            yield out

    async def kv_pull(self, request: dict, context: Context
                      ) -> AsyncIterator[dict]:
        """{"transfer_id"} → the pinned pages as chunked frames of
        `chunk_pages` pages (one frame when the requester names no chunk
        size); {"stage": true, "plane": "cuda_ipc"} → one CUDA IPC
        descriptor frame; {"release": true} → the staged buffer freed;
        {"abort": true} → the pinned pages released."""
        tid = request["transfer_id"]
        if request.get("abort"):
            # the decode side gave up on this pull: release the pinned
            # pages now instead of at the TTL (an idempotent pop)
            self.engine.complete_transfer(tid)
            get_plane().release(tid)
            yield {"aborted": True}
            return
        if request.get("release"):
            # the consumer has copied the staged buffer out
            yield {"released": get_plane().release(tid)}
            return
        try:
            pages, prefill_len = self.engine.take_transfer(tid)
        except KeyError:
            yield {"error": f"unknown transfer {tid}"}
            return
        if request.get("stage"):
            # the CUDA IPC plane: stage a device copy, release the pages
            # (the copy is independent) and reply with its descriptor. A
            # requester that asks for another plane (the reference's JAX
            # transfer server) gets an error and takes the wire.
            if request.get("plane") != PLANE_KIND \
                    or not plane_enabled(self.engine.device):
                yield {"error": "kv plane unavailable (DYN_KV_PLANE=0, no "
                                "card, or another plane asked)"}
                return
            try:
                buf = await self.engine.read_kv_pages_device(pages)
                desc = get_plane().publish(tid, buf)
            except Exception as e:
                logger.exception("kv plane staging failed")
                yield {"error": f"stage failed: {e}"}
                return
            self.engine.complete_transfer(tid)
            yield {"plane": desc, "prefill_len": prefill_len}
            return
        total = len(pages)
        # chunking is opt-in by the requester: a peer that sends no
        # chunk_pages reads exactly one frame
        chunk = max(1, int(request.get("chunk_pages") or total or 1))
        try:
            for i in range(0, total, chunk):
                if i > 0:
                    # the consumer paces the frames, so a slow pull can
                    # outlive the TTL: re-take to refresh the deadline and
                    # confirm the reaper has not released the pages
                    try:
                        self.engine.take_transfer(tid)
                    except KeyError:
                        yield {"error": f"transfer {tid} expired mid-pull"}
                        return
                data = await self.engine.read_kv_pages(pages[i:i + chunk])
                raw, shape, dtype = _tensor_bytes(data)
                yield {"kv": raw, "shape": shape, "dtype": dtype,
                       "page_offset": i, "total_pages": total,
                       "prefill_len": prefill_len}
        finally:
            # release however the stream ends (consumer close, read
            # failure); an idempotent pop
            self.engine.complete_transfer(tid)


async def serve_kv_pull(runtime, namespace: str, component: str,
                        handler: PrefillWorkerHandler, instance_id: int):
    """Serve the prefill worker's `kv_pull` endpoint and register the
    handler for the same-process device path."""
    _LOCAL_PREFILL[instance_id] = handler
    ep = (runtime.namespace(namespace).component(component)
          .endpoint(KV_PULL_ENDPOINT))
    served = await ep.serve(handler.kv_pull, instance_id=instance_id)

    orig_shutdown = served.shutdown

    async def shutdown():
        _LOCAL_PREFILL.pop(instance_id, None)
        await orig_shutdown()

    served.shutdown = shutdown
    return served


class DecodeWorkerHandler:
    """Decode-first disaggregation.

    generate():
    1. if a prefill pool exists and the DisaggRouter says remote, send the
       prompt there with max_tokens = 1 and do_remote_decode;
    2. pull the KV pages from the owning prefill worker;
    3. decode locally with the imported KV (prompt + first token, cached
       length = prefill_len).
    Serves fully locally when no pool exists, the prompt is short or
    mostly cached, or the remote prefill or the pull fails."""

    def __init__(self, engine,
                 prefill_router: Optional[AsyncEngine] = None,
                 kv_pull_router: Optional[PushRouter] = None,
                 disagg_router: Optional[DisaggRouter] = None,
                 pull_chunk_pages: int = DEFAULT_PULL_CHUNK_PAGES,
                 pull_deadline: float = DEFAULT_PULL_DEADLINE_S) -> None:
        self.engine = engine
        self.prefill_router = prefill_router
        self.kv_pull_router = kv_pull_router
        self.disagg_router = disagg_router or DisaggRouter()
        self.pull_chunk_pages = pull_chunk_pages
        self.pull_deadline = pull_deadline
        # "device" | "plane" | "wire"
        self.last_pull_path: Optional[str] = None
        # bounded per-transfer records: bytes, seconds, bandwidth by path
        self.transfer_log: deque = deque(maxlen=256)
        # (path tried, where the pull went on) -> count
        self.fallbacks: dict[tuple[str, str], int] = {}

    @property
    def _metrics(self):
        return getattr(self.engine, "metrics", None)

    def _can_prefill_remote(self) -> bool:
        if self.kv_pull_router is None or self.prefill_router is None:
            return False
        try:
            return bool(self.kv_pull_router.client.instances())
        except Exception:
            return False

    def _prefix_hit_len(self, token_ids: list[int]) -> int:
        page = self.engine.model_cfg.page_size
        hashes = TokenBlockSequence(page, token_ids).seq_hashes()
        return len(self.engine.pool.match_prefix(hashes)) * page

    def _fallback(self, path: str, to: str, why: Any = None) -> None:
        """Count one pull that failed on `path` and went on to `to`."""
        key = (path, to)
        self.fallbacks[key] = self.fallbacks.get(key, 0) + 1
        em = self._metrics
        if em is not None:
            em.kv_pull_fallbacks.inc(path=path, to=to)
        logger.warning("kv pull fell back from %s to %s (%s)", path, to, why)

    def _abort_remote_transfer(self, ktp: dict) -> None:
        """Fire-and-forget release of a failed pull's pinned pages on the
        owning prefill worker (a fresh Context: the request's own may be
        cancelled)."""
        if self.kv_pull_router is None:
            return

        async def _abort() -> None:
            try:
                async for _ in self.kv_pull_router.direct(
                        {"transfer_id": ktp["transfer_id"], "abort": True},
                        ktp["instance_id"], Context()):
                    break
            except Exception:
                logger.debug("transfer abort for %s not delivered",
                             ktp["transfer_id"], exc_info=True)

        task = asyncio.get_running_loop().create_task(
            asyncio.wait_for(_abort(), 5.0))
        _ABORT_TASKS.add(task)

        def _done(t: asyncio.Task) -> None:
            _ABORT_TASKS.discard(t)
            if not t.cancelled():
                t.exception()   # best effort: swallow the wait_for timeout

        task.add_done_callback(_done)

    async def _release_staged(self, ktp: dict) -> None:
        """Tell the producer its staging buffer is free (the consumer has
        copied it out); a lost ack leaves it to the producer's TTL."""
        try:
            async for _ in self.kv_pull_router.direct(
                    {"transfer_id": ktp["transfer_id"], "release": True},
                    ktp["instance_id"], Context()):
                break
        except Exception:
            logger.warning("staging release for %s not delivered",
                           ktp["transfer_id"], exc_info=True)

    async def _pull_device(self, src: "PrefillWorkerHandler", ktp: dict):
        """The same-process path: the owner's gather on its card, moved to
        this engine's device if it differs. None to go on to the next
        path (the transfer stays pinned)."""
        tid = ktp["transfer_id"]
        try:
            pages, _ = src.engine.take_transfer(tid)
        except KeyError:
            # a stale registry entry (an instance id reused by a remote
            # worker): the transport may still reach the owner
            self._fallback("device", "wire", "transfer not on the local "
                                             "engine")
            return None
        try:
            out = await src.engine.read_kv_pages_device(pages)
            if out.device != self.engine.device:
                out = out.to(self.engine.device)
        except asyncio.CancelledError:
            # the pull deadline fired mid-copy: nothing pulls this
            # transfer again, so release its pages now
            src.engine.complete_transfer(tid)
            raise
        except Exception as e:
            logger.exception("device-side KV pull failed")
            self._fallback("device", "wire", e)
            return None
        src.engine.complete_transfer(tid)
        self.last_pull_path = "device"
        return out

    async def _pull_plane(self, ktp: dict, context: Context):
        """The CUDA IPC plane. Returns (done, kv): done False goes on to
        the wire (nothing was staged), done True with kv None serves
        locally (the producer released its pages at staging)."""
        staged = False
        try:
            async for frame in self.kv_pull_router.direct(
                    {"transfer_id": ktp["transfer_id"], "stage": True,
                     "plane": PLANE_KIND},
                    ktp["instance_id"], context):
                desc = frame.get("plane")
                if desc is None or desc.get("kind") != PLANE_KIND:
                    self._fallback("plane", "wire", frame.get("error"))
                    return False, None
                staged = True
                out = await asyncio.to_thread(get_plane().pull, desc,
                                              self.engine.device)
                await self._release_staged(ktp)
                self.last_pull_path = "plane"
                return True, out
        except asyncio.CancelledError:
            if staged:
                # the producer frees its staging buffer at its TTL
                logger.warning("KV plane pull for %s cancelled after "
                               "staging", ktp["transfer_id"])
            raise
        except ConnectionError as e:
            self._fallback("plane", "local", e)
            return True, None
        except Exception as e:
            if staged:
                # the producer released its pages at staging: the wire
                # has nothing left to pull
                logger.exception("kv plane pull failed after staging")
                await self._release_staged(ktp)
                self._fallback("plane", "local", e)
                return True, None
            logger.exception("kv plane staging failed")
            self._fallback("plane", "wire", e)
            return False, None
        self._fallback("plane", "wire", "no staging frame")
        return False, None

    async def _pull_wire(self, ktp: dict, context: Context):
        """Chunked host frames, assembled in arrival order into one host
        tensor; None when the stream fails or ends short. The stream is
        read to its end, so the producer's stream closes (and releases the
        pinned pages) before the pull returns."""
        buf: Optional[torch.Tensor] = None
        got, total = 0, None
        try:
            async for frame in self.kv_pull_router.direct(
                    {"transfer_id": ktp["transfer_id"],
                     "chunk_pages": self.pull_chunk_pages},
                    ktp["instance_id"], context):
                if "kv" not in frame:
                    return None
                chunk = _tensor_from(frame["kv"], frame["shape"],
                                     frame["dtype"])
                if "page_offset" not in frame:     # a single-frame peer
                    buf = chunk
                    got = total = chunk.shape[3]
                    continue
                total = int(frame["total_pages"])
                if buf is None:
                    shape = list(chunk.shape)
                    shape[3] = total
                    buf = torch.empty(shape, dtype=chunk.dtype)
                off = int(frame["page_offset"])
                buf[:, :, :, off:off + chunk.shape[3]] = chunk
                got += chunk.shape[3]
        except ConnectionError:
            return None
        if buf is None or got < total:
            return None    # the stream ended short
        self.last_pull_path = "wire"
        return buf

    async def _pull_kv(self, ktp: dict, context: Context):
        """Fetch the pinned pages by the first path that serves them."""
        self.last_pull_path = None
        src = _LOCAL_PREFILL.get(ktp["instance_id"])
        if src is not None:
            out = await self._pull_device(src, ktp)
            if out is not None:
                return out
        elif plane_enabled(self.engine.device):
            done, out = await self._pull_plane(ktp, context)
            if done:
                return out
        return await self._pull_wire(ktp, context)

    def _record_pull(self, ktp: dict, kv_data, seconds: float) -> None:
        """Account one successful pull: bytes and bandwidth into the
        engine metrics by path, and a bounded per-transfer record."""
        nbytes = int(getattr(kv_data, "nbytes", 0) or 0)
        path = self.last_pull_path or "?"
        link = link_for_pull_path(path)
        bw = nbytes / seconds if seconds > 0 else 0.0
        em = self._metrics
        if em is not None and nbytes:
            em.kv_pull_bytes.inc(nbytes, path=path, link=link)
            em.kv_pull_bw.observe(bw)
        self.transfer_log.append({
            "transfer_id": ktp.get("transfer_id"),
            "path": path,
            "link": link,
            "bytes": nbytes,
            "seconds": round(seconds, 6),
            "bandwidth_bytes_per_s": round(bw, 1),
            "prefill_len": int(ktp.get("prefill_len") or 0),
            "at": time.time(),
        })
        logger.info("kv pull %s: path %s, %d tokens, %d bytes in %.6f s "
                    "(%.3f GB/s)", ktp.get("transfer_id"), path,
                    int(ktp.get("prefill_len") or 0), nbytes, seconds,
                    bw / 1e9)

    async def generate(self, request: dict, context: Context
                       ) -> AsyncIterator[dict]:
        token_ids = list(request.get("token_ids", ()))
        remote = (self._can_prefill_remote()
                  and self.disagg_router.prefill_remote(
                      len(token_ids), self._prefix_hit_len(token_ids)))
        if not remote:
            async for out in self.engine.generate(request, context):
                yield out
            return

        # 1. remote prefill (max_tokens = 1, pages pinned remotely)
        prefill_req = dict(request)
        stop = dict(prefill_req.get("stop") or {})
        stop["max_tokens"] = 1
        stop.pop("stop_token_ids", None)
        prefill_req["stop"] = stop
        prefill_req["kv_transfer_params"] = {"do_remote_decode": True}
        first_token: Optional[int] = None
        first_lp: Optional[float] = None
        first_top: Optional[list] = None
        ktp: Optional[dict] = None
        try:
            async for out in self.prefill_router.generate(prefill_req,
                                                          context):
                if out.get("token_ids"):
                    first_token = out["token_ids"][0]
                    if out.get("log_probs"):
                        first_lp = out["log_probs"][0]
                    if out.get("top_logprobs"):
                        first_top = out["top_logprobs"][0]
                if out.get("kv_transfer_params"):
                    ktp = out["kv_transfer_params"]
                if out.get("finish_reason") == "error":
                    ktp = None
                    break
        except ConnectionError:
            ktp = None
        if ktp is None or first_token is None:
            logger.warning("remote prefill failed; serving locally")
            async for out in self.engine.generate(request, context):
                yield out
            return

        # 2. pull the KV pages from the owning prefill worker, bounded
        try:
            t_pull = time.perf_counter()
            kv_data = await asyncio.wait_for(self._pull_kv(ktp, context),
                                             self.pull_deadline or None)
            pull_s = time.perf_counter() - t_pull
            em = self._metrics
            if em is not None:
                em.kv_pull.observe(pull_s)
            if kv_data is not None:
                self._record_pull(ktp, kv_data, pull_s)
        except asyncio.TimeoutError:
            logger.warning("KV pull for transfer %s exceeded %.1fs; "
                           "serving locally", ktp.get("transfer_id"),
                           self.pull_deadline)
            kv_data = None
        if kv_data is None:
            self._abort_remote_transfer(ktp)
            logger.warning("KV pull failed; serving locally")
            async for out in self.engine.generate(request, context):
                yield out
            return

        # 3. stream the prefill token, then decode with the imported KV
        def first_frame(**kw) -> dict:
            out = {"token_ids": [first_token], **kw}
            if first_lp is not None:
                out["log_probs"] = [first_lp]
            if first_top is not None:
                # the port also carries the first token's top-k
                # alternatives, so a logprobs client sees the aggregated
                # stream's entries (the reference's frame drops them)
                out["top_logprobs"] = [first_top]
            return out

        orig_stop = request.get("stop") or {}
        if orig_stop.get("max_tokens") == 1:
            yield first_frame(finish_reason="length")
            return
        if first_token in (orig_stop.get("stop_token_ids") or ()) \
                and (orig_stop.get("min_tokens") or 0) <= 1:
            yield first_frame(finish_reason="stop")
            return
        yield first_frame()
        decode_req = dict(request)
        decode_req["token_ids"] = token_ids + [first_token]
        stop = dict(decode_req.get("stop") or {})
        # the remote prefill streamed one token: the decode budget shrinks
        # by one, from the engine's default when the request sets none
        eff_max = (stop.get("max_tokens")
                   or self.engine.config.default_max_tokens)
        stop["max_tokens"] = max(eff_max - 1, 1)
        if stop.get("min_tokens"):
            stop["min_tokens"] = max(stop["min_tokens"] - 1, 0)
        decode_req["stop"] = stop
        decode_req["kv_transfer_params"] = {
            "kv_data": kv_data, "prefill_len": int(ktp["prefill_len"])}
        async for out in self.engine.generate(decode_req, context):
            yield out
