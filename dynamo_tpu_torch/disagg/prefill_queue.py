"""Prefill queue: pull-model disaggregation over the durable work queue.

Port of `dynamo_tpu/disagg/prefill_queue.py` (the port keeps its own
copy). Job and result payloads and their keys are the reference's, so a
decode worker of either package can enqueue a job that a prefill worker
of the other takes. One addition rides the result's transfer params:
when the job asked for top logprobs, the first token's list
(`first_token_top_logprobs`, beside the reference's
`first_token_logprob`), so a queued remote prefill streams the same
logprob entries as the push path; the reference's decode side ignores
the key.

Reference: the SGLang pattern (`docs/architecture/dynamo_flow.md:23-52`,
`sglang/request_handlers/llm/{decode,prefill}_handler.py`) — instead of
the decode worker PUSH-routing a prefill request at a chosen worker
(vLLM pattern, `disagg/handlers.py`), it enqueues the job on a shared
queue and ANY prefill worker pulls it. Load-balancing falls out of the
queue (idle workers pull), and a prefill worker dying mid-job redelivers
via the claim lease (`runtime/queue.py`).

Result delivery: the consumer writes `{first_token, kv_transfer_params}`
to the store under the job's result key; the decode side watches for it.
KV pages then move exactly as in the push path (device-side or chunked
wire pull against the owning worker's kv_pull endpoint).
"""

from __future__ import annotations

import asyncio
import json
import logging
import secrets
from typing import Optional

from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.queue import WorkQueue
from dynamo_tpu_torch.runtime.store import PUT

logger = logging.getLogger(__name__)

PREFILL_QUEUE = "prefill"

# the requester stopped waiting (timeout, cooperative cancel, a closed
# watch): its job is retracted and tombstoned
_ABANDONED = object()


def _result_key(namespace: str, queue: str, job_id: str) -> str:
    return f"v1/queue/{namespace}/{queue}/results/{job_id}"


class PrefillQueueConsumer:
    """Runs on a prefill worker: pull job → prefill → publish result."""

    def __init__(self, runtime, handler, namespace: str = "dynamo",
                 queue: str = PREFILL_QUEUE,
                 result_ttl: float = 60.0, max_attempts: int = 3) -> None:
        self.runtime = runtime
        self.handler = handler          # PrefillWorkerHandler
        self.namespace = namespace
        self.queue_name = queue
        self.result_ttl = result_ttl
        self.max_attempts = max_attempts
        self._queue = WorkQueue(runtime, queue, namespace)
        self._task: Optional[asyncio.Task] = None
        self._stopped = False
        self.jobs_done = 0
        self.jobs_failed = 0

    def register(self, registry) -> None:
        """Export the jobs this consumer finished and dead-lettered on a
        metrics registry (`dynamo_prefill_queue_jobs{outcome=...}` on the
        worker's scrape)."""
        g = registry.gauge("prefill_queue_jobs",
                           "prefill-queue jobs this worker took, by outcome")

        def sync() -> None:
            g.set(self.jobs_done, outcome="done")
            g.set(self.jobs_failed, outcome="failed")

        registry.on_scrape(sync)

    def start(self) -> "PrefillQueueConsumer":
        self._task = asyncio.get_running_loop().create_task(self._loop())
        return self

    async def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _loop(self) -> None:
        while not self._stopped:
            try:
                item = await self._queue.dequeue(timeout=3600.0, poll=0.02)
            except asyncio.CancelledError:
                raise
            except Exception:
                # transient store error must not kill the consumer — a
                # dead consumer with a live kv_pull endpoint makes every
                # decode request eat the full queue timeout
                logger.exception("prefill queue dequeue failed; retrying")
                await asyncio.sleep(0.5)
                continue
            if item is None:
                continue
            try:
                await self._run_job(item.payload)
                await item.ack()
                self.jobs_done += 1
            except asyncio.CancelledError:
                await item.nack()  # shutting down: give the job back
                raise
            except Exception:
                # a failing job must not hot-loop at the queue head
                # (nack would make it the oldest claimable item again):
                # ack it and re-enqueue at the TAIL with a retry budget.
                # This cleanup path must itself survive store hiccups —
                # an escaping exception here would kill the consumer.
                try:
                    job = dict(item.payload)
                    attempts = int(job.get("attempts", 0)) + 1
                    logger.exception("prefill job %s failed (attempt %d)",
                                     item.item_id, attempts)
                    await item.ack()
                    if attempts < self.max_attempts:
                        job["attempts"] = attempts
                        await self._queue.enqueue(job)
                    else:
                        self.jobs_failed += 1
                        await self._publish_result(
                            job["job_id"],
                            {"first_token": None,
                             "kv_transfer_params": None,
                             "error": "prefill failed after retries"})
                except asyncio.CancelledError:
                    raise
                except Exception:
                    logger.exception("prefill job cleanup failed")
                    await asyncio.sleep(0.5)

    async def _run_job(self, job: dict) -> None:
        # requester gave up (timeout/cancel tombstone)? don't burn
        # prefill compute + pin transfer pages for a departed client —
        # this also covers RETRIED copies the original retraction missed
        key = _result_key(self.namespace, self.queue_name, job["job_id"])
        existing = await self.runtime.store.get(key)
        if existing is not None and \
                json.loads(existing.value).get("cancelled"):
            logger.info("prefill job %s cancelled by requester; skipping",
                        job["job_id"])
            return
        request = job["request"]
        first_token = None
        first_lp = None
        first_top = None
        ktp = None
        async for out in self.handler.generate(request, Context()):
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
        if ktp is not None and first_lp is not None:
            # ride the transfer params so the decode side can surface N
            # logprobs for N tokens (the first came from remote prefill)
            ktp = {**ktp, "first_token_logprob": first_lp}
        if ktp is not None and first_top is not None:
            ktp = {**ktp, "first_token_top_logprobs": first_top}
        await self._publish_result(
            job["job_id"],
            {"first_token": first_token, "kv_transfer_params": ktp})

    async def _publish_result(self, job_id: str, result: dict) -> None:
        # result under a short-lived lease: an unread result (decode
        # worker died) must not accumulate forever
        lease = await self.runtime.store.create_lease(self.result_ttl)
        await self.runtime.store.put(
            _result_key(self.namespace, self.queue_name, job_id),
            json.dumps(result).encode(), lease_id=lease)


class QueuePrefillClient:
    """Runs on the decode worker: enqueue job, await its result key."""

    def __init__(self, runtime, namespace: str = "dynamo",
                 queue: str = PREFILL_QUEUE,
                 timeout: float = 30.0) -> None:
        self.runtime = runtime
        self.namespace = namespace
        self.queue_name = queue
        self.timeout = timeout
        self._queue = WorkQueue(runtime, queue, namespace)

    async def prefill(self, prefill_req: dict, context=None
                      ) -> Optional[tuple[int, dict]]:
        """(first_token, kv_transfer_params), or None on timeout / error /
        cancel — callers fall back to fully-local serving. A timed-out or
        cancelled job is DELETED from the queue so no worker burns prefill
        compute (and pins transfer pages) for a departed client."""
        job_id = secrets.token_hex(8)
        item_id = await self._queue.enqueue({"job_id": job_id,
                                             "request": prefill_req})
        key = _result_key(self.namespace, self.queue_name, job_id)
        # event-driven wait (no store-read busy loop): the watch fires on
        # the result PUT; short wait slices let us notice cancellation
        watch = await self.runtime.store.watch_prefix(key, replay=True)
        try:
            result = await self._await_result(job_id, key, watch, context)
        except asyncio.CancelledError:
            # hard cancel (client task torn down): still retract the job
            # — shielded, or the cleanup awaits would be cancelled too
            try:
                await asyncio.shield(self._retract(item_id, key))
            except Exception:
                pass
            raise
        finally:
            watch.cancel()
        if result is not _ABANDONED:
            return result
        # timeout / cooperative cancel: retract + tombstone
        await self._retract(item_id, key)
        return None

    async def _await_result(self, job_id: str, key: str, watch, context):
        """The job's result off its watch, or `_ABANDONED` on timeout or
        cooperative cancel."""
        deadline = asyncio.get_running_loop().time() + self.timeout
        while True:
            if context is not None and context.is_cancelled():
                return _ABANDONED
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                logger.warning("prefill queue result %s timed out", job_id)
                return _ABANDONED
            try:
                ev = await asyncio.wait_for(
                    watch.__anext__(), min(remaining, 0.25))
            except asyncio.TimeoutError:
                continue
            except StopAsyncIteration:
                return _ABANDONED
            if ev.kind != PUT or not ev.value:
                continue  # delete/expiry event
            await self.runtime.store.delete(key)
            result = json.loads(ev.value)
            if result.get("kv_transfer_params") is None \
                    or result.get("first_token") is None:
                return None
            return int(result["first_token"]), result["kv_transfer_params"]

    async def _retract(self, item_id: str, result_key: str) -> None:
        """Withdraw an abandoned job AND tombstone its result key so a
        consumer holding (or retrying) it skips instead of prefilling
        for a departed client."""
        await self._queue.retract(item_id)
        lease = await self.runtime.store.create_lease(60.0)
        await self.runtime.store.put(
            result_key, json.dumps({"cancelled": True}).encode(),
            lease_id=lease)
