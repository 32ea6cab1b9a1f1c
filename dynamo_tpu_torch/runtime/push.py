"""PushRouter: select an instance of an endpoint and stream the request to it.

Port of `dynamo_tpu/runtime/push.py` (the port keeps its own copy).

Reference: `lib/runtime/src/pipeline/network/egress/push_router.rs` — modes
RoundRobin/Random/Direct/KV (`push_router.rs:76-86,137-196`) with
busy-threshold gating via a load monitor (`push_router.rs:31-38`). The
port serves round-robin, random and direct; the KV mode needs the radix
index of the KV-router slice (ROADMAP queue 1), and `llm/model_manager.py`
refuses it until then.

In-process fast path: if the chosen instance is served by this process, the
handler is invoked directly — no socket, no serialisation (the reference
gets the same effect from pipeline segments living in one process).

Failure handling: candidates are filtered through the runtime's per-instance
`CircuitBreaker` (breaker.py), and a dial failure (`ConnectError` — no bytes
reached the instance) retries the next candidate instead of surfacing. A
MID-stream death is deliberately not retried here: tokens already reached
the caller, so replay-with-accumulated-tokens is the Migration operator's
job. Both kinds feed the breaker so repeat offenders leave the rotation.
"""

from __future__ import annotations

import random
from typing import Any, AsyncIterator, Callable, Optional

from dynamo_tpu_torch.runtime.breaker import CircuitBreaker
from dynamo_tpu_torch.runtime.component import EndpointClient, Instance
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.transport import STREAM_ERR_MSG, ConnectError

ROUND_ROBIN = "round_robin"
RANDOM = "random"
DIRECT = "direct"


class NoInstancesError(ConnectionError):
    pass


class PushRouter:
    """AsyncEngine over a set of instances of one endpoint."""

    def __init__(self, client: EndpointClient, mode: str = ROUND_ROBIN,
                 busy_filter: Optional[Callable[[Instance], bool]] = None,
                 breaker: Optional[CircuitBreaker] = None) -> None:
        self.client = client
        self.mode = mode
        self._rr = 0
        # busy_filter returns True if the instance should be skipped
        # (reference WorkerLoadMonitor busy-threshold gating).
        self.busy_filter = busy_filter
        self._breaker = breaker

    @property
    def _runtime(self):
        return self.client.endpoint.runtime

    @property
    def breaker(self) -> Optional[CircuitBreaker]:
        if self._breaker is not None:
            return self._breaker
        # default: the runtime-wide breaker, shared across every router in
        # the process so one instance's failures are visible to all
        return getattr(self._runtime, "breaker", None)

    def _candidates(self) -> list[Instance]:
        instances = self.client.instances()
        if self.busy_filter is not None:
            free = [i for i in instances if not self.busy_filter(i)]
            if free:
                instances = free
        breaker = self.breaker
        if breaker is not None:
            ok = [i for i in instances if breaker.allow(i.subject)]
            if ok:
                # every-instance-open falls through: trying a broken
                # instance beats failing a request with zero attempts
                instances = ok
        return instances

    def select(self, instance_id: Optional[int] = None,
               candidates: Optional[list[Instance]] = None) -> Instance:
        if instance_id is not None:
            for inst in self.client.instances():
                if inst.instance_id == instance_id:
                    return inst
            raise NoInstancesError(f"instance {instance_id:x} not found")
        # callers that already breaker-filtered pass the list in;
        # recomputing would consult the side-effectful allow() a second
        # time and double-consume half-open probes
        instances = self._candidates() if candidates is None else candidates
        if not instances:
            raise NoInstancesError(
                f"no instances for {self.client.endpoint.instance_prefix}")
        if self.mode == RANDOM:
            return random.choice(instances)
        # post-increment, raw cursor: the first request hits instance 0,
        # and membership churn only shifts the modulus, not the cursor
        idx = self._rr % len(instances)
        self._rr += 1
        return instances[idx]

    async def generate(self, request: Any, context: Optional[Context] = None
                       ) -> AsyncIterator[Any]:
        async for item in self.direct(request, None, context):
            yield item

    async def direct(self, request: Any, instance_id: Optional[int],
                     context: Optional[Context] = None) -> AsyncIterator[Any]:
        ctx = context or Context()
        rt = self._runtime
        breaker = self.breaker
        # One routing decision consults the breaker exactly ONCE:
        # `allow()` is side-effectful (an open entry past cooldown flips
        # half-open and admits its single probe), so the candidate list
        # is computed here and reused for both the attempt budget and
        # selection. Counting and selecting with separate _candidates()
        # passes would consume the probe in the count, then filter the
        # instance out in the select — locking an opened instance out of
        # rotation for as long as any healthy peer exists.
        candidates = self._candidates() if instance_id is None else None
        # one attempt per current candidate: enough to walk the whole set
        # once when instances keep refusing, without retrying forever
        attempts = max(1, len(candidates)) if candidates is not None else 1
        last_err: Optional[ConnectionError] = None
        for attempt in range(attempts):
            if attempt and candidates is not None:
                # re-filter only after a failure fed the breaker
                candidates = self._candidates()
            inst = self.select(instance_id, candidates)
            local = rt.local_engine(inst.subject)
            yielded = False
            try:
                if local is not None:
                    async for item in local.generate(request, ctx):
                        ctx.raise_if_cancelled()
                        yielded = True
                        yield item
                else:
                    async for item in rt.transport_client.request(
                            inst.address, inst.subject, request, ctx):
                        yielded = True
                        yield item
                if breaker is not None:
                    breaker.record_success(inst.subject)
                return
            except ConnectionError as e:
                # only infra failures feed the breaker: dial failures and
                # dead/stalled streams. Application errors relayed as err
                # frames must not open it (the instance is alive).
                infra = (isinstance(e, ConnectError)
                         or str(e) == STREAM_ERR_MSG)
                if breaker is not None and infra:
                    breaker.record_failure(inst.subject)
                if yielded or ctx.is_cancelled() \
                        or not isinstance(e, ConnectError):
                    raise
                # dial failure, nothing sent: safe to try another instance
                last_err = e
                stats = getattr(rt.transport_client, "stats", None)
                if stats is not None:
                    stats["route_retries"] += 1
        assert last_err is not None
        raise last_err