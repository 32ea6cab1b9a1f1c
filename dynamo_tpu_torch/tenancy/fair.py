"""Deficit-weighted fair-share admission (docs/multitenancy.md).

The engines keep their single `_waiting` list (preemption re-inserts at
the head, cancellation scans it, close() fails it — one structure, many
call sites), and fairness is a *selection policy* over it: each
admission round asks the scheduler for candidate indexes — at most one
per tenant (its FIFO head, so per-tenant order is preserved) — ordered
by normalized service, least-served-per-weight first. The engine tries
them in order and admits the first whose pages fit, which also kills
head-of-line blocking: a page-starved giant at one tenant's head no
longer parks every other tenant's admissible work.

Accounting is virtual-time weighted fair queuing: admitting a request
charges its tenant `cost / weight` of service (cost = prompt tokens +
requested completion budget, the same predicted work the quota bucket
charges). A tenant that rejoins after idling is caught up to the
least-served backlogged tenant, so accumulated idle credit can't be
burned as a starvation-inducing burst. Ties break by tenant name —
every admission order is hand-traceable (tests/test_tenancy.py traces
the 3:1 schedule by hand).

Unarmed engines never construct a FairScheduler: the legacy FIFO path
is byte-identical (pinned by test).

Port of `dynamo_tpu/tenancy/fair.py`: the same decisions, records and
payloads, on the port's own modules (no jax, no `dynamo_tpu` import).
"""

from __future__ import annotations

from typing import Optional, Sequence

from dynamo_tpu_torch.tenancy.config import ANON_TENANT, TenancyConfig


class FairScheduler:
    def __init__(self, cfg: TenancyConfig) -> None:
        self.cfg = cfg
        # tenant -> cumulative service / weight (virtual time)
        self.service: dict[str, float] = {}
        self._backlogged: set[str] = set()
        # optional ServingClassesConfig: when set, admissions carrying a
        # class name divide their cost by the class weight too, so an
        # interactive request at weight 4 charges a quarter of the
        # virtual time a batch request of the same size does. None (the
        # default) keeps the legacy accounting byte-identical.
        self.classes = None

    def weight_of(self, tenant: Optional[str]) -> float:
        return self.cfg.get(tenant).weight

    def candidate_indexes(self, tenants: Sequence[Optional[str]]
                          ) -> list[int]:
        """Indexes into the waiting list to try this round: one per
        backlogged tenant (its head), least normalized service first."""
        heads: dict[str, int] = {}
        for i, t in enumerate(tenants):
            name = t or ANON_TENANT
            if name not in heads:
                heads[name] = i
        present = set(heads)
        # virtual-time catch-up: tenants that just became backlogged
        # can't spend service credit accumulated while idle
        carried = [self.service[t] for t in (present & self._backlogged)
                   if t in self.service]
        if carried:
            floor = min(carried)
            for t in present - self._backlogged:
                if self.service.get(t, 0.0) < floor:
                    self.service[t] = floor
        self._backlogged = present
        order = sorted(heads, key=lambda t: (self.service.get(t, 0.0), t))
        return [heads[t] for t in order]

    def on_admit(self, tenant: Optional[str], cost: float,
                 cls: Optional[str] = None) -> None:
        name = tenant or ANON_TENANT
        weight = self.weight_of(name)
        if cls is not None and self.classes is not None:
            weight *= self.classes.get(cls).weight
        self.service[name] = (self.service.get(name, 0.0)
                              + max(cost, 1.0) / weight)

    def payload(self) -> dict:
        """Normalized-service view for /debug/tenants: the deficit of a
        tenant is how far below the max-served tenant it sits."""
        if not self.service:
            return {}
        top = max(self.service.values())
        return {t: {"service": round(v, 3),
                    "weighted_deficit": round(top - v, 3),
                    "weight": self.weight_of(t)}
                for t, v in sorted(self.service.items())}


def tenant_state(engine) -> dict:
    """Per-tenant live scheduler view of one engine for /debug/tenants:
    queue depths, KV blocks held, fair-share service. Works for both
    TorchEngine (`_Seq.pages`) and MockEngine (`_MockRequest.seq`).
    Empty dict when the engine has no tenancy armed."""
    fair = getattr(engine, "fair", None)
    if fair is None:
        return {}

    def blocks_of(s) -> int:
        pages = getattr(s, "pages", None)
        if pages is not None:
            return len(pages)
        seq = getattr(s, "seq", None)
        return len(seq.seq_hashes()) if seq is not None else 0

    tenants: dict[str, dict] = {}

    def slot(name: Optional[str]) -> dict:
        return tenants.setdefault(name or ANON_TENANT, {
            "waiting": 0, "running": 0, "kv_blocks": 0})

    for s in getattr(engine, "_waiting", []):
        slot(getattr(s, "tenant", None))["waiting"] += 1
    for s in getattr(engine, "_running", []):
        d = slot(getattr(s, "tenant", None))
        d["running"] += 1
        d["kv_blocks"] += blocks_of(s)
    fairness = fair.payload()
    for name, f in fairness.items():
        slot(name).update(f)
    tm = getattr(engine, "tenant_metrics", None)
    if tm is not None:
        for name in tenants:
            tenants[name]["goodput_tokens"] = tm.goodput.get(tenant=name)
            w_sum, w_n = tm.queue_wait.stats(name)
            tenants[name]["queue_wait_mean_s"] = round(
                w_sum / w_n, 6) if w_n else 0.0
    wid = getattr(getattr(engine, "config", None), "worker_id", None)
    return {"worker_id": wid, "tenants": tenants}
