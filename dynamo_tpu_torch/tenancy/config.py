"""Tenant identity plane (docs/multitenancy.md).

One fleet, many tenants: a `Tenant` names a traffic class and carries
its scheduling weight and quota limits. Identity is resolved at the
HTTP frontend from the `x-dyn-tenant` header or a bearer API key, then
rides `Context.headers` across every transport hop — the engines, the
recorders, and the trace spans all attribute by the same name, so
fairness can be *proved* from the flight recorders, not asserted.

Off-by-default contract: `tenancy_from_env()` returns None unless
`DYN_TENANCY` is set (a JSON file path or inline JSON), and every
integration point guards on that None — an untenanted fleet runs the
legacy single-FIFO admission path byte-identical (pinned by
tests/test_tenancy.py).

Port of `dynamo_tpu/tenancy/config.py`: the same decisions, records and
payloads, on the port's own modules (no jax, no `dynamo_tpu` import).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Mapping, Optional

# the identity header: set by clients (or injected by the frontend after
# bearer-key resolution) and propagated verbatim by the transport layer
TENANT_HEADER = "x-dyn-tenant"

# traffic that presents no identity when a config has no default_tenant
ANON_TENANT = "anonymous"


@dataclass(frozen=True)
class Tenant:
    """One traffic class. Zero values mean "unlimited" for every limit
    so a tenant can be named purely for fair-share weighting."""

    name: str
    weight: float = 1.0              # fair-share weight (relative)
    max_concurrent_streams: int = 0  # 0 = unlimited
    token_rate: float = 0.0          # tokens/second budget; 0 = unlimited
    token_burst: float = 0.0         # bucket capacity; 0 = max(rate, 1)
    kv_block_budget: int = 0         # max KV pages/blocks held; 0 = unlimited
    api_keys: tuple = ()             # bearer keys that map to this tenant
    # serving class applied to this tenant's requests when no
    # x-dyn-class header is present; "" = the classes config default
    default_class: str = ""

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")
        if self.token_rate < 0 or self.token_burst < 0:
            raise ValueError(f"tenant {self.name!r}: negative token rate")

    @property
    def burst(self) -> float:
        """Effective bucket capacity (token_burst with its 0-default)."""
        return self.token_burst or max(self.token_rate, 1.0)


@dataclass
class TenancyConfig:
    """The resolved tenant table plus identity-resolution rules."""

    tenants: dict[str, Tenant] = field(default_factory=dict)
    # name applied to traffic that presents no identity; "" keeps the
    # built-in unlimited ANON_TENANT so arming tenancy never 401s
    # untagged traffic
    default_tenant: str = ""

    def __post_init__(self) -> None:
        if self.default_tenant and self.default_tenant not in self.tenants:
            raise ValueError(
                f"default_tenant {self.default_tenant!r} not in tenants")
        self._by_key = {}
        for t in self.tenants.values():
            for k in t.api_keys:
                if k in self._by_key:
                    raise ValueError(
                        f"api key maps to both "
                        f"{self._by_key[k].name!r} and {t.name!r}")
                self._by_key[k] = t

    def get(self, name: Optional[str]) -> Tenant:
        """Tenant record for a name; unknown names get a default-weight
        unlimited record (so an engine never KeyErrors on a header some
        client made up — it just gets no special treatment)."""
        if name and name in self.tenants:
            return self.tenants[name]
        return Tenant(name or ANON_TENANT)

    def resolve(self, header: Optional[str],
                authorization: Optional[str] = None) -> Tenant:
        """Identity resolution at the frontend: explicit header first,
        then bearer API key, then the default tenant."""
        if header:
            return self.get(header.strip())
        if authorization:
            parts = authorization.split(None, 1)
            key = parts[1].strip() if (len(parts) == 2
                                       and parts[0].lower() == "bearer") \
                else authorization.strip()
            t = self._by_key.get(key)
            if t is not None:
                return t
        if self.default_tenant:
            return self.tenants[self.default_tenant]
        return Tenant(ANON_TENANT)

    def tenant_of(self, headers: Optional[Mapping]) -> str:
        """Engine-side identity: the propagated header value, or the
        config's default for untagged traffic."""
        name = (headers or {}).get(TENANT_HEADER)
        if name:
            return str(name)
        return self.default_tenant or ANON_TENANT

    def payload(self) -> dict:
        """Config view for /debug/tenants (api keys elided)."""
        return {name: {
            "weight": t.weight,
            "max_concurrent_streams": t.max_concurrent_streams,
            "token_rate": t.token_rate,
            "token_burst": t.burst if t.token_rate else 0.0,
            "kv_block_budget": t.kv_block_budget,
            "api_keys": len(t.api_keys),
            "default_class": t.default_class,
        } for name, t in sorted(self.tenants.items())}


def parse_tenancy(obj: dict) -> TenancyConfig:
    """Parse the DYN_TENANCY document:

    {"tenants": [{"name": "heavy", "weight": 3, "token_rate": 500,
                  "max_concurrent_streams": 8, "kv_block_budget": 64,
                  "api_keys": ["sk-heavy-1"]}, ...],
     "default_tenant": "heavy"}
    """
    if not isinstance(obj, dict):
        raise ValueError("tenancy config must be a JSON object")
    raw = obj.get("tenants")
    if not isinstance(raw, list) or not raw:
        raise ValueError("tenancy config needs a non-empty 'tenants' list")
    tenants: dict[str, Tenant] = {}
    for entry in raw:
        if not isinstance(entry, dict) or "name" not in entry:
            raise ValueError(f"bad tenant entry {entry!r}")
        t = Tenant(
            name=str(entry["name"]),
            weight=float(entry.get("weight", 1.0)),
            max_concurrent_streams=int(
                entry.get("max_concurrent_streams", 0)),
            token_rate=float(entry.get("token_rate", 0.0)),
            token_burst=float(entry.get("token_burst", 0.0)),
            kv_block_budget=int(entry.get("kv_block_budget", 0)),
            api_keys=tuple(entry.get("api_keys", ())),
            default_class=str(entry.get("default_class", "")),
        )
        if t.name in tenants:
            raise ValueError(f"duplicate tenant {t.name!r}")
        tenants[t.name] = t
    return TenancyConfig(tenants=tenants,
                         default_tenant=str(obj.get("default_tenant", "")))


def tenancy_from_env(env: Optional[Mapping] = None
                     ) -> Optional[TenancyConfig]:
    """None unless DYN_TENANCY is set — the off-by-default gate every
    integration point checks once. The value is inline JSON (starts
    with '{') or a path to a JSON file."""
    val = (env or os.environ).get("DYN_TENANCY", "").strip()
    if not val:
        return None
    if val.startswith("{"):
        doc = json.loads(val)
    else:
        with open(val, encoding="utf-8") as f:
            doc = json.load(f)
    return parse_tenancy(doc)
