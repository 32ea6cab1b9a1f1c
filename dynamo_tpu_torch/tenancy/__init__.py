"""Multi-tenant serving plane (docs/multitenancy.md): tenant identity
and quotas at the frontend, deficit-weighted fair-share admission in
the engines, per-tenant KV budgets, and always-on `dynamo_tenant_*`
fairness surfaces. Armed by DYN_TENANCY; unarmed fleets run the legacy
paths byte-identical.

Port of `dynamo_tpu/tenancy/__init__.py`: the same decisions, records
and payloads, on the port's own modules (no jax, no `dynamo_tpu`
import)."""

from dynamo_tpu_torch.tenancy.config import (  # noqa: F401
    ANON_TENANT,
    TENANT_HEADER,
    TenancyConfig,
    Tenant,
    parse_tenancy,
    tenancy_from_env,
)
from dynamo_tpu_torch.tenancy.fair import (  # noqa: F401
    FairScheduler,
    tenant_state,
)
from dynamo_tpu_torch.tenancy.metrics import (  # noqa: F401
    TenantHistogram,
    TenantMetrics,
)
from dynamo_tpu_torch.tenancy.quota import (  # noqa: F401
    QuotaGate,
    TokenBucket,
    estimate_request_tokens,
    retry_after_header,
)
