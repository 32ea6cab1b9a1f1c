"""Deadline-aware admission: reject provably-late work before prefill.

The formula (docs/robustness.md "Serving classes & brownout"):

    est_ttft = max over live engines of
        Q(queue_wait, q) + Q(ttft, q) - Q(queue_wait_contained_in_ttft)

collapses to the observable version we can actually compute from the
always-on `EngineMetrics` histograms: the engine's ``ttft`` histogram
measures enqueue → first token, which already CONTAINS the queue wait,
so the time a brand-new request should expect to its first token is

    est_ttft = min over engines of Q(dynamo_engine_ttft_seconds, q)

(the router sends work to the least-loaded engine, hence min), floored
by the current queue wait quantile when the ttft window is empty. A
request whose remaining budget — its `Context` deadline, the
``x-dyn-deadline-s`` header, or the class's implicit `deadline_s` —
is below that estimate provably cannot be met at quantile q, and is
rejected 503 + Retry-After (or downgraded) at the frontend, BEFORE it
burns prefill compute that a feasible request could have used.

Everything here is pure given the injected engines supplier, so the
hand-traced admission tests feed synthetic histograms and assert the
exact decision boundary.

Port of `dynamo_tpu/serving_classes/admission.py`: the same decisions,
records and payloads, on the port's own modules (no jax, no `dynamo_tpu`
import).
"""

from __future__ import annotations

import math
from typing import Callable, Optional


def _quantile(hist, q: float) -> float:
    """Histogram quantile, 0.0 when empty/absent (optimistic — an idle
    fleet admits everything)."""
    if hist is None or not getattr(hist, "count", 0):
        return 0.0
    return float(hist.quantile(q))


def estimate_ttft_s(engines: list, quantile: float = 0.9) -> float:
    """Expected enqueue→first-token seconds for a newly admitted
    request: min across engines of the ttft quantile (router picks the
    best engine), falling back to the queue-wait quantile when no ttft
    samples exist yet. 0.0 with no evidence — never reject on silence."""
    best: Optional[float] = None
    for eng in engines:
        m = getattr(eng, "metrics", None)
        if m is None:
            continue
        est = _quantile(getattr(m, "ttft", None), quantile)
        if est <= 0.0:
            est = _quantile(getattr(m, "queue_wait", None), quantile)
        if est > 0.0 and (best is None or est < best):
            best = est
    return best or 0.0


class AdmissionEstimator:
    """Frontend-side deadline feasibility check over live engines.

    ``engines`` is a zero-arg supplier (the same late-bound list
    /debug/profile uses) so workers that start after the frontend are
    seen. One estimator per HttpService."""

    def __init__(self, engines: Callable[[], list],
                 quantile: float = 0.9) -> None:
        self._engines = engines
        self.quantile = quantile

    def estimate_s(self) -> float:
        try:
            engines = list(self._engines() or [])
        except Exception:
            return 0.0
        return estimate_ttft_s(engines, self.quantile)

    def check(self, budget_s: float) -> tuple[bool, float, float]:
        """(feasible, est_ttft_s, retry_after_s) for a request with
        ``budget_s`` seconds of remaining deadline. budget_s <= 0 means
        no deadline — always feasible."""
        if budget_s <= 0:
            return True, 0.0, 0.0
        est = self.estimate_s()
        if est <= budget_s:
            return True, est, 0.0
        # retry once the backlog implied by the estimate should have
        # drained past the budget; never advertise 0
        return False, est, max(math.ceil(est - budget_s), 1.0)
