"""Port of `dynamo_tpu/runtime/metrics.py`: `Counter`, `Gauge`,
`Histogram`, `hist_quantile` and `MetricsRegistry`, copied as they are
(the engine's compile tracker, the runtime's robustness gauges and the
HTTP frontend's TTFT/ITL histograms render through them).

Reference: `lib/runtime/src/metrics.rs` — MetricsRegistry trait with
hierarchical prefixes (drt → namespace → component → endpoint), prometheus
registries and pre-scrape callbacks (`lib.rs:97-179`). No external client
library: counters/gauges/histograms are tiny classes rendered to the
Prometheus text format by `render()`.
"""

from __future__ import annotations

import bisect
import logging
import threading
from typing import Callable, Optional, Sequence

logger = logging.getLogger(__name__)


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def get(self, **labels: str) -> float:
        return self._values.get(tuple(sorted(labels.items())), 0.0)

    def items(self) -> list[tuple[dict[str, str], float]]:
        """[(labels, value)] under the lock — snapshot-consistent."""
        with self._lock:
            return [(dict(k), v) for k, v in self._values.items()]

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            out.append(f"{self.name}{_fmt_labels(dict(key))} {v}")
        if len(out) == 2:
            out.append(f"{self.name} 0")
        return out


class Gauge:
    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[tuple(sorted(labels.items()))] = value

    def add(self, amount: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def get(self, **labels: str) -> float:
        return self._values.get(tuple(sorted(labels.items())), 0.0)

    def items(self) -> list[tuple[dict[str, str], float]]:
        """[(labels, value)] under the lock — snapshot-consistent."""
        with self._lock:
            return [(dict(k), v) for k, v in self._values.items()]

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            out.append(f"{self.name}{_fmt_labels(dict(key))} {v}")
        if len(out) == 2:
            out.append(f"{self.name} 0")
        return out


DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def hist_quantile(edges: Sequence[float], counts: Sequence[int],
                  q: float) -> float:
    """Approximate quantile (bucket upper bound) from a histogram's
    (edges, counts-incl-+Inf) pair — shared by live Histograms and
    merged telemetry snapshots so fleet math matches per-process math."""
    total = sum(counts)
    if total == 0:
        return 0.0
    target = q * total
    acc = 0
    for i, ub in enumerate(edges):
        acc += counts[i]
        if acc >= target:
            return ub
    return float("inf")


class Histogram:
    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        self.name = name
        self.help = help
        self.buckets = sorted(buckets)
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._total = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._total += 1

    @property
    def count(self) -> int:
        return self._total

    @property
    def sum(self) -> float:
        return self._sum

    def mean(self) -> float:
        with self._lock:
            return self._sum / self._total if self._total else 0.0

    def snapshot(self) -> tuple[list[int], float, int]:
        """(bucket counts incl. +Inf, sum, total) — one consistent view.
        Observers run on kvbm-io threads; readers must not see a count
        bumped without its sum."""
        with self._lock:
            return list(self._counts), self._sum, self._total

    def quantile(self, q: float) -> float:
        """Approximate quantile from bucket upper bounds."""
        counts, _, _total = self.snapshot()
        return hist_quantile(self.buckets, counts, q)

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        counts, total_sum, total = self.snapshot()
        acc = 0
        for i, ub in enumerate(self.buckets):
            acc += counts[i]
            out.append(f'{self.name}_bucket{{le="{ub}"}} {acc}')
        acc += counts[-1]
        out.append(f'{self.name}_bucket{{le="+Inf"}} {acc}')
        out.append(f"{self.name}_sum {total_sum}")
        out.append(f"{self.name}_count {total}")
        return out


class MetricsRegistry:
    """A node in the registry hierarchy; children share the flat metric map
    but get dotted name prefixes (reference hierarchical prefixes)."""

    def __init__(self, prefix: str = "dynamo",
                 parent: Optional["MetricsRegistry"] = None) -> None:
        self.prefix = prefix
        self._parent = parent
        root = self
        while root._parent is not None:
            root = root._parent
        self._root = root
        if parent is None:
            self._metrics: dict[str, object] = {}
            self._callbacks: list[Callable[[], None]] = []
            self._callback_logged: set[int] = set()

    def child(self, name: str) -> "MetricsRegistry":
        return MetricsRegistry(f"{self.prefix}_{name}", parent=self)

    def _full(self, name: str) -> str:
        return f"{self.prefix}_{name}"

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_make(name, lambda n: Counter(n, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_make(name, lambda n: Gauge(n, help))

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(name, lambda n: Histogram(n, help, buckets))

    def _get_or_make(self, name: str, factory):
        full = self._full(name)
        metrics = self._root._metrics
        if full not in metrics:
            metrics[full] = factory(full)
        return metrics[full]

    def register(self, metric) -> None:
        """Adopt an externally-constructed metric (already fully named) into
        the scrape set — for metrics owned by a component (e.g. the engine)
        that must exist before any registry is wired up."""
        self._root._metrics.setdefault(metric.name, metric)

    def on_scrape(self, fn: Callable[[], None]) -> None:
        """Register a pre-scrape update callback (reference `lib.rs:137-160`)."""
        self._root._callbacks.append(fn)

    def collect(self) -> dict[str, object]:
        """Run pre-scrape callbacks, then hand back the live metric map
        (full name → Counter/Gauge/Histogram). Snapshot consumers (the
        telemetry publisher) use this instead of re-parsing render()."""
        for fn in self._root._callbacks:
            try:
                fn()
            except Exception:
                if id(fn) not in self._root._callback_logged:
                    self._root._callback_logged.add(id(fn))
                    logger.exception(
                        "metrics scrape callback %s failed (logged once)",
                        getattr(fn, "__qualname__", None)
                        or getattr(fn, "__name__", repr(fn)))
        return self._root._metrics

    def render(self) -> str:
        lines: list[str] = []
        for m in self.collect().values():
            lines.extend(m.render())  # type: ignore[attr-defined]
        return "\n".join(lines) + "\n"
