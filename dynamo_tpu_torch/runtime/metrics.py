"""The part of `dynamo_tpu/runtime/metrics.py` that the engine's compile
tracker needs: `_fmt_labels`, `Counter` and `MetricsRegistry`, copied as
they are. The registry's `gauge` and `histogram` factories are left out
with the `Gauge` and `Histogram` classes they build; a later slice that
needs them copies them whole.

Reference: `lib/runtime/src/metrics.rs` — MetricsRegistry trait with
hierarchical prefixes (drt → namespace → component → endpoint), prometheus
registries and pre-scrape callbacks (`lib.rs:97-179`). No external client
library: counters are tiny classes rendered to the Prometheus text format
by `render()`.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

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
