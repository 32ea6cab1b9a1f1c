"""Stream perf capture: timestamped response recording + latency stats.

Port of `dynamo_tpu/llm/perf.py` (the port keeps its own copy); the
engine's ITL histogram (`engine/metrics.py`) reads its edges from here.
The CLI is `python -m dynamo_tpu_torch.llm.perf capture.jsonl`.

Reference: `lib/llm/src/perf.rs:4-8` — wrap a response stream, record an
arrival timestamp per item without perturbing it, then analyze (TTFT,
ITL distribution, tokens/sec) after the fact.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, AsyncIterator

# ---------------------------------------------------------------------------
# ITL histogram (shared with engine.perf["itl_hist"])
# ---------------------------------------------------------------------------

# Log-spaced upper edges in ms; the last bucket is open-ended. Fixed at
# import time so engine counters, _publish_metrics snapshots, and offline
# analysis all agree on bucket meaning without shipping edges on the wire.
ITL_BUCKET_EDGES_MS: tuple[float, ...] = (
    1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
    1000.0, 2000.0, 5000.0, float("inf"))


def itl_new_hist() -> list[int]:
    """Fresh zeroed histogram (one count per bucket edge)."""
    return [0] * len(ITL_BUCKET_EDGES_MS)


def itl_observe(hist: list[int], gap_ms: float) -> None:
    """Count one inter-token gap into `hist` (in place)."""
    for i, edge in enumerate(ITL_BUCKET_EDGES_MS):
        if gap_ms <= edge:
            hist[i] += 1
            return


def itl_percentile(hist: list[int], q: float) -> float | None:
    """Approximate q-quantile (0..1) from a bucket histogram: the upper
    edge of the bucket containing the q-th observation (None when empty;
    the open last bucket reports its lower edge). Histogram quantiles
    are what the wire carries — exact sample percentiles stay engine-
    local (TpuEngine keeps a capped raw-sample list for bench)."""
    total = sum(hist)
    if total == 0:
        return None
    rank = q * total
    seen = 0
    for i, n in enumerate(hist):
        seen += n
        if seen >= rank and n:
            edge = ITL_BUCKET_EDGES_MS[i]
            if edge == float("inf"):
                return ITL_BUCKET_EDGES_MS[i - 1]
            return edge
    return ITL_BUCKET_EDGES_MS[-2]


def count_tokens(item: Any) -> int:
    """Tokens carried by one stream item — engine dicts (token_ids) or
    OpenAI chunks (content deltas count 1). The ONE counting rule for
    live capture (StreamPerf.observe) and the offline CLI."""
    if not isinstance(item, dict):
        return 0
    n = len(item.get("token_ids", ()) or ())
    if not n:
        for ch in item.get("choices", ()):
            if ch.get("delta", {}).get("content") or ch.get("text"):
                return 1
    return n


@dataclass
class RecordedItem:
    at: float                       # perf_counter arrival
    n_tokens: int
    data: Any = None                # optionally retained item


@dataclass
class StreamPerf:
    started_at: float = field(default_factory=time.perf_counter)
    items: list[RecordedItem] = field(default_factory=list)
    keep_items: bool = False

    def observe(self, item: Any) -> None:
        self.items.append(RecordedItem(
            at=time.perf_counter(), n_tokens=count_tokens(item),
            data=item if self.keep_items else None))

    # -- analysis ------------------------------------------------------------

    @property
    def token_items(self) -> list[RecordedItem]:
        return [i for i in self.items if i.n_tokens > 0]

    def ttft(self) -> float:
        toks = self.token_items
        return toks[0].at - self.started_at if toks else float("nan")

    def itls(self) -> list[float]:
        toks = self.token_items
        return [b.at - a.at for a, b in zip(toks, toks[1:])]

    def total_tokens(self) -> int:
        return sum(i.n_tokens for i in self.items)

    def duration(self) -> float:
        return (self.items[-1].at - self.started_at) if self.items else 0.0

    def summary(self) -> dict:
        itls = sorted(self.itls())

        def pct(p: float) -> float:
            if not itls:
                return float("nan")
            return itls[min(len(itls) - 1, int(p * len(itls)))]

        dur = self.duration()
        return {
            "ttft_s": self.ttft(),
            "itl_mean_s": sum(itls) / len(itls) if itls else float("nan"),
            "itl_p50_s": pct(0.50), "itl_p99_s": pct(0.99),
            "total_tokens": self.total_tokens(),
            "duration_s": dur,
            "tokens_per_sec": (self.total_tokens() / dur) if dur else 0.0,
        }


async def record_stream(stream: AsyncIterator[Any],
                        perf: StreamPerf) -> AsyncIterator[Any]:
    """Pass-through wrapper: items flow unchanged; timings accumulate."""
    async for item in stream:
        perf.observe(item)
        yield item


# ---------------------------------------------------------------------------
# logprob sensitivity analysis
# ---------------------------------------------------------------------------
# Reference: `lib/llm/src/perf/logprobs.rs:1` — record per-position
# chosen-vs-alternative logprobs from a response stream, then analyze
# how close the model was to emitting something else (greedy detection,
# close-position counting, sampling-temperature forensics). Same
# analysis here over this stack's two native shapes: engine
# EngineOutput dicts (token_ids/log_probs/top_logprobs) and OpenAI chat
# chunks (choices[].logprobs.content[]), plus the runtime Recorder's
# JSONL envelope for offline analysis.


@dataclass
class PositionLogprobs:
    """One sequence position: the chosen token + sorted alternatives."""

    token: Any                       # id (engine) or string (OpenAI)
    logprob: float
    top: list[tuple[Any, float]]     # sorted desc, may include chosen

    @property
    def alternatives(self) -> list[tuple[Any, float]]:
        return [(t, lp) for t, lp in self.top if t != self.token]

    @property
    def margin(self) -> float:
        """chosen logprob minus the best alternative's (negative when
        the model preferred a token it did not emit)."""
        alts = self.alternatives
        return self.logprob - alts[0][1] if alts else float("inf")


def _positions_from_engine_item(item: dict) -> list[PositionLogprobs]:
    toks = item.get("token_ids") or []
    lps = item.get("log_probs") or []
    tops = item.get("top_logprobs") or []
    out = []
    for i, tok in enumerate(toks):
        lp = float(lps[i]) if i < len(lps) else float("nan")
        top = [(t, float(v)) for t, v in (tops[i] if i < len(tops)
                                          else [])]
        out.append(PositionLogprobs(token=tok, logprob=lp, top=top))
    return out


def _positions_from_openai_chunk(item: dict) -> list[PositionLogprobs]:
    out = []
    for ch in item.get("choices") or []:
        content = ((ch.get("logprobs") or {}).get("content")) or []
        for entry in content:
            top = [(t.get("token"), float(t.get("logprob", 0.0)))
                   for t in entry.get("top_logprobs") or []]
            out.append(PositionLogprobs(
                token=entry.get("token"),
                logprob=float(entry.get("logprob", 0.0)), top=top))
    return out


@dataclass
class LogprobAnalysis:
    """Positional logprob record + the reference analyzer's questions."""

    positions: list[PositionLogprobs] = field(default_factory=list)

    def observe(self, item: Any) -> None:
        """Accept an engine output dict or an OpenAI chat chunk."""
        if not isinstance(item, dict):
            return
        if "choices" in item:
            self.positions.extend(_positions_from_openai_chunk(item))
        else:
            self.positions.extend(_positions_from_engine_item(item))

    @classmethod
    def from_items(cls, items) -> "LogprobAnalysis":
        a = cls()
        for it in items:
            a.observe(it)
        return a

    @classmethod
    def from_recorder_jsonl(cls, path) -> "LogprobAnalysis":
        """Analyze a runtime Recorder capture ({'timestamp', 'event'}
        JSONL lines; events are stream items)."""
        from dynamo_tpu_torch.runtime.recorder import Recorder

        return cls.from_items(ev for _, ev in Recorder.iter_events(path))

    # -- analysis (logprobs.rs SensitivityAnalysis analog) ------------------

    def greedy_selection_pct(self) -> float:
        """Fraction of positions whose chosen token IS the top-1
        (~1.0 ⇒ the stream was greedy-decoded; logprobs.rs
        detect_likely_greedy_decoding)."""
        scored = [p for p in self.positions if p.top]
        if not scored:
            return float("nan")
        hits = sum(1 for p in scored
                   if p.top[0][0] == p.token
                   or p.logprob >= p.top[0][1] - 1e-6)
        return hits / len(scored)

    def close_positions(self, threshold: float = 0.1
                        ) -> list[tuple[int, float]]:
        """(index, margin) of positions where an alternative was within
        `threshold` nats of the chosen token — the places a tiny logit
        perturbation (quantization, different chunking, temperature)
        flips the output (logprobs.rs get_close_positions)."""
        return [(i, p.margin) for i, p in enumerate(self.positions)
                if p.alternatives and p.margin <= threshold]

    def close_position_pct(self, threshold: float = 0.1) -> float:
        scored = [p for p in self.positions if p.alternatives]
        if not scored:
            return float("nan")
        return len(self.close_positions(threshold)) / len(scored)

    def perplexity(self) -> float:
        """exp(-mean chosen logprob) over scored positions."""
        import math

        lps = [p.logprob for p in self.positions
               if p.logprob == p.logprob]          # drop NaN
        if not lps:
            return float("nan")
        return math.exp(-sum(lps) / len(lps))

    def topk_overlap(self, other: "LogprobAnalysis") -> float:
        """Mean positional Jaccard overlap of the top-k candidate sets
        across two runs — the determinism/quantization-drift witness
        (two greedy runs of the same weights should be ~1.0)."""
        pairs = [(a, b) for a, b in zip(self.positions, other.positions)
                 if a.top and b.top]
        if not pairs:
            return float("nan")
        total = 0.0
        for a, b in pairs:
            sa = {t for t, _ in a.top}
            sb = {t for t, _ in b.top}
            total += len(sa & sb) / len(sa | sb)
        return total / len(pairs)

    def summary(self) -> dict:
        return {
            "positions": len(self.positions),
            "greedy_selection_pct": self.greedy_selection_pct(),
            "close_position_pct_0p1": self.close_position_pct(0.1),
            "close_position_pct_0p5": self.close_position_pct(0.5),
            "perplexity": self.perplexity(),
        }


def main(argv=None) -> None:
    """``python -m dynamo_tpu_torch.llm.perf capture.jsonl`` — analyze a
    runtime Recorder capture: latency stats when timestamps are present
    and the logprob sensitivity summary when logprobs are (the CLI face
    of StreamPerf + LogprobAnalysis; ref `lib/llm/src/perf/`)."""
    import argparse
    import json as _json

    p = argparse.ArgumentParser(
        prog="python -m dynamo_tpu_torch.llm.perf",
        description="latency + logprob analysis over recorder JSONL")
    p.add_argument("path", help="Recorder capture "
                                "({'timestamp','event'} JSONL)")
    p.add_argument("--close-threshold", type=float, default=0.1,
                   help="margin (nats) below which a position counts "
                        "as close/flippable")
    args = p.parse_args(argv)

    from dynamo_tpu_torch.runtime.recorder import Recorder

    perf = StreamPerf()
    lp = LogprobAnalysis()
    for ts, ev in Recorder.iter_events(args.path):
        if not perf.items:
            perf.started_at = ts
        perf.items.append(RecordedItem(at=ts,
                                       n_tokens=count_tokens(ev)))
        lp.observe(ev)
    latency = perf.summary()
    # the capture starts at its first event — a request's true TTFT is
    # unknowable offline, so don't report a misleading 0.0
    latency.pop("ttft_s", None)
    out = {"latency": latency, "logprobs": lp.summary(),
           "note": "ttft_s omitted: offline captures start at the "
                   "first event"}
    close = lp.close_positions(args.close_threshold)
    out["logprobs"]["close_positions"] = close[:20]

    def no_nan(o):
        if isinstance(o, dict):
            return {k: no_nan(v) for k, v in o.items()}
        if isinstance(o, list):
            return [no_nan(v) for v in o]
        if isinstance(o, float) and o != o:
            return None                 # NaN is not valid JSON
        return o

    print(_json.dumps(no_nan(out), indent=1))


if __name__ == "__main__":
    main()
