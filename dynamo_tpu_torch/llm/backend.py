"""Backend operator: incremental detokenization + stop conditions.

Port of `dynamo_tpu/llm/backend.py` (the port keeps its own copy). Sits
after the preprocessor; on the response path it turns raw `EngineOutput` token deltas into
`BackendOutput` text deltas via an incremental DecodeStream, and enforces
stop strings with *hidden partial-match jailing*: while the generated tail
could still be the prefix of a stop string, the text is held back, so a
stop string never leaks into the client stream.
"""

from __future__ import annotations

from typing import AsyncIterator, Optional

from dynamo_tpu_torch.llm.tokenizer import DecodeStream, Tokenizer
from dynamo_tpu_torch.protocols import (
    FINISH_EOS,
    FINISH_STOP,
    PreprocessedRequest,
)
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.engine import Operator


class StopJail:
    """Holds back text that may be the prefix of a stop string.

    feed() returns (emittable_text, matched_stop): once a stop string fully
    matches, everything from its start is swallowed and matched_stop is set.
    """

    def __init__(self, stop: list[str]) -> None:
        self.stop = [s for s in stop if s]
        self._held = ""

    def feed(self, text: str) -> tuple[str, Optional[str]]:
        if not self.stop:
            return text, None
        buf = self._held + text
        for s in self.stop:
            i = buf.find(s)
            if i >= 0:
                self._held = ""
                return buf[:i], s
        # longest suffix of buf that is a proper prefix of any stop string
        hold = 0
        for s in self.stop:
            for k in range(min(len(s) - 1, len(buf)), 0, -1):
                if buf.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        if hold:
            self._held = buf[-hold:]
            return buf[:-hold], None
        self._held = ""
        return buf, None

    def flush(self) -> str:
        held, self._held = self._held, ""
        return held


class Backend(Operator):
    """PreprocessedRequest dict → (inner engine) → BackendOutput dicts
    {"text", "token_ids", "finish_reason"}."""

    def __init__(self, tokenizer: Tokenizer) -> None:
        super().__init__()
        self.tokenizer = tokenizer

    async def forward(self, request: dict, context: Context
                      ) -> AsyncIterator[dict]:
        assert self.inner is not None
        if (request.get("extra") or {}).get("embed"):
            # an embedding request: no tokens to detokenize, no stops
            async for out in self.inner.generate(request, context):
                yield out
            return
        req = PreprocessedRequest.from_dict(request)
        decode = DecodeStream(self.tokenizer, req.token_ids)
        jail = StopJail(req.stop.stop)
        eos_ids = set(req.stop.stop_token_ids)
        generated = 0
        # Child context: an early stop here must stop the *engine* without
        # cancelling the request for the stages above us.
        inner_ctx = context.child()
        async for out in self.inner.generate(request, inner_ctx):
            token_ids = out.get("token_ids", ())
            finish = out.get("finish_reason")
            in_lps = out.get("log_probs")
            in_tops = out.get("top_logprobs")
            text_parts = []
            matched_stop = None
            hit_eos = False
            emitted_ids = []
            emitted_lps = [] if in_lps is not None else None
            emitted_tops = [] if in_tops is not None else None
            for ti, t in enumerate(token_ids):
                generated += 1
                if t in eos_ids and not req.stop.ignore_eos:
                    if generated >= req.stop.min_tokens:
                        hit_eos = True
                        break
                    continue  # pre-min_tokens EOS: suppress, keep generating
                emitted_ids.append(t)
                if emitted_lps is not None and ti < len(in_lps):
                    # logprobs stay aligned with EMITTED tokens, not with
                    # whatever text happened to detokenize this frame
                    emitted_lps.append(in_lps[ti])
                if emitted_tops is not None and ti < len(in_tops):
                    emitted_tops.append(in_tops[ti])
                delta = decode.step(t)
                if delta:
                    emit, matched_stop = jail.feed(delta)
                    if emit:
                        text_parts.append(emit)
                    if matched_stop:
                        break
            def with_lps(d: dict) -> dict:
                if emitted_lps is not None:
                    d["log_probs"] = emitted_lps
                if emitted_tops is not None:
                    d["top_logprobs"] = emitted_tops
                return d
            if matched_stop is not None:
                yield with_lps({"text": "".join(text_parts),
                                "token_ids": emitted_ids,
                                "finish_reason": FINISH_STOP})
                inner_ctx.cancel()  # engine side stops generating
                return
            if hit_eos:
                # held-back text is real output (no stop matched): flush it
                yield with_lps({"text": "".join(text_parts) + jail.flush(),
                                "token_ids": emitted_ids,
                                "finish_reason": FINISH_EOS})
                inner_ctx.cancel()
                return
            result = with_lps({"text": "".join(text_parts),
                               "token_ids": emitted_ids})
            if finish:
                # engine-side finish (length/cancelled/error): flush any
                # jailed text — it is real output, not a stop string.
                result["text"] += jail.flush()
                result["finish_reason"] = finish
            for k in ("kv_transfer_params", "cum_log_prob"):
                if out.get(k) is not None:
                    result[k] = out[k]
            yield result
            if finish:
                return
        # Inner stream ended without a finish_reason frame: flush jailed text.
        tail = jail.flush()
        if tail:
            yield {"text": tail, "token_ids": []}
