"""OpenAIPreprocessor: OpenAI request → PreprocessedRequest on the way
down, Backend output stream → OpenAI chunks on the way up.

Port of the chat/completions part of `dynamo_tpu/llm/preprocessor.py`
(the port keeps its own copy): chat templating, tokenization, sampling
and stop options, and the postprocess stream transform with usage and
logprobs. Not in this slice: tool-call and reasoning parsers, images,
embeddings, the Responses API and n > 1 (llm/protocols_openai.py rejects
the requests that ask for them).
"""

from __future__ import annotations

import time
from typing import AsyncIterator, Optional

from dynamo_tpu_torch.llm.protocols_openai import (
    ChatCompletionRequest,
    CompletionRequest,
    OpenAIError,
    chat_chunk,
    completion_chunk,
    new_request_id,
    usage_dict,
)
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from dynamo_tpu_torch.protocols import PreprocessedRequest
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.engine import Operator

KIND_CHAT = "chat"
KIND_COMPLETION = "completion"

DEFAULT_TEMPLATE_SUFFIX = "assistant:"


def render_chat_template(messages: list[dict]) -> str:
    """Minimal role-prefixed rendering (the reference's fallback when the
    tokenizer has no chat template; this slice serves none that do)."""
    lines = []
    for m in messages:
        content = m.get("content") or ""
        if isinstance(content, list):  # typed parts: text only
            content = " ".join(p.get("text", "") for p in content
                               if isinstance(p, dict))
        lines.append(f"{m.get('role', 'user')}: {content}")
    lines.append(DEFAULT_TEMPLATE_SUFFIX)
    return "\n".join(lines)


class OpenAIPreprocessor(Operator):
    """Front pipeline stage. Requests are dicts with ``_kind`` ("chat" or
    "completion") and ``body``; responses are OpenAI chunk dicts."""

    def __init__(self, tokenizer: Tokenizer, model_name: str,
                 context_length: int = 0,
                 default_max_tokens: int = 1024) -> None:
        super().__init__()
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.context_length = context_length
        self.default_max_tokens = default_max_tokens

    def _token_text(self, tid: int) -> str:
        """Display text of ONE token id (logprobs entries)."""
        return self.tokenizer.decode([tid])

    @staticmethod
    def _token_id_text(tid: int) -> str:
        """A logprobs token under `return_tokens_as_token_ids`."""
        return f"token_id:{tid}"

    def preprocess_chat(self, req: ChatCompletionRequest
                        ) -> PreprocessedRequest:
        ids = self.tokenizer.encode(render_chat_template(req.messages))
        return self._finish_preprocess(ids, req.sampling_options(),
                                       req.stop_conditions())

    def preprocess_completion(self, req: CompletionRequest
                              ) -> PreprocessedRequest:
        if isinstance(req.prompt, list):
            ids = [int(t) for t in req.prompt]
        else:
            ids = self.tokenizer.encode(req.prompt)
        return self._finish_preprocess(ids, req.sampling_options(),
                                       req.stop_conditions())

    def _finish_preprocess(self, prompt_ids, sampling, stop
                           ) -> PreprocessedRequest:
        if stop.max_tokens is None:
            stop.max_tokens = self.default_max_tokens
        if not stop.ignore_eos and self.tokenizer.eos_token_id is not None:
            eos = self.tokenizer.eos_token_id
            if eos not in stop.stop_token_ids:
                stop.stop_token_ids.append(eos)
        if self.context_length and len(prompt_ids) >= self.context_length:
            raise OpenAIError(
                f"prompt ({len(prompt_ids)} tokens) exceeds the model "
                f"context length of {self.context_length}", status=400)
        return PreprocessedRequest(
            token_ids=list(prompt_ids), model=self.model_name,
            sampling=sampling, stop=stop)

    async def forward(self, request: dict, context: Context
                      ) -> AsyncIterator[dict]:
        assert self.inner is not None
        kind = request.get("_kind", KIND_CHAT)
        created = int(time.time())
        if kind == KIND_CHAT:
            oai = ChatCompletionRequest.from_dict(request["body"])
            pre = self.preprocess_chat(oai)
            request_id = request.get("request_id") or new_request_id()
            async for chunk in self._chat_chunks(pre, oai, request_id,
                                                 created, context):
                yield chunk
        elif kind == KIND_COMPLETION:
            oai_c = CompletionRequest.from_dict(request["body"])
            pre = self.preprocess_completion(oai_c)
            request_id = request.get("request_id") or new_request_id("cmpl")
            async for chunk in self._completion_chunks(
                    pre, oai_c, request_id, created, context):
                yield chunk
        else:
            raise OpenAIError(f"request kind {kind!r} is not supported by "
                              f"dynamo_tpu_torch yet")

    def _lp_entry(self, tid: int, lp: float, top, render) -> dict:
        """One OpenAI chat logprobs.content[] entry; `render` gives a
        token's text."""
        text = render(tid)
        entry = {"token": text, "logprob": lp,
                 "bytes": list(text.encode("utf-8"))}
        if top is not None:
            entry["top_logprobs"] = [
                {"token": (t := render(int(aid))),
                 "logprob": alp, "bytes": list(t.encode("utf-8"))}
                for aid, alp in top]
        return entry

    async def _chat_chunks(self, pre: PreprocessedRequest,
                           oai: ChatCompletionRequest, request_id: str,
                           created: int, context: Context
                           ) -> AsyncIterator[dict]:
        prompt_tokens = len(pre.token_ids)
        completion_tokens = 0
        yield chat_chunk(request_id, oai.model, created, role="assistant")
        finish: Optional[str] = None
        # logprob entries buffer while text is held back (stop jail,
        # multi-byte holdback)
        want_lps = bool(oai.logprobs)
        as_ids = want_lps and oai.return_tokens_as_token_ids
        render = self._token_id_text if as_ids else self._token_text
        pending: list[dict] = []
        async for out in self.inner.generate(pre.to_dict(), context):
            ids = out.get("token_ids", ())
            completion_tokens += len(ids)
            text = out.get("text", "")
            finish = out.get("finish_reason")
            if want_lps and out.get("log_probs"):
                tops = out.get("top_logprobs") or [None] * len(ids)
                for tid, lp, top in zip(ids, out["log_probs"], tops):
                    pending.append(self._lp_entry(tid, lp, top, render))
            if text or (as_ids and pending):
                entries, pending = (pending, []) if want_lps else (None,
                                                                   [])
                yield chat_chunk(request_id, oai.model, created,
                                 content=text or None,
                                 logprob_content=entries)
            if finish:
                break
        yield chat_chunk(
            request_id, oai.model, created, finish_reason=finish or "stop",
            usage=usage_dict(prompt_tokens, completion_tokens),
            logprob_content=(pending or None) if want_lps else None)

    async def _completion_chunks(self, pre: PreprocessedRequest,
                                 oai: CompletionRequest, request_id: str,
                                 created: int, context: Context
                                 ) -> AsyncIterator[dict]:
        prompt_tokens = len(pre.token_ids)
        completion_tokens = 0
        finish: Optional[str] = None
        if oai.echo and isinstance(oai.prompt, str):
            yield completion_chunk(request_id, oai.model, created, oai.prompt)
        # logprobs=0 is valid ("chosen token, no alternatives"): gate on
        # presence, not truthiness
        want_lps = oai.logprobs is not None
        want_top = bool(oai.logprobs)
        as_ids = want_lps and oai.return_tokens_as_token_ids
        render = self._token_id_text if as_ids else self._token_text
        lps: list[float] = []
        toks: list[str] = []
        tops: list[dict] = []

        def drain() -> dict:
            nonlocal lps, toks, tops
            out = {"token_logprobs": lps or None, "tokens": toks or None,
                   "top_logprobs": (tops or None) if want_top else None}
            lps, toks, tops = [], [], []
            return out

        async for out in self.inner.generate(pre.to_dict(), context):
            ids = out.get("token_ids", ())
            completion_tokens += len(ids)
            text = out.get("text", "")
            finish = out.get("finish_reason")
            if want_lps and out.get("log_probs"):
                lps.extend(out["log_probs"])
                alts_all = out.get("top_logprobs") or []
                for ti, tid in enumerate(ids[:len(out["log_probs"])]):
                    toks.append(render(tid))
                    if want_top:
                        d: dict = {}
                        alts = alts_all[ti] if ti < len(alts_all) else None
                        for a, lp in (alts or []):
                            # distinct ids can decode to the same text:
                            # keep the higher-ranked alternative
                            d.setdefault(render(int(a)), lp)
                        tops.append(d)
            if text or (as_ids and lps):
                kw = drain() if want_lps else {}
                yield completion_chunk(request_id, oai.model, created,
                                       text, **kw)
            if finish:
                break
        tail = drain() if want_lps else {}
        yield completion_chunk(
            request_id, oai.model, created, "",
            finish_reason=finish or "stop",
            usage=usage_dict(prompt_tokens, completion_tokens), **tail)
