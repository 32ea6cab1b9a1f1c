"""OpenAIPreprocessor: OpenAI request → PreprocessedRequest on the way
down, Backend output stream → OpenAI chunks on the way up.

Port of `dynamo_tpu/llm/preprocessor.py` (the port keeps its own copy):
chat templating, tokenization, sampling and stop options, the postprocess
stream transform with usage and logprobs, n > 1 (one engine stream per
choice, reseeded, interleaved with their indices, one trailing usage
chunk; `:382-430`, `:523-526`), embeddings (one `extra.embed` engine
request per input, bounded fan-out, `:243-305`) and the Responses API
over the chat pipeline (typed events, `:309-352`). The card's tool-call
and reasoning parsers wrap each chat choice's stream in a fresh
`JailedStream` (`_chat_parsers`, `:354-380`), on chat, on n > 1 and on
`/v1/responses`; a tokenizer with a chat template (the HF tokenizer)
renders the prompt with it. Image parts of a chat (`_resolve_images`,
`:121-178`): each `data:` URL goes to the card's encode workers (remote
URLs are refused: there is no egress to fetch them), a marker takes the
part's place in the rendered prompt, and the image's token run is
spliced in at the marker (`:93-116`); a model whose card names no encode
component refuses image parts.
"""

from __future__ import annotations

import time
import asyncio
import copy
from typing import AsyncIterator, Optional

from dynamo_tpu_torch.llm.protocols_openai import (
    ChatCompletionRequest,
    CompletionRequest,
    EmbeddingRequest,
    OpenAIError,
    chat_chunk,
    completion_chunk,
    embedding_response,
    new_request_id,
    response_object,
    responses_input_to_messages,
    usage_dict,
)
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from dynamo_tpu_torch.protocols import PreprocessedRequest, StopConditions
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.engine import Operator

KIND_CHAT = "chat"
KIND_COMPLETION = "completion"
KIND_EMBEDDING = "embedding"
KIND_RESPONSES = "responses"

DEFAULT_TEMPLATE_SUFFIX = "assistant:"


def render_chat_template(tokenizer: Tokenizer, messages: list[dict]) -> str:
    """The tokenizer's chat template when it has one; else a minimal
    role-prefixed rendering (the reference's fallback)."""
    apply = getattr(tokenizer, "apply_chat_template", None)
    if apply is not None:
        try:
            return apply(messages, add_generation_prompt=True)
        except Exception:
            pass  # template missing or broken: the fallback below
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
                 default_max_tokens: int = 1024,
                 tool_call_parser: str = "",
                 reasoning_parser: str = "",
                 encode_router=None) -> None:
        super().__init__()
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.context_length = context_length
        self.default_max_tokens = default_max_tokens
        self.tool_call_parser = tool_call_parser
        self.reasoning_parser = reasoning_parser
        # an AsyncEngine routing to the encode workers: image parts become
        # discrete tokens spliced into the prompt (dynamo_tpu_torch.multimodal)
        self.encode_router = encode_router

    def _token_text(self, tid: int) -> str:
        """Display text of ONE token id (logprobs entries)."""
        return self.tokenizer.decode([tid])

    @staticmethod
    def _token_id_text(tid: int) -> str:
        """A logprobs token under `return_tokens_as_token_ids`."""
        return f"token_id:{tid}"

    def preprocess_chat(self, req: ChatCompletionRequest,
                        image_tokens: Optional[dict] = None
                        ) -> PreprocessedRequest:
        prompt = render_chat_template(self.tokenizer, req.messages)
        if image_tokens:
            # the markers `_resolve_images` put in: the text between them
            # tokenizes as usual, each image's token run goes in verbatim
            ids: list[int] = []
            rest = prompt
            for marker, toks in image_tokens.items():
                before, sep, rest = rest.partition(marker)
                if not sep:
                    # a template that escapes list content would otherwise
                    # put the image tokens after the generation suffix
                    raise OpenAIError(
                        "the model's chat template dropped the image "
                        "placeholder; this template does not support "
                        "multimodal content parts")
                ids.extend(self.tokenizer.encode(before) if before else [])
                ids.extend(toks)
            if rest:
                ids.extend(self.tokenizer.encode(rest))
        else:
            ids = self.tokenizer.encode(prompt)
        return self._finish_preprocess(ids, req.sampling_options(),
                                       req.stop_conditions())

    async def _resolve_images(self, messages: list[dict], context: Context
                              ) -> tuple[list[dict], dict]:
        """Replace image parts with unique markers and encode each image
        on the encode workers, all at once. Returns (the rewritten
        messages, {marker: image token ids}), empty without images."""
        image_tokens: dict[str, list[int]] = {}
        out_messages: list[dict] = []
        jobs: list[tuple[str, str]] = []     # (marker, url)
        for m in messages:
            content = m.get("content")
            if not isinstance(content, list):
                out_messages.append(m)
                continue
            parts = []
            for part in content:
                if not (isinstance(part, dict)
                        and part.get("type") == "image_url"):
                    parts.append(part)
                    continue
                url = (part.get("image_url") or {}).get("url", "")
                if self.encode_router is None:
                    raise OpenAIError(
                        "this deployment has no encode workers: image "
                        "inputs are not supported for "
                        f"{self.model_name!r}")
                if not url.startswith("data:"):
                    raise OpenAIError(
                        "only data: image URLs are supported "
                        "(no egress to fetch remote images)")
                marker = f"\x00dyn_image_{len(jobs)}\x00"
                jobs.append((marker, url))
                parts.append({"type": "text", "text": marker})
            out_messages.append({**m, "content": parts})

        async def encode_one(url: str) -> list[int]:
            toks = None
            async for resp in self.encode_router.generate({"image": url},
                                                          context):
                if resp.get("error"):
                    raise OpenAIError(
                        f"image encode failed: {resp['error']}")
                if resp.get("image_tokens") is not None:
                    toks = [int(t) for t in resp["image_tokens"]]
            if toks is None:
                raise OpenAIError("encode worker returned no tokens")
            return toks

        results = await asyncio.gather(*(encode_one(url)
                                         for _, url in jobs))
        for (marker, _), toks in zip(jobs, results):
            image_tokens[marker] = toks
        return out_messages, image_tokens

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
        if kind == KIND_EMBEDDING:
            async for out in self._embed(request, context):
                yield out
        elif kind == KIND_RESPONSES:
            async for out in self._responses(request, created, context):
                yield out
        elif kind == KIND_CHAT:
            oai = ChatCompletionRequest.from_dict(request["body"])
            image_tokens: dict = {}
            if any(isinstance(m.get("content"), list)
                   for m in oai.messages):
                oai.messages, image_tokens = await self._resolve_images(
                    oai.messages, context)
            pre = self.preprocess_chat(oai, image_tokens)
            request_id = request.get("request_id") or new_request_id()
            streams = [self._one_chat_stream(self._reseed(pre, i), oai,
                                             request_id, created, context)
                       for i in range(oai.n)]
            async for chunk in self._choices(
                    streams, request_id, oai.model, created,
                    "chat.completion.chunk"):
                yield chunk
        elif kind == KIND_COMPLETION:
            oai_c = CompletionRequest.from_dict(request["body"])
            pre = self.preprocess_completion(oai_c)
            request_id = request.get("request_id") or new_request_id("cmpl")
            streams = [self._completion_chunks(self._reseed(pre, i), oai_c,
                                               request_id, created, context)
                       for i in range(oai_c.n)]
            async for chunk in self._choices(
                    streams, request_id, oai_c.model, created,
                    "text_completion"):
                yield chunk
        else:
            raise OpenAIError(f"request kind {kind!r} is not supported by "
                              f"dynamo_tpu_torch yet")

    def _chat_parsers(self, oai: ChatCompletionRequest):
        """The jail and reasoning wrap for this request, or None when
        neither applies: the parsers engage only when the card names them,
        the jail only when the request carries tools."""
        from dynamo_tpu_torch.parsers import (
            JailedStream,
            get_reasoning_parser,
            get_tool_parser,
        )

        want_tools = bool(oai.raw.get("tools")) and bool(
            self.tool_call_parser)
        want_reasoning = bool(self.reasoning_parser)
        if not (want_tools or want_reasoning):
            return None
        return JailedStream(
            tool_config=(get_tool_parser(self.tool_call_parser)
                         if want_tools else None),
            reasoning=(get_reasoning_parser(self.reasoning_parser)
                       if want_reasoning else None))

    def _one_chat_stream(self, pre, oai, request_id, created, context):
        """One choice's chunk stream, through a fresh jail when the
        parsers apply (a jail holds state: one per choice)."""
        stream = self._chat_chunks(pre, oai, request_id, created, context)
        jail = self._chat_parsers(oai)
        return stream if jail is None else jail.apply(stream)

    # -- n > 1 ---------------------------------------------------------------

    async def _choices(self, streams: list, request_id: str, model: str,
                       created: int, obj: str) -> AsyncIterator[dict]:
        """One choice's stream as it is; n of them interleaved
        (`_fanout_choices`), then one usage chunk with no choices (an
        index-0 delta after that choice's finish would break strict
        stream consumers)."""
        if len(streams) == 1:
            async for chunk in streams[0]:
                yield chunk
            return
        usages: dict[int, dict] = {}
        async for chunk in self._fanout_choices(streams, usages):
            yield chunk
        yield {"id": request_id, "object": obj, "created": created,
               "model": model, "choices": [],
               "usage": self._merge_usage(usages)}

    @staticmethod
    def _reseed(pre: PreprocessedRequest, i: int) -> PreprocessedRequest:
        """Choice i's request: the same tokens, seed + i (a fixed user seed
        still yields n distinct choices, deterministically); choice 0
        keeps the request's seed. Shallow copies: only the seed changes."""
        if i == 0 or pre.sampling.seed is None:
            return pre
        p2 = copy.copy(pre)
        p2.sampling = copy.copy(pre.sampling)
        p2.sampling.seed = pre.sampling.seed + i
        return p2

    @staticmethod
    def _merge_usage(usages: dict[int, dict]) -> dict:
        prompt = max((u.get("prompt_tokens", 0) for u in usages.values()),
                     default=0)
        completion = sum(u.get("completion_tokens", 0)
                         for u in usages.values())
        return usage_dict(prompt, completion)

    async def _fanout_choices(self, streams,
                              usages: dict[int, dict]
                              ) -> AsyncIterator[dict]:
        """Merge per-choice chunk streams: relabel their indices and take
        their usage chunks' usage into `usages`. A bounded queue paces the
        engine streams by the consumer as one stream is paced; a failing
        choice cancels its siblings at once."""
        queue: asyncio.Queue = asyncio.Queue(maxsize=4)

        async def pump(i, stream):
            try:
                async for chunk in stream:
                    await queue.put((i, chunk, None))
            except asyncio.CancelledError:
                raise
            except BaseException as e:
                await queue.put((i, None, e))
                return
            await queue.put((i, None, None))

        tasks = [asyncio.get_running_loop().create_task(pump(i, st))
                 for i, st in enumerate(streams)]
        try:
            done = 0
            while done < len(streams):
                i, chunk, err = await queue.get()
                if chunk is None:
                    if err is not None:
                        raise err      # the finally cancels the siblings
                    done += 1
                    continue
                for ch in chunk.get("choices", ()):
                    ch["index"] = i
                u = chunk.pop("usage", None)
                if u:
                    usages[i] = u
                yield chunk
        finally:
            for t in tasks:
                t.cancel()

    # -- embeddings (/v1/embeddings) ------------------------------------------

    async def _embed(self, request: dict, context: Context
                     ) -> AsyncIterator[dict]:
        req = EmbeddingRequest.from_dict(request["body"])
        token_lists: list[list[int]] = []
        for item in req.inputs:
            ids = (list(item) if isinstance(item, list)
                   else self.tokenizer.encode(item))
            if self.context_length and len(ids) >= self.context_length:
                raise OpenAIError(
                    f"input ({len(ids)} tokens) exceeds the model context "
                    f"length of {self.context_length}", status=400)
            token_lists.append(ids)

        sem = asyncio.Semaphore(32)    # a batch can hold 2048 items

        async def one(ids: list[int]) -> list[float]:
            pre = PreprocessedRequest(
                token_ids=ids, model=self.model_name,
                stop=StopConditions(max_tokens=1), extra={"embed": True})
            async with sem:
                async for out in self.inner.generate(pre.to_dict(),
                                                     context):
                    if out.get("embedding") is not None:
                        return [float(x) for x in out["embedding"]]
                    if out.get("finish_reason"):
                        break
            raise OpenAIError(
                f"model {self.model_name!r} does not support embeddings",
                status=400)

        # independent items: bounded fan-out, order kept by position; the
        # siblings are cancelled the moment one item fails
        results: list = [None] * len(token_lists)

        async def slot(i: int, ids: list) -> None:
            results[i] = await one(ids)

        tasks = [asyncio.ensure_future(slot(i, ids))
                 for i, ids in enumerate(token_lists)]
        try:
            await asyncio.gather(*tasks)
        except BaseException:
            for t in tasks:
                t.cancel()
            settled = await asyncio.gather(*tasks, return_exceptions=True)
            errors = [e for e in settled
                      if isinstance(e, BaseException)
                      and not isinstance(e, asyncio.CancelledError)]
            for e in errors:
                if isinstance(e, OpenAIError):
                    raise e
            if errors:
                raise errors[0]
            raise
        yield embedding_response(req.model, results,
                                 sum(len(t) for t in token_lists),
                                 req.encoding_format)

    # -- responses (/v1/responses) --------------------------------------------

    async def _responses(self, request: dict, created: int,
                         context: Context) -> AsyncIterator[dict]:
        """The Responses API over the chat pipeline: typed events out
        (`response.created`, `response.output_text.delta`,
        `response.output_text.done`, `response.completed`); the unary
        route folds the completed event."""
        body = dict(request["body"])
        messages = responses_input_to_messages(body)
        chat_body = {"model": body.get("model"), "messages": messages}
        if body.get("max_output_tokens") is not None:
            chat_body["max_tokens"] = body["max_output_tokens"]
        for k in ("temperature", "top_p"):
            if body.get(k) is not None:
                chat_body[k] = body[k]
        oai = ChatCompletionRequest.from_dict(chat_body)
        pre = self.preprocess_chat(oai)
        resp_id = request.get("request_id") or new_request_id("resp")
        yield {"type": "response.created",
               "response": response_object(resp_id, oai.model, created,
                                           "in_progress")}
        parts: list[str] = []
        usage = None
        # the parsers as on chat: think text never reaches output_text
        async for chunk in self._one_chat_stream(pre, oai, resp_id, created,
                                                 context):
            if chunk.get("usage"):
                usage = chunk["usage"]
            for choice in chunk.get("choices", ()):
                t = choice.get("delta", {}).get("content")
                if t:
                    parts.append(t)
                    yield {"type": "response.output_text.delta",
                           "item_id": f"msg-{resp_id}", "output_index": 0,
                           "content_index": 0, "delta": t}
        text = "".join(parts)
        yield {"type": "response.output_text.done",
               "item_id": f"msg-{resp_id}", "output_index": 0,
               "content_index": 0, "text": text}
        yield {"type": "response.completed",
               "response": response_object(resp_id, oai.model, created,
                                           "completed", text, usage)}

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
