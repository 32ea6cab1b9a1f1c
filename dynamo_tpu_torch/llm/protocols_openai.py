"""OpenAI-compatible chat/completions request types and stream chunks.

Port of the part of `dynamo_tpu/llm/protocols_openai.py` that the chat and
completions pipeline needs (the port keeps its own copy): request parsing
and validation, guided decoding's request surface (`_guided_from`:
`response_format` json_object / json_schema and `nvext` or top-level
guided_json / guided_regex / guided_choice), chunk builders, usage, the
unary response builders, the stream folds (`aggregate_*_stream`), the
SSE codec, n up to `MAX_N`, the embeddings request and response
(`EmbeddingRequest`, `embedding_response`) and the Responses API
(`responses_input_to_messages`, `response_object`, the typed SSE frames
`sse_encode_event`, `aggregate_responses_stream`; `:516-634`).

One request field the reference does not read: `return_tokens_as_token_ids`
(vLLM's name for it). With logprobs on, each logprobs token string is
"token_id:<id>", so tokens whose text is empty or not valid UTF-8 can be
told apart, and every engine output that carries tokens goes out as a
chunk of its own, so a client sees each token as it arrives.
"""

from __future__ import annotations

import base64
import json
import struct
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Optional

from dynamo_tpu_torch.protocols import SamplingOptions, StopConditions


class OpenAIError(ValueError):
    """Maps to an HTTP 4xx with an OpenAI-style error body."""

    def __init__(self, message: str, status: int = 400,
                 err_type: str = "invalid_request_error") -> None:
        super().__init__(message)
        self.status = status
        self.err_type = err_type

    def body(self) -> dict:
        return {"error": {"message": str(self), "type": self.err_type,
                          "param": None, "code": None}}


# one request fans out into n engine streams, each holding KV pages and
# a batch slot: an uncapped n is a single-request denial of service
MAX_N = 16

# widest top-k logprob alternatives served (engine TOPK_WIDTH)
MAX_TOP_LOGPROBS = 8


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise OpenAIError(msg)


def _as_int(v, name: str) -> int:
    """Coerce a JSON field to int, 400ing (not 500ing) on 'abc'/[1]."""
    try:
        return int(v)
    except (TypeError, ValueError):
        raise OpenAIError(f"'{name}' must be an integer") from None


def _opt_int(v, name: str):
    return None if v is None else _as_int(v, name)


def _guided_from(d: dict, nvext: dict) -> Optional[dict]:
    """Map OpenAI `response_format` + nvext guided_* onto the engine's
    guided spec ({"regex"|"choice"|"json": ...}); at most one source."""
    rf = d.get("response_format") or {}
    rf_type = rf.get("type") if isinstance(rf, dict) else None
    candidates = []
    if rf_type == "json_object":
        candidates.append({"json": True})
    elif rf_type == "json_schema":
        js = rf.get("json_schema")
        _require(js is None or isinstance(js, dict),
                 "'response_format.json_schema' must be an object")
        schema = (js or {}).get("schema", js)
        candidates.append({"json": schema or True})
    for src in (d, nvext):
        if src.get("guided_json") is not None:
            candidates.append({"json": src["guided_json"]})
        if src.get("guided_regex") is not None:
            candidates.append({"regex": src["guided_regex"]})
        if src.get("guided_choice") is not None:
            candidates.append({"choice": list(src["guided_choice"])})
        # serving a CFG request unconstrained would be a silent contract
        # violation — reject until a grammar compiler exists
        _require(src.get("guided_grammar") is None,
                 "'guided_grammar' (context-free grammar) is not "
                 "supported; use guided_regex, guided_json, or "
                 "guided_choice")
    if not candidates:
        return None
    _require(len(candidates) == 1,
             "at most one guided-decoding option may be set")
    return candidates[0]


def _common(d: dict) -> dict:
    """Fields and checks shared by chat and completions."""
    _require(isinstance(d, dict), "request body must be a JSON object")
    _require(bool(d.get("model")), "'model' is required")
    n = _as_int(d.get("n", 1), "n")
    _require(1 <= n <= MAX_N, f"'n' must be between 1 and {MAX_N}")
    nvext = d.get("nvext") or {}
    stop = d.get("stop") or []
    if isinstance(stop, str):
        stop = [stop]
    return dict(
        model=d["model"], stream=bool(d.get("stream")), n=n,
        temperature=d.get("temperature"), top_p=d.get("top_p"),
        top_k=d.get("top_k", nvext.get("top_k")),
        min_p=d.get("min_p"),
        frequency_penalty=d.get("frequency_penalty"),
        presence_penalty=d.get("presence_penalty"),
        seed=d.get("seed"), stop=list(stop),
        ignore_eos=bool(d.get("ignore_eos", nvext.get("ignore_eos", False))),
        min_tokens=_opt_int(d.get("min_tokens"), "min_tokens"),
        guided=_guided_from(d, nvext),
        return_tokens_as_token_ids=bool(d.get("return_tokens_as_token_ids")),
        raw=d)


@dataclass
class ChatCompletionRequest:
    model: str
    messages: list[dict]
    stream: bool = False
    max_tokens: Optional[int] = None
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None          # NVIDIA/NIM extension field
    min_p: Optional[float] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    seed: Optional[int] = None
    stop: list[str] = field(default_factory=list)
    ignore_eos: bool = False
    min_tokens: Optional[int] = None
    logprobs: bool = False
    top_logprobs: int = 0
    n: int = 1
    # guided decoding (the reference's GuidedDecodingOptions): from
    # `response_format` (json_object / json_schema) or nvext guided_json /
    # guided_regex / guided_choice
    guided: Optional[dict] = None
    # logprobs tokens as "token_id:<id>", one chunk per engine output
    return_tokens_as_token_ids: bool = False
    raw: dict = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "ChatCompletionRequest":
        common = _common(d)
        msgs = d.get("messages")
        _require(isinstance(msgs, list) and len(msgs) > 0,
                 "'messages' must be a non-empty array")
        for m in msgs:
            _require(isinstance(m, dict) and "role" in m,
                     "each message needs a 'role'")
        top_lps = _as_int(d.get("top_logprobs") or 0, "top_logprobs")
        _require(0 <= top_lps <= MAX_TOP_LOGPROBS,
                 f"'top_logprobs' must be between 0 and "
                 f"{MAX_TOP_LOGPROBS}")
        _require(top_lps == 0 or bool(d.get("logprobs")),
                 "'top_logprobs' requires 'logprobs': true")
        return cls(
            messages=msgs,
            max_tokens=_opt_int(
                d.get("max_tokens", d.get("max_completion_tokens")),
                "max_tokens"),
            logprobs=bool(d.get("logprobs")), top_logprobs=top_lps,
            **common)

    def sampling_options(self) -> SamplingOptions:
        s = SamplingOptions()
        if self.temperature is not None:
            s.temperature = float(self.temperature)
        if self.top_p is not None:
            s.top_p = float(self.top_p)
        if self.top_k is not None:
            s.top_k = int(self.top_k)
        if self.min_p is not None:
            s.min_p = float(self.min_p)
        if self.frequency_penalty is not None:
            s.frequency_penalty = float(self.frequency_penalty)
        if self.presence_penalty is not None:
            s.presence_penalty = float(self.presence_penalty)
        if self.seed is not None:
            s.seed = int(self.seed)
        if self.guided is not None:
            s.guided = self.guided
        # completions carry no top_logprobs field (their `logprobs` is
        # the count, set by CompletionRequest.sampling_options)
        s.top_logprobs = int(getattr(self, "top_logprobs", 0) or 0)
        return s

    def stop_conditions(self) -> StopConditions:
        return StopConditions(
            max_tokens=self.max_tokens, stop=list(self.stop),
            ignore_eos=self.ignore_eos, min_tokens=self.min_tokens or 0)


@dataclass
class CompletionRequest:
    model: str
    prompt: "str | list[int]"
    stream: bool = False
    max_tokens: Optional[int] = None
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    min_p: Optional[float] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    seed: Optional[int] = None
    stop: list[str] = field(default_factory=list)
    ignore_eos: bool = False
    min_tokens: Optional[int] = None
    echo: bool = False
    logprobs: Optional[int] = None       # OpenAI: int top-k
    n: int = 1
    guided: Optional[dict] = None
    return_tokens_as_token_ids: bool = False
    raw: dict = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "CompletionRequest":
        common = _common(d)
        prompt = d.get("prompt")
        _require(prompt is not None, "'prompt' is required")
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], str):
            _require(len(prompt) == 1, "batch prompts not supported yet")
            prompt = prompt[0]
        lps = d.get("logprobs")
        lps = None if lps is None else _as_int(lps, "logprobs")
        _require(lps is None or 0 <= lps <= MAX_TOP_LOGPROBS,
                 f"'logprobs' must be between 0 and {MAX_TOP_LOGPROBS}")
        return cls(prompt=prompt,
                   max_tokens=_opt_int(d.get("max_tokens"), "max_tokens"),
                   echo=bool(d.get("echo")), logprobs=lps, **common)

    def sampling_options(self) -> SamplingOptions:
        s = ChatCompletionRequest.sampling_options(self)
        s.top_logprobs = int(self.logprobs or 0)
        return s

    def stop_conditions(self) -> StopConditions:
        return ChatCompletionRequest.stop_conditions(self)


def _now() -> int:
    return int(time.time())


def new_request_id(prefix: str = "chatcmpl") -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


def usage_dict(prompt_tokens: int, completion_tokens: int) -> dict:
    return {"prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens}


def chat_chunk(request_id: str, model: str, created: int,
               content: Optional[str] = None, role: Optional[str] = None,
               finish_reason: Optional[str] = None,
               usage: Optional[dict] = None,
               logprob_content: Optional[list[dict]] = None) -> dict:
    delta: dict[str, Any] = {}
    if role is not None:
        delta["role"] = role
    if content is not None:
        delta["content"] = content
    choice: dict[str, Any] = {"index": 0, "delta": delta,
                              "finish_reason": finish_reason}
    if logprob_content is not None:
        choice["logprobs"] = {"content": logprob_content}
    out = {"id": request_id, "object": "chat.completion.chunk",
           "created": created, "model": model, "choices": [choice]}
    if usage is not None:
        out["usage"] = usage
    return out


def completion_chunk(request_id: str, model: str, created: int, text: str,
                     finish_reason: Optional[str] = None,
                     usage: Optional[dict] = None,
                     token_logprobs: Optional[list[float]] = None,
                     tokens: Optional[list[str]] = None,
                     top_logprobs: Optional[list[dict]] = None) -> dict:
    logprobs = None
    if token_logprobs is not None:
        logprobs = {"token_logprobs": token_logprobs, "tokens": tokens,
                    "top_logprobs": top_logprobs, "text_offset": None}
    out = {"id": request_id, "object": "text_completion",
           "created": created, "model": model,
           "choices": [{"index": 0, "text": text,
                        "finish_reason": finish_reason,
                        "logprobs": logprobs}]}
    if usage is not None:
        out["usage"] = usage
    return out


async def _fold_chunks(chunks: AsyncIterator[dict], on_choice) -> tuple:
    """Shared stream-fold scaffolding: header fields + usage capture;
    ``on_choice(index, choice)`` accumulates per-choice state."""
    request_id, model, created, usage = "", "", _now(), None
    async for c in chunks:
        request_id = c.get("id", request_id)
        model = c.get("model", model)
        created = c.get("created", created)
        if c.get("usage"):
            usage = c["usage"]
        for choice in c.get("choices", ()):
            on_choice(int(choice.get("index", 0)), choice)
    return request_id, model, created, usage or usage_dict(0, 0)


def chat_completion(request_id: str, model: str, created: int, text: str,
                    finish_reason: str, usage: dict,
                    tool_calls: Optional[list[dict]] = None,
                    reasoning: str = "",
                    logprob_content: Optional[list[dict]] = None) -> dict:
    message: dict[str, Any] = {"role": "assistant", "content": text}
    if tool_calls:
        # unary shape carries no streaming 'index' field
        message["tool_calls"] = [
            {k: v for k, v in tc.items() if k != "index"}
            for tc in tool_calls]
    if reasoning:
        message["reasoning_content"] = reasoning
    choice: dict[str, Any] = {
        "index": 0,
        "message": message,
        "finish_reason": finish_reason,
    }
    if logprob_content is not None:
        choice["logprobs"] = {"content": logprob_content}
    return {
        "id": request_id, "object": "chat.completion", "created": created,
        "model": model,
        "choices": [choice],
        "usage": usage,
    }


def completion_response(request_id: str, model: str, created: int, text: str,
                        finish_reason: str, usage: dict,
                        token_logprobs: Optional[list[float]] = None,
                        tokens: Optional[list[str]] = None,
                        top_logprobs: Optional[list[dict]] = None
                        ) -> dict:
    return completion_chunk(request_id, model, created, text,
                            finish_reason, usage,
                            token_logprobs=token_logprobs,
                            tokens=tokens, top_logprobs=top_logprobs)


# ---------------------------------------------------------------------------
# SSE codec (protocols/codec.rs)
# ---------------------------------------------------------------------------

SSE_DONE = b"data: [DONE]\n\n"


def sse_encode(payload: dict) -> bytes:
    return b"data: " + json.dumps(payload, separators=(",", ":")).encode() \
        + b"\n\n"


async def aggregate_chat_stream(chunks: AsyncIterator[dict]) -> dict:
    """Fold chat.completion.chunk stream into one chat.completion —
    per CHOICE INDEX (n>1 interleaves choices), including
    `delta.tool_calls` and `delta.reasoning_content` from the jailed
    stream (aggregator.rs folds the same three delta kinds)."""
    per: dict[int, dict] = {}

    def empty() -> dict:
        return {"text": [], "tool_calls": [], "reasoning": [],
                "finish": "stop", "lp_content": None}

    def on_choice(i: int, choice: dict) -> None:
        st = per.setdefault(i, empty())
        delta = choice.get("delta", {})
        if delta.get("content"):
            st["text"].append(delta["content"])
        for tc in delta.get("tool_calls") or ():
            tc = dict(tc)
            tc["index"] = len(st["tool_calls"])
            st["tool_calls"].append(tc)
        if delta.get("reasoning_content"):
            st["reasoning"].append(delta["reasoning_content"])
        lp = choice.get("logprobs")
        if lp and lp.get("content"):
            st["lp_content"] = (st["lp_content"] or []) + lp["content"]
        if choice.get("finish_reason"):
            st["finish"] = choice["finish_reason"]

    request_id, model, created, usage = await _fold_chunks(chunks,
                                                           on_choice)
    choices = []
    for i in sorted(per) if per else [0]:
        st = per.get(i, empty())
        one = chat_completion(
            request_id, model, created, "".join(st["text"]), st["finish"],
            usage, tool_calls=st["tool_calls"],
            reasoning="".join(st["reasoning"]),
            logprob_content=st["lp_content"])["choices"][0]
        one["index"] = i
        choices.append(one)
    return {"id": request_id, "object": "chat.completion",
            "created": created, "model": model, "choices": choices,
            "usage": usage}


async def aggregate_completion_stream(chunks: AsyncIterator[dict]) -> dict:
    """Fold text_completion chunk stream into one text_completion — per
    choice index (n>1), keeping token logprobs (a unary logprobs request
    must not silently drop them)."""
    per: dict[int, dict] = {}

    def empty() -> dict:
        return {"text": [], "lps": [], "toks": [], "tops": [],
                "finish": "stop"}

    def on_choice(i: int, choice: dict) -> None:
        st = per.setdefault(i, empty())
        if choice.get("text"):
            st["text"].append(choice["text"])
        lp = choice.get("logprobs")
        if lp and lp.get("token_logprobs"):
            st["lps"].extend(lp["token_logprobs"])
            if lp.get("tokens"):
                st["toks"].extend(lp["tokens"])
            if lp.get("top_logprobs"):
                st["tops"].extend(lp["top_logprobs"])
        if choice.get("finish_reason"):
            st["finish"] = choice["finish_reason"]

    request_id, model, created, usage = await _fold_chunks(chunks,
                                                           on_choice)
    choices = []
    for i in sorted(per) if per else [0]:
        st = per.get(i, empty())
        one = completion_response(
            request_id, model, created, "".join(st["text"]), st["finish"],
            usage, token_logprobs=st["lps"] or None,
            tokens=st["toks"] or None,
            top_logprobs=st["tops"] or None)["choices"][0]
        one["index"] = i
        choices.append(one)
    return {"id": request_id, "object": "text_completion",
            "created": created, "model": model, "choices": choices,
            "usage": usage}


# ---------------------------------------------------------------------------
# /v1/embeddings (the reference's http/service/openai.rs:1125)
# ---------------------------------------------------------------------------


@dataclass
class EmbeddingRequest:
    model: str
    inputs: list                    # each item: text or pre-tokenized ids
    encoding_format: str = "float"

    @classmethod
    def from_dict(cls, d: dict) -> "EmbeddingRequest":
        _require(isinstance(d, dict), "request body must be a JSON object")
        _require(bool(d.get("model")), "'model' is required")
        raw = d.get("input")
        _require(raw is not None and raw != [], "'input' is required")
        if isinstance(raw, str):
            inputs: list = [raw]
        elif isinstance(raw, list) and raw and all(
                isinstance(t, int) for t in raw):
            inputs = [raw]              # one pre-tokenized prompt
        elif isinstance(raw, list):
            for item in raw:
                _require(isinstance(item, str)
                         or (isinstance(item, list) and all(
                             isinstance(t, int) for t in item)),
                         "'input' items must be strings or token arrays")
            inputs = list(raw)
        else:
            raise OpenAIError("'input' must be a string or array")
        fmt = d.get("encoding_format", "float")
        _require(fmt in ("float", "base64"),
                 "'encoding_format' must be 'float' or 'base64'")
        return cls(model=d["model"], inputs=inputs, encoding_format=fmt)


def embedding_response(model: str, embeddings: list[list[float]],
                       prompt_tokens: int,
                       encoding_format: str = "float") -> dict:
    data = []
    for i, vec in enumerate(embeddings):
        if encoding_format == "base64":
            payload: Any = base64.b64encode(
                struct.pack(f"<{len(vec)}f", *vec)).decode()
        else:
            payload = vec
        data.append({"object": "embedding", "index": i,
                     "embedding": payload})
    return {"object": "list", "model": model, "data": data,
            "usage": {"prompt_tokens": prompt_tokens,
                      "total_tokens": prompt_tokens}}


# ---------------------------------------------------------------------------
# /v1/responses (the reference's http/service/openai.rs:766)
# ---------------------------------------------------------------------------


def responses_input_to_messages(body: dict) -> list[dict]:
    """OpenAI Responses `input` (a string or an item array) → chat
    messages, `instructions` first as the system message."""
    raw = body.get("input")
    _require(raw is not None, "'input' is required")
    msgs: list[dict] = []
    if instructions := body.get("instructions"):
        msgs.append({"role": "system", "content": instructions})
    if isinstance(raw, str):
        msgs.append({"role": "user", "content": raw})
        return msgs
    _require(isinstance(raw, list), "'input' must be a string or array")
    for item in raw:
        _require(isinstance(item, dict) and "role" in item,
                 "input items must have a 'role'")
        content = item.get("content", "")
        if isinstance(content, list):  # typed parts: text only
            content = "".join(p.get("text", "") for p in content
                              if isinstance(p, dict))
        msgs.append({"role": item["role"], "content": content})
    return msgs


def response_object(response_id: str, model: str, created: int,
                    status: str, text: str = "",
                    usage: Optional[dict] = None) -> dict:
    out: dict[str, Any] = {
        "id": response_id, "object": "response", "created_at": created,
        "model": model, "status": status, "output": [], "output_text": text,
    }
    if text or status == "completed":
        out["output"] = [{
            "type": "message", "id": f"msg-{response_id}", "status": status,
            "role": "assistant",
            "content": [{"type": "output_text", "text": text,
                         "annotations": []}],
        }]
    if usage is not None:
        out["usage"] = {
            "input_tokens": usage.get("prompt_tokens", 0),
            "output_tokens": usage.get("completion_tokens", 0),
            "total_tokens": usage.get("total_tokens", 0),
        }
    return out


def sse_encode_event(event: str, payload: dict) -> bytes:
    """A Responses-API SSE frame: a typed `event:` line, then the data."""
    return (b"event: " + event.encode() + b"\ndata: "
            + json.dumps(payload, separators=(",", ":")).encode() + b"\n\n")


async def aggregate_responses_stream(events: AsyncIterator[dict]) -> dict:
    """Unary /v1/responses: the final `response.completed` event carries
    the whole response object."""
    last: Optional[dict] = None
    async for ev in events:
        if ev.get("type") in ("response.completed", "response.failed"):
            last = ev.get("response")
    if last is None:
        raise OpenAIError("stream ended without response.completed",
                          status=500, err_type="internal_error")
    return last
