"""The engine-facing serving extras of the port against the JAX package:
embeddings, n > 1, the Responses API and the deadline admission drop.

- `embed_batch` (models/llama.py) against the reference's on the same
  fp32 weights and padded batch: within 2e-5, padded lanes included;
  the engine's `extra.embed` answer against `TpuEngine`'s.
- Over HTTP, a tiny fp32 Llama served by the reference's frontend over a
  `TpuEngine` worker and by the port's stdlib frontend over a
  `TorchEngine` worker with the same weights: `/v1/embeddings` (one
  string, a batch with token arrays, base64) and its over-context
  refusal; chat and completions with n = 3 (seeded, streamed and unary:
  three choices with distinct seeds, each equal to the reference's
  choice of the same index, one trailing usage chunk with no choices);
  n = 17 is the same 400; `/v1/responses` streamed (typed events) and
  unary. Bodies are compared after normalizing ids and timestamps, the
  floats (embeddings, logprobs) within 2e-5.
- A queued request whose `Context.deadline` has passed ends with
  `DEADLINE_ADMIT_ERR`, as in `TpuEngine`, and costs no prefill.
"""

import asyncio
import base64
import json
import re
import struct

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.llm import entrypoint as ref_entry
from dynamo_tpu.llm import model_card as ref_card
from dynamo_tpu.models import llama as jl
from dynamo_tpu.protocols import DEADLINE_ADMIT_ERR as REF_DEADLINE_ERR
from dynamo_tpu.runtime import config as ref_config
from dynamo_tpu.runtime import distributed as ref_dist
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.llm import entrypoint as t_entry
from dynamo_tpu_torch.llm import model_card as t_card
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.protocols import DEADLINE_ADMIT_ERR
from dynamo_tpu_torch.runtime import config as t_config
from dynamo_tpu_torch.runtime import distributed as t_dist
from dynamo_tpu_torch.runtime.context import Context
from tests.test_torch_serving import (
    _card,
    _engines,
    _renew_lease,
    call,
    default_impl,  # noqa: F401
)

TOL = 2e-5
_FLOAT = re.compile(rb"-?\d+\.\d+(?:e-?\d+)?")


def _models():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    params = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    return jcfg, params, params_from_jax(jax.tree.map(np.asarray, params),
                                         tcfg, "cpu")


def test_embed_batch_matches_reference_with_padded_lanes():
    jcfg, params, model = _models()
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 256, (4, 16)).astype(np.int32)
    lengths = np.array([16, 5, 1, 11], np.int32)
    toks[np.arange(16)[None, :] >= lengths[:, None]] = 0   # padding
    want = np.asarray(jl.embed_batch(params, jnp.asarray(toks),
                                     jnp.asarray(lengths), jcfg))
    got = tl.embed_batch(model, torch.from_numpy(toks),
                         torch.from_numpy(lengths)).numpy()
    assert got.shape == (4, 64)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


async def test_engine_embeddings_and_refusal_match_tpu_engine():
    jcfg, params, model = _models()
    kw = dict(num_pages=32, max_batch_size=2, min_prefill_bucket=8)
    jax_eng = TpuEngine(TpuEngineConfig(model=jcfg, **kw), params=params)
    torch_eng = TorchEngine(TorchEngineConfig(
        model=model.cfg, device="cpu", **kw), model=model)

    async def ask(eng, ids):
        ctx = JaxContext() if isinstance(eng, TpuEngine) else Context()
        req = {"token_ids": ids, "model": "m", "stop": {"max_tokens": 1},
               "extra": {"embed": True}}
        return [o async for o in eng.generate(req, ctx)]

    try:
        for ids in ([5, 6, 7], list(range(1, 30)), list(range(65))):
            want = await ask(jax_eng, ids)
            got = await ask(torch_eng, ids)
            assert len(got) == len(want) == 1
            assert got[0]["finish_reason"] == want[0]["finish_reason"]
            if "embedding" in want[0]:
                np.testing.assert_allclose(got[0]["embedding"],
                                           want[0]["embedding"], atol=TOL)
            else:       # 65 tokens > the 64-token context: refused first
                assert got[0]["extra"] == want[0]["extra"]
        assert torch_eng.rounds == 0           # no paged step ran
    finally:
        await jax_eng.close()
        await torch_eng.close()


async def test_deadline_passed_while_queued_drops_at_admission():
    """One slot: the second request waits behind the first; its deadline
    passes while it is queued, and admission drops it with the
    reference's error and no prefill."""
    assert DEADLINE_ADMIT_ERR == REF_DEADLINE_ERR
    jcfg, params, model = _models()
    kw = dict(num_pages=32, max_batch_size=1, min_prefill_bucket=8,
              decode_steps_per_sync=2)
    engines = (TpuEngine(TpuEngineConfig(model=jcfg, **kw), params=params),
               TorchEngine(TorchEngineConfig(model=model.cfg, device="cpu",
                                             **kw), model=model))
    results = []
    for eng in engines:
        mk = JaxContext if isinstance(eng, TpuEngine) else Context

        async def one(ids, ctx, n=12):
            req = {"token_ids": ids, "model": "m",
                   "sampling": {"temperature": 0.0},
                   "stop": {"max_tokens": n}}
            return [o async for o in eng.generate(req, ctx)]

        try:
            first = asyncio.ensure_future(one([1, 2, 3], mk()))
            await asyncio.sleep(0)
            late = mk()
            late.deadline = asyncio.get_running_loop().time() + 0.01
            second = await one(list(range(10, 30)), late)
            await first
        finally:
            await eng.close()
        results.append(second)
        if isinstance(eng, TorchEngine):
            # only the first request's prompt was prefilled
            assert eng.metrics.prefill_chunk.count == 1
            assert eng.pool.active_pages == 0
    assert results[1] == results[0]
    assert results[1][-1]["finish_reason"] == "error"
    assert results[1][-1]["extra"]["error"] == DEADLINE_ADMIT_ERR


# -- over HTTP ----------------------------------------------------------------


def _norm(body: bytes) -> bytes:
    body = re.sub(rb'"(chatcmpl|cmpl|resp|msg-resp|embd)-[0-9a-f]+"',
                  rb'"\1-ID"', body)
    body = re.sub(rb'"(created|created_at)": ?\d+', rb'"\1":0', body)
    return body


def _same(got: tuple, want: tuple) -> None:
    (gs, gt, gb), (ws, wt, wb) = got, want
    assert (gs, gt) == (ws, wt)
    gb, wb = _norm(gb), _norm(wb)
    assert _FLOAT.sub(b"F", gb) == _FLOAT.sub(b"F", wb), (gb, wb)
    gf = [float(x) for x in _FLOAT.findall(gb)]
    wf = [float(x) for x in _FLOAT.findall(wb)]
    assert np.allclose(gf, wf, rtol=0, atol=TOL), (gf, wf)


def _sse(body: bytes) -> list:
    assert body.endswith(b"data: [DONE]\n\n")
    return [json.loads(e[6:]) for e in body.split(b"\n\n")[:-2]]


def _by_choice(events: list) -> dict:
    """Streamed chunks of an n > 1 request, per choice index, in order;
    the trailing usage chunk under None."""
    per: dict = {}
    for c in events:
        if not c["choices"]:
            per[None] = c["usage"]
        for ch in c["choices"]:
            per.setdefault(ch["index"], []).append(
                (ch.get("delta") or {}).get("content") or ch.get("text"))
    return per


def _typed_events(body: bytes) -> list:
    out = []
    for frame in body.split(b"\n\n")[:-1]:
        ev, data = frame.split(b"\n", 1)
        assert ev.startswith(b"event: ") and data.startswith(b"data: ")
        out.append((ev[7:].decode(), json.loads(data[6:])))
    return out


def test_extras_over_http_identical_to_jax_package(default_impl):
    jax_eng, torch_eng = _engines()
    msgs = [{"role": "user", "content": "hello world"}]
    chat_n = {"model": "tiny", "messages": msgs, "max_tokens": 6,
              "temperature": 0.9, "seed": 5, "n": 3}
    cmpl_n = {"model": "tiny", "prompt": "the quick brown", "max_tokens": 5,
              "temperature": 0.8, "seed": 9, "n": 3}
    unary = [
        ("/v1/embeddings", {"model": "tiny", "input": "hello there"}),
        ("/v1/embeddings", {"model": "tiny",
                            "input": ["one", [5, 6, 7, 8], "three"]}),
        ("/v1/embeddings", {"model": "tiny", "input": [1, 2, 3],
                            "encoding_format": "base64"}),
        ("/v1/embeddings", {"model": "tiny", "input": "x" * 80}),
        ("/v1/chat/completions", chat_n),
        ("/v1/completions", cmpl_n),
        ("/v1/chat/completions", dict(chat_n, n=17)),
        ("/v1/completions", dict(cmpl_n, n=0)),
        ("/v1/responses", {"model": "tiny", "input": "hi there",
                           "instructions": "be brief",
                           "max_output_tokens": 6, "temperature": 0}),
    ]
    streamed = [("/v1/chat/completions", dict(chat_n, stream=True)),
                ("/v1/completions", dict(cmpl_n, stream=True)),
                ("/v1/responses", {"model": "tiny", "stream": True,
                                   "input": [{"role": "user",
                                              "content": "hi there"}],
                                   "max_output_tokens": 6,
                                   "temperature": 0})]

    async def main():
        ref_rt = await ref_dist.DistributedRuntime.create(
            ref_config.RuntimeConfig())
        renew = asyncio.ensure_future(_renew_lease(ref_rt))
        t_rt = await t_dist.DistributedRuntime.create(
            t_config.RuntimeConfig())
        handles, fes = [], []
        try:
            handles.append(await ref_entry.serve_engine(
                ref_rt, jax_eng, _card(ref_card, "tiny", "backend")))
            handles.append(await t_entry.serve_engine(
                t_rt, torch_eng, _card(t_card, "tiny", "backend")))
            fes.append(await ref_entry.start_frontend(ref_rt, port=0))
            fes.append(await t_entry.start_frontend(t_rt, port=0))
            out = []
            for path, body in unary + streamed:
                out.append([await call(fe.http.port, "POST", path, body)
                            for fe in fes])
            return out
        finally:
            renew.cancel()
            for fe in fes:
                await fe.stop()
            for h in handles:
                await h.stop()
            await jax_eng.close()
            await torch_eng.close()
            await ref_rt.close()
            await t_rt.close()

    out = asyncio.run(asyncio.wait_for(main(), 120))
    for (want, got), (path, body) in zip(out[:len(unary)], unary):
        if body.get("encoding_format") == "base64":
            # little-endian fp32 bytes: equal within TOL once decoded
            w, g = (json.loads(r[2])["data"][0].pop("embedding")
                    for r in (want, got))
            np.testing.assert_allclose(
                struct.unpack("<64f", base64.b64decode(g)),
                struct.unpack("<64f", base64.b64decode(w)), atol=TOL)
            continue
        _same(got, want)
    statuses = [w[0] for w, _ in out[:len(unary)]]
    assert statuses == [200, 200, 200, 400, 200, 200, 400, 400, 200]
    emb = json.loads(out[0][1][2])
    assert len(emb["data"][0]["embedding"]) == 64
    b64 = json.loads(out[2][1][2])["data"][0]["embedding"]
    assert len(struct.unpack("<64f", base64.b64decode(b64))) == 64
    chat = json.loads(out[4][1][2])
    assert [c["index"] for c in chat["choices"]] == [0, 1, 2]
    texts = [c["message"]["content"] for c in chat["choices"]]
    assert len(set(texts)) > 1                 # distinct seeds per choice
    assert b"between 1 and 16" in out[6][1][2]
    # streamed n = 3: per choice, the same chunks; one usage chunk last
    for (want, got) in out[len(unary):len(unary) + 2]:
        assert got[0] == want[0] == 200
        w_ev, g_ev = _sse(want[2]), _sse(got[2])
        assert _by_choice(g_ev) == _by_choice(w_ev)
        assert sorted(k for k in _by_choice(g_ev) if k is not None) == \
            [0, 1, 2]
        assert g_ev[-1]["choices"] == [] and g_ev[-1]["usage"]
        assert sum(1 for e in g_ev if not e["choices"]) == 1
    want, got = out[-1]
    assert got[:2] == want[:2] == (200, "text/event-stream")
    w_ev, g_ev = (_typed_events(_norm(b)) for b in (want[2], got[2]))
    assert [e for e, _ in g_ev] == [e for e, _ in w_ev]
    assert [e for e, _ in g_ev][0] == "response.created"
    assert [e for e, _ in g_ev][-1] == "response.completed"
    assert g_ev == w_ev
