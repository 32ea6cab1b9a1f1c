"""Speculative decoding in the port's engine against `TpuEngine` with the
same draft, on the CPU in fp32: the cases of tests/test_spec_decode.py,
both engines fed the same requests.

The load-bearing property is the reference's: greedy spec output equals
the target-only greedy stream for ANY draft (accepted tokens are target
argmaxes, and so is the extra token), so a random draft tests rollback and
the stale KV it leaves. Beyond it, seeded stochastic streams and
`SpecDecodeStats` equal the reference's, since the port draws the same
bits. Covered: a random draft and a self-draft; greedy, seeded, nucleus,
min_p, penalties and guided lanes with plain ones in one burst; top-k
logprobs; the budgeted prefill (draft_pos 0, then the catch-up); bursts
served without speculating (`spec_shrink`), then the catch-up; near the
context limit; a page geometry that differs; w8a8 with the reference on
its Pallas kernels in interpret mode; a KVBM-onboarded prefix (the draft
prefills the full prompt); the compile-tracker keys ("spec_decode",
"prefill_draft") and the published ForwardPassMetrics.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import attention as jattn
from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.kvbm import KvbmConfig, KvbmManager
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_jax
from tests.test_torch_engine import _ctx
from tests.test_torch_quant import GATED, jax_kernels  # noqa: F401

TOKEN_BYTES = [bytes([i]) for i in range(256)]
PROMPT = [1, 2, 3, 4, 5, 6, 7]
KW = dict(num_pages=96, max_batch_size=2, default_max_tokens=24,
          decode_steps_per_sync=4, spec_gamma=3, spec_iters_per_sync=2,
          prefill_chunk=32, min_prefill_bucket=8)


@pytest.fixture(autouse=True)
def phase_impl():
    """The reference's phase path ("auto" on the CPU), restored after."""
    prev = jattn._impl
    jattn.set_attention_impl("auto")
    yield
    jattn.set_attention_impl(prev)


def _engines(draft="random", gated=False, **kw):
    """(TpuEngine, TorchEngine) with the same fp32 target and draft
    weights: draft "random" (seed 99), "self" (the target's weights, its
    own caches) or None (no draft)."""
    extra = GATED if gated else {}
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, **extra)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, **extra)
    params = jl.init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    jd = td = None
    if draft == "random":
        jd = jl.init_params(jax.random.PRNGKey(99), jcfg)
        td = params_from_jax(jax.tree.map(np.asarray, jd), tcfg, "cpu")
    elif draft == "self":
        jd, td = params, model
    cfg = {**KW, **kw}
    jax_eng = TpuEngine(TpuEngineConfig(
        model=jcfg, draft_model=jcfg if draft else None, **cfg),
        params=params, draft_params=jd, token_bytes=TOKEN_BYTES,
        eos_token_id=0)
    torch_eng = TorchEngine(TorchEngineConfig(
        model=tcfg, draft_model=tcfg if draft else None, device="cpu",
        **cfg), model=model, draft=td, token_bytes=TOKEN_BYTES,
        eos_token_id=0)
    return jax_eng, torch_eng


def _req(prompt=PROMPT, max_tokens=24, stop=(), topk=0, **sampling):
    return {"token_ids": list(prompt), "model": "m",
            "sampling": {"temperature": 0.0, "top_logprobs": topk,
                         **sampling},
            "stop": {"max_tokens": max_tokens,
                     "stop_token_ids": list(stop)}}


async def _run(eng, request):
    toks, lps, tops, finish = [], [], [], None
    async for o in eng.generate(request, _ctx(eng)):
        toks += o.get("token_ids", [])
        lps += o.get("log_probs") or []
        tops += o.get("top_logprobs") or []
        finish = o.get("finish_reason") or finish
    return toks, lps, tops, finish


async def _serve(eng, requests):
    """All requests at once; their (tokens, logprobs, top-k, finish)."""
    try:
        return await asyncio.gather(*(_run(eng, r) for r in requests))
    finally:
        await eng.close()


def _stats(eng):
    st = eng._spec_stats
    return (st.num_draft_tokens, st.num_accepted_tokens)


async def _both(requests, draft="random", **kw):
    jax_eng, torch_eng = _engines(draft, **kw)
    want = await _serve(jax_eng, requests)
    got = await _serve(torch_eng, requests)
    return want, got, jax_eng, torch_eng


def _same(got, want):
    for (gt, gl, gk, gf), (wt, wl, wk, wf) in zip(got, want):
        assert gt == wt and gf == wf
        np.testing.assert_allclose(gl, wl, atol=1e-4, rtol=0)
        assert [[a for a, _ in e] for e in gk] == \
            [[a for a, _ in e] for e in wk]


@pytest.mark.parametrize("draft", ["random", "self"])
async def test_greedy_spec_equals_tpu_engine_and_target_only(draft):
    want, got, jax_eng, torch_eng = await _both([_req()], draft)
    _same(got, want)
    assert _stats(torch_eng) == _stats(jax_eng)
    assert torch_eng._spec_stats.num_draft_tokens > 0
    _, plain = _engines(None)
    base = await _serve(plain, [_req()])
    assert got[0][0] == base[0][0]             # the draft changes no token
    if draft == "self":
        assert torch_eng._spec_stats.acceptance_rate > 0.8
    assert torch_eng.pool.active_pages == 0


@pytest.mark.parametrize("sampling,draft", [
    ({"temperature": 0.8, "seed": 7}, "random"),
    ({"temperature": 0.8, "seed": 7}, "self"),
    ({"temperature": 0.8, "top_p": 0.5, "seed": 3}, "self"),
    ({"temperature": 0.8, "min_p": 0.2, "seed": 3}, "random"),
    ({"temperature": 0.7, "top_k": 5, "seed": 21}, "self")],
    ids=["seeded-random", "seeded-self", "nucleus-self", "min_p-random",
         "top_k-self"])
async def test_stochastic_spec_streams_and_stats_equal(sampling, draft):
    want, got, jax_eng, torch_eng = await _both(
        [_req(max_tokens=20, **sampling)], draft)
    _same(got, want)
    assert len(got[0][0]) == 20
    assert _stats(torch_eng) == _stats(jax_eng)
    if draft == "self":
        assert torch_eng._spec_stats.acceptance_rate > 0.8


async def test_penalties_guided_and_plain_lanes_in_one_burst():
    requests = [
        _req(prompt=[9, 8, 7], max_tokens=12, temperature=0.7, seed=11,
             repetition_penalty=1.2, frequency_penalty=0.3),
        _req(prompt=[1, 2, 3], max_tokens=12, stop=[0],
             guided={"regex": "[a-f]{10}"}),
        _req(max_tokens=16, topk=3),
        _req(prompt=[4, 5], max_tokens=8, stop=[0], temperature=0.7,
             seed=5, guided={"choice": ["abcd", "wxyz"]})]
    want, got, jax_eng, torch_eng = await _both(requests, max_batch_size=4)
    _same(got, want)
    assert _stats(torch_eng) == _stats(jax_eng)
    body = bytes(t for t in got[1][0] if t != 0)
    assert len(body) == 10 and all(97 <= c <= 102 for c in body)
    assert bytes(t for t in got[3][0] if t != 0) in (b"abcd", b"wxyz")


async def test_greedy_penalties_equal_the_constrained_engine():
    sampling = dict(repetition_penalty=1.3, frequency_penalty=0.2,
                    presence_penalty=0.1)
    _, spec = _engines("random")
    _, plain = _engines(None)
    got = await _serve(spec, [_req(**sampling)])
    base = await _serve(plain, [_req(**sampling)])
    assert got[0][0] == base[0][0]
    assert spec._spec_stats.num_draft_tokens > 0


async def test_topk_logprobs_ride_the_spec_burst():
    """Top-k lanes speculate; the alternatives equal the reference's spec
    engine's, and the plain burst's by value wherever both name an id
    (the spec burst orders alternatives closer than a bf16 ulp by index,
    `stable_topk_logprobs`, the plain one by exact value)."""
    want, got, jax_eng, spec = await _both([_req(max_tokens=12, topk=3)],
                                           "self")
    _same(got, want)
    _, plain = _engines(None)
    base = await _serve(plain, [_req(max_tokens=12, topk=3)])
    assert got[0][0] == base[0][0]
    assert spec._spec_stats.num_accepted_tokens > 0
    for st, bt, t in zip(got[0][2], base[0][2], got[0][0]):
        bvals = dict(bt)
        common = [a for a, _ in st if a in bvals]
        assert len(common) >= 2 and st[0][0] == t == bt[0][0]
        np.testing.assert_allclose([dict(st)[a] for a in common],
                                   [bvals[a] for a in common], atol=1e-4)


async def test_budgeted_prefill_catches_the_draft_up():
    """prefill_chunk_budget > 0: the draft's caches see no prompt chunk
    (draft_pos 0), and the first spec burst's catch-up replays it through
    "prefill_draft" rounds; streams still equal the reference's."""
    requests = [_req(prompt=list(range(3, 40)), max_tokens=16),
                _req(prompt=list(range(50, 61)), max_tokens=12,
                     temperature=0.9, seed=4)]
    want, got, jax_eng, torch_eng = await _both(requests,
                                                prefill_chunk_budget=8)
    _same(got, want)
    assert _stats(torch_eng) == _stats(jax_eng)
    assert any(e == "prefill_draft"
               for e, _ in torch_eng.compile_tracker._seen)
    assert torch_eng.compile_tracker._seen == jax_eng.metrics.compile._seen


async def test_catchup_after_bursts_that_did_not_speculate():
    """`spec_shrink` serves plain bursts, which write target KV only; once
    it is off, the catch-up replays those positions through the draft
    and the greedy stream is still the target-only one."""
    _, plain = _engines(None)
    base = await _serve(plain, [_req(max_tokens=40)])
    _, eng = _engines("random", default_max_tokens=40)
    eng.spec_shrink = True
    seen = []

    async def run():
        toks = []
        async for o in eng.generate(_req(max_tokens=40), _ctx(eng)):
            toks += o.get("token_ids", [])
            seen.append(len(toks))
            if len(toks) >= 8:
                eng.spec_shrink = False
        return toks

    try:
        toks = await run()
    finally:
        await eng.close()
    assert toks == base[0][0]
    assert eng._spec_stats.num_draft_tokens > 0
    shapes = [s for e, s in eng.compile_tracker._seen
              if e == "prefill_draft"]
    assert shapes, "the catch-up ran no draft round"


async def test_near_max_context_is_budgeted_for_the_spec_burst():
    """The admission guard budgets spec_iters x (gamma + 1) positions: the
    longest admissible prompt decodes to its length, one more token is
    refused (as the reference)."""
    kw = dict(max_batch_size=1, default_max_tokens=8,
              spec_iters_per_sync=6)
    ctx_len = 4 * 16
    prompt = [(i % 250) + 1 for i in range(ctx_len - 6 * 4 - 8)]
    for eng in _engines("random", **kw):
        try:
            outs = await _run(eng, _req(prompt=prompt, max_tokens=8))
            assert outs[3] == "length" and len(outs[0]) == 8
            outs = await _run(eng, _req(prompt=prompt + [1], max_tokens=8))
            assert outs[3] == "error"
        finally:
            await eng.close()


def test_draft_geometry_mismatch_raises():
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    with pytest.raises(ValueError, match="page geometry"):
        TorchEngine(TorchEngineConfig(
            model=cfg, device="cpu",
            draft_model=tl.LlamaConfig.tiny(page_size=8)))
    with pytest.raises(ValueError, match=">= 1"):
        TorchEngine(TorchEngineConfig(model=cfg, device="cpu",
                                      draft_model=cfg, spec_gamma=0))


async def test_w8a8_spec_equals_tpu_engine(jax_kernels):
    """Target and draft quantized by their engines (w8a8); the reference's
    projections on its A8 Pallas kernels in interpret mode."""
    want, got, jax_eng, torch_eng = await _both(
        [_req(max_tokens=8), _req(prompt=[9, 8, 7], max_tokens=8,
                                  temperature=0.8, seed=2)],
        gated=True, quantize="w8a8")
    assert [g[0] for g in got] == [w[0] for w in want]
    assert _stats(torch_eng) == _stats(jax_eng)
    assert torch_eng.draft.layers[0].w_down is not None
    assert type(torch_eng.draft.layers[0].w_down).__name__ == "QTensor"


async def test_kvbm_onboarded_prefix_with_a_draft():
    """A prefix onboarded from KVBM's host tier holds target KV only: the
    draft prefills the FULL prompt, so the revisit's greedy stream equals
    the cold one and the no-draft engine's."""
    kw = dict(num_pages=12, max_batch_size=2, default_max_tokens=6,
              spec_iters_per_sync=1)
    _, eng = _engines("random", **kw)
    mgr = KvbmManager(eng, KvbmConfig(host_blocks=64))
    prompt = list(range(20, 36))
    try:
        first = await _run(eng, _req(prompt=prompt, max_tokens=6))
        for base in (60, 90, 120):
            await _run(eng, _req(prompt=list(range(base, base + 16)),
                                 max_tokens=6))
        again = await _run(eng, _req(prompt=prompt, max_tokens=6))
    finally:
        await eng.close()
    assert mgr.stats.onboarded > 0
    assert again[0] == first[0]
    _, plain = _engines(None, **kw)
    base = await _serve(plain, [_req(prompt=prompt, max_tokens=6)])
    assert first[0] == base[0][0]


async def test_spec_compile_keys_and_published_metrics():
    """The "spec_decode" key is the reference's (b, gamma, iters, tk,
    sorted extras); ForwardPassMetrics carries the SpecDecodeStats and the
    scrape its two counters."""
    published = []
    _, eng = _engines("random")
    eng.metrics_sink = published.append
    await _serve(eng, [_req(max_tokens=10, topk=2, min_p=0.1,
                            temperature=0.5, seed=1)])
    keys = [s for e, s in eng.compile_tracker._seen if e == "spec_decode"]
    assert keys == [(2, 3, 2, 8, "min_p")]
    last = published[-1].to_dict()["spec_decode_stats"]
    assert last["num_draft_tokens"] == eng._spec_stats.num_draft_tokens > 0
    assert eng.metrics.spec_draft_tokens.get() == last["num_draft_tokens"]
    assert eng.metrics.spec_accepted_tokens.get() == \
        last["num_accepted_tokens"]
