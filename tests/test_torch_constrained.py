"""Constrained sampling in the port — guided decoding, min_p and the
sampling penalties — against the JAX package on the same inputs.

- The constrained head of engine/sampling.py (`filtered_probs`,
  `apply_penalties`, `stop_token_mask`, `guided_allow`,
  `constrained_logits`, `stable_topk_logprobs`) against the reference's on
  seeded numpy inputs: masks and ids exact, fp32 values within 1e-6.
- `decode_multi_step_guided` at `LlamaConfig.tiny` in fp32 (the reference
  on its CPU path, as tests/test_torch_phase.py runs `decode_multi_step`):
  sampled tokens identical, logprobs within 1e-5; the burst writes none of
  its inputs.
- `TorchEngine` against `TpuEngine` (fp32 weights carried across by
  `params_from_jax`, the byte vocabulary, EOS 0) on the phase path and on
  the ragged path, under the budgeted scheduler: token streams and finish
  reasons identical for every lane kind — choice, a regex across several
  bursts, JSON mode, seeded stochastic guided, guided and free lanes in
  one batch, each penalty, min_p, the constrained first token, eviction
  and re-registration of a grammar, and guided without a vocabulary (a
  clean error).
"""

import asyncio
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import attention as jattn
from dynamo_tpu.engine import sampling as js
from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.llm import guided as jg
from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.engine import sampling as ts
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.llm import guided as tg
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.protocols import PreprocessedRequest
from dynamo_tpu_torch.runtime.context import Context
from tests.test_torch_engine import _ctx
from tests.test_torch_phase import (
    _assert_rows,
    _burst_args,
    _caches,
    _setup,
    _torch,
    _written,
)

TOKEN_BYTES = [bytes([i]) for i in range(256)]
EOS = 0
V = 256

# -- the constrained head -----------------------------------------------------


def _head_inputs(seed: int, b: int = 6, v: int = 300):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    logits[0, 5:9] = logits[0, 4]                       # exact ties
    pc = rng.integers(0, 3, (b, v)).astype(np.int32) \
        * (rng.random((b, v)) < 0.1)
    oc = rng.integers(0, 4, (b, v)).astype(np.int32) \
        * (rng.random((b, v)) < 0.1)
    rep = np.array([1.0, 1.3, 0.8, 1.0, 2.0, 1.1], np.float32)[:b]
    freq = np.array([0.0, 0.5, 0.0, 1.2, -0.3, 0.1], np.float32)[:b]
    pres = np.array([0.0, 0.0, 0.7, 1.5, 0.2, -0.4], np.float32)[:b]
    return rng, logits, pc.astype(np.int32), oc.astype(np.int32), rep, \
        freq, pres


def _stack(tables_list, v):
    """The reference engine's (G, S) stack: slot 0 all-allowed, then each
    grammar, padded to powers of two."""
    g = 1
    while g < len(tables_list) + 1:
        g *= 2
    s = 1
    while s < max(t.num_states for t in tables_list):
        s *= 2
    bv = (v + 7) // 8
    bits = np.zeros((g, s, bv), np.uint8)
    nxt = np.zeros((g, s, v), np.int16)
    eos = np.zeros((g, s), bool)
    bits[0] = 0xFF
    for i, t in enumerate(tables_list, start=1):
        n = t.num_states
        bits[i, :n] = t.allowed_bits
        nxt[i, :n] = t.next_state
        eos[i, :n] = t.eos_ok
    return bits, nxt, eos


@pytest.fixture(scope="module")
def grammars():
    specs = [{"choice": ["ab", "ba", "abc"]}, {"regex": "[a-d]+x?"},
             {"regex": r"\d{2,3}"}]
    return [tg.compile_guided(s, TOKEN_BYTES) for s in specs]


def test_filtered_probs_matches_reference():
    rng, logits, *_ = _head_inputs(0)
    b = logits.shape[0]
    temp = np.array([0.0, 0.7, 1.0, 1.5, 0.3, 2.0], np.float32)
    top_p = np.array([1.0, 0.9, 0.5, 1.0, 0.0, 0.95], np.float32)
    top_k = np.array([0, 0, 5, 40, 0, 3], np.int32)
    for min_p in (None, np.array([0.0, 0.1, 0.0, 0.3, 0.5, 0.05],
                                 np.float32)):
        want = np.asarray(js.filtered_probs(
            *map(jnp.asarray, (logits, temp, top_p, top_k)),
            None if min_p is None else jnp.asarray(min_p)))
        got = ts.filtered_probs(
            *map(torch.from_numpy, (logits, temp, top_p)),
            torch.from_numpy(top_k).long(),
            None if min_p is None else torch.from_numpy(min_p)).numpy()
        assert got.shape == want.shape == (b, logits.shape[1])
        assert np.array_equal(got > 0, want > 0)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert got[0].max() == 1.0 and (got[0] > 0).sum() == 1


def test_apply_penalties_matches_reference():
    _, logits, pc, oc, rep, freq, pres = _head_inputs(1)
    want = np.asarray(js.apply_penalties(*map(jnp.asarray, (
        logits, pc, oc, rep, freq, pres))))
    got = ts.apply_penalties(*map(torch.from_numpy, (
        logits, pc, oc, rep, freq, pres))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert np.array_equal(got[0], logits[0] - 0.0)      # no-op lane


def test_stop_token_mask_matches_reference():
    stop_ids = np.array([[0, -1, -1], [5, 299, -1], [-1, -1, -1],
                         [7, 7, 8]], np.int32)
    want = np.asarray(js.stop_token_mask(jnp.asarray(stop_ids), 300))
    got = ts.stop_token_mask(torch.from_numpy(stop_ids), 300).numpy()
    assert got.dtype == want.dtype == np.bool_
    assert np.array_equal(got, want)


def _allow_inputs(grammars, seed):
    rng = np.random.default_rng(seed)
    bits, nxt, eos = _stack(grammars, V)
    b = 6
    g_ids = np.array([0, 1, 2, 3, 1, 2], np.int32)
    states = np.array([rng.integers(0, max(1, grammars[g - 1].num_states))
                       if g else 0 for g in g_ids], np.int32)
    states[1] = 0
    stop_ids = np.full((b, 8), -1, np.int32)
    stop_ids[:, 0] = EOS
    stop_ids[2, 1] = 97
    is_stop = np.asarray(js.stop_token_mask(jnp.asarray(stop_ids), V))
    return bits, nxt, eos, g_ids, states, stop_ids, is_stop


def test_guided_allow_matches_reference(grammars):
    bits, _, eos, g_ids, states, _, is_stop = _allow_inputs(grammars, 2)
    want = np.asarray(js.guided_allow(*map(jnp.asarray, (
        bits, eos, g_ids, states, is_stop))))
    got = ts.guided_allow(*map(torch.tensor, (
        bits, eos, g_ids, states, is_stop))).numpy()
    assert np.array_equal(got, want)
    assert got[0].all()                                  # trivial grammar
    assert got[1, ord("a")] and got[1, ord("b")] and not got[1, ord("c")]


def test_constrained_logits_matches_reference(grammars):
    bits, _, eos, g_ids, states, _, is_stop = _allow_inputs(grammars, 3)
    _, logits, pc, oc, rep, freq, pres = _head_inputs(3, v=V)
    args = (logits, pc, oc, rep, freq, pres, bits, eos, g_ids, states,
            is_stop)
    want = np.asarray(js.constrained_logits(*map(jnp.asarray, args)))
    got = ts.constrained_logits(*map(torch.tensor, args)).numpy()
    assert np.array_equal(got == -1e30, want == -1e30)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("k", [1, 8])
def test_stable_topk_logprobs_matches_reference(k):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((5, 3, 200)).astype(np.float32) * 2
    # near-ties below a bf16 ulp, and exact ties: order by lowest index
    logits[..., 10] = logits[..., 3] + 1e-6
    logits[..., 50:60] = logits[..., 49:50]
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    want_ids, want_vals = map(np.asarray, js.stable_topk_logprobs(
        jnp.asarray(logp), k))
    got_ids, got_vals = (t.numpy() for t in ts.stable_topk_logprobs(
        torch.from_numpy(logp), k))
    assert got_ids.dtype == np.float32
    assert np.array_equal(got_ids, want_ids)
    assert np.array_equal(got_vals, want_vals)


# -- the constrained burst ----------------------------------------------------


@pytest.mark.parametrize("topk_lp", [0, 8])
@pytest.mark.parametrize("seeded", [False, True], ids=["greedy", "seeded"])
def test_decode_multi_step_guided_fp32_matches_jax(grammars, seeded,
                                                   topk_lp):
    jcfg, tcfg, params, model = _setup("float32", 4)
    rng = np.random.default_rng(5)
    args = _burst_args(rng, tcfg, [7, 10, 0, 3, 0],
                       [True, True, True, True, False], seeded)
    b = 5
    _, _, pc, oc, rep, freq, pres = _head_inputs(6, b=b, v=V)
    min_p = np.array([0.0, 0.2, 0.1, 0.0, 0.0], np.float32)
    bits, nxt, eos = _stack(grammars, V)
    g_ids = np.array([1, 2, 0, 3, 0], np.int32)
    g_states = np.array([0, 1, 0, 0, 0], np.int32)
    stop_ids = np.full((b, 8), -1, np.int32)
    stop_ids[:, 0] = EOS
    stop_ids[1, 1] = ord("z")
    extra = (min_p, rep, freq, pres, pc, oc, bits, nxt, eos, g_ids,
             g_states, stop_ids)
    kc, vc = _caches(rng, tcfg, "float32")
    k = 4
    j_out, jkc, _ = jl.decode_multi_step_guided(
        params, tuple(map(jnp.asarray, kc)), tuple(map(jnp.asarray, vc)),
        *(jnp.asarray(a) for a in args + extra), cfg=jcfg, num_steps=k,
        topk_lp=topk_lp)
    tkc, tvc = [list(map(_torch, c)) for c in (kc, vc)]
    t_args = [_torch(a) for a in args + extra]
    before = [t.clone() for t in t_args]
    t_out = tl.decode_multi_step_guided(model, tkc, tvc, *t_args,
                                        num_steps=k, topk_lp=topk_lp).numpy()
    for a, c in zip(t_args, before):
        assert torch.equal(a, c)              # no input written
    j_out = np.asarray(j_out)
    assert t_out.shape == j_out.shape == (2 + 2 * topk_lp, k, b)
    valid = args[3]
    assert np.array_equal(t_out[0][:, valid], j_out[0][:, valid])
    np.testing.assert_allclose(t_out[1:][:, :, valid],
                               j_out[1:][:, :, valid], atol=1e-5, rtol=0)
    # the grammar lanes stayed inside their grammars up to their stop
    toks = t_out[0].astype(int)
    lane0 = bytes(toks[:, 0]).split(bytes([EOS]))[0]
    assert any(c.startswith(lane0) for c in (b"ab", b"ba", b"abc"))
    assert set(bytes(toks[:, 1]).split(bytes([EOS]))[0]) <= set(b"abcdx")
    positions = args[1]
    rows = _written(args[2][valid], positions[valid], positions[valid] + k,
                    tcfg.page_size)
    _assert_rows(tkc, jkc, rows)


# -- the engines --------------------------------------------------------------

KW = dict(num_pages=64, max_batch_size=4, prefill_chunk=32,
          min_prefill_bucket=8, default_max_tokens=8,
          decode_steps_per_sync=4, prefill_chunk_budget=12)


@pytest.fixture(params=["phase", "ragged"])
def impl(request):
    """The port's path, and the reference's matching attention impl
    ("auto" is its phase path on the CPU), restored afterwards."""
    prev = jattn._impl
    jattn.set_attention_impl("auto" if request.param == "phase"
                             else "ragged")
    yield request.param
    jattn.set_attention_impl(prev)


def _engines(impl: str, vocab=TOKEN_BYTES, **kw):
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    params = jl.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = {**KW, **kw}
    jax_eng = TpuEngine(TpuEngineConfig(model=jcfg, **cfg), params=params,
                        token_bytes=vocab, eos_token_id=EOS)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    torch_eng = TorchEngine(TorchEngineConfig(
        model=tcfg, device="cpu", attention_impl=impl, **cfg), model=model,
        token_bytes=vocab, eos_token_id=EOS)
    return jax_eng, torch_eng


def _req(sampling, prompt=(10, 20, 30), max_tokens=16, stop=(EOS,)):
    return {"token_ids": list(prompt), "model": "m",
            "sampling": {"temperature": 0.0, **sampling},
            "stop": {"max_tokens": max_tokens,
                     "stop_token_ids": list(stop)}}


async def _run(eng, request):
    toks, finish, error = [], None, None
    async for o in eng.generate(request, _ctx(eng)):
        toks += o.get("token_ids", [])
        finish = o.get("finish_reason") or finish
        error = (o.get("extra") or {}).get("error") or error
    return toks, finish, error


async def _both(impl, requests, concurrent=False, **kw):
    """Streams of `requests` on both engines (one after another, or all
    at once); returns (reference's, port's, port engine)."""
    jax_eng, torch_eng = _engines(impl, **kw)

    async def serve(eng):
        if concurrent:
            return await asyncio.gather(*(_run(eng, r) for r in requests))
        return [await _run(eng, r) for r in requests]

    try:
        want = await serve(jax_eng)
        got = await serve(torch_eng)
    finally:
        await jax_eng.close()
        await torch_eng.close()
    assert torch_eng.pool.active_pages == 0
    return want, got, torch_eng


def _text(toks):
    return bytes(toks[:-1] if toks and toks[-1] == EOS else toks)


def _inside(pattern, toks):
    dfa = tg.compile_regex(pattern)
    s = 0
    for byte in _text(toks):
        s = int(dfa.next[s, byte])
        if s < 0:
            return False
    return True


CASES = {
    "choice": [_req({"guided": {"choice": ["hi", "hey", "hello"]}})],
    "regex-bursts": [_req({"guided": {"regex": "(ab)+c?"}}, max_tokens=13)],
    "json-mode": [_req({"guided": {"json": True}}, max_tokens=24)],
    "json-schema": [_req({"guided": {"json": {
        "type": "object", "properties": {"n": {"type": "integer"}}}}},
        max_tokens=20)],
    "seeded-guided": [_req({"guided": {"regex": "[abc]+"},
                            "temperature": 1.0, "seed": 7}),
                      _req({"guided": {"regex": "[a-f]{3,9}"},
                            "temperature": 0.7, "seed": 11, "top_p": 0.9})],
    "presence": [_req({"presence_penalty": 4.0,
                       "guided": {"regex": "[a-d]{6}"}}),
                 _req({"presence_penalty": 0.8}, prompt=(4, 4, 9))],
    "frequency": [_req({"frequency_penalty": 0.9,
                        "guided": {"regex": "[ab]{8}"}}),
                  _req({"frequency_penalty": 2.0}, prompt=(3, 3, 3))],
    "repetition": [_req({"repetition_penalty": 1.8,
                         "guided": {"regex": "[a-c]{6}"}}, prompt=(99, 99)),
                   _req({"repetition_penalty": 0.7}, prompt=(7, 8, 7))],
    "min-p": [_req({"min_p": 0.15, "temperature": 1.5, "seed": 3}),
              _req({"min_p": 0.3, "temperature": 0.9, "seed": 5,
                    "guided": {"regex": "[a-z]+"}})],
    "first-token": [_req({"guided": {"choice": ["q", "zz"]}}, max_tokens=1),
                    _req({"repetition_penalty": 50.0}, prompt=(4, 63, 36),
                         max_tokens=1),
                    _req({"presence_penalty": 9.0, "seed": 1,
                          "temperature": 0.5}, max_tokens=1)],
}


@pytest.mark.parametrize("case", sorted(CASES))
async def test_streams_identical_to_tpu_engine(impl, case):
    want, got, eng = await _both(impl, CASES[case])
    assert got == want
    assert all(e is None for _, _, e in got)
    for r, (toks, finish, _) in zip(CASES[case], got):
        spec = r["sampling"].get("guided")
        if spec is None:
            continue
        pattern = (tg.choice_regex(spec["choice"]) if "choice" in spec
                   else spec.get("regex") or (
                       tg.json_regex() if spec["json"] is True
                       else tg.json_schema_regex(spec["json"])))
        assert _inside(pattern, toks), (case, toks)
        if finish == "stop":
            assert tg.match_bytes(tg.compile_regex(pattern), _text(toks))
    # every constrained lane went through the constrained burst
    entries = {k[0] for k in eng.compile_tracker._seen}
    assert ("decode_guided" in entries) == any(
        r["stop"]["max_tokens"] > 1 for r in CASES[case])


async def test_penalties_change_the_stream(impl):
    """The penalty cases above are not no-ops: each changes its lane's
    stream against the same request without it."""
    plain = [_req({"guided": {"regex": "[a-d]{6}"}}),
             _req({"guided": {"regex": "[ab]{8}"}}),
             _req({"guided": {"regex": "[a-c]{6}"}}, prompt=(99, 99))]
    penalised = [CASES["presence"][0], CASES["frequency"][0],
                 CASES["repetition"][0]]
    want, got, _ = await _both(impl, plain + penalised)
    assert got == want
    for a, b in zip(got[:3], got[3:]):
        assert a[0] != b[0]
    # presence: no letter repeats while unused ones remain
    assert len(set(_text(got[3][0])[:4])) == 4


async def test_batch_mixes_guided_and_free_lanes(impl):
    """Guided, penalised, min_p and free lanes in one batch, while a long
    prompt is chunked in (the budgeted scheduler runs its rounds alone
    beside constrained lanes)."""
    reqs = [_req({"guided": {"choice": ["yes", "no"]}}),
            _req({}, prompt=(5, 6, 7), max_tokens=10),
            _req({"presence_penalty": 1.2, "guided": {"regex": "[a-e]+"}},
                 max_tokens=12),
            _req({"min_p": 0.2, "temperature": 1.2, "seed": 9},
                 max_tokens=9),
            _req({}, prompt=tuple(range(3, 43)), max_tokens=6)]
    want, got, eng = await _both(impl, reqs, concurrent=True)
    assert got == want
    assert _text(got[0][0]).decode() in ("yes", "no")
    assert len(got[1][0]) == 10 and got[1][1] == "length"
    assert set(_text(got[2][0])) <= set(b"abcde")


async def test_guided_without_vocab_errors_cleanly(impl):
    want, got, eng = await _both(
        impl, [_req({"guided": {"json": True}}, max_tokens=4),
               _req({}, max_tokens=3)], vocab=None)
    assert got == want
    (toks, finish, err), free = got
    assert toks == [] and finish == "error" and "guided" in err
    assert len(free[0]) == 3 and free[2] is None
    assert not eng._guided_tables and not eng._guided_pending


async def test_lazy_vocab_and_stop_width(impl):
    """A callable vocabulary is built once, at the first guided request;
    more stop ids than the grammar mask's width fail the request."""
    calls = []

    def vocab():
        calls.append(1)
        return TOKEN_BYTES

    too_many = _req({"guided": {"regex": "a+"}}, stop=range(9))
    ok = _req({"guided": {"regex": "a+"}}, max_tokens=4)
    jax_eng, torch_eng = _engines(impl)
    torch_eng._guided_vocab = vocab
    try:
        want = [await _run(jax_eng, r) for r in (too_many, ok, ok)]
        got = await asyncio.gather(*(_run(torch_eng, r)
                                     for r in (too_many, ok, ok)))
    finally:
        await jax_eng.close()
        await torch_eng.close()
    assert list(got) == want and calls == [1]
    assert want[0][1] == "error" and "stop token ids" in want[0][2]


async def test_grammar_eviction_and_reregistration(impl):
    """With room for two grammars, a third evicts what no request holds
    and renumbers the slots (the resident rows move); streams stay the
    reference's. A grammar dropped from under a live sequence is
    registered again from the sequence's own tables."""
    specs = [{"choice": ["ab", "abc"]}, {"regex": "[xy]+z"},
             {"regex": "c+d?"}, {"choice": ["ab", "abc"]}]
    reqs = [_req({"guided": s}, max_tokens=10) for s in specs]
    jax_eng, torch_eng = _engines(impl)
    for eng in (jax_eng, torch_eng):
        eng.MAX_GUIDED_GRAMMARS = 2
    try:
        want = [await _run(jax_eng, r) for r in reqs]
        got = []
        for r in reqs:
            got.append(await _run(torch_eng, r))
            assert len(torch_eng._guided_tables) <= 2
        assert got == want
        # both reference and port evicted: the last spec compiled again
        assert sorted(torch_eng._guided_slots.values()) == [1, 2]

        # the backstop: drop a running request's grammar from the cache
        # mid-stream; its next burst registers it again
        async def drop_then_run(eng):
            task = asyncio.create_task(_run(eng, _req(
                {"guided": {"regex": "(ab)+"}}, max_tokens=14)))
            while not any(s.prefilled for s in eng._running):
                await asyncio.sleep(0.001)
            key = eng._guided_key({"regex": "(ab)+"})
            eng._guided_tables.pop(key)
            eng._guided_slots = {k: i + 1 for i, k in
                                 enumerate(eng._guided_tables)}
            return await task

        want_b = await drop_then_run(jax_eng)
        got_b = await drop_then_run(torch_eng)
    finally:
        await jax_eng.close()
        await torch_eng.close()
    assert got_b == want_b and got_b[2] is None
    assert _text(got_b[0]) == b"ab" * (len(_text(got_b[0])) // 2)


async def test_pending_refs_spare_a_grammar_from_eviction():
    """The port's own bookkeeping, as tests/test_guided.py pins the
    reference's: a pending ref keeps a grammar through eviction; without
    refs or requests eviction drops it; a sequence holding evicted tables
    registers them again at its slot lookup."""
    from dynamo_tpu_torch.engine.engine import _Seq

    _, eng = _engines("phase")
    spec = {"choice": ["abc", "xyz"]}
    key = json.dumps(spec, sort_keys=True)
    tables = await eng._compile_guided(spec)
    assert key in eng._guided_tables
    eng._guided_pending[key] = 1
    eng._evict_guided_unused()
    assert key in eng._guided_tables
    eng._guided_unpend(key)
    assert key not in eng._guided_pending
    eng._evict_guided_unused()
    assert key not in eng._guided_tables
    req = PreprocessedRequest.from_dict({
        "token_ids": [10], "model": "m", "sampling": {"guided": spec},
        "stop": {"max_tokens": 1}})
    seq = _Seq(req=req, ctx=Context(), queue=None, token_seq=None,
               prompt=[10], guided=tables)
    slot = eng._guided_slot_of(seq)
    assert slot >= 1 and key in eng._guided_tables
    assert eng._guided_slot_of(seq) == slot
    await eng.close()


def test_resident_tables_written_in_place_and_kept():
    """The packed layout: row 0 all-allowed, each grammar's states at its
    first row with its transitions offset there; a new grammar in the same
    row bucket is written into the same buffers, a larger bucket gets new
    ones and the old stay; a renumbering rewrites only moved grammars."""
    _, eng = _engines("phase")
    compile_ = lambda s: tg.compile_guided(s, TOKEN_BYTES)  # noqa: E731
    small = {"choice": ["ab", "ba"]}
    other = {"regex": "[xy]{2}"}
    big = {"regex": "[a-z]{20}"}
    for i, spec in enumerate((small, other)):
        key = eng._guided_key(spec)
        eng._guided_tables[key] = compile_(spec)
        eng._guided_slots[key] = i + 1
    layout = eng._guided_layout()
    bits, nxt, eos = eng._guided_device_stack(layout)
    rows, placed, first_row = layout
    t_small, t_other = compile_(small), compile_(other)
    used = 1 + t_small.num_states + t_other.num_states
    assert rows >= used > rows // 2 and tuple(bits.shape) == (1, rows, 32)
    assert list(first_row) == [0, 1, 1 + t_small.num_states]
    assert (bits[0, 0] == 0xFF).all() and (nxt[0, 0] == 0).all()
    for (key, row, t) in placed:
        n = t.num_states
        assert np.array_equal(bits[0, row:row + n].numpy(), t.allowed_bits)
        assert np.array_equal(nxt[0, row:row + n].numpy(),
                              t.next_state.astype(np.int32) + row)
        assert np.array_equal(eos[0, row:row + n].numpy(), t.eos_ok)
    # a grammar past the bucket: new buffers, the old ones kept
    key = eng._guided_key(big)
    eng._guided_tables[key] = compile_(big)
    eng._guided_slots[key] = 3
    layout2 = eng._guided_layout()
    bits2, _, _ = eng._guided_device_stack(layout2)
    assert layout2[0] > rows and bits2.shape[1] == layout2[0]
    assert bits2.data_ptr() != bits.data_ptr()
    assert set(eng._guided_buffers) == {rows, layout2[0]}
    assert eng._guided_buffers[rows][0] is bits
    # drop the small grammar: the others move down in their bucket, a new
    # grammar in the same bucket is written into the same buffers
    eng._guided_tables.pop(eng._guided_key(small))
    eng._guided_slots = {k: i + 1 for i, k in enumerate(eng._guided_tables)}
    layout3 = eng._guided_layout()
    assert layout3[0] == layout2[0]
    bits3, nxt3, _ = eng._guided_device_stack(layout3)
    assert bits3.data_ptr() == bits2.data_ptr()
    _, placed3, _ = layout3
    for (k, row, t) in placed3:
        assert row == (1 if k == eng._guided_key(other)
                       else 1 + t_other.num_states)
        assert np.array_equal(nxt3[0, row:row + t.num_states].numpy(),
                              t.next_state.astype(np.int32) + row)
        assert eng._guided_buffers[layout2[0]][3][k] == row


async def test_table_cap_fails_the_request_not_the_engine():
    """Past GUIDED_TABLE_MAX_BYTES (the packed rows, padded to a power of
    two) a grammar that no live request can make room for fails its own
    request with an error; the live one finishes, and a grammar that fits
    is served after it."""
    _, eng = _engines("phase")
    row = 2 * V + V // 8 + 1
    eng.GUIDED_TABLE_MAX_BYTES = 16 * row       # 16 rows
    long_lane = _req({"guided": {"regex": "[ab]{12}"}}, max_tokens=14)
    too_big = _req({"guided": {"regex": "[cd]{6}"}})
    try:
        task = asyncio.create_task(_run(eng, long_lane))
        while not eng._running:
            await asyncio.sleep(0.001)
        toks, finish, err = await _run(eng, too_big)
        assert toks == [] and finish == "error" and "MiB" in err
        first = await task
        after = await _run(eng, too_big)
    finally:
        await eng.close()
    assert first[2] is None and len(_text(first[0])) == 12
    assert after[2] is None and len(_text(after[0])) == 6
