"""TorchEngine (dynamo_tpu_torch/engine/engine.py) against the JAX
reference's TpuEngine, both on the ragged path (`set_attention_impl("ragged")`,
restored afterwards; `attention_impl="ragged"`), with the JAX engine's weights carried across by
`params_from_jax`, in fp32 (bf16 near-ties flip greedy tokens between
any two implementations).

The workload is tests/test_ragged_attention.py's `_run_workload`: two
short lanes decoding, a long prompt landing mid-decode (budgeted chunk
rounds riding the decode block), then two more prompts with a
misaligning chunk budget. Token streams and finish reasons must be
identical, under the budgeted scheduler and under prefill-all."""

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import attention
from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.models import llama as jl
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.tokens import TokenBlockSequence

ENGINE_KW = dict(num_pages=64, max_batch_size=4, prefill_chunk=32,
                 min_prefill_bucket=8, default_max_tokens=8,
                 decode_steps_per_sync=2)


@pytest.fixture
def ragged_impl():
    prev = attention._impl
    attention.set_attention_impl("ragged")
    yield
    attention.set_attention_impl(prev)


def _engines(budget: int, seed: int = 0, impl: str = "ragged", **kw):
    """(TpuEngine, TorchEngine) with the same fp32 weights; `impl` is the
    torch engine's path (the JAX engine's follows the global attention
    impl), `kw` further config fields for both."""
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    params = jl.init_params(jax.random.PRNGKey(seed), jcfg)
    jax_eng = TpuEngine(TpuEngineConfig(
        model=jcfg, prefill_chunk_budget=budget, **ENGINE_KW, **kw),
        params=params)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    torch_eng = TorchEngine(TorchEngineConfig(
        model=tcfg, prefill_chunk_budget=budget, device="cpu",
        attention_impl=impl, **ENGINE_KW, **kw), model=model)
    return jax_eng, torch_eng


def req(tokens, max_tokens=8, temperature=0.0, seed=None, stop_ids=()):
    return {"token_ids": list(tokens), "model": "m",
            "sampling": {"temperature": temperature, "seed": seed},
            "stop": {"max_tokens": max_tokens,
                     "stop_token_ids": list(stop_ids)}}


def _ctx(eng):
    return JaxContext() if isinstance(eng, TpuEngine) else Context()


async def _consume(eng, request, label, events):
    toks, finish = [], None
    async for o in eng.generate(request, _ctx(eng)):
        if o.get("token_ids"):
            events.append(label)
            toks.extend(o["token_ids"])
        finish = o.get("finish_reason") or finish
    return toks, finish


async def _run_workload(eng):
    """tests/test_ragged_attention.py `_run_workload`, with finish
    reasons kept."""
    events = []
    shorts = [asyncio.create_task(_consume(
        eng, req(list(range(1 + i, 7 + 2 * i)), 36), f"s{i}", events))
        for i in range(2)]
    while len({lab for lab in events if lab.startswith("s")}) < 2:
        await asyncio.sleep(0.01)
    l0 = asyncio.create_task(_consume(
        eng, req(list(range(3, 43)), 8), "l0", events))
    while "l0" not in events:
        await asyncio.sleep(0.01)
    l1 = asyncio.create_task(_consume(
        eng, req(list(range(5, 28)), 6), "l1", events))
    l2 = asyncio.create_task(_consume(
        eng, req(list(range(7, 24)), 6), "l2", events))
    return await asyncio.gather(*shorts, l0, l1, l2)


@pytest.mark.parametrize("budget", [12, 0], ids=["budgeted", "prefill-all"])
async def test_workload_streams_identical_to_tpu_engine(ragged_impl, budget):
    jax_eng, torch_eng = _engines(budget)
    try:
        want = await _run_workload(jax_eng)
        assert jax_eng.ragged_active and torch_eng.ragged
        got = await _run_workload(torch_eng)
    finally:
        await jax_eng.close()
        await torch_eng.close()
    assert got == want
    assert [f for _, f in got] == ["length"] * 5
    assert torch_eng.tokens_emitted == sum(len(t) for t, _ in got)
    assert len(torch_eng.ttft_s) == 5


async def test_seeded_sampling_and_stop_ids_match_tpu_engine(ragged_impl):
    jax_eng, torch_eng = _engines(12, seed=3)
    reqs = [req(range(1, 12), 10, temperature=0.8, seed=1234),
            req(range(20, 31), 10, temperature=1.2, seed=7),
            req(range(40, 45), 10)]
    try:
        want = [await _consume(jax_eng, r, "x", []) for r in reqs]
        got = [await _consume(torch_eng, r, "x", []) for r in reqs]
        # a stop id taken from the greedy stream ends it there, as "stop"
        stop_at = want[2][0][3]
        r = req(range(40, 45), 10, stop_ids=[stop_at])
        want_stop = await _consume(jax_eng, r, "x", [])
        got_stop = await _consume(torch_eng, r, "x", [])
    finally:
        await jax_eng.close()
        await torch_eng.close()
    assert got == want
    assert got_stop == want_stop
    assert got_stop[1] == "stop" and got_stop[0][-1] == stop_at


async def test_prefix_reuse_cancel_and_unsupported_requests():
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    eng = TorchEngine(TorchEngineConfig(model=tcfg, device="cpu",
                                        prefill_chunk_budget=8,
                                        **ENGINE_KW))
    try:
        prompt = list(range(1, 30))
        first = await _consume(eng, req(prompt, 4), "a", [])
        cached = eng.pool.match_prefix(
            TokenBlockSequence(tcfg.page_size, prompt).seq_hashes())
        assert len(cached) == (len(prompt) - 1) // tcfg.page_size
        again = await _consume(eng, req(prompt, 4), "b", [])
        assert again == first                  # prefix hit, same stream
        ctx = Context()
        ctx.cancel()
        outs = [o async for o in eng.generate(req(prompt, 4), ctx)]
        assert outs[-1]["finish_reason"] == "cancelled"
        # an embedding request is served (it was refused before the
        # embeddings were ported): one output with a unit vector
        emb = {**req(prompt), "extra": {"embed": True}}
        outs = [o async for o in eng.generate(emb, Context())]
        assert len(outs) == 1 and outs[0]["finish_reason"] == "stop"
        assert len(outs[0]["embedding"]) == tcfg.hidden_size
        assert abs(np.linalg.norm(outs[0]["embedding"]) - 1.0) < 1e-5
    finally:
        await eng.close()
    assert eng.pool.active_pages == 0


def test_engine_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchEngine(TorchEngineConfig(model=tl.LlamaConfig.tiny()))
