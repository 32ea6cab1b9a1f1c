"""TorchEngine on the phase path (the default: batched prefill rounds,
fused k-step decode bursts, mixed chunk+burst steps, pipelined bursts)
against the reference's TpuEngine on its default path, with the JAX
engine's fp32 weights carried across by `params_from_jax`.

The workload is tests/test_torch_engine.py's `_run_workload`: two short
lanes decoding, a long prompt landing mid-decode, then two more prompts
with a misaligning chunk budget; under the budgeted scheduler and under
prefill-all, with `pipeline_bursts` on and off. Token streams and finish
reasons must be identical, and the port's phase streams must equal its
ragged ones (the reference pins the same for its own two paths,
tests/test_ragged_attention.py)."""

import asyncio

import pytest

from dynamo_tpu.engine import attention as jattn
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.models import llama as tl
from tests.test_torch_engine import (
    ENGINE_KW,
    _consume,
    _engines,
    _run_workload,
    req,
)


@pytest.fixture
def default_impl():
    """The reference's default attention impl ("auto": on the CPU, the
    phase path with its XLA fallbacks), restored afterwards."""
    prev = jattn._impl
    jattn.set_attention_impl("auto")
    yield
    jattn.set_attention_impl(prev)


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "sync"])
@pytest.mark.parametrize("budget", [12, 0], ids=["budgeted", "prefill-all"])
async def test_workload_streams_identical_to_tpu_engine(default_impl, budget,
                                                        pipeline):
    jax_eng, torch_eng = _engines(budget, impl="phase",
                                  pipeline_bursts=pipeline)
    try:
        want = await _run_workload(jax_eng)
        assert not jax_eng.ragged_active and not torch_eng.ragged
        got = await _run_workload(torch_eng)
    finally:
        await jax_eng.close()
        await torch_eng.close()
    assert got == want
    assert [f for _, f in got] == ["length"] * 5
    assert torch_eng.tokens_emitted == sum(len(t) for t, _ in got)
    assert len(torch_eng.ttft_s) == 5
    assert torch_eng.pool.active_pages == 0
    assert (torch_eng.pipelined_bursts > 0) == pipeline


async def test_seeded_sampling_and_stop_ids_match_tpu_engine(default_impl):
    jax_eng, torch_eng = _engines(12, seed=3, impl="phase")
    reqs = [req(range(1, 12), 10, temperature=0.8, seed=1234),
            req(range(20, 31), 10, temperature=1.2, seed=7),
            req(range(40, 45), 10)]
    try:
        want = [await _consume(jax_eng, r, "x", []) for r in reqs]
        got = [await _consume(torch_eng, r, "x", []) for r in reqs]
        # a stop id taken from the greedy stream ends it there, mid-burst
        stop_at = want[2][0][3]
        r = req(range(40, 45), 10, stop_ids=[stop_at])
        want_stop = await _consume(jax_eng, r, "x", [])
        got_stop = await _consume(torch_eng, r, "x", [])
        # and concurrently, seeded and greedy lanes in one burst
        want_all = await asyncio.gather(
            *(_consume(jax_eng, r, "x", []) for r in reqs))
        got_all = await asyncio.gather(
            *(_consume(torch_eng, r, "x", []) for r in reqs))
    finally:
        await jax_eng.close()
        await torch_eng.close()
    assert got == want
    assert got_stop == want_stop
    assert got_stop[1] == "stop" and got_stop[0][-1] == stop_at
    assert got_all == want_all == want
    assert torch_eng.pool.active_pages == 0


@pytest.mark.parametrize("budget", [12, 0], ids=["budgeted", "prefill-all"])
async def test_phase_streams_equal_ragged_streams(budget):
    _, phase = _engines(budget, impl="phase")
    _, ragged = _engines(budget, impl="ragged")
    try:
        got_phase = await _run_workload(phase)
        got_ragged = await _run_workload(ragged)
    finally:
        await phase.close()
        await ragged.close()
    assert got_phase == got_ragged
    # the phase path fuses k decode steps per dispatch
    assert phase.rounds < ragged.rounds


async def test_close_with_a_burst_in_flight_returns_every_page():
    eng = TorchEngine(TorchEngineConfig(
        model=tl.LlamaConfig.tiny(), device="cpu", **ENGINE_KW))
    try:
        task = asyncio.create_task(_consume(eng, req(range(3, 20), 30),
                                            "a", []))
        while eng._inflight is None and not task.done():
            await asyncio.sleep(0.001)
        assert eng._inflight is not None
    finally:
        await eng.close()
    toks, finish = await task
    assert finish == "cancelled" and 0 < len(toks) < 30
    assert eng._inflight is None and eng.pool.active_pages == 0


def test_unknown_attention_impl_is_refused():
    with pytest.raises(ValueError, match="attention_impl"):
        TorchEngine(TorchEngineConfig(model=tl.LlamaConfig.tiny(),
                                      device="cpu", attention_impl="xla"))


async def test_prefill_batch_widths_bound_the_round(default_impl):
    """A restricted width ladder (the reference's prefill_batch_widths)
    cuts a prefill round to its widest allowed width; streams are
    unchanged."""
    jax_eng, torch_eng = _engines(0, impl="phase",
                                  prefill_batch_widths=(1, 2))
    prompts = [req(range(1 + i, 9 + 3 * i), 4) for i in range(4)]
    try:
        want = await asyncio.gather(
            *(_consume(jax_eng, r, "x", []) for r in prompts))
        got = await asyncio.gather(
            *(_consume(torch_eng, r, "x", []) for r in prompts))
    finally:
        await jax_eng.close()
        await torch_eng.close()
    assert got == want
    assert torch_eng._prefill_width(4) == 2
