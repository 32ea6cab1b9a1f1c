"""The phase path's compiled steps on the CPU.

On the card the engine replays one CUDA graph per bucket for "prefill",
"mixed_step" and "sample_first", and the chunk attention runs K1's
kernel over the chunk rows flattened (`attention.prefill_attention`).
Here: the plain `prefill_attention` / `mixed_attention` against the
reference's on the same numpy inputs; the K1 route's row tags
(`chunk_rows`) through K1's plain version against the plain prefill
attention (the function the kernel computes on the card); the engine's
three entries going through `StepGraphs.run` under the reference's keys;
and the static-output hazard of graph replays, reproduced on the CPU by a
`StepGraphs` whose outputs, like a graph's, are the same tensors at every
run of a key. The kernel and the replays themselves need the card:
tests/test_torch_cuda.py."""

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import attention as jattn
from dynamo_tpu_torch.engine import attention, graphs, ragged
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.models import llama as tl
from tests.test_torch_engine import ENGINE_KW, _consume, _engines, req
from tests.test_torch_graphs import UPFRONT, _upfront_workload

H, KVH, D, P, N_PAGES, MAX_PAGES = 4, 2, 16, 4, 40, 8


def _chunk_case(seed: int, cached, lens, t: int):
    """q (Bp, T, H, D), pages, tables (Bp, max_pages), positions (Bp, T),
    seq_lens (Bp,) as numpy, fp32; lane i's chunk starts at cached[i] and
    is valid below lens[i] (a padding lane has lens == cached)."""
    rng = np.random.default_rng(seed)
    bp = len(cached)
    q = rng.standard_normal((bp, t, H, D)).astype(np.float32)
    k = rng.standard_normal((KVH, N_PAGES, P, D)).astype(np.float32)
    v = rng.standard_normal((KVH, N_PAGES, P, D)).astype(np.float32)
    tables = (1 + rng.permutation(N_PAGES - 1)[:bp * MAX_PAGES]).reshape(
        bp, MAX_PAGES).astype(np.int32)
    pos = (np.asarray(cached, dtype=np.int32)[:, None]
           + np.arange(t, dtype=np.int32)[None, :])
    return q, k, v, tables, pos, np.asarray(lens, dtype=np.int32)


CASES = {
    "aligned": ([0, 8, 4], [8, 13, 4], 8),      # lane 2 is padding
    "mid-page": ([3, 17, 0], [10, 23, 1], 8),
    "deep": ([16, 0], [31, 5], 16),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_prefill_attention_matches_reference(case):
    """The CPU `prefill_attention` (the plain version) against the
    reference's per-sequence `prefill_attention` vmapped over the batch,
    every row (padding rows included), fp32 at 1e-5."""
    cached, lens, t = CASES[case]
    q, k, v, tables, pos, lens_np = _chunk_case(7, cached, lens, t)
    want = jax.vmap(lambda q1, pt, p1, sl: jattn.prefill_attention(
        q1, jnp.asarray(k), jnp.asarray(v), pt, p1, sl, P))(
        jnp.asarray(q), jnp.asarray(tables), jnp.asarray(pos),
        jnp.asarray(lens_np))
    got = attention.prefill_attention(*map(torch.from_numpy, (
        q, k, v, tables, pos, lens_np)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_plain_mixed_attention_matches_reference():
    """`mixed_attention` on the CPU (K4's plain version for the decode
    lanes, the plain prefill attention for the chunks) against the
    reference's on the same caches."""
    cached, lens, t = CASES["mid-page"]
    q, k, v, tables, pos, lens_np = _chunk_case(9, cached, lens, t)
    rng = np.random.default_rng(10)
    q_dec = rng.standard_normal((3, H, D)).astype(np.float32)
    d_lens = np.array([5, 0, 19], dtype=np.int32)
    d_tables = (1 + rng.permutation(N_PAGES - 1)[:3 * MAX_PAGES]).reshape(
        3, MAX_PAGES).astype(np.int32)
    prev = jattn._impl
    jattn.set_attention_impl("xla")
    try:
        want_d, want_c = jattn.mixed_attention(
            jnp.asarray(q_dec), jnp.asarray(q), jnp.asarray(k),
            jnp.asarray(v), jnp.asarray(d_lens), jnp.asarray(d_tables),
            jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(lens_np), P)
    finally:
        jattn.set_attention_impl(prev)
    got_d, got_c = attention.mixed_attention(*map(torch.from_numpy, (
        q_dec, q, k, v, d_lens, d_tables, tables, pos, lens_np)))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5,
                               atol=1e-5)
    # the reference's plain decode gives a padding lane a uniform row, K4
    # exact zeros: compare the live lanes
    live = d_lens > 0
    np.testing.assert_allclose(got_d.numpy()[live],
                               np.asarray(want_d)[live], rtol=1e-5,
                               atol=1e-5)


def test_chunk_rows_tags():
    pos = torch.tensor([[4, 5, 6, 7], [0, 1, 2, 3]], dtype=torch.int32)
    lens = torch.tensor([6, 0], dtype=torch.int32)
    qpos, lanes = attention.chunk_rows(pos, lens)
    assert qpos.tolist() == [4, 5, -1, -1, -1, -1, -1, -1]
    assert lanes.tolist() == [0, 0, 0, 0, 1, 1, 1, 1]
    assert qpos.dtype == lanes.dtype == torch.int32


@pytest.mark.parametrize("case", list(CASES))
def test_k1_route_equals_plain_prefill_attention(case):
    """The card's route through K1 — the chunk rows flattened, tagged by
    `chunk_rows`, reading each lane's row of the page tables — run
    through K1's plain version: equal to the plain prefill attention on
    every valid row, and exact zeros on the padding rows (where the plain
    prefill attention averages the valid keys, by design)."""
    cached, lens, t = CASES[case]
    q, k, v, tables, pos, lens_np = (torch.from_numpy(a) for a in
                                     _chunk_case(11, cached, lens, t))
    bp = q.shape[0]
    qpos, lanes = attention.chunk_rows(pos, lens_np)
    got = ragged.ragged_attention_ref(q.reshape(bp * t, H, D), k, v, qpos,
                                      lanes, tables).view(bp, t, H, D)
    want = attention.prefill_attention_ref(q, k, v, tables, pos, lens_np)
    valid = pos < lens_np[:, None]
    torch.testing.assert_close(got[valid], want[valid], rtol=1e-5,
                               atol=1e-5)
    assert torch.all(got[~valid] == 0)
    assert (~valid).any()


# -- the engine's graphed entries ---------------------------------------------

class RecordingGraphs(graphs.StepGraphs):
    """The CPU's StepGraphs (the eager call), recording each key run."""

    def __init__(self, device):
        super().__init__(device)
        self.keys = []

    def run(self, key, fn, inputs):
        self.keys.append(key)
        return super().run(key, fn, inputs)


class StaticGraphs(graphs.StepGraphs):
    """StepGraphs whose outputs behave as a CUDA graph's: every run of a
    key returns the same tensors, overwritten in place (on the CPU)."""

    def __init__(self, device):
        super().__init__(device)
        self.static = {}

    def run(self, key, fn, inputs):
        out = super().run(key, fn, inputs)
        outs = out if isinstance(out, tuple) else (out,)
        kept = self.static.get(key)
        if kept is None:
            kept = self.static[key] = tuple(o.clone() for o in outs)
        else:
            for dst, src in zip(kept, outs):
                dst.copy_(src)
        return kept if isinstance(out, tuple) else kept[0]


class PooledGraphs(StaticGraphs):
    """StaticGraphs whose graphs share one memory pool at its worst: every
    run of a key overwrites the outputs every other key returned (a
    later-captured graph may hold its intermediates where an earlier one
    left its output). What the engine keeps must be copied right behind
    the run that made it."""

    def run(self, key, fn, inputs):
        out = super().run(key, fn, inputs)
        for other, kept in self.static.items():
            if other != key:
                for t in kept:
                    t.fill_(float("nan") if t.is_floating_point() else -7)
        return out


@pytest.mark.parametrize("budget", [12, 0], ids=["budgeted", "prefill-all"])
async def test_graph_outputs_kept_only_as_copies(monkeypatch, budget):
    """Pipelined bursts (their host copies queued behind them, as on the
    card), chunk rounds, mixed steps and first-token sampling under graphs
    that overwrite each other's outputs: the streams of the eager engine.
    The pipelined burst's next input tokens are copied behind the burst,
    not read from its output after other graphs ran."""
    from dynamo_tpu_torch.engine import engine as engine_mod

    monkeypatch.setattr(engine_mod, "_start_copy",
                        lambda packed: (packed.clone(), None))
    outs = []
    for graphs_cls in (PooledGraphs, None):
        eng = TorchEngine(TorchEngineConfig(
            model=tl.LlamaConfig.tiny(dtype=torch.float32), device="cpu",
            **dict(ENGINE_KW, prefill_chunk_budget=budget)))
        if graphs_cls is not None:
            eng.graphs = graphs_cls(eng.device)
        try:
            outs.append(await _upfront_workload(eng))
        finally:
            await eng.close()
        if graphs_cls is not None:
            assert eng.pipelined_bursts > 0
    assert outs[0] == outs[1]


@pytest.mark.parametrize("budget", [12, 0], ids=["budgeted", "prefill-all"])
async def test_phase_entries_run_through_step_graphs(budget):
    """Every "prefill", "mixed_step" and "sample_first" dispatch goes
    through `StepGraphs.run` under its tracker key (the reference's key),
    and the streams stay TpuEngine's."""
    prev = jattn._impl
    jattn.set_attention_impl("auto")
    try:
        jax_eng, torch_eng = _engines(budget, impl="phase")
        torch_eng.graphs = RecordingGraphs(torch_eng.device)
        try:
            want = await _upfront_workload(jax_eng)
            got = await _upfront_workload(torch_eng)
        finally:
            await jax_eng.close()
            await torch_eng.close()
    finally:
        jattn.set_attention_impl(prev)
    assert got == want
    ran = {k for k in torch_eng.graphs.keys
           if k[0] in ("prefill", "mixed_step", "sample_first")}
    tracked = {k for k in torch_eng.compile_tracker._seen
               if k[0] in ("prefill", "mixed_step", "sample_first")}
    assert ran == tracked
    assert {k[0] for k in ran} >= {"prefill", "sample_first"}
    if budget:
        assert any(k[0] == "mixed_step" for k in ran)


async def _static_vs_eager(cfg_kw, requests):
    """The same requests, all in flight, on an engine whose graphs keep
    static outputs and on a plain CPU engine (one set of weights). Bursts
    are not pipelined: on the CPU a burst's host copy is its output
    tensor itself, where the card queues a copy before the next replay
    (tests/test_torch_cuda.py holds two pipelined bursts through one
    graph)."""
    cfg_kw = dict(cfg_kw, pipeline_bursts=False)
    outs = []
    for static in (True, False):
        eng = TorchEngine(TorchEngineConfig(
            model=tl.LlamaConfig.tiny(dtype=torch.float32), device="cpu",
            **cfg_kw))
        if static:
            eng.graphs = StaticGraphs(eng.device)
        try:
            outs.append(await asyncio.gather(*(
                _consume(eng, r, str(i), []) for i, r in
                enumerate(requests))))
        finally:
            await eng.close()
    return outs


async def test_prompts_finishing_in_rounds_of_one_key_keep_their_logits():
    """Prefill-all with one prefill width and 16-token chunks: prompts of
    8 tokens finish in round 1 and prompts of 32 in round 2, both rounds
    keyed (4, 16, aligned). With static outputs, round 2 overwrites round
    1's logits; the engine copied the rows it kept, so every first token
    is the eager engine's."""
    kw = dict(ENGINE_KW, prefill_batch_widths=(4,), prefill_chunk=16)
    prompts = [list(range(1, 9)), list(range(3, 35)), list(range(40, 48)),
               list(range(9, 41))]
    static, eager = await _static_vs_eager(
        kw, [req(p, 4) for p in prompts])
    assert static == eager
    assert [f for _, f in eager] == ["length"] * 4
    firsts = [toks[0] for toks, _ in eager]
    assert len(set(firsts)) > 1     # the hazard would have swapped rows


async def test_mixed_steps_with_static_outputs_match_eager():
    """The budgeted scheduler's mixed steps and chunk rounds, with static
    outputs: the streams of the eager engine."""
    kw = dict(ENGINE_KW, prefill_chunk_budget=12)
    static, eager = await _static_vs_eager(
        kw, [req(list(p), n) for p, n in UPFRONT])
    assert static == eager
