"""Speculative decoding's function level in the port against the JAX
package on the same inputs: `engine/spec.py` `spec_decode_multi_step` and
the sampling pieces it adds (`uniform`, `categorical`).

The models are `LlamaConfig.tiny()` in fp32, the JAX weights carried
across by `params_from_jax`, the caches and lane arrays made from a numpy
seed. Each case runs a random draft and a self-draft (the draft is the
target's own weights with caches of its own) over five lanes, one of them
padding, two iterations of gamma 3: greedy, seeded stochastic with top-p
and top-k, min_p, the three penalties, guided lanes (a choice and a regex
beside a free lane), with `topk_lp` 0 and 4. Held: token rows and count
rows identical, the logprob and top-k rows within 1e-5, both cache pairs
within 2e-5 on every row the burst wrote (scratch page 0 excepted), the
new positions equal, and no input written.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import spec as jspec
from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.engine import sampling as ts
from dynamo_tpu_torch.engine import spec as tspec
from dynamo_tpu_torch.llm import guided as tg
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_jax, tensor_from_numpy
from tests.test_torch_constrained import TOKEN_BYTES, _head_inputs, _stack
from tests.test_torch_phase import _caches, _tables, _torch

GAMMA, ITERS = 3, 2
B = 5
V = 256


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    target = jl.init_params(jax.random.PRNGKey(0), jcfg)
    draft = jl.init_params(jax.random.PRNGKey(99), jcfg)
    to_torch = lambda p: params_from_jax(jax.tree.map(np.asarray, p), tcfg,
                                         "cpu")
    return jcfg, tcfg, (target, to_torch(target)), (draft, to_torch(draft))


@pytest.fixture(scope="module")
def grammars():
    specs = [{"choice": ["abc", "bca", "cab"]}, {"regex": "[a-d]+x?"}]
    return [tg.compile_guided(s, TOKEN_BYTES) for s in specs]


def test_uniform_and_categorical_match_jax():
    """`uniform` is `jax.random.uniform(key, (n,))` (no floor at tiny),
    `categorical` on a support is `jax.random.categorical` over the
    log-probabilities of the whole row, seed by seed."""
    rng = np.random.default_rng(3)
    seeds = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    steps = rng.integers(0, 1000, 64).astype(np.uint32)
    keys = jax.vmap(lambda s, t: jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(s), t), jnp.uint32(0x5EC0)))(
        jnp.asarray(seeds), jnp.asarray(steps))
    want_u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (7,)))(keys))
    tkey = tspec._key(_torch(seeds), _torch(steps), 0x5EC0)
    assert np.array_equal(ts.uniform(tkey, 7).numpy(), want_u)
    logits = rng.standard_normal((64, 300)).astype(np.float32) * 3
    temp = np.where(np.arange(64) % 3 == 0, 0.0, 0.8).astype(np.float32)
    top_k = (np.arange(64) % 5 * 4).astype(np.int32)
    top_p = np.full(64, 0.9, np.float32)
    probs, sup = ts.filtered_probs_support(
        torch.from_numpy(logits), torch.from_numpy(temp),
        torch.from_numpy(top_p), torch.from_numpy(top_k).long())
    want = np.asarray(jax.vmap(jspec._categorical)(
        keys, jnp.asarray(probs.numpy())))
    got = ts.categorical(tkey, probs, sup).numpy()
    assert np.array_equal(got, want)


def _inputs(rng, tcfg, case: str):
    positions = np.array([7, 10, 0, 3, 0], np.int32)
    valid = np.array([True, True, True, True, False])
    toks = rng.integers(1, V, B).astype(np.int32)
    tables = _tables(rng, tcfg, B, 6)
    seeds = (np.arange(1, B + 1) * 7919).astype(np.uint32)
    steps = (np.arange(B) * 3).astype(np.uint32)
    if case == "greedy":
        temp = np.zeros(B, np.float32)
    else:
        temp = np.array([0.9, 0.0, 1.2, 0.7, 0.0], np.float32)
    top_p = np.array([0.9, 1.0, 0.8, 1.0, 1.0], np.float32)
    top_k = np.array([20, 0, 5, 0, 0], np.int32)
    base = (toks, positions, tables, valid, seeds, steps, temp, top_p,
            top_k)
    return base


def _run_both(models, draft_kind, case, topk_lp, grammars):
    jcfg, tcfg, (jt, tt), (jd, td) = models
    if draft_kind == "self":
        jd, td = jt, tt
    rng = np.random.default_rng(11)
    base = _inputs(rng, tcfg, case)
    kc, vc = _caches(rng, tcfg, "float32")
    dkc, dvc = _caches(rng, tcfg, "float32")
    if draft_kind == "self":
        # the same prefix KV in both cache pairs (copies)
        dkc, dvc = [a.copy() for a in kc], [a.copy() for a in vc]
    jkw, tkw = {}, {}
    if case == "min_p":
        mp = np.array([0.1, 0.0, 0.3, 0.05, 0.0], np.float32)
        jkw["min_p"] = jnp.asarray(mp)
        tkw["min_p"] = torch.from_numpy(mp)
    if case == "penalties":
        _, _, pc, oc, rep, freq, pres = _head_inputs(7, b=B, v=V)
        pen = (rep, freq, pres, pc, oc)
        jkw.update(use_penalties=True, rep_pen=jnp.asarray(rep),
                   freq_pen=jnp.asarray(freq), pres_pen=jnp.asarray(pres),
                   prompt_counts=jnp.asarray(pc), out_counts=jnp.asarray(oc))
        tkw["penalties"] = tuple(map(_torch, pen))
    if case == "guided":
        bits, nxt, eos = _stack(grammars, V)
        g_ids = np.array([1, 2, 0, 1, 0], np.int32)
        g_states = np.array([0, 1, 0, 2, 0], np.int32)
        stop_ids = np.full((B, 8), -1, np.int32)
        stop_ids[:, 0] = 0
        g = (bits, nxt, eos, g_ids, g_states, stop_ids)
        jkw.update(use_guided=True, **dict(zip(
            ("g_bits", "g_next", "g_eos_ok", "g_ids", "g_states",
             "stop_ids"), map(jnp.asarray, g))))
        tkw["guided"] = tuple(map(_torch, g))
    jout, jk, jv, jdk, jdv, jpos = jspec.spec_decode_multi_step(
        jt, jd, *(tuple(map(jnp.asarray, c)) for c in (kc, vc, dkc, dvc)),
        *map(jnp.asarray, base), cfg=jcfg, draft_cfg=jcfg, gamma=GAMMA,
        num_iters=ITERS, topk_lp=topk_lp, **jkw)
    caches = [list(map(tensor_from_numpy, c)) for c in (kc, vc, dkc, dvc)]
    t_base = [_torch(a) for a in base]
    before = [a.clone() for a in t_base] + [
        a.clone() for v in tkw.values()
        for a in (v if isinstance(v, tuple) else (v,))]
    tout, tpos = tspec.spec_decode_multi_step(
        tt, td, *caches, *t_base, gamma=GAMMA, num_iters=ITERS,
        topk_lp=topk_lp, **tkw)
    after = t_base + [a for v in tkw.values()
                      for a in (v if isinstance(v, tuple) else (v,))]
    for a, b4 in zip(after, before):
        assert torch.equal(a, b4)                # no input written
    return (base, np.asarray(jout), tout.numpy(), np.asarray(jpos),
            tpos.numpy(), (jk, jv, jdk, jdv), caches)


def _written_rows(base, new_pos, page):
    toks, positions, tables, valid = base[:4]
    rows = []
    for i in np.flatnonzero(valid):
        # every position the burst wrote: up to the last iteration's
        # verified block (ITERS * (GAMMA + 1) past the start at most)
        for p in range(positions[i], min(new_pos[i] + GAMMA + 1,
                                         positions[i] + ITERS * (GAMMA + 1))):
            rows.append((int(tables[i, p // page]), p % page))
    return rows


CASES = [("greedy", 4), ("seeded", 0), ("min_p", 4), ("penalties", 0),
         ("guided", 4)]


@pytest.mark.parametrize("draft_kind", ["random", "self"])
@pytest.mark.parametrize("case,topk_lp", CASES,
                         ids=[f"{c}-tk{k}" for c, k in CASES])
def test_spec_decode_multi_step_fp32_matches_jax(models, grammars,
                                                 draft_kind, case, topk_lp):
    base, jout, tout, jpos, tpos, jc, tc = _run_both(
        models, draft_kind, case, topk_lp, grammars)
    valid = base[3]
    assert tout.shape == jout.shape == (3 + 2 * topk_lp, ITERS, GAMMA + 1,
                                        B)
    counts = jout[2, :, 0, :]
    assert np.array_equal(tout[2][..., valid], jout[2][..., valid])
    # token rows: the emitted prefix of every iteration (slots past the
    # count are padding the reference leaves 0 as well)
    assert np.array_equal(tout[0][..., valid], jout[0][..., valid])
    mask = np.arange(GAMMA + 1)[None, :, None] < counts[:, None, :]
    mask &= valid[None, None, :]
    np.testing.assert_allclose(tout[1][mask], jout[1][mask], atol=1e-5,
                               rtol=0)
    if topk_lp:
        assert np.array_equal(tout[3:3 + topk_lp][:, mask],
                              jout[3:3 + topk_lp][:, mask])
        np.testing.assert_allclose(tout[3 + topk_lp:][:, mask],
                                   jout[3 + topk_lp:][:, mask], atol=1e-5,
                                   rtol=0)
    assert np.array_equal(tpos[valid], jpos[valid])
    page = models[1].page_size
    rows = _written_rows(base, jpos, page)
    for t_cache, j_cache in zip(tc, jc):
        for tk, jk in zip(t_cache, j_cache):
            want = tensor_from_numpy(np.asarray(jk))
            for pg, off in rows:
                torch.testing.assert_close(tk[:, pg, off], want[:, pg, off],
                                           atol=2e-5, rtol=0)
    if draft_kind == "self" and case == "greedy":
        # a self-draft proposes the target's own argmax: all accepted
        assert (counts[:, valid] == GAMMA + 1).all()
    if case == "guided":
        toks = tout[0].astype(int)
        lane0 = bytes(t for it in range(ITERS)
                      for t in toks[it, :int(counts[it, 0]), 0])
        lane0 = lane0.split(b"\0")[0]
        assert any(c.startswith(lane0) or lane0.startswith(c)
                   for c in (b"abc", b"bca", b"cab"))
