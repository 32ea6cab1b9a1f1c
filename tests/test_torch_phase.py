"""The phase path of the PyTorch port against the JAX reference on the
CPU: K3's and K4's plain versions, and `prefill_batch`,
`decode_multi_step` and `mixed_prefill_decode` with the JAX weights
carried across by `params_from_jax`, on the same inputs made with numpy.

K3 (`paged_kv_write_pages`): the plain version is bit-exact with the JAX
Pallas kernel run under `pltpu.force_tpu_interpret_mode()`, on every page
but scratch page 0 (padding slots race there in both).

K4 (`paged_attention_decode`): the plain version matches the reference's
`paged_attention_decode` on the CPU — its `_xla_decode` — to 1e-5 in fp32
on valid lanes (a length-0 lane is exact zeros in the port and a
uniform-softmax row in the reference). The reference's TPU path,
`_pallas_decode` → the upstream Pallas `paged_attention` kernel, does NOT
scale the scores by 1/sqrt(D): fed q unscaled, as `_pallas_decode` feeds
it, it computes another function. Fed q·D^-1/2 in interpret mode it agrees
with the scaled plain version within 2e-2 (the kernel's matmuls run at
default precision; ~4e-3 seen).

Model functions: fp32 sampled tokens identical and logits / logprobs
within atol 1e-4 (|logits| ~ 3; summation order between XLA and PyTorch);
bf16 logits within 0.15 (bf16 rounds at different places in the two
frameworks). The caches are compared, at atol 1e-5, on the rows both
sides write: on the
aligned path the port stores whole pages (K3) and so also writes the
padding tokens' rows into the tail of a partly filled last page, which the
reference's CPU scatter leaves alone — masked by length there, and
overwritten by decode later.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from dynamo_tpu.engine import attention as jattn
from dynamo_tpu.engine import kernels as jkernels
from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.engine import attention, kernels
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_jax, tensor_from_numpy

N_PAGES = 40
NP_DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _torch(a: np.ndarray) -> torch.Tensor:
    return tensor_from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                             else a)


# -- K3 ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_plain_bit_exact_with_pallas_interpret(dtype):
    rng = np.random.default_rng(11)
    kvh, n, p, d = 2, 12, 8, 128
    kc = rng.standard_normal((kvh, n, p, d)).astype(NP_DTYPES[dtype])
    vc = rng.standard_normal((kvh, n, p, d)).astype(NP_DTYPES[dtype])
    ids = np.array([5, 0, 9, 1, 0, 0, 7], np.int32)   # three padding slots
    kb = rng.standard_normal((len(ids), kvh, p, d)).astype(NP_DTYPES[dtype])
    vb = rng.standard_normal((len(ids), kvh, p, d)).astype(NP_DTYPES[dtype])
    with pltpu.force_tpu_interpret_mode():
        jk, jv = jkernels.paged_kv_write_pages(
            *(jnp.asarray(a) for a in (kc, vc, kb, vb, ids)))
    tk, tv = tensor_from_numpy(kc), tensor_from_numpy(vc)
    kernels.paged_kv_write_pages(tk, tv, tensor_from_numpy(kb),
                                 tensor_from_numpy(vb), torch.from_numpy(ids))
    for got, want, blocks in ((tk, jk, kb), (tv, jv, vb)):
        want = tensor_from_numpy(np.asarray(want))
        assert np.array_equal(_bits(got[:, 1:]), _bits(want[:, 1:]))
        # every element of page 0 comes from one of the padding slots
        # (which one wins the race is unspecified, element by element)
        pads = torch.stack([tensor_from_numpy(blocks[m])
                            for m in np.flatnonzero(ids == 0)])
        assert (pads == got[:, 0][None]).any(0).all()
    # the real slots landed where their ids say
    assert torch.equal(tk[:, 9], tensor_from_numpy(kb[2]))


def test_k3_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    rng = np.random.default_rng(12)
    kc = torch.from_numpy(rng.standard_normal((2, 6, 4, 16)).astype(
        np.float32))
    kb = torch.from_numpy(rng.standard_normal((2, 2, 4, 16)).astype(
        np.float32))
    ids = torch.tensor([3, 0], dtype=torch.int32)
    want_k, want_v = kc.clone(), kc.clone()
    kernels.paged_kv_write_pages_ref(want_k, want_v, kb, kb + 1, ids)
    got_k, got_v = kc.clone(), kc.clone()
    kernels.paged_kv_write_pages(got_k, got_v, kb, kb + 1, ids)
    assert torch.equal(got_k, want_k) and torch.equal(got_v, want_v)
    assert torch.equal(got_v[:, 3], (kb + 1)[0])
    meta = [t.to("meta") for t in (kc, kc, kb, kb, ids)]
    with pytest.raises(ValueError):
        kernels.paged_kv_write_pages(*meta)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_plain_on_chunk_views_bit_exact_with_pallas_interpret(dtype):
    """K3 as `_chunk_kv_writer` runs it: the chunk's token-major (Bp, T,
    KVH, D) K and V, each page's rows viewed as (KVH, P, D) blocks with
    no copy, against the JAX Pallas kernel (interpret mode) fed the same
    blocks made contiguous with numpy."""
    rng = np.random.default_rng(14)
    bp, t, kvh, p, d = 2, 16, 2, 4, 16
    cfg = tl.LlamaConfig.tiny(num_kv_heads=kvh, page_size=p, head_dim=d,
                              num_heads=2 * kvh)
    kc = rng.standard_normal((kvh, N_PAGES, p, d)).astype(NP_DTYPES[dtype])
    vc = rng.standard_normal((kvh, N_PAGES, p, d)).astype(NP_DTYPES[dtype])
    k = rng.standard_normal((bp, t, kvh, d)).astype(NP_DTYPES[dtype])
    v = rng.standard_normal((bp, t, kvh, d)).astype(NP_DTYPES[dtype])
    tables = _tables(rng, cfg, bp, 8)
    cached = np.array([8, 0], np.int32)
    seq_lens = np.array([8 + 13, 0], np.int32)    # lane 1 is padding
    positions = cached[:, None] + np.arange(t, dtype=np.int32)[None]
    write = tl._chunk_kv_writer(cfg, torch.from_numpy(tables),
                                torch.from_numpy(positions),
                                torch.from_numpy(seq_lens), aligned=True)
    tk, tv = tensor_from_numpy(kc), tensor_from_numpy(vc)
    write(tk, tv, tensor_from_numpy(k), tensor_from_numpy(v))
    # the reference's slots: one per (lane, page of the chunk)
    m = bp * t // p
    ids = np.where(positions[:, ::p] < seq_lens[:, None],
                   tables[np.arange(bp)[:, None], positions[:, ::p] // p],
                   0).reshape(m).astype(np.int32)
    blocks = [np.ascontiguousarray(
        a.reshape(m, p, kvh, d).transpose(0, 2, 1, 3)) for a in (k, v)]
    with pltpu.force_tpu_interpret_mode():
        jk, jv = jkernels.paged_kv_write_pages(
            *(jnp.asarray(a) for a in (kc, vc, *blocks, ids)))
    for got, want in ((tk, jk), (tv, jv)):
        want = tensor_from_numpy(np.asarray(want))
        assert np.array_equal(_bits(got[:, 1:]), _bits(want[:, 1:]))
    # lane 0's 4 pages landed where its table says; 13 valid rows fill
    # pages 0-2 and the first row of page 3 (its tail takes padding rows)
    for j in range(4):
        page = tables[0, 2 + j]
        assert np.array_equal(_bits(tk[:, page]), _bits(tensor_from_numpy(
            np.ascontiguousarray(k[0, 4 * j:4 * j + 4].transpose(1, 0, 2)))))


def test_chunk_writer_hands_k3_views_not_copies():
    """The aligned chunk writer passes K3 views of the caller's K/V (their
    storage, permuted strides), and the unaligned one passes K2 views."""
    cfg = tl.LlamaConfig.tiny()
    bp, t = 2, 8
    kvh, p, d = cfg.num_kv_heads, cfg.page_size, cfg.head_dim
    seen = []

    def spy(kc, vc, k, v, *ids):
        seen.append((k, v))
    tables = torch.arange(1, 1 + 2 * cfg.max_pages_per_seq,
                          dtype=torch.int32).reshape(2, -1)
    pos = torch.arange(t, dtype=torch.int32)[None].repeat(bp, 1)
    k = torch.randn(bp, t, kvh, d)
    v = torch.randn(bp, t, kvh, d)
    for aligned, name in ((True, "paged_kv_write_pages"),
                          (False, "paged_kv_write")):
        saved = getattr(kernels, name)
        setattr(kernels, name, spy)
        try:
            tl._chunk_kv_writer(cfg, tables, pos,
                                torch.tensor([t, 3], dtype=torch.int32),
                                aligned)(None, None, k, v)
        finally:
            setattr(kernels, name, saved)
        bk, bv = seen.pop()
        assert bk.data_ptr() == k.data_ptr() and bv.data_ptr() == v.data_ptr()
        if aligned:
            assert bk.shape == (bp * t // p, kvh, p, d)
            assert bk.stride() == (p * kvh * d, d, kvh * d, 1)
        else:
            assert bk.shape == (bp * t, kvh, d) and bk.is_contiguous()


# -- K4 ----------------------------------------------------------------------


def _decode_case(rng, dtype, kvh, groups, p, d, lengths, max_pages=12):
    b = len(lengths)
    q = rng.standard_normal((b, kvh * groups, d)).astype(NP_DTYPES[dtype])
    kp = rng.standard_normal((kvh, N_PAGES, p, d)).astype(NP_DTYPES[dtype])
    vp = rng.standard_normal((kvh, N_PAGES, p, d)).astype(NP_DTYPES[dtype])
    tables = (1 + rng.permutation(N_PAGES - 1)[:b * max_pages]).reshape(
        b, max_pages).astype(np.int32)
    return q, kp, vp, np.asarray(lengths, np.int32), tables


@pytest.mark.parametrize("kvh,groups,p", [(2, 2, 4), (1, 4, 8), (2, 1, 16)])
def test_k4_plain_matches_xla_decode_fp32(kvh, groups, p):
    rng = np.random.default_rng(20 + p)
    lengths = [1, p - 1, p, p + 1, 2 * p, 0, 3 * p + 2]
    args = _decode_case(rng, "float32", kvh, groups, p, 16, lengths, 4)
    want = np.asarray(jattn.paged_attention_decode(
        *(jnp.asarray(a) for a in args), page_size=p))
    got = attention.paged_attention_decode(
        *(torch.from_numpy(a) for a in args)).numpy()
    valid = np.asarray(lengths) > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-5, rtol=0)
    assert np.all(got[~valid] == 0)


def test_k4_plain_bf16_close_to_xla_decode():
    rng = np.random.default_rng(31)
    lengths = [5, 16, 0, 33]
    args = _decode_case(rng, "bfloat16", 2, 4, 8, 32, lengths, 8)
    want = np.asarray(jattn.paged_attention_decode(
        *(jnp.asarray(a) for a in args), page_size=8), np.float32)
    got = attention.paged_attention_decode(
        *(tensor_from_numpy(a) for a in args)).float().numpy()
    valid = np.asarray(lengths) > 0
    # both round the fp32 result to bf16 once: within one bf16 ulp
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-2, rtol=8e-3)


def test_k4_plain_matches_upstream_tpu_kernel_fed_scaled_q():
    """The TPU path omits 1/sqrt(D): fed q·D^-1/2 the upstream kernel (in
    interpret mode) computes the port's function; fed q as
    `_pallas_decode` feeds it, it does not."""
    rng = np.random.default_rng(41)
    d, p = 128, 8
    lengths = [20, 9, 31, 8]
    q, kp, vp, lens, tables = _decode_case(rng, "float32", 2, 2, p, d,
                                           lengths, 4)
    got = attention.paged_attention_decode(
        *(torch.from_numpy(a) for a in (q, kp, vp, lens, tables))).numpy()
    with pltpu.force_tpu_interpret_mode():
        scaled = np.asarray(jattn._pallas_decode(
            *(jnp.asarray(a) for a in (q / np.sqrt(d), kp, vp, lens,
                                       tables))))
        unscaled = np.asarray(jattn._pallas_decode(
            *(jnp.asarray(a) for a in (q, kp, vp, lens, tables))))
    np.testing.assert_allclose(got, scaled, atol=2e-2, rtol=0)
    assert np.abs(got - unscaled).max() > 0.1


def test_k4_wrapper_raises_on_meta_tensors():
    rng = np.random.default_rng(5)
    args = [torch.from_numpy(a) for a in
            _decode_case(rng, "float32", 2, 2, 4, 16, [3, 0])]
    want = attention.paged_attention_decode_ref(*args)
    assert torch.equal(attention.paged_attention_decode(*args), want)
    with pytest.raises(ValueError):
        attention.paged_attention_decode(*(a.to("meta") for a in args))


# -- model functions -----------------------------------------------------------


def _setup(dtype: str, seed: int, **kw):
    jcfg = jl.LlamaConfig.tiny(dtype=getattr(jnp, dtype), **kw)
    tcfg = tl.LlamaConfig.tiny(dtype=getattr(torch, dtype), **kw)
    params = jl.init_params(jax.random.PRNGKey(seed), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return jcfg, tcfg, params, model


def _caches(rng, cfg, dtype):
    shape = (cfg.num_kv_heads, N_PAGES, cfg.page_size, cfg.head_dim)
    return [[rng.standard_normal(shape).astype(NP_DTYPES[dtype])
             for _ in range(cfg.num_layers)] for _ in range(2)]


def _tables(rng, cfg, n_lanes, n_pages):
    pages = rng.permutation(np.arange(1, N_PAGES))
    tables = np.zeros((n_lanes, cfg.max_pages_per_seq), np.int32)
    for i in range(n_lanes):
        tables[i, :n_pages] = pages[i * n_pages:(i + 1) * n_pages]
    return tables


def _chunks(rng, cfg, cached, new, t):
    """Chunk sub-batch: lane i holds `cached[i]` tokens already and adds
    `new[i]` (0 = a padding lane), padded to T = t."""
    bp = len(cached)
    toks = rng.integers(0, cfg.vocab_size, (bp, t)).astype(np.int32)
    cached = np.asarray(cached, np.int32)
    seq_lens = cached + np.asarray(new, np.int32)
    return toks, _tables(rng, cfg, bp, 8), cached, seq_lens


def _burst_args(rng, cfg, positions, valid, seeded):
    b = len(positions)
    toks = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
    sampling = (np.arange(1, b + 1, dtype=np.uint32) * 7,      # seeds
                np.arange(b, dtype=np.uint32) * 3,               # steps
                np.where(np.arange(b) % 2 == 0, 0.9 if seeded else 0.0,
                         0.0).astype(np.float32),                # temperature
                np.full(b, 0.9 if seeded else 1.0, np.float32),  # top_p
                np.full(b, 20 if seeded else 0, np.int32))       # top_k
    return (toks, np.asarray(positions, np.int32), _tables(rng, cfg, b, 6),
            np.asarray(valid, bool)) + sampling


def _written(tables, starts, ends, p):
    """[(page, offset)] of positions starts[i] .. ends[i]-1 of each lane."""
    return [(int(tables[i, s // p]), s % p) for i in range(len(starts))
            for s in range(starts[i], ends[i])]


def _assert_rows(t_cache, j_cache, rows):
    for tk, jk in zip(t_cache, j_cache):
        want = tensor_from_numpy(np.asarray(jk))
        for page, off in rows:
            torch.testing.assert_close(tk[:, page, off], want[:, page, off],
                                       atol=1e-5, rtol=0)


@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned-k3", "unaligned-k2"])
def test_prefill_batch_fp32_matches_jax(aligned):
    jcfg, tcfg, params, model = _setup("float32", 0)
    rng = np.random.default_rng(1)
    P = tcfg.page_size
    cached = [0, 8, 4, 0] if aligned else [2, 5, 0, 0]
    new = [7, 8, 5, 0]                      # lane 3 pads the width
    toks, tables, cached, seq_lens = _chunks(rng, tcfg, cached, new, 8)
    kc, vc = _caches(rng, tcfg, "float32")
    j_logits, jkc, jvc = jl.prefill_batch(
        params, tuple(map(jnp.asarray, kc)), tuple(map(jnp.asarray, vc)),
        *(jnp.asarray(a) for a in (toks, tables, cached, seq_lens)),
        cfg=jcfg, aligned=aligned)
    tkc, tvc = [list(map(tensor_from_numpy, c)) for c in (kc, vc)]
    t_logits = tl.prefill_batch(model, tkc, tvc,
                                *(torch.from_numpy(a) for a in
                                  (toks, tables, cached, seq_lens)),
                                aligned=aligned)
    live = np.asarray(new) > 0
    np.testing.assert_allclose(t_logits.numpy()[live],
                               np.asarray(j_logits)[live], atol=1e-4, rtol=0)
    assert np.array_equal(t_logits.numpy()[live].argmax(-1),
                          np.asarray(j_logits)[live].argmax(-1))
    rows = _written(tables, cached, seq_lens, P)
    _assert_rows(tkc, jkc, rows)
    _assert_rows(tvc, jvc, rows)
    # pages nobody writes are untouched (page 0 and partly filled pages'
    # tails aside)
    touched = {pg for pg, _ in rows} | {0}
    for l in range(tcfg.num_layers):
        for pg in set(range(N_PAGES)) - touched:
            assert torch.equal(tkc[l][:, pg], tensor_from_numpy(kc[l][:, pg]))


def test_prefill_step_is_prefill_batch_of_one():
    _, tcfg, _, model = _setup("float32", 3)
    rng = np.random.default_rng(2)
    toks, tables, cached, seq_lens = _chunks(rng, tcfg, [4], [6], 8)
    kc, vc = _caches(rng, tcfg, "float32")
    a = [list(map(tensor_from_numpy, c)) for c in (kc, vc)]
    b = [list(map(tensor_from_numpy, c)) for c in (kc, vc)]
    want = tl.prefill_batch(model, *a, *(torch.from_numpy(x) for x in
                                         (toks, tables, cached, seq_lens)))
    got = tl.prefill_step(model, *b, torch.from_numpy(toks[0]),
                          torch.from_numpy(tables[0]), 4, 10)
    assert torch.equal(got, want[0])


def test_prefill_batch_bf16_logits_close_to_jax():
    jcfg, tcfg, params, model = _setup("bfloat16", 2)
    rng = np.random.default_rng(3)
    toks, tables, cached, seq_lens = _chunks(rng, tcfg, [0, 4], [8, 3], 8)
    kc, vc = _caches(rng, tcfg, "bfloat16")
    j_logits, _, _ = jl.prefill_batch(
        params, tuple(map(jnp.asarray, kc)), tuple(map(jnp.asarray, vc)),
        *(jnp.asarray(a) for a in (toks, tables, cached, seq_lens)),
        cfg=jcfg, aligned=True)
    t_logits = tl.prefill_batch(
        model, *[list(map(tensor_from_numpy, c)) for c in (kc, vc)],
        *(torch.from_numpy(a) for a in (toks, tables, cached, seq_lens)),
        aligned=True)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=0.15, rtol=0)


@pytest.mark.parametrize("topk_lp", [0, 8])
@pytest.mark.parametrize("seeded", [False, True], ids=["greedy", "seeded"])
def test_decode_multi_step_fp32_matches_jax(seeded, topk_lp):
    jcfg, tcfg, params, model = _setup("float32", 4)
    rng = np.random.default_rng(5)
    # lanes at a page edge, mid-page, position 0, and one padding lane
    args = _burst_args(rng, tcfg, [7, 10, 0, 0], [True, True, True, False],
                       seeded)
    kc, vc = _caches(rng, tcfg, "float32")
    k = 3
    j_out, jkc, _ = jl.decode_multi_step(
        params, tuple(map(jnp.asarray, kc)), tuple(map(jnp.asarray, vc)),
        *(jnp.asarray(a) for a in args), cfg=jcfg, num_steps=k,
        topk_lp=topk_lp)
    tkc, tvc = [list(map(tensor_from_numpy, c)) for c in (kc, vc)]
    t_out = tl.decode_multi_step(model, tkc, tvc, *map(_torch, args),
                                 num_steps=k, topk_lp=topk_lp).numpy()
    j_out = np.asarray(j_out)
    assert t_out.shape == j_out.shape == (2 + 2 * topk_lp, k, 4)
    valid = args[3]
    assert np.array_equal(t_out[0][:, valid], j_out[0][:, valid])
    np.testing.assert_allclose(t_out[1:][:, :, valid],
                               j_out[1:][:, :, valid], atol=1e-4, rtol=0)
    positions = args[1]
    rows = _written(args[2][valid], positions[valid], positions[valid] + k,
                    tcfg.page_size)
    _assert_rows(tkc, jkc, rows)


def test_decode_step_is_one_step_of_the_burst():
    _, tcfg, _, model = _setup("float32", 6)
    rng = np.random.default_rng(6)
    args = _burst_args(rng, tcfg, [3, 9], [True, True], False)
    kc, vc = _caches(rng, tcfg, "float32")
    a = [list(map(tensor_from_numpy, c)) for c in (kc, vc)]
    b = [list(map(tensor_from_numpy, c)) for c in (kc, vc)]
    logits = tl.decode_step(model, *a, *map(_torch, args[:4]))
    packed = tl.decode_multi_step(model, *b, *map(_torch, args),
                                  num_steps=1)
    assert torch.equal(logits.argmax(-1).float(), packed[0, 0])


@pytest.mark.parametrize("aligned", [True, False],
                         ids=["aligned-k3", "unaligned-k2"])
def test_mixed_prefill_decode_fp32_matches_jax(aligned):
    jcfg, tcfg, params, model = _setup("float32", 7)
    rng = np.random.default_rng(8)
    cached = [4, 0] if aligned else [3, 1]
    chunk = _chunks(rng, tcfg, cached, [6, 8], 8)
    burst = _burst_args(rng, tcfg, [9, 4, 0, 0], [True, True, False, True],
                        True)
    kc, vc = _caches(rng, tcfg, "float32")
    k, tk = 3, 8
    j_out, j_ch, jkc, _ = jl.mixed_prefill_decode(
        params, tuple(map(jnp.asarray, kc)), tuple(map(jnp.asarray, vc)),
        *(jnp.asarray(a) for a in chunk + burst), cfg=jcfg, num_steps=k,
        aligned=aligned, topk_lp=tk)
    tkc, tvc = [list(map(tensor_from_numpy, c)) for c in (kc, vc)]
    t_out, t_ch = tl.mixed_prefill_decode(
        model, tkc, tvc, *map(_torch, chunk + burst), num_steps=k,
        aligned=aligned, topk_lp=tk)
    np.testing.assert_allclose(t_ch.numpy(), np.asarray(j_ch), atol=1e-4,
                               rtol=0)
    t_out, j_out, valid = t_out.numpy(), np.asarray(j_out), burst[3]
    assert np.array_equal(t_out[0][:, valid], j_out[0][:, valid])
    np.testing.assert_allclose(t_out[1:][:, :, valid],
                               j_out[1:][:, :, valid], atol=1e-4, rtol=0)
    toks, tables, cached_a, seq_lens = chunk
    rows = _written(tables, cached_a, seq_lens, tcfg.page_size)
    rows += _written(burst[2][valid], burst[1][valid], burst[1][valid] + k,
                     tcfg.page_size)
    _assert_rows(tkc, jkc, rows)


def test_mixed_prefill_decode_bf16_close_to_jax():
    jcfg, tcfg, params, model = _setup("bfloat16", 9)
    rng = np.random.default_rng(10)
    chunk = _chunks(rng, tcfg, [0, 4], [8, 5], 8)
    burst = _burst_args(rng, tcfg, [6, 13, 0, 0], [True, True, False, False],
                        False)
    kc, vc = _caches(rng, tcfg, "bfloat16")
    j_out, j_ch, _, _ = jl.mixed_prefill_decode(
        params, tuple(map(jnp.asarray, kc)), tuple(map(jnp.asarray, vc)),
        *(jnp.asarray(a) for a in chunk + burst), cfg=jcfg, num_steps=2,
        aligned=True)
    t_out, t_ch = tl.mixed_prefill_decode(
        model, *[list(map(tensor_from_numpy, c)) for c in (kc, vc)],
        *map(_torch, chunk + burst), num_steps=2, aligned=True)
    np.testing.assert_allclose(t_ch.numpy(), np.asarray(j_ch), atol=0.15,
                               rtol=0)
    assert t_out.shape == np.asarray(j_out).shape
    assert np.isfinite(t_out.numpy()).all()
