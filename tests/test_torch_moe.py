"""The port's MoE (Mixtral) serving held against the JAX package's.

`dynamo_tpu_torch/models/mixtral.py` against `dynamo_tpu/models/mixtral.py`
at `MoeConfig.tiny`, fp32, the JAX weights carried across with
`params_from_jax` (the reference's `init_params` dispatches to
`init_moe_params`):
- `moe_mlp`, `moe_mlp_capacity` (with dropped tokens) and
  `moe_mlp_reference`, each against the reference's function;
- int8 expert stacks: the port's quantization gives the reference's
  (`quantize_params_jit`) q and s bit for bit, its `moe_mlp` the
  reference's int8 output, within the reference's 5% bound of fp32;
- top-k with ties broken by the lowest expert index, as `jax.lax.top_k`;
- `moe_forward` logits (dense and capacity dispatch);
- greedy streams of `TorchEngine` identical to `TpuEngine`'s on the phase
  path and on the ragged path, with and without int8, and an MoE target
  beside a dense draft under speculative decoding;
- `config_from_hf` and the loader on the reference's `mixtral-tiny`
  synthetic checkpoint (every tensor bit-exact with the reference
  loader's, int8 load equal to quantize-after-load), and the loader's
  logits against `transformers`' `MixtralForCausalLM`;
- the w8a8/int4 refusals, and `--expert-parallel-size` 1 against 2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import attention as jattn
from dynamo_tpu.engine import quant as jquant
from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import mixtral as jm
from dynamo_tpu_torch.engine import quant as tquant
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models import mixtral as tm
from dynamo_tpu_torch.models.convert import params_from_jax, tensor_from_numpy
from tests.test_torch_engine import ENGINE_KW, _consume, _run_workload, req

# fp32 on both sides: XLA and PyTorch order the products' sums apart
MLP_TOL = dict(atol=2e-5, rtol=2e-5)
# logits of a whole forward (two layers, attention included)
LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)
# against transformers (as tests/test_torch_hf.py's LOGITS_TOL)
HF_TOL = 2e-4


def _jax_params(seed=0, **kw):
    jcfg = jm.MoeConfig.tiny(dtype=jnp.float32, **kw)
    return jcfg, jl.init_params(jax.random.PRNGKey(seed), jcfg)


def _carried(params, **kw):
    tcfg = tm.MoeConfig.tiny(dtype=torch.float32, **kw)
    return tcfg, params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                 "cpu")


def _h(shape, seed=4):
    return np.random.RandomState(seed).standard_normal(shape) \
        .astype(np.float32)


def test_config_presets_match_reference():
    for name in ("tiny", "mixtral_8x7b"):
        j, t = getattr(jm.MoeConfig, name)(), getattr(tm.MoeConfig, name)()
        for f in ("vocab_size", "hidden_size", "intermediate_size",
                  "num_layers", "num_heads", "num_kv_heads", "head_dim",
                  "rope_theta", "rms_eps", "page_size", "max_pages_per_seq",
                  "num_experts", "experts_per_token"):
            assert getattr(t, f) == getattr(j, f), (name, f)
    assert isinstance(tm.MoeConfig.tiny(), tl.LlamaConfig)


def test_layer_layout_and_init():
    cfg = tm.MoeConfig.tiny(dtype=torch.float32)
    model = tl.init_params(cfg, 0, torch.device("cpu"))
    layer = model.layers[0]
    assert isinstance(layer, tm.MoeLayer)
    assert tuple(layer.router.shape) == (64, 4)
    assert tuple(layer.w_gate.shape) == (4, 64, 96)
    assert tuple(layer.w_up.shape) == (4, 64, 96)
    assert tuple(layer.w_down.shape) == (4, 96, 64)
    again = tl.init_params(cfg, 0, torch.device("cpu"))
    assert torch.equal(again.layers[1].w_down, model.layers[1].w_down)
    # N(0, 1/fan_in) per expert
    std = model.layers[0].w_down.std().item()
    assert abs(std - 96 ** -0.5) < 0.1 * 96 ** -0.5


@pytest.mark.parametrize("lead", [(7,), (2, 5)], ids=["tokens", "batched"])
def test_moe_mlp_matches_reference(lead):
    jcfg, params = _jax_params()
    tcfg, model = _carried(params)
    h = _h(lead + (64,))
    for l in range(2):
        want = np.asarray(jm.moe_mlp(jnp.asarray(h),
                                     jm._layer_params(params, l), jcfg))
        got = tm.moe_mlp(torch.from_numpy(h), model.layers[l], tcfg)
        np.testing.assert_allclose(got.numpy(), want, **MLP_TOL)


def test_moe_mlp_reference_loop_matches():
    jcfg, params = _jax_params(seed=1)
    tcfg, model = _carried(params)
    h = _h((6, 64), seed=5)
    lp = jm._layer_params(params, 1)
    want = jm.moe_mlp_reference(jnp.asarray(h), lp, jcfg)
    got = tm.moe_mlp_reference(torch.from_numpy(h), model.layers[1], tcfg)
    np.testing.assert_allclose(got.numpy(), want, **MLP_TOL)
    # and the serving function against the port's own loop
    np.testing.assert_allclose(
        tm.moe_mlp(torch.from_numpy(h), model.layers[1], tcfg).numpy(),
        got.numpy(), **MLP_TOL)


@pytest.mark.parametrize("factor", [0.5, 4.0], ids=["drops", "no-drops"])
def test_moe_mlp_capacity_matches_reference(factor):
    jcfg, params = _jax_params(seed=2)
    tcfg, model = _carried(params)
    h = _h((2, 12, 64), seed=6)
    lp = jm._layer_params(params, 0)
    want = np.asarray(jm.moe_mlp_capacity(jnp.asarray(h), lp, jcfg,
                                          capacity_factor=factor))
    got = tm.moe_mlp_capacity(torch.from_numpy(h), model.layers[0], tcfg,
                              capacity_factor=factor).numpy()
    np.testing.assert_allclose(got, want, **MLP_TOL)
    dense = tm.moe_mlp(torch.from_numpy(h), model.layers[0], tcfg).numpy()
    if factor < 1:
        # C = max(k, ceil(12 * 2 / 4 * 0.5)) = 3 slots per expert for 24
        # choices: some choices are dropped, so the output differs from
        # dense dispatch there
        assert not np.allclose(got, dense, **MLP_TOL)
    else:
        np.testing.assert_allclose(got, dense, **MLP_TOL)


def test_top_k_breaks_ties_by_lowest_index():
    """Router logits built with ties (equal router columns give equal
    logits, bit for bit): the port picks what `jax.lax.top_k` picks."""
    rng = np.random.RandomState(3)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    logits[:, [2, 5, 6]] = logits[:, [2]] + 5.0      # a three-way tie on top
    logits[10:20, 7] = logits[10:20, 2]              # four-way
    logits[20:30] = 0.0                              # every expert tied
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(logits), k)
        tv, ti = tm.top_k(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # through the FFN: a router with equal columns ties every token
    jcfg, params = _jax_params(seed=5)
    router = np.array(params["layers"]["router"])
    router[:, :, 1] = router[:, :, 0]
    router[:, :, 3] = router[:, :, 0]
    params = dict(params, layers=dict(params["layers"],
                                      router=jnp.asarray(router)))
    tcfg, model = _carried(params)
    h = _h((9, 64), seed=8)
    want = np.asarray(jm.moe_mlp(jnp.asarray(h), jm._layer_params(params, 0),
                                 jcfg))
    got = tm.moe_mlp(torch.from_numpy(h), model.layers[0], tcfg).numpy()
    np.testing.assert_allclose(got, want, **MLP_TOL)
    logits = torch.from_numpy(h) @ model.layers[0].router
    _, top = tm.top_k(logits, 2)
    tied = (logits[:, 0] == logits[:, 1]) & (logits[:, 0] == logits[:, 3])
    assert bool(tied.all())
    # where expert 0's logit leads, the tie's lowest two win
    lead = logits[:, 0] > logits[:, 2]
    assert lead.any()
    assert (top[lead] == torch.tensor([0, 1])).all()


def test_int8_stacks_match_reference_quantization():
    jcfg, params = _jax_params(seed=3)
    tcfg, model = _carried(params)
    ours = tquant.quantize_params(model, mode="int8")
    ref = jax.tree.map(np.asarray,
                       jquant.quantize_params_jit(params, donate=False))
    carried = params_from_jax(ref, tcfg, "cpu")
    for l in range(2):
        for key in ("w_gate", "w_up", "w_down"):
            a, b = getattr(ours.layers[l], key), getattr(carried.layers[l],
                                                         key)
            assert isinstance(a, tquant.QStack) and isinstance(b,
                                                               tquant.QStack)
            assert torch.equal(a.q, b.q) and torch.equal(a.s, b.s), (l, key)
        # the router is not quantized (as the reference's)
        assert not isinstance(ours.layers[l].router, tquant.QStack)
        assert torch.equal(ours.layers[l].wq.q, carried.layers[l].wq.q)
    assert tquant.is_quantized(ours)
    # the model the engine draws quantized equals quantize-after-init
    drawn = tl.init_params(tcfg, 7, torch.device("cpu"), quantize="int8")
    after = tquant.quantize_params(tl.init_params(tcfg, 7,
                                                  torch.device("cpu")))
    got, want = dict(drawn.named_buffers()), dict(after.named_buffers())
    assert sorted(got) == sorted(want)
    for name, b in want.items():
        assert torch.equal(got[name], b), name
    assert tquant.weight_bytes(drawn) == tquant.weight_bytes(after)
    # weight_bytes counts the int8 stacks
    stack_bytes = sum(getattr(layer, k).nbytes for layer in drawn.layers
                      for k in ("w_gate", "w_up", "w_down"))
    # q: 2 layers x 3 stacks x (4, 64, 96) int8; s: fp32 (4, 1, out)
    assert stack_bytes == 2 * 3 * 4 * 64 * 96 + 2 * 4 * 4 * (96 + 96 + 64)
    assert tquant.weight_bytes(drawn) > stack_bytes

    h = _h((5, 64), seed=9)
    for l in range(2):
        want = np.asarray(jm.moe_mlp(jnp.asarray(h),
                                     jm._layer_params(ref, l), jcfg))
        got = tm.moe_mlp(torch.from_numpy(h), ours.layers[l], tcfg).numpy()
        np.testing.assert_allclose(got, want, **MLP_TOL)
        # the reference's bound of int8 against the unquantized FFN
        dense = tm.moe_mlp(torch.from_numpy(h), model.layers[l],
                           tcfg).numpy()
        err, scale = np.abs(got - dense).max(), np.abs(dense).max()
        assert err < 0.05 * scale + 1e-3, (err, scale)
        # and the port's int8 loop reads the stack dequantized
        loop = tm.moe_mlp_reference(torch.from_numpy(h), ours.layers[l],
                                    tcfg).numpy()
        np.testing.assert_allclose(got, loop, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_moe_forward_logits_match_reference(dispatch):
    jcfg, params = _jax_params(seed=4)
    tcfg, model = _carried(params)
    tokens = np.random.RandomState(2).randint(0, 256, (2, 11)) \
        .astype(np.int32)
    want = np.asarray(jm.moe_forward(params, jnp.asarray(tokens), jcfg,
                                     dispatch=dispatch))
    got = tm.moe_forward(model, torch.from_numpy(tokens), dispatch=dispatch)
    assert got.dtype == torch.float32 and got.shape == (2, 256)
    np.testing.assert_allclose(got.numpy(), want, **LOGITS_TOL)
    with pytest.raises(ValueError, match="dispatch"):
        tm.moe_forward(model, torch.from_numpy(tokens), dispatch="routed")


@pytest.fixture
def jax_impl():
    """Set the reference's attention impl for one test, restored after."""
    prev = jattn._impl

    def use(impl):
        jattn.set_attention_impl(impl)

    yield use
    jattn.set_attention_impl(prev)


def _moe_engines(budget, impl, quantize=None, seed=0, **kw):
    jcfg, params = _jax_params(seed=seed, max_pages_per_seq=16)
    jax_eng = TpuEngine(TpuEngineConfig(
        model=jcfg, prefill_chunk_budget=budget, quantize=quantize,
        **ENGINE_KW, **kw), params=params)
    tcfg, model = _carried(params, max_pages_per_seq=16)
    torch_eng = TorchEngine(TorchEngineConfig(
        model=tcfg, prefill_chunk_budget=budget, device="cpu",
        attention_impl=impl, quantize=quantize, **ENGINE_KW, **kw),
        model=model)
    return jax_eng, torch_eng


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["fp32", "int8"])
@pytest.mark.parametrize("impl", ["phase", "ragged"])
async def test_engine_streams_identical_to_tpu_engine(jax_impl, impl,
                                                      quantize):
    jax_impl("auto" if impl == "phase" else "ragged")
    jax_eng, torch_eng = _moe_engines(12, impl, quantize)
    try:
        want = await _run_workload(jax_eng)
        got = await _run_workload(torch_eng)
    finally:
        await jax_eng.close()
        await torch_eng.close()
    assert got == want
    assert [f for _, f in got] == ["length"] * 5
    assert torch_eng.ragged == (impl == "ragged")
    assert torch_eng.pool.active_pages == 0
    if quantize:
        assert isinstance(torch_eng.model.layers[0].w_gate, tquant.QStack)


async def test_moe_target_with_dense_draft_spec(jax_impl):
    """Speculative decoding over an MoE target with a dense draft: greedy
    streams equal the reference's spec engine and the no-draft engine."""
    jax_impl("auto")
    jcfg, params = _jax_params(seed=12, max_pages_per_seq=32)
    jdraft_cfg = jl.LlamaConfig.tiny(dtype=jnp.float32, max_pages_per_seq=32)
    dparams = jl.init_params(jax.random.PRNGKey(13), jdraft_cfg)
    tcfg, model = _carried(params, max_pages_per_seq=32)
    tdraft_cfg = tl.LlamaConfig.tiny(dtype=torch.float32,
                                     max_pages_per_seq=32)
    draft = params_from_jax(jax.tree.map(np.asarray, dparams), tdraft_cfg,
                            "cpu")
    kw = dict(num_pages=96, max_batch_size=2, decode_steps_per_sync=4,
              spec_gamma=2, spec_iters_per_sync=2)
    r = req([3, 1, 4, 1, 5], 12)
    j_spec = TpuEngine(TpuEngineConfig(model=jcfg, draft_model=jdraft_cfg,
                                       **kw), params=params,
                       draft_params=dparams)
    t_spec = TorchEngine(TorchEngineConfig(model=tcfg,
                                           draft_model=tdraft_cfg,
                                           device="cpu", **kw),
                         model=model, draft=draft)
    t_plain = TorchEngine(TorchEngineConfig(model=tcfg, device="cpu", **kw),
                          model=model)
    try:
        want = await _consume(j_spec, r, "x", [])
        got = await _consume(t_spec, r, "x", [])
        base = await _consume(t_plain, r, "x", [])
        stats = t_spec._spec_stats
    finally:
        for e in (j_spec, t_spec, t_plain):
            await e.close()
    assert got == want == base and len(got[0]) == 12
    assert stats.num_draft_tokens > 0
    assert stats.to_dict() == j_spec._spec_stats.to_dict()


def test_quantize_refusals():
    cfg = tm.MoeConfig.tiny()
    for mode in ("w8a8", "int4"):
        with pytest.raises(ValueError, match="int8"):
            TorchEngine(TorchEngineConfig(model=cfg, num_pages=16,
                                          max_batch_size=2, quantize=mode,
                                          device="cpu"))
        with pytest.raises(ValueError, match="weight-only int8"):
            tl.init_params(cfg, 0, torch.device("cpu"), quantize=mode)
        model = tl.init_params(cfg, 0, torch.device("cpu"))
        with pytest.raises(ValueError, match="weight-only int8"):
            tquant.quantize_params(model, mode=mode)
    # the message is the reference's
    with pytest.raises(ValueError) as ref:
        TpuEngine(TpuEngineConfig(model=jm.MoeConfig.tiny(), num_pages=16,
                                  max_batch_size=2, quantize="int4"))
    assert str(ref.value) == tquant.MOE_QUANT_ERROR


def test_expert_parallel_size_one_is_served_two_refused():
    from dynamo_tpu_torch.worker import main as worker_main

    base = ["--model", "x", "--router-mode", "round_robin"]
    worker_main.check_args(worker_main.parse_args(
        base + ["--expert-parallel-size", "1"]))
    with pytest.raises(SystemExit) as e:
        worker_main.check_args(worker_main.parse_args(
            base + ["--expert-parallel-size", "2"]))
    assert "--expert-parallel-size" in str(e.value)
    assert "multi-device paths" in str(e.value)
    assert "MoE" not in str(e.value)


# -- checkpoints --------------------------------------------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from dynamo_tpu.models.synth_ckpt import write_synthetic_hf_checkpoint

    return write_synthetic_hf_checkpoint(
        str(tmp_path_factory.mktemp("ckpt") / "mixtral-tiny"),
        "mixtral-tiny")


def test_config_and_loader_match_reference(synth):
    from dynamo_tpu.models import loader as jloader
    from dynamo_tpu_torch.models import loader as tloader

    jcfg = jloader.config_from_hf(synth)
    tcfg = tloader.config_from_hf(synth)
    assert isinstance(tcfg, tm.MoeConfig) and isinstance(jcfg, jm.MoeConfig)
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_layers",
              "num_heads", "num_kv_heads", "head_dim", "rope_theta",
              "rms_eps", "num_experts", "experts_per_token"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert (tcfg.num_experts, tcfg.experts_per_token) == (4, 2)
    tree = jloader.load_llama_params(synth, jcfg)
    model = tloader.load_llama_params(synth, tcfg, "cpu")
    assert set(tree["layers"]) == {"attn_norm", "wq", "wk", "wv", "wo",
                                   "mlp_norm", "router", "w_gate", "w_up",
                                   "w_down"}

    def same(t, a):
        want = tensor_from_numpy(a)
        assert t.dtype == want.dtype and torch.equal(t, want)

    same(model.embed, tree["embed"])
    same(model.lm_head, tree["lm_head"])
    for key, stack in tree["layers"].items():
        for l, layer in enumerate(model.layers):
            same(getattr(layer, key), stack[l])
    # int8 on load == quantize after load
    q = tloader.load_llama_params(synth, tcfg, "cpu", quantize="int8")
    after = tquant.quantize_params(model, mode="int8")
    for l in range(tcfg.num_layers):
        for key in ("w_gate", "w_up", "w_down"):
            a, b = getattr(q.layers[l], key), getattr(after.layers[l], key)
            assert isinstance(a, tquant.QStack)
            assert tuple(a.q.shape) == tuple(getattr(model.layers[l],
                                                     key).shape)
            assert torch.equal(a.q, b.q) and torch.equal(a.s, b.s)
    for mode in ("w8a8", "int4"):
        with pytest.raises(ValueError, match="int8"):
            tloader.load_llama_params(synth, tcfg, "cpu", quantize=mode)


async def test_engine_from_synth_checkpoint_matches_reference(synth,
                                                              jax_impl):
    """The checkpoint path end to end: `build_torch_engine` serves the
    synth Mixtral checkpoint (int8) with the reference engine's stream."""
    from dynamo_tpu.models import loader as jloader
    from dynamo_tpu_torch.llm.entrypoint import build_torch_engine

    jax_impl("auto")
    jcfg = jloader.config_from_hf(synth, page_size=16, max_pages_per_seq=8)
    j_eng = TpuEngine(TpuEngineConfig(
        model=jcfg, num_pages=32, max_batch_size=2, quantize="int8",
        decode_steps_per_sync=4),
        params=jloader.load_llama_params_device(synth, jcfg,
                                                quantize="int8"))
    t_eng, card = build_torch_engine(synth, "mixtral-tiny", num_pages=32,
                                     max_batch_size=2, quantize="int8",
                                     decode_steps_per_sync=4, device="cpu")
    r = req([9, 8, 7, 290, 299], 6)
    try:
        want = await _consume(j_eng, r, "x", [])
        got = await _consume(t_eng, r, "x", [])
    finally:
        await j_eng.close()
        await t_eng.close()
    assert isinstance(t_eng.model_cfg, tm.MoeConfig)
    assert card.kv_block_size == 16
    assert got == want and len(got[0]) == 6


def test_logits_match_transformers_mixtral(tmp_path):
    transformers = pytest.importorskip("transformers")
    from dynamo_tpu_torch.models.loader import config_from_hf, \
        load_llama_params

    hf_cfg = transformers.MixtralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rope_theta=10000.0, rms_norm_eps=1e-5,
        num_local_experts=4, num_experts_per_tok=2,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = transformers.MixtralForCausalLM(hf_cfg).float().eval()
    path = str(tmp_path / "mixtral")
    hf.save_pretrained(path, safe_serialization=True)
    cfg = config_from_hf(path, dtype=torch.float32, page_size=4,
                         max_pages_per_seq=16)
    assert isinstance(cfg, tm.MoeConfig)
    model = load_llama_params(path, cfg, torch.device("cpu"))
    tokens = [int(t) for t in
              np.random.RandomState(1).randint(0, 128, size=19)]
    with torch.no_grad():
        want = hf(torch.tensor([tokens])).logits[0].float()
    k_cache, v_cache = tl.init_cache(cfg, 16, torch.device("cpu"))
    T = len(tokens)
    table = torch.zeros((1, cfg.max_pages_per_seq), dtype=torch.int32)
    table[0, :5] = torch.arange(1, 6, dtype=torch.int32)
    with torch.inference_mode():
        x = tl.paged_forward(model, k_cache, v_cache,
                             torch.tensor([tokens], dtype=torch.int32), table,
                             torch.zeros((1,), dtype=torch.int32),
                             torch.full((1,), T, dtype=torch.int32))
        got = tquant.qm(x[0], model.lm_head).float()
    err = (got - want).abs().max().item()
    assert err < HF_TOL, err
    assert torch.equal(got.argmax(-1), want.argmax(-1))
