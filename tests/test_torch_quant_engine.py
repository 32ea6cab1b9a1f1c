"""Quantized serving end to end on the CPU: `TorchEngine(quantize=...)`
against the reference's `TpuEngine(quantize=...)`, and the ways a
quantized model reaches the engine — carried from a quantized JAX tree,
quantized by the engine, or by the loader.

Both engines start from the same fp32 weights and quantize them
themselves (the two quantizations are bit-identical); the reference's
projections run its A8 Pallas kernels in interpret mode (the
`jax_kernels` fixture of tests/test_torch_quant.py). Token streams and
finish reasons must be identical on the phase path (pipelined bursts on
and off) and on the ragged path.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import attention as jattn
from dynamo_tpu.engine import quant as jquant
from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import loader as jloader
from dynamo_tpu.models.synth_ckpt import write_synthetic_hf_checkpoint
from dynamo_tpu_torch.engine import quant
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models import loader as tloader
from dynamo_tpu_torch.models.convert import params_from_jax
from tests.test_torch_engine import _consume, req
from tests.test_torch_quant import GATED, jax_kernels  # noqa: F401

ENGINE_KW = dict(num_pages=48, max_batch_size=4, prefill_chunk=16,
                 min_prefill_bucket=8, default_max_tokens=8,
                 decode_steps_per_sync=2)


def _engines(mode: str, impl: str, seed: int = 0, **kw):
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, **GATED)
    params = jl.init_params(jax.random.PRNGKey(seed), jcfg)
    jax_eng = TpuEngine(TpuEngineConfig(model=jcfg, quantize=mode,
                                        **ENGINE_KW, **kw), params=params)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, **GATED)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    torch_eng = TorchEngine(TorchEngineConfig(
        model=tcfg, quantize=mode, attention_impl=impl, device="cpu",
        **ENGINE_KW, **kw), model=model)
    return jax_eng, torch_eng


async def _workload(eng):
    """A lane decoding when two more prompts land (one longer than the
    chunk budget): chunk rounds, mixed steps and bursts."""
    first = asyncio.create_task(_consume(eng, req(range(3, 9), 7), "a", []))
    await asyncio.sleep(0)
    rest = [_consume(eng, req(range(20, 41), 5), "b", []),
            _consume(eng, req(range(50, 61), 6, temperature=0.9, seed=11),
                     "c", [])]
    return [await first] + list(await asyncio.gather(*rest))


@pytest.mark.parametrize("impl,pipeline", [("phase", True), ("phase", False),
                                           ("ragged", True)],
                         ids=["phase-pipelined", "phase-sync", "ragged"])
@pytest.mark.parametrize("mode", ["w8a8", "int4"])
async def test_streams_identical_to_tpu_engine(jax_kernels, mode, impl,
                                               pipeline):
    prev = jattn._impl
    jattn.set_attention_impl("ragged" if impl == "ragged" else "auto")
    try:
        jax_eng, torch_eng = _engines(mode, impl, prefill_chunk_budget=8,
                                      pipeline_bursts=pipeline)
        try:
            want = await _workload(jax_eng)
            got = await _workload(torch_eng)
        finally:
            await jax_eng.close()
            await torch_eng.close()
    finally:
        jattn.set_attention_impl(prev)
    assert got == want
    assert [f for _, f in got] == ["length"] * 3
    assert isinstance(torch_eng.model.layers[0].w_down, quant.QTensor)
    assert torch_eng.pool.active_pages == 0


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown quantize mode"):
        TorchEngine(TorchEngineConfig(model=tl.LlamaConfig.tiny(),
                                      quantize="fp8", device="cpu"))


def test_callers_model_is_left_untouched():
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, **GATED)
    model = tl.init_params(cfg, 0, torch.device("cpu"))
    before = {n: t.clone() for n, t in model.named_parameters()}
    eng = TorchEngine(TorchEngineConfig(model=cfg, quantize="int4",
                                        device="cpu", **ENGINE_KW),
                      model=model)
    assert all(isinstance(getattr(layer, k), quant.QTensor)
               for layer in eng.model.layers for k in quant.QUANT_KEYS)
    assert eng.model is not model and eng.model.embed is model.embed
    assert not quant.is_quantized(model)
    for n, t in model.named_parameters():
        assert torch.equal(t, before[n]), n
    # an engine that made its own model quantizes that one in place
    own = TorchEngine(TorchEngineConfig(model=cfg, quantize="w8a8",
                                        device="cpu", **ENGINE_KW))
    assert own.model.layers[0].wq.act_bits == 8
    assert quant.weight_bytes(own.model) < quant.weight_bytes(model)


def test_pre_quantized_tree_is_carried_and_remarked_for_w8a8():
    """A tree the reference quantized ("int8": W8A16) is carried bit for
    bit; a w8a8 engine re-marks its layer weights A8 (the lm_head stays
    A16) without touching the carried model; an int8 engine serves it as
    it is."""
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.bfloat16, **GATED)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.bfloat16, **GATED)
    tree = jax.tree.map(np.asarray, jquant.quantize_params_jit(
        jl.init_params(jax.random.PRNGKey(2), jcfg), donate=False))
    carried = params_from_jax(tree, tcfg, "cpu")
    wq = carried.layers[1].wq
    assert (wq.bits, wq.act_bits) == (8, 16)
    assert np.array_equal(wq.q.T.numpy(), tree["layers"]["wq"].q[1])
    assert np.array_equal(wq.s.numpy(), tree["layers"]["wq"].s[1])
    assert np.array_equal(carried.lm_head.q.T.numpy(), tree["lm_head"].q)
    eng = TorchEngine(TorchEngineConfig(model=tcfg, quantize="w8a8",
                                        device="cpu", **ENGINE_KW),
                      model=carried)
    for layer, src in zip(eng.model.layers, carried.layers):
        for k in quant.QUANT_KEYS:
            w = getattr(layer, k)
            assert w.act_bits == 8 and w.q is getattr(src, k).q
    assert eng.model.lm_head.act_bits == 16
    assert carried.layers[0].wq.act_bits == 16
    int8_eng = TorchEngine(TorchEngineConfig(model=tcfg, quantize="int8",
                                             device="cpu", **ENGINE_KW),
                           model=carried)
    assert int8_eng.model is carried


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    return write_synthetic_hf_checkpoint(
        str(tmp_path_factory.mktemp("qckpt") / "tiny"), preset="tiny")


def _tensors(model):
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


@pytest.mark.parametrize("mode", ["int8", "w8a8", "int4"])
def test_loader_quantizes_as_it_loads(tiny_ckpt, mode):
    """`load_llama_params(quantize=...)` is bit-identical to quantizing
    after a plain load, and to the reference's
    `load_llama_params_device(quantize=...)` carried across."""
    tcfg = tloader.config_from_hf(tiny_ckpt)
    loaded = tloader.load_llama_params(tiny_ckpt, tcfg, "cpu", quantize=mode)
    after = quant.quantize_params(
        tloader.load_llama_params(tiny_ckpt, tcfg, "cpu"), mode=mode)
    jcfg = jloader.config_from_hf(tiny_ckpt)
    ref = params_from_jax(jax.tree.map(np.asarray, jloader.
                                       load_llama_params_device(
                                           tiny_ckpt, jcfg, quantize=mode)),
                          tcfg, "cpu")
    got = _tensors(loaded)
    assert isinstance(loaded.lm_head, quant.QTensor)   # vocab 300
    for other in (after, ref):
        want = _tensors(other)
        assert sorted(got) == sorted(want)
        for name, t in got.items():
            assert t.dtype == want[name].dtype and torch.equal(
                t, want[name]), name
    for layer in loaded.layers:
        for key in quant.QUANT_KEYS:
            w = getattr(layer, key)
            assert w.bits == quant._bits_of(mode)
            assert w.act_bits == quant._act_bits_of(mode)
