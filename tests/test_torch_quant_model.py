"""The port's model functions under quantized serving against the JAX
reference on the CPU: `prefill_batch` then `decode_multi_step`,
`mixed_prefill_decode` and `ragged_prefill_decode`, with "w8a8" and "int4"
weights quantized by the reference (`quantize_params_jit`) and carried
across by `params_from_jax`, on the same numpy inputs and caches.

Two geometries: `GATED` (hidden 256, intermediate 512, head_dim 128),
where every projection takes the A8 kernels on both sides (the reference's
routed to its Pallas kernels in interpret mode, tests/test_torch_quant.py
`jax_kernels`), and the 64-wide `tiny()`, where every projection falls
outside the gate (64 is not a multiple of 128) and both compute W8A16 /
W4A16. fp32; sampled tokens identical; logits, logprobs and written K/V
within `LOGIT_TOL` (tests/test_torch_quant.py says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import quant as jquant
from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.engine import int4_mm, quant
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_jax, tensor_from_numpy
from tests.test_torch_model import _caches as _ragged_caches
from tests.test_torch_model import _round
from tests.test_torch_phase import (
    _burst_args,
    _caches,
    _chunks,
    _torch,
    _written,
)
from tests.test_torch_quant import GATED, LOGIT_TOL, jax_kernels  # noqa: F401


def _quantized_pair(mode: str, seed: int, **geometry):
    """(jcfg, tcfg, quantized JAX params, the port's model carried across
    by params_from_jax) in fp32."""
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, **geometry)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, **geometry)
    params = jquant.quantize_params_jit(
        jl.init_params(jax.random.PRNGKey(seed), jcfg), donate=False,
        mode=mode)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return jcfg, tcfg, params, model


def _launch_counts():
    return (int4_mm._W8A8_KERNEL.launches, int4_mm._INT4_KERNEL.launches)


GEOMETRIES = [pytest.param(GATED, id="gated"),
              pytest.param({}, id="ungated-64")]


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("mode", ["w8a8", "int4"])
def test_prefill_and_burst_match_jax(jax_kernels, mode, geometry):
    """prefill_batch (aligned, K3) then decode_multi_step on the caches it
    filled, both sides."""
    jcfg, tcfg, params, model = _quantized_pair(mode, 1, **geometry)
    assert isinstance(model.layers[0].wq, quant.QTensor)
    assert model.layers[0].wq.act_bits == (8 if mode == "w8a8" else 16)
    rng = np.random.default_rng(2)
    toks, tables, cached, seq_lens = _chunks(rng, tcfg, [0, 4, 0], [7, 8, 0],
                                             8)
    kc, vc = _caches(rng, tcfg, "float32")
    j_logits, jkc, jvc = jl.prefill_batch(
        params, tuple(map(jnp.asarray, kc)), tuple(map(jnp.asarray, vc)),
        *(jnp.asarray(a) for a in (toks, tables, cached, seq_lens)),
        cfg=jcfg, aligned=True)
    tkc, tvc = [list(map(tensor_from_numpy, c)) for c in (kc, vc)]
    t_logits = tl.prefill_batch(model, tkc, tvc, *(torch.from_numpy(a) for a
                                                   in (toks, tables, cached,
                                                       seq_lens)),
                                aligned=True)
    live = [0, 1]
    np.testing.assert_allclose(t_logits.numpy()[live],
                               np.asarray(j_logits)[live], atol=LOGIT_TOL,
                               rtol=0)
    assert np.array_equal(t_logits.numpy()[live].argmax(-1),
                          np.asarray(j_logits)[live].argmax(-1))
    # a 3-step greedy burst over the two prefilled lanes (+ 1 padding lane)
    burst = _burst_args(rng, tcfg, [7, 12, 0], [True, True, False], False)
    burst = (np.asarray(j_logits).argmax(-1).astype(np.int32),
             seq_lens, tables) + burst[3:]
    j_out, _, _ = jl.decode_multi_step(
        params, jkc, jvc, *(jnp.asarray(a) for a in burst), cfg=jcfg,
        num_steps=3)
    t_out = tl.decode_multi_step(model, tkc, tvc, *map(_torch, burst),
                                 num_steps=3).numpy()
    j_out = np.asarray(j_out)
    valid = burst[3]
    assert np.array_equal(t_out[0][:, valid], j_out[0][:, valid])
    np.testing.assert_allclose(t_out[1][:, valid], j_out[1][:, valid],
                               atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("mode", ["w8a8", "int4"])
def test_mixed_prefill_decode_matches_jax(jax_kernels, mode, geometry):
    jcfg, tcfg, params, model = _quantized_pair(mode, 3, **geometry)
    rng = np.random.default_rng(4)
    chunk = _chunks(rng, tcfg, [4, 0], [6, 8], 8)
    burst = _burst_args(rng, tcfg, [9, 4, 0, 0], [True, True, False, True],
                        True)
    kc, vc = _caches(rng, tcfg, "float32")
    j_out, j_ch, jkc, _ = jl.mixed_prefill_decode(
        params, tuple(map(jnp.asarray, kc)), tuple(map(jnp.asarray, vc)),
        *(jnp.asarray(a) for a in chunk + burst), cfg=jcfg, num_steps=2,
        aligned=True, topk_lp=4)
    tkc, tvc = [list(map(tensor_from_numpy, c)) for c in (kc, vc)]
    t_out, t_ch = tl.mixed_prefill_decode(
        model, tkc, tvc, *map(_torch, chunk + burst), num_steps=2,
        aligned=True, topk_lp=4)
    np.testing.assert_allclose(t_ch.numpy(), np.asarray(j_ch),
                               atol=LOGIT_TOL, rtol=0)
    t_out, j_out, valid = t_out.numpy(), np.asarray(j_out), burst[3]
    assert np.array_equal(t_out[0][:, valid], j_out[0][:, valid])
    assert np.array_equal(t_out[2:6][:, :, valid], j_out[2:6][:, :, valid])
    np.testing.assert_allclose(t_out[1][:, valid], j_out[1][:, valid],
                               atol=LOGIT_TOL, rtol=0)
    toks, tables, cached, seq_lens = chunk
    for tk, jk in zip(tkc, jkc):
        want = tensor_from_numpy(np.asarray(jk))
        for page, off in _written(tables, cached, seq_lens, tcfg.page_size):
            torch.testing.assert_close(tk[:, page, off], want[:, page, off],
                                       atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("mode", ["w8a8", "int4"])
def test_ragged_step_matches_jax(jax_kernels, mode, geometry):
    jcfg, tcfg, params, model = _quantized_pair(mode, 5, **geometry)
    rng = np.random.default_rng(6)
    args = _round(rng, tcfg)
    kc, vc = _ragged_caches(rng, tcfg, np.float32)
    out, ch, _, _ = jl.ragged_prefill_decode(
        params, tuple(jnp.asarray(a) for a in kc),
        tuple(jnp.asarray(a) for a in vc),
        *(jnp.asarray(a) for a in args), cfg=jcfg)
    before = _launch_counts()
    t_out, t_ch = tl.ragged_prefill_decode(
        model, list(map(tensor_from_numpy, kc)),
        list(map(tensor_from_numpy, vc)), *map(_torch, args))
    assert _launch_counts() == before        # CPU tensors: plain versions
    np.testing.assert_allclose(t_ch.numpy()[:2], np.asarray(ch)[:2],
                               atol=LOGIT_TOL, rtol=0)
    out, t_out = np.asarray(out), t_out.numpy()
    assert np.array_equal(t_out[0, :, :2], out[0, :, :2])


def test_bf16_model_route_is_unchanged():
    """A bf16 Parameter goes through `qm` as exactly `x @ w`."""
    cfg = tl.LlamaConfig.tiny()
    model = tl.init_params(cfg, 0, torch.device("cpu"))
    x = torch.randn(3, cfg.hidden_size, dtype=cfg.dtype)
    assert torch.equal(quant.qm(x, model.layers[0].wq),
                       x @ model.layers[0].wq)
    assert not quant.is_quantized(model)
