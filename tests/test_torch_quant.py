"""Quantized serving in the PyTorch port (dynamo_tpu_torch/engine/quant.py,
engine/int4_mm.py) against the JAX reference on the CPU, on the same inputs
made with numpy.

What the reference computes on a TPU, and what the port computes: under
"w8a8" and "int4" every projection inside the kernel gate runs the A8
kernels — activations quantized per row to int8, an exact int32 product,
the epilogue (y·sx)·s. Off the TPU the reference's `use_pallas()` is false
and it serves those modes as W8A16 / W4A16 instead; the port never does.
So the reference side here runs its Pallas kernels in interpret mode
(`DYN_PALLAS_INTERPRET=1`): `jax_kernels` wraps `quant._qm8a8` / `_qm4`
so that `attention._impl` reads "pallas" only inside those calls (forcing
it globally would also switch on the upstream decode kernel), with the
jit caches cleared around the patch.

Scales: the reference divides by constants inside jitted functions, which
XLA compiles as products with fp32 reciprocals; the port computes those
products, so quantization is compared with `jax.jit(quantize)` — what the
reference's engine and loader run.

Tolerances: quantize/pack4/_unpack4 and the plain kernels are
bit-identical. Model functions in fp32: sampled tokens identical; logits
and logprobs within 2e-2 — XLA and PyTorch sum in different orders (~1e-6
apart), and an activation lying that close to a rounding boundary of its
int8 grid rounds the other way, which moves a logit by up to sx·s·127
(~1e-2 at these widths).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.engine import attention as jattn
from dynamo_tpu.engine import int4_mm as jmm
from dynamo_tpu.engine import quant as jquant
from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.engine import int4_mm, quant
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_jax, tensor_from_numpy
from tests.test_torch_model import _round
from tests.test_torch_model import _caches as _ragged_caches
from tests.test_torch_phase import (
    _burst_args,
    _caches,
    _chunks,
    _torch,
    _written,
)

# every projection inside the gate for both modes (K and the packed row
# count multiples of 128); the lm_head (vocab 256) is int8 at act_bits 16
GATED = dict(hidden_size=256, intermediate_size=512, num_heads=4,
             num_kv_heads=2, head_dim=128)
LOGIT_TOL = 2e-2
_qjit = jax.jit(jquant.quantize, static_argnums=(1, 2))


@pytest.fixture
def jax_kernels(monkeypatch):
    """The reference's qm routed to its A8 Pallas kernels (interpret
    mode) for the duration of a test."""
    def routed(fn):
        def call(x, w):
            prev = jattn._impl
            jattn.set_attention_impl("pallas")
            try:
                return fn(x, w)
            finally:
                jattn.set_attention_impl(prev)
        return call

    monkeypatch.setenv("DYN_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jquant, "_qm8a8", routed(jquant._qm8a8))
    monkeypatch.setattr(jquant, "_qm4", routed(jquant._qm4))
    jax.clear_caches()
    yield
    jax.clear_caches()


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _weights(rng, k, n):
    """Columns of very different scales, so scales span many binades."""
    return (rng.standard_normal((k, n))
            * np.logspace(-2, 1, n)[None, :]).astype(np.float32)


# -- quantize, pack4, _unpack4 ------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,act_bits", [(8, 16), (8, 8), (4, 16)])
def test_quantize_bit_exact_with_jax(dtype, bits, act_bits):
    rng = np.random.default_rng(bits + act_bits)
    w = jnp.asarray(_weights(rng, 192, 256)).astype(getattr(jnp, dtype))
    want = _qjit(w, bits, act_bits)
    got = quant.quantize(tensor_from_numpy(np.asarray(w)), bits, act_bits)
    assert (got.bits, got.act_bits) == (bits, act_bits)
    assert got.shape == w.shape == want.shape
    assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32
    # the port stores q K-major: the transpose of the reference's
    assert np.array_equal(got.q.T.numpy(), np.asarray(want.q))
    assert np.array_equal(got.s.numpy(), np.asarray(want.s))
    assert got.nbytes == want.nbytes
    with pytest.raises(AssertionError):
        quant.quantize(tensor_from_numpy(np.asarray(w)), 4, 8)


def test_pack4_and_unpack4_bit_exact_with_jax():
    rng = np.random.default_rng(3)
    vals = rng.integers(-7, 8, (5, 64)).astype(np.int8)
    packed = quant.pack4(torch.from_numpy(vals))
    assert np.array_equal(packed.numpy(),
                          np.asarray(jquant.pack4(jnp.asarray(vals))))
    assert torch.equal(quant._unpack4(packed), torch.from_numpy(vals))
    every_byte = np.arange(-128, 128, dtype=np.int8).reshape(4, 64)
    assert np.array_equal(
        quant._unpack4(torch.from_numpy(every_byte)).numpy(),
        np.asarray(jquant._unpack4(jnp.asarray(every_byte))))


# -- plain K5 / K6 against the Pallas kernels ----------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(128, 256), (256, 512)])
@pytest.mark.parametrize("bits", [8, 4], ids=["k5-w8a8", "k6-int4"])
def test_plain_kernels_bit_identical_with_pallas_interpret(monkeypatch, dtype,
                                                           k, n, bits):
    monkeypatch.setenv("DYN_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(k + n + bits)
    qj = _qjit(jnp.asarray(_weights(rng, k, n)), bits, 16)
    qt = quant.QTensor(tensor_from_numpy(np.asarray(qj.q)).T.contiguous(),
                       tensor_from_numpy(np.asarray(qj.s)), bits=bits)
    j_fn, t_fn = ((jmm.w8a8_matmul, int4_mm.w8a8_matmul) if bits == 8
                  else (jmm.int4_matmul, int4_mm.int4_matmul))
    for m in (1, 8, 33):
        x = rng.standard_normal((m, k)).astype(np.float32)
        x *= np.logspace(-3, 2, m)[:, None].astype(np.float32)
        x[0, 5] = 40.0                                 # an outlier
        if m > 2:
            x[1] = 0.0                                 # sx at its floor
        xj = jnp.asarray(x).astype(getattr(jnp, dtype))
        want = tensor_from_numpy(np.asarray(j_fn(xj, qj.q, qj.s)))
        got = t_fn(tensor_from_numpy(np.asarray(xj)), qt.q, qt.s)
        assert got.dtype == want.dtype and got.shape == (m, n)
        assert np.array_equal(_bits(got), _bits(want)), m


def test_plain_prologue_matches_reference():
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((40, 256))
         * rng.uniform(0.01, 100, (40, 1))).astype(np.float32)
    x[3] = 0.0
    xq_j, sx_j, _, _ = jax.jit(jmm._a8_prologue)(jnp.asarray(x))
    xq, sx = int4_mm.a8_prologue_ref(torch.from_numpy(x))
    assert np.array_equal(xq.numpy(), np.asarray(xq_j)[:40])
    assert np.array_equal(sx.numpy(), np.asarray(sx_j)[:40])


def test_wrappers_refuse_other_devices():
    qt = quant.quantize(torch.randn(128, 256), 8, 8)
    x = torch.randn(2, 128)
    with pytest.raises(ValueError):
        int4_mm.w8a8_matmul(x.to("meta"), qt.q.to("meta"), qt.s.to("meta"))
    q4 = quant.quantize(torch.randn(128, 256), 4)
    with pytest.raises(ValueError):
        int4_mm.int4_matmul(x.to("meta"), q4.q.to("meta"), q4.s.to("meta"))


# -- qm: the reference's gate -------------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "w8a8", "int4"])
def test_qm_gate_mirrors_reference(jax_kernels, mode):
    """Inside the gate: the kernels, bit-identical with the reference's
    routed to its Pallas kernels (int8 is W8A16 everywhere). Outside it
    (K = 64, or a packed width of 64 / 96): W8A16 / W4A16, as the reference
    computes there, within fp32 summation order."""
    rng = np.random.default_rng(21)
    bits, act = quant._bits_of(mode), quant._act_bits_of(mode)
    for k, n, inside in ((256, 256, True), (64, 256, False),
                         (128, 128 if bits == 4 else 192, False)):
        w = jnp.asarray(_weights(rng, k, n))
        qj = _qjit(w, bits, act)
        qt = quant.quantize(torch.from_numpy(np.array(w)), bits, act)
        x = rng.standard_normal((3, 5, k)).astype(np.float32)
        want = np.asarray(jquant.qm(jnp.asarray(x), qj))
        got = quant.qm(torch.from_numpy(x), qt).numpy()
        assert got.shape == want.shape == (3, 5, n)
        if inside and mode != "int8":
            assert np.array_equal(got, want), (k, n)
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        assert quant._kernel_gate(torch.from_numpy(x), qt) == inside


def test_w8a8_differs_from_int8_on_outlier_activations():
    """The reference pins w8a8 == int8 on the CPU, where it never
    quantizes activations. The port quantizes them everywhere: with an
    outlier in a row, the other entries of that row lose precision."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy(_weights(rng, 256, 256))
    x = torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32))
    x[:, 7] = 300.0
    qa8 = quant.quantize(w, 8, 8)
    y8a8 = quant.qm(x, qa8)
    y8 = quant.qm(x, quant.quantize(w, 8, 16))
    assert (y8a8 - y8).abs().max() > 1.0
    assert torch.equal(y8a8, int4_mm.w8a8_matmul_ref(x, qa8.q, qa8.s))
    # both see the outlier column alike: the products stay correlated
    assert torch.corrcoef(torch.stack([y8a8.flatten(), y8.flatten()]))[0, 1] \
        > 0.9


# -- carrying, quantizing, loading ---------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "w8a8", "int4"])
def test_port_quantization_equals_carried_jax_quantization(mode):
    """quantize_params on the port's model gives the very bits that the
    reference's quantize_params_jit gives, carried across."""
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.bfloat16, **GATED)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.bfloat16, **GATED)
    params = jl.init_params(jax.random.PRNGKey(7), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    ours = quant.quantize_params(model, mode=mode)
    carried = params_from_jax(jax.tree.map(np.asarray, jquant.quantize_params_jit(
        params, donate=False, mode=mode)), tcfg, "cpu")
    for a, b in [(ours, carried)] + list(zip(ours.layers, carried.layers)):
        for name, t in a.named_parameters(recurse=False):
            assert torch.equal(t, getattr(b, name)), name
        for name, t in a.named_buffers():
            assert torch.equal(t, b.get_buffer(name)), name
    for key in quant.QUANT_KEYS:
        w, c = getattr(ours.layers[1], key), getattr(carried.layers[1], key)
        assert (w.bits, w.act_bits) == (c.bits, c.act_bits)
    assert ours.lm_head.bits == 8 and ours.lm_head.act_bits == 16
    # the source model was left as it was, and shares its other tensors
    assert not quant.is_quantized(model)
    assert ours.embed is model.embed
    assert quant.weight_bytes(ours) < quant.weight_bytes(model)


def test_lm_head_vocab_rule_and_resident_bytes():
    cfg = tl.LlamaConfig.tiny(vocab_size=quant.LM_HEAD_QUANT_MAX_VOCAB + 8,
                              hidden_size=16, intermediate_size=32,
                              head_dim=4, num_layers=1)
    model = tl.LlamaModel(cfg, torch.device("meta"))
    out = quant.quantize_params(model, mode="int4")
    assert not isinstance(out.lm_head, quant.QTensor)
    w = out.layers[0].w_gate
    assert w.shape == (16, 32) and tuple(w.q.shape) == (16, 16)
    assert w.nbytes == 16 * 16 + 4 * 32
