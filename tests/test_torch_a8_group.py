"""The A8 GEMMs' grouped call and the stream GEMM's work split, on the CPU.

`quant.qm_group` multiplies the activations that q/k/v (and gate/up) share
by all their A8 weights in one K5 / K6 call: one row quantize, one GEMM,
one counted launch. It must be the reference's function bit for bit: the
separate calls share xq and sx, and the int32 sums are exact. Held here
against the JAX `qkv_proj` and gate/up `qm` calls with the reference's A8
Pallas kernels in interpret mode (`jax_kernels`), and against the port's
own separate calls, on the CPU (the plain versions).

`int4_mm.stream_split` mirrors the integer arithmetic the stream GEMM
(`csrc/a8_gemm.cuh`, M <= 64) does on the device: units of (32 weight
rows, 512 bytes of K) in tile-major order, CTA c of G = min(n, U) owning
units [c·U/G, (c+1)·U/G), pieces of cut tiles parked in slot 2c (the
CTA's first tile) or 2c + 1 (its last), one ticket per piece. These tests
pin that every unit is covered exactly once, the windows differ by at most
one unit, slots never collide, and each cut tile's ticket count is the
number of its pieces, counted as the kernel counts it (`cta_of`).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dynamo_tpu.engine import quant as jquant
from dynamo_tpu.models import llama as jl
from dynamo_tpu_torch.engine import int4_mm, quant
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import tensor_from_numpy
from tests.test_torch_quant import GATED, _bits, jax_kernels  # noqa: F401
from tests.test_torch_quant_model import _quantized_pair

# -- the grouped call against the reference -----------------------------------


@pytest.mark.parametrize("mode", ["w8a8", "int4"])
def test_grouped_qkv_and_gate_up_bit_identical_with_jax(jax_kernels, mode):
    """Layer 0's q/k/v projections and its gate/up pair through `qm_group`
    (one A8 call each) equal the reference's `qkv_proj` and its two `qm`
    calls, whose A8 products run the Pallas kernels in interpret mode, bit
    for bit in fp32. `_swiglu` then applies silu, which PyTorch and XLA
    round apart in the last bit, so it is held to the port's own two-step
    product of the same gate/up."""
    jcfg, tcfg, params, model = _quantized_pair(mode, 3, **GATED)
    lp = jl._layer_params(params, 0)
    layer = model.layers[0]
    rng = np.random.default_rng(4)
    for rows in (1, 5, 40):
        h = rng.standard_normal((rows, GATED["hidden_size"])).astype(
            np.float32)
        h[0] *= 30.0                                   # a row of large scale
        hj, ht = jnp.asarray(h), tensor_from_numpy(h)
        want = jl.qkv_proj(hj, lp, jcfg)
        got = tl.qkv_proj(ht, layer, tcfg)
        for w, g in zip(want, got):
            assert np.array_equal(_bits(g), np.asarray(w)), rows
        gate, up = quant.qm_group(ht, [layer.w_gate, layer.w_up])
        assert np.array_equal(_bits(gate),
                              np.asarray(jquant.qm(hj, lp["w_gate"])))
        assert np.array_equal(_bits(up), np.asarray(jquant.qm(hj, lp["w_up"])))
        assert torch.equal(tl._swiglu(ht, layer), quant.qm(
            torch.nn.functional.silu(gate) * up, layer.w_down))


@pytest.mark.parametrize("bits,act", [(8, 8), (4, 16)],
                         ids=["w8a8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_equals_separate_calls_and_counts_nothing_on_cpu(bits, act,
                                                               dtype):
    gen = torch.Generator().manual_seed(bits + act)
    k = 256
    ws = [quant.quantize(torch.randn(k, n, generator=gen), bits, act)
          for n in (512, 256, 256)]
    x = (torch.randn(2, 3, k, generator=gen) * 4).to(dtype)
    before = (int4_mm._W8A8_KERNEL.launches, int4_mm._INT4_KERNEL.launches)
    got = quant.qm_group(x, ws)
    assert (int4_mm._W8A8_KERNEL.launches,
            int4_mm._INT4_KERNEL.launches) == before
    for g, w in zip(got, ws):
        want = quant.qm(x, w)
        assert g.shape == want.shape == (2, 3, w.shape[1])
        assert torch.equal(g, want)


def test_group_takes_qm_for_mixed_or_ungated_weights():
    """Plain tensors, W8A16 weights, mixed kinds or a weight outside the
    kernel gate: `qm` per weight, as before."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(4, 256, generator=gen)
    dense = torch.randn(256, 128, generator=gen)
    a8 = quant.quantize(torch.randn(256, 256, generator=gen), 8, 8)
    w16 = quant.quantize(torch.randn(256, 256, generator=gen), 8, 16)
    i4 = quant.quantize(torch.randn(256, 256, generator=gen), 4)
    narrow = quant.quantize(torch.randn(256, 192, generator=gen), 8, 8)
    for ws in ([dense, dense], [a8, w16], [a8, i4], [a8, narrow], [w16]):
        got = quant.qm_group(x, ws)
        for g, w in zip(got, ws):
            assert torch.equal(g, quant.qm(x, w))


def test_group_wrappers_take_at_most_three_weights():
    qt = quant.quantize(torch.randn(128, 256), 8, 8)
    x = torch.randn(2, 128)
    assert len(int4_mm.w8a8_matmul_group(x, [(qt.q, qt.s)] * 3)) == 3
    with pytest.raises(ValueError):
        int4_mm._launch(int4_mm._W8A8_KERNEL, x, [(qt.q, qt.s)] * 4,
                        int4=False)


# -- the GEMM designs, the wide tiles and the stream GEMM's work split ---------


@pytest.mark.parametrize("m,want", [
    (1, ("stream", 1)), (8, ("stream", 1)), (9, ("stream", 2)),
    (16, ("stream", 2)), (17, ("wide", 0)), (40, ("wide", 0)),
    (64, ("wide", 0)), (65, ("wide", 0)), (512, ("wide", 0))])
def test_design_by_m(m, want):
    assert int4_mm.design(m) == want


@pytest.mark.parametrize("int4,m,cols,want", [
    (True, 512, 14336, 256),          # gate/up chunk: 224 tiles
    (True, 512, 2 * 14336, 256),      # grouped gate/up
    (True, 512, 4096, 128),           # wq/wo, down: 64 tiles would idle
    (True, 512, 6144, 128),           # grouped q/k/v: 96 tiles
    (True, 40, 14336, 128),           # one row of tiles
    (True, 600, 14336, 256),
    (False, 512, 14336, 128)])        # K5: one tile
def test_wide_tile_by_shape(int4, m, cols, want):
    assert int4_mm.wide_cols(int4, m, cols, 132) == want


def _check_split(rows, k, n_ctas):
    split = int4_mm.stream_split(rows, k, n_ctas)
    kc = -(-k // int4_mm.STREAM_CHUNK)
    tiles = rows // int4_mm.STREAM_ROWS
    total = tiles * kc
    g = min(n_ctas, total)
    assert len(split) == g
    covered, slots, pieces = {}, {}, {}
    sizes = []
    for c, cta in enumerate(split):
        sizes.append(sum(e - b for _, b, e, _ in cta))
        cut = [p for p in cta if p[3] >= 0]
        assert len(cut) <= 2
        for tile, b, e, slot in cta:
            assert 0 <= tile < tiles and 0 <= b < e <= kc
            for u in range(b, e):
                assert (tile, u) not in covered, "a unit covered twice"
                covered[(tile, u)] = c
            if slot >= 0:
                assert slot in (2 * c, 2 * c + 1) and slot not in slots
                slots[slot] = tile
                pieces.setdefault(tile, []).append(c)
            else:
                assert (b, e) == (0, kc)
    assert len(covered) == total
    assert max(sizes) - min(sizes) <= 1
    for tile, ctas in pieces.items():
        lo = int4_mm.cta_of(tile * kc, total, g)
        hi = int4_mm.cta_of(tile * kc + kc - 1, total, g)
        assert sorted(ctas) == list(range(lo, hi + 1)), tile
        assert len(ctas) >= 2


@pytest.mark.parametrize("rows,k", [(4096, 4096), (1024, 4096),
                                    (14336, 4096), (4096, 14336),
                                    (7168, 4096), (512, 14336),
                                    (6144, 4096), (28672, 4096)])
@pytest.mark.parametrize("n_ctas", [264, 132])
def test_split_of_8b_projections(rows, k, n_ctas):
    """Llama-3-8B's projections, int8 and packed int4 rows, and the grouped
    q/k/v (6144) and gate/up (28672) rows, on one and two CTAs per SM."""
    _check_split(rows, k, n_ctas)


@pytest.mark.parametrize("rows,k,n_ctas", [
    (128, 128, 264),      # fewer units than CTAs
    (256, 384, 7),        # a short last chunk
    (384, 640, 5),
    (128, 4096, 3),       # one tile cut over several CTAs
    (4096, 128, 1),       # one CTA: nothing cut
    (32, 4096, 264),      # one tile cut over 8 CTAs
    (160 * 32, 1152, 264)])
def test_split_edges(rows, k, n_ctas):
    _check_split(rows, k, n_ctas)


def test_split_balances_every_8b_call():
    """At two CTAs per SM on 132 SMs no CTA runs more than one unit above
    the average on any 8B projection, grouped or not."""
    for rows, k in ((4096, 4096), (1024, 4096), (14336, 4096),
                    (4096, 14336), (6144, 4096), (28672, 4096)):
        split = int4_mm.stream_split(rows, k, 264)
        sizes = [sum(e - b for _, b, e, _ in cta) for cta in split]
        avg = (rows // int4_mm.STREAM_ROWS * (k // int4_mm.STREAM_CHUNK)
               / len(split))
        assert max(sizes) <= avg + 1
