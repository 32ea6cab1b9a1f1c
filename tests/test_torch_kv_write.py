"""K2 paged KV write in the PyTorch port: the plain version behind
`dynamo_tpu_torch/models/llama.py` `_write_kv` against the JAX
`dynamo_tpu/models/llama.py` `_write_kv` on the CPU (its XLA scatter
branch), bit-exact, including the redirect of invalid rows to scratch
page 0 — also as the model runs it, the redirect (`_kv_targets`) once per
step and K2 on views of the projections' output in every layer. The CUDA
kernel is held against the plain version by tests/test_torch_cuda.py and
chip_smoke.py on the card.

The layer loops issue nothing around K2: counted with a
`TorchDispatchMode`, each added layer of `decode_step` and of
`ragged_prefill_decode` costs 3 aten ops fewer than before the redirect
left the loop (its `zeros_like` and two `where`)."""

import collections

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dynamo_tpu.models.llama import _write_kv as jax_write_kv
from torch.utils._python_dispatch import TorchDispatchMode

from dynamo_tpu_torch.engine import kernels
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.convert import tensor_from_numpy
from dynamo_tpu_torch.models.llama import _kv_targets, _write_kv

KVH, N, P, D = 2, 10, 4, 16


def _case(rng, valid, dtype):
    b = len(valid)
    kc = rng.standard_normal((KVH, N, P, D)).astype(dtype)
    vc = rng.standard_normal((KVH, N, P, D)).astype(dtype)
    k = rng.standard_normal((b, KVH, D)).astype(dtype)
    v = rng.standard_normal((b, KVH, D)).astype(dtype)
    # distinct real targets on pages 1.. ; invalid rows carry junk targets
    slots = rng.permutation((N - 1) * P)[:b]
    page_ids = (1 + slots // P).astype(np.int32)
    offsets = (slots % P).astype(np.int32)
    return kc, vc, k, v, page_ids, offsets, np.asarray(valid, bool)


def _run_both(args):
    kc, vc, k, v, page_ids, offsets, valid = args
    jk, jv = jax_write_kv(*(jnp.asarray(a) for a in args))
    tkc, tvc = tensor_from_numpy(kc), tensor_from_numpy(vc)
    _write_kv(tkc, tvc, tensor_from_numpy(k), tensor_from_numpy(v),
              torch.from_numpy(page_ids), torch.from_numpy(offsets),
              torch.from_numpy(valid))
    return np.asarray(jk), np.asarray(jv), tkc, tvc


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bit_exact_with_one_redirected_row(dtype):
    import ml_dtypes

    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    rng = np.random.default_rng(3)
    args = _case(rng, [True, True, False, True, True], np_dtype)
    jk, jv, tkc, tvc = _run_both(args)
    assert np.array_equal(_bits(tkc), _bits(tensor_from_numpy(jk)))
    assert np.array_equal(_bits(tvc), _bits(tensor_from_numpy(jv)))
    # the invalid row landed on scratch page 0, offset 0, and nowhere else
    assert np.array_equal(_bits(tkc[:, 0, 0]),
                          _bits(tensor_from_numpy(args[2][2])))


def test_plain_many_padding_rows_race_only_on_page_zero():
    rng = np.random.default_rng(5)
    valid = [True, False, True, False, False, True]
    args = _case(rng, valid, np.float32)
    jk, jv, tkc, tvc = _run_both(args)
    # every page but scratch page 0 is bit-exact
    assert np.array_equal(tkc.numpy()[:, 1:], jk[:, 1:])
    assert np.array_equal(tvc.numpy()[:, 1:], jv[:, 1:])
    # page 0 offset 0 holds one of the padding rows (last-writer unspecified
    # in both scatters); the rest of page 0 is untouched
    pads = [args[2][i] for i, ok in enumerate(valid) if not ok]
    assert any(np.array_equal(tkc.numpy()[:, 0, 0], p) for p in pads)
    assert np.array_equal(tkc.numpy()[:, 0, 1:], args[0][:, 0, 1:])


def test_wrapper_runs_plain_on_cpu_and_refuses_other_devices():
    rng = np.random.default_rng(7)
    kc, vc, k, v, pages, offs, _ = (torch.from_numpy(a) for a in
                                    _case(rng, [True] * 3, np.float32))
    want_k, want_v = kc.clone(), vc.clone()
    kernels.paged_kv_write_ref(want_k, want_v, k, v, pages, offs)
    kernels.paged_kv_write(kc, vc, k, v, pages, offs)
    assert torch.equal(kc, want_k) and torch.equal(vc, want_v)
    meta = [t.to("meta") for t in (kc, vc, k, v, pages, offs)]
    with pytest.raises(ValueError):
        kernels.paged_kv_write(*meta)



def _strided(a: np.ndarray, layout: str) -> torch.Tensor:
    """(B, KVH, D) rows `a` as a tensor laid out as a caller hands them to
    K2: "projection" — one (B, KVH·D) projection output viewed as heads
    (what `_decode_once` and the ragged step pass); "fused" — a slice of a
    wider (B, 3·KVH·D) output, so rows are strided by 3·KVH·D; "heads" —
    a head-major (KVH, B, D) tensor transposed."""
    t = tensor_from_numpy(a)
    b, kvh, d = a.shape
    if layout == "projection":
        return t.reshape(b, kvh * d).view(b, kvh, d)
    if layout == "fused":
        wide = torch.zeros(b, 3 * kvh * d, dtype=t.dtype)
        wide[:, kvh * d:2 * kvh * d] = t.reshape(b, kvh * d)
        return wide[:, kvh * d:2 * kvh * d].view(b, kvh, d)
    return t.transpose(0, 1).contiguous().transpose(0, 1)


@pytest.mark.parametrize("layout", ["projection", "fused", "heads"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_on_strided_views_bit_exact_with_jax(layout, dtype):
    import ml_dtypes

    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    rng = np.random.default_rng(11)
    valid = [True, False, True, True, False, True, True]
    kc, vc, k, v, pages, offs, ok = _case(rng, valid, np_dtype)
    jk, jv = jax_write_kv(*(jnp.asarray(a) for a in
                            (kc, vc, k, v, pages, offs, ok)))
    tk, tv = _strided(k, layout), _strided(v, layout)
    if layout != "projection":
        assert not tk.is_contiguous()
    tkc, tvc = tensor_from_numpy(kc), tensor_from_numpy(vc)
    kernels.paged_kv_write_ref(tkc, tvc, tk, tv, *_kv_targets(
        torch.from_numpy(pages), torch.from_numpy(offs),
        torch.from_numpy(ok)))
    for got, want in ((tkc, jk), (tvc, jv)):
        assert np.array_equal(_bits(got[:, 1:]),
                              _bits(tensor_from_numpy(np.asarray(want)[:,
                                                                        1:])))


def test_targets_once_then_plain_is_jax_write_kv():
    """`_kv_targets` (once per step) composed with K2's plain version in
    each of several layers equals JAX `_write_kv` per layer, bit for bit,
    padding rows redirected to page 0 offset 0 (all but one of them)."""
    rng = np.random.default_rng(13)
    valid = [False, True, True, False, True, False, False, True]
    cases = [_case(rng, valid, np.float32) for _ in range(3)]
    pages, offs, ok = cases[0][4:]
    t_pages, t_offs = _kv_targets(torch.from_numpy(pages),
                                  torch.from_numpy(offs),
                                  torch.from_numpy(ok))
    assert t_pages.dtype == t_offs.dtype == torch.int32
    assert np.array_equal(t_pages.numpy(), np.where(ok, pages, 0))
    assert np.array_equal(t_offs.numpy(), np.where(ok, offs, 0))
    for kc, vc, k, v, *_ in cases:                 # one layer each
        jk, jv = jax_write_kv(*(jnp.asarray(a) for a in
                                (kc, vc, k, v, pages, offs, ok)))
        tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        kernels.paged_kv_write_ref(tkc, tvc, torch.from_numpy(k),
                                   torch.from_numpy(v), t_pages, t_offs)
        assert np.array_equal(tkc.numpy()[:, 1:], np.asarray(jk)[:, 1:])
        assert np.array_equal(tvc.numpy()[:, 1:], np.asarray(jv)[:, 1:])
        assert np.array_equal(tkc.numpy()[:, 0, 1:], kc[:, 0, 1:])


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _count_step(step: str, layers: int) -> collections.Counter:
    cfg = llama.LlamaConfig.tiny(num_layers=layers, dtype=torch.float32)
    model = llama.init_params(cfg, 0, torch.device("cpu"))
    kc, vc = llama.init_cache(cfg, 40, torch.device("cpu"))
    tables = torch.arange(1, 33, dtype=torch.int32).reshape(2, 16)
    i32 = dict(dtype=torch.int32)
    with torch.inference_mode(), _OpCounter() as counter:
        if step == "decode_step":
            llama.decode_step(model, kc, vc, torch.tensor([3, 5], **i32),
                              torch.tensor([6, 9], **i32), tables,
                              torch.tensor([True, False]))
        else:
            pos = torch.tensor([0, 1, 2, 9, 0], **i32)
            lanes = torch.tensor([0, 0, 0, 1, 0], **i32)
            z = torch.zeros(1, dtype=torch.int64)
            llama.ragged_prefill_decode(
                model, kc, vc, torch.arange(5, **i32), pos,
                tables[lanes.long(), (pos // cfg.page_size).long()],
                pos % cfg.page_size,
                torch.tensor([True, True, True, True, False]), lanes, tables,
                torch.tensor([2], **i32), torch.tensor([3], **i32), z, z,
                torch.zeros(1), torch.ones(1), z)
    return counter.ops


# aten ops per added layer on the CPU while the layer loop still ran the
# redirect (a `zeros_like` and two `where` before every K2), counted with
# this test's counter and inputs
OPS_PER_LAYER_BEFORE = {"decode_step": 97, "ragged_prefill_decode": 100}


@pytest.mark.parametrize("step", sorted(OPS_PER_LAYER_BEFORE))
def test_layer_loop_issues_nothing_around_k2(step):
    two, four = _count_step(step, 2), _count_step(step, 4)
    per_layer = {op: (four[op] - two[op]) // 2 for op in four}
    assert sum(per_layer.values()) == OPS_PER_LAYER_BEFORE[step] - 3
    # one K2 per layer (the plain version's two index_put_), and of the
    # redirect's ops only what the plain attention itself issues per layer
    assert per_layer["aten.index_put_.default"] == 2
    assert per_layer["aten.zeros_like.default"] == 1
    assert per_layer["aten.where.self"] == 2
    assert per_layer.get("aten.clone.default", 0) == 0
