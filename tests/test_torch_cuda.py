"""The port's hand-written CUDA kernels on the card, against their plain
versions on the same inputs; and the torch engine on the card against the
same engine on the CPU. Every test here is `cuda`-marked and skips where
torch.cuda.is_available() is false.

This file imports neither jax nor dynamo_tpu, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: K2 and K3 are copies, bit-exact outside scratch page 0, on
contiguous and on strided sources (the views a step hands them). K1
and K4 in fp32 at atol/rtol 2e-5 (the
reference's kernel-parity tolerance); in bf16 at rtol 1.6e-2, two bf16
ulps (2^-7 relative), since both sides round the output to bf16 once
(the kernel's P·V takes P as a bf16 head and tail), with atol 4e-3
(2^-8) for rows whose output is small beside its V values. With q = 0 every score is 0
and P = 1 is exact in bf16, so the bf16 kernel's output is each row's
fp32 mean of the V rows it can see, rounded once: held to the fp32 plain
version at rtol 4e-3 (half a bf16 ulp), atol 1e-5. K4 in bf16 runs K1's
core at one row per lane (the same P·V) and is held to the
same tolerances. K5 and K6 (the A8
GEMMs) compute an exact int32 product between two roundings that both
sides make alike: bit-identical with their plain versions. The engine's
CUDA graphs (engine/graphs.py) replay the same kernels on the same
inputs: bit-identical with eager calls, outputs and caches. The phase
path's prefill attention through K1 (`attention.prefill_attention`) is
held to K1's tolerances on the valid rows, its padding rows exact zeros.
The KV gather is a copy: bit-exact. The CUDA IPC plane moves bytes:
bit-exact across two processes. KVBM's offload (the gather, a block-order
copy, the pinned copy to the host) and onboard (the pinned stack, one copy
to the card, K3) move bytes too: bit-exact at Llama-3-8B's KV geometry;
with the pipelined offload running across graph captures, fp32 streams
equal the eager engine's bit for bit. The dispatch watchdog trips once on
a real device stall (`torch.cuda._sleep` inside one dispatch) and the
worker's quarantine completes; idle canaries run through the card's
engine. MoE: `moe_mlp` (cuBLAS expert products) against the fp32
per-token loop, fp32 at FP32_TOL and bf16 / int8 stacks within
MOE_BF16_TOL of the largest output (tokens at a router near-tie,
ROUTER_TIE_TOL, set apart); top-k ties take the lowest expert; an MoE
burst's graph replay bit-identical with eager; int8 MoE streams equal
on the card and the CPU. The image encoder's tokens on the card equal
its fp64 numpy version and the CPU's. The flight recorders: the memory
ledger's device figures are the caching allocator's (allocated bytes
exact), a real allocator OOM is `is_resource_exhausted`, and an engine
with both recorders armed gives the unarmed engine's streams bit for bit
with the same captures, replays and launches. Request tracing: an engine
under an enabled tracer gives the untraced engine's streams, captures,
replays and launches, and every span it hands the drain carries host
values only (ints, strings, bools, floats; never a tensor). The router's
native radix tree builds on the card's machine and serves by default; a
`--mock` worker process holds no CUDA context. Flight control's
mechanism: a bucket rung proposed while a phase engine serves is adopted
at its safe point, its prefill shape warms up eagerly before its graph
is captured, a round at that shape replays bit-identically with eager,
and the fp32 streams equal those of an engine without the rung.
"""

import asyncio
import copy

import numpy as np
import pytest
import torch

from dynamo_tpu_torch.engine import attention, int4_mm, kernels, quant, ragged

pytestmark = pytest.mark.cuda

FP32_TOL = {"atol": 2e-5, "rtol": 2e-5}
BF16_TOL = {"atol": 4e-3, "rtol": 1.6e-2}
UNIFORM_TOL = {"atol": 1e-5, "rtol": 4e-3}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (hand-written kernels)")
    return torch.device("cuda")


def _attention_case(gen, t_rows, h, kvh, d, n_pages, p, max_pages, qpos):
    lanes_n = 4
    q = torch.randn(t_rows, h, d, generator=gen)
    k = torch.randn(kvh, n_pages, p, d, generator=gen)
    v = torch.randn(kvh, n_pages, p, d, generator=gen)
    tables = (1 + torch.randperm(lanes_n * max_pages, generator=gen)) \
        .reshape(lanes_n, max_pages).to(torch.int32)
    lanes = torch.randint(0, lanes_n, (t_rows,), generator=gen,
                          dtype=torch.int32)
    return q, k, v, torch.tensor(qpos, dtype=torch.int32), lanes, tables


@pytest.mark.parametrize("dtype,tol", [(torch.float32, FP32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("h,kvh,p", [(8, 2, 16), (32, 8, 16), (4, 4, 8)])
def test_ragged_kernel_matches_plain(cuda_device, dtype, tol, h, kvh, p):
    gen = torch.Generator().manual_seed(h * 100 + kvh * 10 + p)
    qpos = [0, 3, p - 1, p, p + 1, 2 * p - 1, 2 * p, 40, 47, -1, 5, -1]
    args = _attention_case(gen, len(qpos), h, kvh, 128, 40, p,
                           48 // p + 1, qpos)
    q, k, v = (a.to(cuda_device, dtype) for a in args[:3])
    rest = [a.to(cuda_device) for a in args[3:]]
    got = ragged.ragged_paged_attention(q, k, v, *rest)
    want = ragged.ragged_attention_ref(q, k, v, *rest)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.all(got[9] == 0) and torch.all(got[11] == 0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, FP32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
def test_ragged_kernel_split_kv_decode_rows(cuda_device, dtype, tol):
    """Few rows, long contexts: the kernel splits each row's pages across
    CTAs and merges them; padding rows stay exact zeros."""
    gen = torch.Generator().manual_seed(31)
    h, kvh, p, max_pages = 32, 8, 16, 128
    qpos = [0, 15, 16, 700, 1300, 2047, -1]
    lanes = torch.arange(len(qpos), dtype=torch.int32)
    tables = (1 + torch.randperm(len(qpos) * max_pages, generator=gen)) \
        .reshape(len(qpos), max_pages).to(torch.int32)
    n_pages = len(qpos) * max_pages + 1
    assert ragged.num_splits(len(qpos), kvh, max_pages, 132) > 1
    q = torch.randn(len(qpos), h, 128, generator=gen).to(cuda_device, dtype)
    k = torch.randn(kvh, n_pages, p, 128, generator=gen).to(cuda_device,
                                                            dtype)
    v = torch.randn(kvh, n_pages, p, 128, generator=gen).to(cuda_device,
                                                            dtype)
    rest = [torch.tensor(qpos, dtype=torch.int32).to(cuda_device),
            lanes.to(cuda_device), tables.to(cuda_device)]
    got = ragged.ragged_paged_attention(q, k, v, *rest)
    want = ragged.ragged_attention_ref(q, k, v, *rest)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.all(got[-1] == 0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, FP32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("n_pad", [3, 600])
def test_ragged_kernel_chunk_tiles(cuda_device, dtype, tol, n_pad):
    """Prefill chunks as the engine lays them out: contiguous rows of one
    lane crossing 16-row blocks, a decode row between them, padding rows
    of lane 0 sharing a block with lane 0's chunk. 3 padding rows give a
    small grid (split-KV), 600 a large one."""
    gen = torch.Generator().manual_seed(41 + n_pad)
    h, kvh, p, d, max_pages = 32, 8, 16, 128, 40
    chunks = [(0, 5, 37), (1, 300, 1), (2, 100, 20), (3, 611, 9)]
    qpos, lanes = [], []
    for lane, start, n in chunks:
        qpos += range(start, start + n)
        lanes += [lane] * n
    qpos += [-1] * n_pad
    lanes += [0] * n_pad
    tables = (1 + torch.randperm(len(chunks) * max_pages, generator=gen)) \
        .reshape(len(chunks), max_pages).to(torch.int32)
    n_pages = len(chunks) * max_pages + 1
    q = torch.randn(len(qpos), h, d, generator=gen).to(cuda_device, dtype)
    k = torch.randn(kvh, n_pages, p, d, generator=gen).to(cuda_device, dtype)
    v = torch.randn(kvh, n_pages, p, d, generator=gen).to(cuda_device, dtype)
    rest = [torch.tensor(qpos, dtype=torch.int32).to(cuda_device),
            torch.tensor(lanes, dtype=torch.int32).to(cuda_device),
            tables.to(cuda_device)]
    got = ragged.ragged_paged_attention(q, k, v, *rest)
    want = ragged.ragged_attention_ref(q, k, v, *rest)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.all(got[-n_pad:] == 0)


@pytest.mark.parametrize("h,kvh,d,p", [(16, 2, 64, 32), (8, 8, 32, 8),
                                       (4, 2, 16, 4), (8, 1, 128, 64)])
def test_ragged_kernel_bf16_tile_geometries(cuda_device, h, kvh, d, p):
    """Every head_dim the bf16 tensor-core path builds, pages of 4 to 64
    keys, 1 to 8 warps per CTA; a chunk and decode rows."""
    gen = torch.Generator().manual_seed(h * 1000 + d * 10 + p)
    max_pages = 200 // p + 2
    qpos = list(range(3, 40)) + [0, p - 1, p, 199] + [-1] * 3
    lanes = [0] * 37 + [1, 2, 3, 0] + [0] * 3
    tables = (1 + torch.randperm(4 * max_pages, generator=gen)) \
        .reshape(4, max_pages).to(torch.int32)
    q = torch.randn(len(qpos), h, d, generator=gen).to(cuda_device,
                                                       torch.bfloat16)
    k = torch.randn(kvh, 4 * max_pages + 1, p, d, generator=gen) \
        .to(cuda_device, torch.bfloat16)
    v = torch.randn(kvh, 4 * max_pages + 1, p, d, generator=gen) \
        .to(cuda_device, torch.bfloat16)
    rest = [torch.tensor(qpos, dtype=torch.int32).to(cuda_device),
            torch.tensor(lanes, dtype=torch.int32).to(cuda_device),
            tables.to(cuda_device)]
    assert ragged.ragged_supported(h, kvh, p, d, torch.bfloat16)
    got = ragged.ragged_paged_attention(q, k, v, *rest)
    want = ragged.ragged_attention_ref(q, k, v, *rest)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    assert torch.all(got[-3:] == 0)


@pytest.mark.parametrize("n_pad", [2, 700])
def test_ragged_kernel_bf16_uniform_long_context(cuda_device, n_pad):
    """q = 0 on long contexts: every output row is the mean of the V rows
    its lane shows it, so a tile step, page, split or masked key that the
    bf16 kernel drops or adds moves the row by about |v| / context, above
    half a bf16 ulp. Decode rows to 4096 keys and a 512-row chunk at
    positions 512..1023; 2 padding rows give a small grid (split-KV), 700
    a large one."""
    gen = torch.Generator().manual_seed(53 + n_pad)
    h, kvh, p, d, max_pages = 32, 8, 16, 128, 256
    decode_ctx = [1, 17, 100, 511, 1024, 2047, 3000, 4096]
    qpos = [c - 1 for c in decode_ctx] + list(range(512, 1024)) \
        + [-1] * n_pad
    lanes = list(range(len(decode_ctx))) + [len(decode_ctx)] * 512 \
        + [0] * n_pad
    n_lanes = len(decode_ctx) + 1
    tables = (1 + torch.randperm(n_lanes * max_pages, generator=gen)) \
        .reshape(n_lanes, max_pages).to(torch.int32)
    k = torch.randn(kvh, n_lanes * max_pages + 1, p, d, generator=gen) \
        .to(cuda_device, torch.bfloat16)
    v = torch.randn(kvh, n_lanes * max_pages + 1, p, d, generator=gen) \
        .to(cuda_device, torch.bfloat16)
    q = torch.zeros(len(qpos), h, d, device=cuda_device,
                    dtype=torch.bfloat16)
    rest = [torch.tensor(qpos, dtype=torch.int32).to(cuda_device),
            torch.tensor(lanes, dtype=torch.int32).to(cuda_device),
            tables.to(cuda_device)]
    got = ragged.ragged_paged_attention(q, k, v, *rest)
    kf, vf = k.float(), v.float()
    want = torch.cat([ragged.ragged_attention_ref(
        q[i:i + 64].float(), kf, vf, *(r[i:i + 64] for r in rest[:2]),
        rest[2]) for i in range(0, len(qpos), 64)])
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, **UNIFORM_TOL)
    assert torch.all(got[len(qpos) - n_pad:] == 0)


def test_ragged_kernel_rejects_unsupported_geometry(cuda_device):
    q = torch.zeros(2, 4, 12, device=cuda_device, dtype=torch.bfloat16)
    kp = torch.zeros(2, 4, 4, 12, device=cuda_device, dtype=torch.bfloat16)
    ints = torch.zeros(2, device=cuda_device, dtype=torch.int32)
    tables = torch.zeros(2, 2, device=cuda_device, dtype=torch.int32)
    with pytest.raises(ValueError):
        ragged.ragged_paged_attention(q, kp, kp, ints, ints, tables)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_write_kernel_bit_exact_with_plain(cuda_device, dtype):
    g = torch.Generator().manual_seed(11)
    kvh, n, p, d, b = 8, 64, 16, 128, 48
    kc = torch.randn(kvh, n, p, d, generator=g).to(cuda_device, dtype)
    vc = torch.randn(kvh, n, p, d, generator=g).to(cuda_device, dtype)
    k = torch.randn(b, kvh, d, generator=g).to(cuda_device, dtype)
    v = torch.randn(b, kvh, d, generator=g).to(cuda_device, dtype)
    slots = torch.randperm((n - 1) * p, generator=g)[:b]
    pages = (1 + slots // p).to(cuda_device, torch.int32)
    offs = (slots % p).to(cuda_device, torch.int32)
    want_k, want_v = kc.clone(), vc.clone()
    kernels.paged_kv_write_ref(want_k, want_v, k, v, pages, offs)
    kernels.paged_kv_write(kc, vc, k, v, pages, offs)
    torch.cuda.synchronize()
    assert torch.equal(kc, want_k) and torch.equal(vc, want_v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kvh,p,d", [(8, 16, 128), (2, 4, 16), (1, 64, 64),
                                     (4, 8, 32)])
def test_k3_kernel_bit_exact_with_plain(cuda_device, dtype, kvh, p, d):
    """Whole pages to their ids, several padding slots aimed at page 0:
    every other page bit-exact with the plain version."""
    g = torch.Generator().manual_seed(kvh * 100 + p + d)
    n, m = 48, 13
    kc = torch.randn(kvh, n, p, d, generator=g).to(cuda_device, dtype)
    vc = torch.randn(kvh, n, p, d, generator=g).to(cuda_device, dtype)
    kb = torch.randn(m, kvh, p, d, generator=g).to(cuda_device, dtype)
    vb = torch.randn(m, kvh, p, d, generator=g).to(cuda_device, dtype)
    ids = (1 + torch.randperm(n - 1, generator=g)[:m]).to(torch.int32)
    ids[[2, 7, 8, 12]] = 0
    ids = ids.to(cuda_device)
    want_k, want_v = kc.clone(), vc.clone()
    kernels.paged_kv_write_pages_ref(want_k, want_v, kb, vb, ids)
    kernels.paged_kv_write_pages(kc, vc, kb, vb, ids)
    torch.cuda.synchronize()
    assert torch.equal(kc[:, 1:], want_k[:, 1:])
    assert torch.equal(vc[:, 1:], want_v[:, 1:])
    pads = kb[[2, 7, 8, 12]].transpose(0, 1)       # (KVH, 4, P, D)
    assert (pads == kc[:, 0][:, None]).any(1).all()


def _kv_views(gen, dev, dtype, b, kvh, d, layout):
    """(k, v) rows (B, KVH, D) laid out as a caller may hand them to K2:
    "projection" (a (B, KVH·D) output viewed as heads), "fused" (a slice
    of a wider (B, 3·KVH·D) output), "heads" (a head-major tensor
    transposed), "chunk" (a (Bp, T, KVH, D) chunk flattened by a view)."""
    def one():
        if layout == "fused":
            wide = torch.randn(b, 3 * kvh * d, generator=gen).to(dev, dtype)
            return wide[:, kvh * d:2 * kvh * d].view(b, kvh, d)
        if layout == "heads":
            return torch.randn(kvh, b, d, generator=gen).to(
                dev, dtype).transpose(0, 1)
        if layout == "chunk":
            return torch.randn(2, b // 2, kvh, d, generator=gen).to(
                dev, dtype).view(b, kvh, d)
        return torch.randn(b, kvh * d, generator=gen).to(dev, dtype).view(
            b, kvh, d)
    return one(), one()


def _kv_targets_case(gen, dev, b, n, p, n_pad):
    slots = torch.randperm((n - 1) * p, generator=gen)[:b]
    pages = (1 + slots // p).to(torch.int32)
    offs = (slots % p).to(torch.int32)
    pages[b - n_pad:] = 0                  # padding rows → page 0 offset 0
    offs[b - n_pad:] = 0
    return pages.to(dev), offs.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["projection", "fused", "heads", "chunk"])
@pytest.mark.parametrize("b", [8, 768])
def test_kv_write_kernel_strided_sources(cuda_device, dtype, layout, b):
    """K2 on the views a step hands it, at the decode and mixed-round row
    counts: bit-exact with the plain version outside page 0."""
    g = torch.Generator().manual_seed(b + len(layout))
    kvh, n, p, d = 8, 128, 16, 128
    k, v = _kv_views(g, cuda_device, dtype, b, kvh, d, layout)
    pages, offs = _kv_targets_case(g, cuda_device, b, n, p, b // 4)
    kc = torch.randn(kvh, n, p, d, generator=g).to(cuda_device, dtype)
    vc = torch.randn(kvh, n, p, d, generator=g).to(cuda_device, dtype)
    want_k, want_v = kc.clone(), vc.clone()
    kernels.paged_kv_write_ref(want_k, want_v, k, v, pages, offs)
    kernels.paged_kv_write(kc, vc, k, v, pages, offs)
    torch.cuda.synchronize()
    assert torch.equal(kc[:, 1:], want_k[:, 1:])
    assert torch.equal(vc[:, 1:], want_v[:, 1:])


def _k3_blocks(gen, dev, dtype, m, kvh, p, d, layout):
    """(kb, vb) blocks (M, KVH, P, D) as K3's caller hands them: "chunk"
    (the token-major (M·P, KVH, D) chunk K/V viewed per page and permuted,
    as `_chunk_kv_writer`), "sliced" (every other slot of a wider chunk),
    "contiguous"."""
    def one():
        if layout == "contiguous":
            return torch.randn(m, kvh, p, d, generator=gen).to(dev, dtype)
        rows = torch.randn(2 * m if layout == "sliced" else m, p, kvh, d,
                           generator=gen).to(dev, dtype)
        if layout == "sliced":
            rows = rows[::2]
        return rows.permute(0, 2, 1, 3)
    return one(), one()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["chunk", "sliced", "contiguous"])
@pytest.mark.parametrize("kvh,p,d", [(8, 16, 128), (2, 4, 16), (4, 8, 32)])
def test_k3_kernel_strided_sources(cuda_device, dtype, layout, kvh, p, d):
    g = torch.Generator().manual_seed(kvh + p + d + len(layout))
    n, m = 64, 32
    kb, vb = _k3_blocks(g, cuda_device, dtype, m, kvh, p, d, layout)
    ids = (1 + torch.randperm(n - 1, generator=g)[:m]).to(torch.int32)
    ids[[3, 30, 31]] = 0
    ids = ids.to(cuda_device)
    kc = torch.randn(kvh, n, p, d, generator=g).to(cuda_device, dtype)
    vc = torch.randn(kvh, n, p, d, generator=g).to(cuda_device, dtype)
    want_k, want_v = kc.clone(), vc.clone()
    kernels.paged_kv_write_pages_ref(want_k, want_v, kb, vb, ids)
    kernels.paged_kv_write_pages(kc, vc, kb, vb, ids)
    torch.cuda.synchronize()
    assert torch.equal(kc[:, 1:], want_k[:, 1:])
    assert torch.equal(vc[:, 1:], want_v[:, 1:])


def test_kv_stores_refuse_layouts_they_cannot_read(cuda_device):
    """A source whose rows do not start on 16-byte boundaries, or whose
    last dimension is strided, raises; nothing is launched."""
    dev, bf = cuda_device, torch.bfloat16
    kvh, n, p, d, b = 2, 8, 4, 64, 4
    kc = torch.zeros(kvh, n, p, d, device=dev, dtype=bf)
    ids = torch.zeros(b, device=dev, dtype=torch.int32)
    wide = torch.zeros(b, kvh * d + 4, device=dev, dtype=bf)
    odd_rows = wide[:, :kvh * d].view(b, kvh, d)       # row stride 8 B off
    odd_start = wide[:, 4:].view(b, kvh, d)            # data_ptr 8 B off
    strided_d = torch.zeros(b, kvh, 2 * d, device=dev, dtype=bf)[..., ::2]
    ok = torch.zeros(b, kvh, d, device=dev, dtype=bf)
    before = (kernels._KERNEL.launches, kernels._PAGES_KERNEL.launches)
    for bad in (odd_rows, odd_start, strided_d):
        with pytest.raises(ValueError):
            kernels.paged_kv_write(kc, kc.clone(), bad, ok, ids, ids)
        with pytest.raises(ValueError):
            kernels.paged_kv_write(kc, kc.clone(), ok, bad, ids, ids)
    blocks = torch.zeros(b, p, kvh, d + 4, device=dev, dtype=bf)
    for bad in (blocks[..., :d].permute(0, 2, 1, 3),
                torch.zeros(b, kvh, p, 2 * d, device=dev, dtype=bf)[..., ::2]):
        with pytest.raises(ValueError):
            kernels.paged_kv_write_pages(kc, kc.clone(), bad, bad, ids)
    assert (kernels._KERNEL.launches,
            kernels._PAGES_KERNEL.launches) == before


def test_kv_stores_return_on_empty_batches(cuda_device):
    dev = cuda_device
    kc = torch.randn(2, 8, 4, 16, device=dev)
    vc = kc.clone()
    before = (kc.clone(), kernels._KERNEL.launches,
              kernels._PAGES_KERNEL.launches)
    none = torch.zeros(0, device=dev, dtype=torch.int32)
    kernels.paged_kv_write(kc, vc, torch.zeros(0, 2, 16, device=dev),
                           torch.zeros(0, 2, 16, device=dev), none, none)
    kernels.paged_kv_write_pages(kc, vc, torch.zeros(0, 2, 4, 16, device=dev),
                                 torch.zeros(0, 2, 4, 16, device=dev), none)
    torch.cuda.synchronize()
    assert torch.equal(kc, before[0]) and torch.equal(vc, before[0])
    assert (kernels._KERNEL.launches,
            kernels._PAGES_KERNEL.launches) == before[1:]


@pytest.mark.parametrize("which", ["k2", "k3"])
def test_kv_stores_graph_replay_and_repeat(cuda_device, which):
    """One call on strided sources captured in a CUDA graph, the sources
    and targets changed in place, replayed: equal to an eager call on the
    same inputs; and two eager calls back to back agree."""
    g = torch.Generator().manual_seed(21)
    dev, bf = cuda_device, torch.bfloat16
    kvh, n, p, d = 8, 64, 16, 128
    if which == "k2":
        k, v = _kv_views(g, dev, bf, 64, kvh, d, "fused")
        a, c = _kv_targets_case(g, dev, 64, n, p, 5)
        ids = (a, c)
        call = lambda kc, vc: kernels.paged_kv_write(kc, vc, k, v, *ids)
    else:
        k, v = _k3_blocks(g, dev, bf, 16, kvh, p, d, "chunk")
        ids = ((1 + torch.randperm(n - 1, generator=g)[:16])
               .to(torch.int32).to(dev),)
        call = lambda kc, vc: kernels.paged_kv_write_pages(kc, vc, k, v,
                                                           *ids)
    kc = torch.randn(kvh, n, p, d, generator=g).to(dev, bf)
    vc = torch.randn(kvh, n, p, d, generator=g).to(dev, bf)
    call(kc, vc)                         # built before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call(kc, vc)
    k.mul_(-2.0)
    v.add_(1.0)
    for t in ids:                        # the same targets, other rows
        t.copy_(t.flip(0))
    graph.replay()
    want_k, want_v = kc.clone(), vc.clone()
    call(want_k, want_v)
    torch.cuda.synchronize()
    assert torch.equal(kc[:, 1:], want_k[:, 1:])
    assert torch.equal(vc[:, 1:], want_v[:, 1:])
    again_k, again_v = kc.clone(), vc.clone()
    call(again_k, again_v)
    call(again_k, again_v)
    torch.cuda.synchronize()
    assert torch.equal(again_k[:, 1:], want_k[:, 1:])
    assert torch.equal(again_v[:, 1:], want_v[:, 1:])


def _decode_args(gen, dev, dtype, b, h, kvh, p, d, lengths, max_pages,
                 zero_q=False):
    n_pages = b * max_pages + 1
    q = torch.zeros(b, h, d) if zero_q else torch.randn(b, h, d,
                                                        generator=gen)
    k = torch.randn(kvh, n_pages, p, d, generator=gen)
    v = torch.randn(kvh, n_pages, p, d, generator=gen)
    tables = (1 + torch.randperm(b * max_pages, generator=gen)) \
        .reshape(b, max_pages).to(torch.int32)
    return [q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            torch.tensor(lengths, dtype=torch.int32).to(dev), tables.to(dev)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, FP32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("h,kvh,d,p", [(32, 8, 128, 16), (16, 2, 64, 32),
                                       (8, 8, 32, 8), (4, 2, 16, 4),
                                       (8, 1, 128, 64), (12, 4, 96, 16)])
def test_k4_kernel_matches_plain(cuda_device, dtype, tol, h, kvh, d, p):
    """G 1..8, D 16..128, P 4..64; lengths 0 (exact zeros), at page edges
    and past them."""
    gen = torch.Generator().manual_seed(h * 1000 + d * 10 + p)
    lengths = [1, p - 1, p, p + 1, 2 * p, 0, 5 * p + 3, 0, 300]
    max_pages = 300 // p + 2
    args = _decode_args(gen, cuda_device, dtype, len(lengths), h, kvh, p, d,
                        lengths, max_pages)
    assert attention.decode_supported(h, kvh, p, d, dtype)
    got = attention.paged_attention_decode(*args)
    want = attention.paged_attention_decode_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.all(got[5] == 0) and torch.all(got[7] == 0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, FP32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
def test_k4_kernel_split_kv_long_contexts(cuda_device, dtype, tol):
    """An 8-lane burst at Llama-3-8B geometry, contexts to 4096: each lane's
    pages split across CTAs and merged; a length-0 lane stays zeros."""
    gen = torch.Generator().manual_seed(77)
    lengths = [1, 16, 17, 700, 1300, 4096, 0, 2048]
    args = _decode_args(gen, cuda_device, dtype, 8, 32, 8, 16, 128, lengths,
                        256)
    assert ragged.num_splits(8, 8, 256, 132) > 1
    got = attention.paged_attention_decode(*args)
    want = attention.paged_attention_decode_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.all(got[6] == 0)


def test_k4_kernel_bf16_uniform_is_exact_mean(cuda_device):
    """q = 0: every lane's output is the mean of the V rows it can see, so
    a dropped or extra key, page or split moves it by about |v| / length,
    above half a bf16 ulp."""
    gen = torch.Generator().manual_seed(78)
    lengths = [1, 15, 16, 17, 32, 0, 1000, 4096]
    args = _decode_args(gen, cuda_device, torch.bfloat16, 8, 32, 8, 16, 128,
                        lengths, 256, zero_q=True)
    got = attention.paged_attention_decode(*args)
    want = attention.paged_attention_decode_ref(
        *[a.float() if a.is_floating_point() else a for a in args])
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, **UNIFORM_TOL)
    assert torch.all(got[5] == 0)


def test_k4_kernel_rejects_unsupported_geometry(cuda_device):
    q = torch.zeros(2, 4, 12, device=cuda_device, dtype=torch.bfloat16)
    kp = torch.zeros(2, 4, 4, 12, device=cuda_device, dtype=torch.bfloat16)
    lengths = torch.ones(2, device=cuda_device, dtype=torch.int32)
    tables = torch.zeros(2, 2, device=cuda_device, dtype=torch.int32)
    with pytest.raises(ValueError):
        attention.paged_attention_decode(q, kp, kp, lengths, tables)


# --- the bf16 paged-attention core (csrc/paged_attention.cuh), K1 and K4 ---
# Cases its device-side work split makes risky, each against the plain
# version (BF16_TOL), with q = 0 against the fp32 plain version
# (UNIFORM_TOL: a dropped or doubled page, split piece or masked key shows)
# and exact zeros on padding rows and length-0 lanes.

def _pages(gen, kvh, n_pages, p, d, dev):
    return [torch.randn(kvh, n_pages, p, d, generator=gen)
            .to(dev, torch.bfloat16) for _ in range(2)]


def _blocked_ref(q, k, v, qpos, lanes, tables):
    """The plain K1 in fp32 over blocks of 64 rows (it gathers whole
    contexts per row)."""
    return torch.cat([ragged.ragged_attention_ref(
        q[i:i + 64].float(), k.float(), v.float(), qpos[i:i + 64],
        lanes[i:i + 64], tables) for i in range(0, q.shape[0], 64)])


def _check_core_k1(gen, dev, h, kvh, d, p, qpos, lanes, tables):
    """K1 bf16 on these rows: random q against the plain version, q = 0
    against the fp32 plain version, padding rows exactly 0."""
    n_pages = int(tables.max()) + 1
    k, v = _pages(gen, kvh, n_pages, p, d, dev)
    rest = [torch.tensor(qpos, dtype=torch.int32).to(dev),
            torch.tensor(lanes, dtype=torch.int32).to(dev), tables.to(dev)]
    pad = rest[0] < 0
    for zero_q in (False, True):
        q = torch.zeros(len(qpos), h, d) if zero_q else \
            torch.randn(len(qpos), h, d, generator=gen)
        q = q.to(dev, torch.bfloat16)
        got = ragged.ragged_paged_attention(q, k, v, *rest)
        want = _blocked_ref(q, k, v, *rest)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want,
                                   **(UNIFORM_TOL if zero_q else BF16_TOL))
        assert torch.all(got[pad] == 0)


def _check_core_k4(gen, dev, h, kvh, d, p, lengths, max_pages):
    """K4 bf16 on these lanes, as `_check_core_k1`."""
    for zero_q in (False, True):
        args = _decode_args(gen, dev, torch.bfloat16, len(lengths), h, kvh,
                            p, d, lengths, max_pages, zero_q=zero_q)
        got = attention.paged_attention_decode(*args)
        want = attention.paged_attention_decode_ref(
            *[a.float() if a.is_floating_point() else a for a in args])
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want,
                                   **(UNIFORM_TOL if zero_q else BF16_TOL))
        assert torch.all(got[args[3] <= 0] == 0)


def _decode_rows(lengths, max_pages, gen):
    """K1 rows of decode lanes: row b is lane b at position lengths[b]-1."""
    tables = (1 + torch.randperm(len(lengths) * max_pages, generator=gen)) \
        .reshape(len(lengths), max_pages).to(torch.int32)
    return [n - 1 for n in lengths], list(range(len(lengths))), tables


@pytest.mark.parametrize("lengths", [
    [4096] + [1] * 7,                         # one long lane, 1-token lanes
    [0] * 8,                                  # all lanes empty
    [1, 15, 16, 17, 31, 32, 33, 48, 49, 0],   # lengths at page edges
    [1],                                      # more CTAs than work
    [44, 73, 133, 233, 383, 653, 853, 1033],  # the burst's decode shape
])
def test_core_decode_rows(cuda_device, lengths):
    gen = torch.Generator().manual_seed(sum(lengths) + len(lengths))
    max_pages = 4096 // 16
    _check_core_k4(gen, cuda_device, 32, 8, 128, 16, lengths, max_pages)
    _check_core_k1(gen, cuda_device, 32, 8, 128, 16,
                   *_decode_rows(lengths, max_pages, gen))


def test_core_identical_lanes_are_bit_identical(cuda_device):
    """Lanes with the same query, pages and length, at different places in
    the batch, give bit-identical outputs (the work is cut from each item's
    own start): identical greedy requests in one burst stay identical."""
    gen = torch.Generator().manual_seed(12)
    dev = cuda_device
    lengths = [1033, 44, 1033, 73, 653, 1033, 7, 1033]
    max_pages = 80
    q, k, v, lens, tables = _decode_args(gen, dev, torch.bfloat16, 8, 32, 8,
                                         16, 128, lengths, max_pages)
    same = [i for i, n in enumerate(lengths) if n == 1033]
    q[same] = q[same[0]].clone()
    tables[same] = tables[same[0]].clone()
    out4 = attention.paged_attention_decode(q, k, v, lens, tables)
    lanes = torch.arange(8, dtype=torch.int32, device=dev)
    out1 = ragged.ragged_paged_attention(q, k, v, lens - 1, lanes, tables)
    torch.cuda.synchronize()
    for out in (out4, out1):
        assert all(torch.equal(out[i], out[same[0]]) for i in same)
    # two identical 100-row prefill chunks whose rows fall differently on
    # the aligned tile blocks (rows 0..99 and 100..199), beside a decode row
    qpos = torch.tensor(list(range(300, 400)) * 2 + [500], dtype=torch.int32,
                        device=dev)
    lanes = torch.tensor([0] * 100 + [1] * 100 + [2], dtype=torch.int32,
                         device=dev)
    tables[1] = tables[0].clone()
    qc = torch.randn(201, 32, 128, generator=gen).to(dev, torch.bfloat16)
    qc[100:200] = qc[:100].clone()
    out = ragged.ragged_paged_attention(qc, k, v, qpos, lanes, tables)
    torch.cuda.synchronize()
    assert torch.equal(out[:100], out[100:200])


def test_core_more_ctas_than_work(cuda_device):
    """One KV head, one page of work in all: nearly every CTA finds an
    empty range."""
    gen = torch.Generator().manual_seed(3)
    _check_core_k4(gen, cuda_device, 4, 1, 64, 16, [3, 0], 4)
    _check_core_k1(gen, cuda_device, 4, 1, 64, 16,
                   *_decode_rows([1, 0, 2], 4, gen))


@pytest.mark.parametrize("n_pad", [0, 3, 600])
def test_core_chunk_tiles_straddle_blocks(cuda_device, n_pad):
    """Chunks starting off the aligned 16-row blocks and crossing them,
    decode rows between them, lane 0's padding rows right after lane 0's
    chunk (a tile of valid and padding rows), rows out of position order."""
    gen = torch.Generator().manual_seed(90 + n_pad)
    qpos = [7, 900] + list(range(5, 42)) + [-1] * 3 + list(range(300, 401)) \
        + [15, 16] + list(range(611, 631))
    lanes = [1, 2] + [0] * 37 + [0] * 3 + [3] * 101 + [4, 5] + [6] * 20
    qpos[50], qpos[51] = qpos[51], qpos[50]
    qpos += [-1] * n_pad
    lanes += [0] * n_pad
    max_pages = 60
    tables = (1 + torch.randperm(7 * max_pages, generator=gen)) \
        .reshape(7, max_pages).to(torch.int32)
    _check_core_k1(gen, cuda_device, 32, 8, 128, 16, qpos, lanes, tables)


@pytest.mark.parametrize("label", ["decode", "mixed"])
def test_core_ragged_rounds(cuda_device, label):
    """The ragged path's rounds at Llama-3-8B geometry: 8 decode rows, and
    a 512-row chunk at positions 512..1023 beside them in the 768 bucket."""
    gen = torch.Generator().manual_seed(17)
    ctx = [41, 70, 130, 230, 380, 650, 850, 1030]
    chunk = label == "mixed"
    qpos = (list(range(512, 1024)) if chunk else []) + [c - 1 for c in ctx]
    lanes = ([8] * 512 if chunk else []) + list(range(8))
    qpos += [-1] * (248 if chunk else 0)
    lanes += [0] * (248 if chunk else 0)
    max_pages = 64
    tables = (1 + torch.randperm(9 * max_pages, generator=gen)) \
        .reshape(9, max_pages).to(torch.int32)
    _check_core_k1(gen, cuda_device, 32, 8, 128, 16, qpos, lanes, tables)


@pytest.mark.parametrize("d", [16, 32, 64, 96, 128])
@pytest.mark.parametrize("p", [1, 2, 4, 8, 16, 32, 64])
def test_core_every_gate_geometry(cuda_device, d, p):
    """Every (G, D, P) the bf16 gates accept: G 1..8 query heads per KV
    head, each built head_dim, each power-of-two page to 64 keys; K4 lanes
    at page edges, K1 a chunk crossing a tile block and decode rows."""
    from dynamo_tpu_torch.engine import paged_core

    for g in range(1, 9):
        gen = torch.Generator().manual_seed(g * 1000 + d * 10 + p)
        kvh = 2
        h = g * kvh
        assert attention.decode_supported(h, kvh, p, d, torch.bfloat16)
        assert ragged.ragged_supported(h, kvh, p, d, torch.bfloat16)
        lengths = [1, p, p + 1, 0, 3 * p + 2, 150]
        _check_core_k4(gen, cuda_device, h, kvh, d, p, lengths,
                       150 // p + 2)
        rows = paged_core.tile_rows(h, kvh)
        qpos = list(range(3, 3 + rows + 5)) + [0, p - 1, p, 149, -1, -1]
        lanes = [0] * (rows + 5) + [1, 2, 3, 0, 0, 0]
        max_pages = 150 // p + 2
        tables = (1 + torch.randperm(4 * max_pages, generator=gen)) \
            .reshape(4, max_pages).to(torch.int32)
        _check_core_k1(gen, cuda_device, h, kvh, d, p, qpos, lanes, tables)


def test_core_counters_stay_zero_and_graph_replays(cuda_device):
    """Every launch leaves the ticket counters 0, and a CUDA graph of one
    K1 and one K4 call replays with lengths / positions changed in place
    on the device equal to eager calls (no host read of either)."""
    from dynamo_tpu_torch.engine import paged_core

    gen = torch.Generator().manual_seed(5)
    dev = cuda_device
    h, kvh, d, p, max_pages = 32, 8, 128, 16, 256
    k, v = _pages(gen, kvh, 8 * max_pages + 1, p, d, dev)
    tables = (1 + torch.randperm(8 * max_pages, generator=gen)) \
        .reshape(8, max_pages).to(torch.int32).to(dev)
    q = torch.randn(8, h, d, generator=gen).to(dev, torch.bfloat16)
    lengths = torch.tensor([4096, 1, 2, 3, 0, 17, 1000, 5],
                           dtype=torch.int32, device=dev)
    qpos = (lengths - 1).clone()
    lanes = torch.arange(8, dtype=torch.int32, device=dev)
    attention.paged_attention_decode(q, k, v, lengths, tables)   # warm-up
    ragged.ragged_paged_attention(q, k, v, qpos, lanes, tables)
    torch.cuda.synchronize()
    _, counters = paged_core._SCRATCH[q.device]
    assert int(counters.abs().sum()) == 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out4 = attention.paged_attention_decode(q, k, v, lengths, tables)
        out1 = ragged.ragged_paged_attention(q, k, v, qpos, lanes, tables)
    for new in ([1, 4096, 0, 33, 2048, 16, 15, 700],
                [0, 0, 0, 0, 0, 0, 0, 1]):
        lengths.copy_(torch.tensor(new, dtype=torch.int32))
        qpos.copy_(lengths - 1)
        graph.replay()
        want4 = attention.paged_attention_decode(q, k, v, lengths, tables)
        want1 = ragged.ragged_paged_attention(q, k, v, qpos, lanes, tables)
        torch.cuda.synchronize()
        assert torch.equal(out4, want4) and torch.equal(out1, want1)
        torch.testing.assert_close(
            out4.float(), attention.paged_attention_decode_ref(
                q, k, v, lengths, tables).float(), **BF16_TOL)
    assert int(counters.abs().sum()) == 0


A8_MS = (1, 5, 8, 16, 17, 33, 64, 65, 127, 600)


def _a8_inputs(gen, m, k, dtype, dev):
    """Rows of mixed scale: an all-zero row (sx at its 1e-12 floor), an
    outlier row, tiny and large rows."""
    x = torch.randn(m, k, generator=gen)
    x *= torch.logspace(-3, 2, m)[:, None]
    x[0] = 0.0
    if m > 2:
        x[2, k // 3] = 500.0
    return x.to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(128, 256), (512, 1024), (4096, 1024),
                                 (256, 14336), (14336, 4096)])
@pytest.mark.parametrize("bits", [8, 4], ids=["k5-w8a8", "k6-int4"])
def test_a8_kernels_bit_identical_with_plain(cuda_device, dtype, k, n, bits):
    """K5 / K6 against their plain versions over M 1..600 (odd M, every tile
    config: <= 16, <= 64 and wide), several (K, N) in the gate — (4096,
    1024) and (14336, 4096) split K at M <= 64."""
    gen = torch.Generator().manual_seed(k * 7 + n + bits)
    w = torch.randn(k, n, generator=gen).to(cuda_device)
    qt = quant.quantize(w, bits, 8 if bits == 8 else 16)
    fn, ref = ((int4_mm.w8a8_matmul, int4_mm.w8a8_matmul_ref) if bits == 8
               else (int4_mm.int4_matmul, int4_mm.int4_matmul_ref))
    for m in A8_MS:
        x = _a8_inputs(gen, m, k, dtype, cuda_device)
        got = fn(x, qt.q, qt.s)
        want = ref(x, qt.q, qt.s)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (m, n)
        assert torch.equal(got, want), (m, (got.float() - want.float())
                                        .abs().max().item())
        assert torch.all(got[0] == 0)


A8_DESIGN_MS = (1, 8, 9, 16, 17, 32, 33, 40, 64, 65, 128, 129, 300)


def _a8_pair(bits):
    return ((int4_mm.w8a8_matmul, int4_mm.w8a8_matmul_ref) if bits == 8
            else (int4_mm.int4_matmul, int4_mm.int4_matmul_ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(384, 512), (640, 768), (1152, 256)])
@pytest.mark.parametrize("bits", [8, 4], ids=["k5-w8a8", "k6-int4"])
def test_a8_every_design_and_chunk_edge(cuda_device, dtype, k, n, bits):
    """Every GEMM design (stream NB 1, 2, 4, 8 and wide, at the M edges of
    each) on K that ends in a short 512-byte chunk, bit-identical with the
    plain versions."""
    gen = torch.Generator().manual_seed(k + n + bits)
    w = torch.randn(k, n, generator=gen).to(cuda_device)
    qt = quant.quantize(w, bits, 8 if bits == 8 else 16)
    fn, ref = _a8_pair(bits)
    for m in A8_DESIGN_MS:
        x = _a8_inputs(gen, m, k, dtype, cuda_device)
        got, want = fn(x, qt.q, qt.s), ref(x, qt.q, qt.s)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (m, int4_mm.design(m))


@pytest.mark.parametrize("bits", [8, 4], ids=["k5-w8a8", "k6-int4"])
def test_a8_zero_rows_return_empty(cuda_device, bits):
    fn, _ = _a8_pair(bits)
    qt = quant.quantize(torch.randn(256, 512, device=cuda_device), bits,
                        8 if bits == 8 else 16)
    out = fn(torch.empty(0, 256, device=cuda_device), qt.q, qt.s)
    assert out.shape == (0, 512)


@pytest.mark.parametrize("bits", [8, 4], ids=["k5-w8a8", "k6-int4"])
def test_a8_tickets_left_clean_and_calls_agree(cuda_device, bits):
    """Cut tiles fold through tickets the kernel resets: after each call
    every ticket is 0 again, and back-to-back calls give the same bits."""
    gen = torch.Generator().manual_seed(11 + bits)
    k, n = 4096, 1024                       # wk/wv: tiles cut across CTAs
    w = torch.randn(k, n, generator=gen).to(cuda_device)
    qt = quant.quantize(w, bits, 8 if bits == 8 else 16)
    fn, ref = _a8_pair(bits)
    for m in (1, 8, 16, 40, 64):
        x = _a8_inputs(gen, m, k, torch.bfloat16, cuda_device)
        first, second = fn(x, qt.q, qt.s), fn(x, qt.q, qt.s)
        torch.cuda.synchronize()
        _, tickets = int4_mm.stream_scratch(cuda_device, qt.q.shape[0])
        assert int(tickets.abs().sum()) == 0
        assert torch.equal(first, second)
        assert torch.equal(first, ref(x, qt.q, qt.s))


@pytest.mark.parametrize("bits", [8, 4], ids=["k5-w8a8", "k6-int4"])
def test_a8_interleaved_shapes_on_one_stream(cuda_device, bits):
    """Two projections of different shape, and both designs, queued
    alternately on one stream without a sync: each equals its plain
    version."""
    gen = torch.Generator().manual_seed(21 + bits)
    fn, ref = _a8_pair(bits)
    cases = []
    for k, n in ((4096, 1024), (1024, 4096)):
        w = torch.randn(k, n, generator=gen).to(cuda_device)
        qt = quant.quantize(w, bits, 8 if bits == 8 else 16)
        for m in (8, 100):
            cases.append((qt, _a8_inputs(gen, m, k, torch.bfloat16,
                                         cuda_device)))
    outs = [fn(x, qt.q, qt.s) for _ in range(3) for qt, x in cases]
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        qt, x = cases[i % len(cases)]
        assert torch.equal(out, ref(x, qt.q, qt.s)), i


@pytest.mark.parametrize("bits", [8, 4], ids=["k5-w8a8", "k6-int4"])
@pytest.mark.parametrize("m", [8, 40, 200])
def test_a8_graph_replay(cuda_device, bits, m):
    """One call captured in a CUDA graph (the quantize launch, then the
    GEMM behind it by programmatic dependent launch), x changed in place,
    replayed: equal to an eager call on the new x."""
    gen = torch.Generator().manual_seed(31 + bits + m)
    k, n = 4096, 1024
    w = torch.randn(k, n, generator=gen).to(cuda_device)
    qt = quant.quantize(w, bits, 8 if bits == 8 else 16)
    fn, _ = _a8_pair(bits)
    x = _a8_inputs(gen, m, k, torch.bfloat16, cuda_device)
    fn(x, qt.q, qt.s)                       # scratch exists before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(x, qt.q, qt.s)
    for scale_by in (2.0, -0.5):
        x.mul_(scale_by)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, fn(x, qt.q, qt.s))


@pytest.mark.parametrize("n,m", [(14336, 600), (1024, 600), (512, 65)])
def test_a8_k6_both_wide_tiles(cuda_device, n, m):
    """K6's two wide tiles (256 columns where they fill the card, else 128),
    chosen as `int4_mm.wide_cols` mirrors, bit-identical with the plain
    version; (14336, 600) takes the 256-column tile, the others 128."""
    gen = torch.Generator().manual_seed(n + m)
    k = 256
    qt = quant.quantize(torch.randn(k, n, generator=gen).to(cuda_device), 4)
    cols = int4_mm.wide_cols(True, m, n, torch.cuda.get_device_properties(
        cuda_device).multi_processor_count)
    assert cols == (256 if n == 14336 else 128)
    for dtype in (torch.float32, torch.bfloat16):
        x = _a8_inputs(gen, m, k, dtype, cuda_device)
        assert torch.equal(int4_mm.int4_matmul(x, qt.q, qt.s),
                           int4_mm.int4_matmul_ref(x, qt.q, qt.s))


def _a8_group(bits):
    return (int4_mm.w8a8_matmul_group if bits == 8
            else int4_mm.int4_matmul_group)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4], ids=["k5-w8a8", "k6-int4"])
def test_a8_group_bit_identical_with_separate_calls(cuda_device, dtype, bits):
    """One grouped call over q/k/v-like and gate/up-like weights (one
    quantize, one GEMM over all their tiles, one counted launch) equals
    the plain version of each weight, in both designs."""
    gen = torch.Generator().manual_seed(41 + bits)
    k = 512
    qts = [quant.quantize(torch.randn(k, n, generator=gen).to(cuda_device),
                          bits, 8 if bits == 8 else 16)
           for n in (1024, 256, 256)]
    _, ref = _a8_pair(bits)
    kern = int4_mm._W8A8_KERNEL if bits == 8 else int4_mm._INT4_KERNEL
    for group in (qts, qts[:2]):
        for m in (1, 8, 16, 40, 64, 65, 300):
            x = _a8_inputs(gen, m, k, dtype, cuda_device)
            before = kern.launches
            outs = _a8_group(bits)(x, [(qt.q, qt.s) for qt in group])
            torch.cuda.synchronize()
            assert kern.launches == before + 1
            for out, qt in zip(outs, group):
                assert torch.equal(out, ref(x, qt.q, qt.s)), (m, len(group))


@pytest.mark.parametrize("bits", [8, 4], ids=["k5-w8a8", "k6-int4"])
def test_a8_group_graph_replay(cuda_device, bits):
    gen = torch.Generator().manual_seed(51 + bits)
    k = 1024
    qts = [quant.quantize(torch.randn(k, n, generator=gen).to(cuda_device),
                          bits, 8 if bits == 8 else 16) for n in (512, 256)]
    fn = _a8_group(bits)
    x = _a8_inputs(gen, 8, k, torch.bfloat16, cuda_device)
    pairs = [(qt.q, qt.s) for qt in qts]
    fn(x, pairs)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn(x, pairs)
    x.mul_(-3.0)
    graph.replay()
    torch.cuda.synchronize()
    for out, want in zip(outs, fn(x, pairs)):
        assert torch.equal(out, want)


def test_quantize_on_card_is_bit_exact_with_cpu(cuda_device):
    gen = torch.Generator().manual_seed(5)
    w = (torch.randn(512, 768, generator=gen)
         * torch.logspace(-2, 1, 768)).to(torch.bfloat16)
    for bits in (8, 4):
        on_card = quant.quantize(w.to(cuda_device), bits)
        on_cpu = quant.quantize(w, bits)
        assert torch.equal(on_card.q.cpu(), on_cpu.q)
        assert torch.equal(on_card.s.cpu(), on_cpu.s)


def test_a8_kernels_refuse_shapes_outside_the_gate(cuda_device):
    x = torch.randn(4, 192, device=cuda_device)
    q = torch.zeros(256, 192, dtype=torch.int8, device=cuda_device)
    s = torch.ones(1, 256, device=cuda_device)
    with pytest.raises(ValueError):
        int4_mm.w8a8_matmul(x, q, s)                  # K = 192
    x = torch.randn(4, 256, device=cuda_device)
    with pytest.raises(ValueError):                   # N = 192
        int4_mm.w8a8_matmul(x, torch.zeros(192, 256, dtype=torch.int8,
                                           device=cuda_device), s[:, :192])
    with pytest.raises(ValueError):                   # N/2 = 64 for int4
        int4_mm.int4_matmul(x, torch.zeros(64, 256, dtype=torch.int8,
                                           device=cuda_device), s[:, :128])
    with pytest.raises(ValueError):                   # not contiguous
        int4_mm.w8a8_matmul(x, torch.zeros(256, 512, dtype=torch.int8,
                                           device=cuda_device)[:, ::2], s)
    with pytest.raises(ValueError):                   # fp16 activations
        int4_mm.w8a8_matmul(x.half(), torch.zeros(
            256, 256, dtype=torch.int8, device=cuda_device), s)


def test_a8_launch_counts_move_only_on_cuda(cuda_device):
    gen = torch.Generator().manual_seed(6)
    w = torch.randn(256, 512, generator=gen)
    x = torch.randn(3, 256, generator=gen)
    for bits, fn, kern in ((8, int4_mm.w8a8_matmul, int4_mm._W8A8_KERNEL),
                           (4, int4_mm.int4_matmul, int4_mm._INT4_KERNEL)):
        qt = quant.quantize(w, bits)
        before = kern.launches
        on_cpu = fn(x, qt.q, qt.s)
        assert kern.launches == before
        qt.to(cuda_device)
        on_card = fn(x.to(cuda_device), qt.q, qt.s)
        assert kern.launches == before + 1
        assert torch.equal(on_card.cpu(), on_cpu)


# every projection of this config is inside the kernels' gate
A8_MODEL = dict(hidden_size=256, intermediate_size=512, num_heads=4,
                num_kv_heads=2, head_dim=128, page_size=8)


@pytest.mark.parametrize("mode,impl", [("w8a8", "phase"), ("int4", "phase"),
                                       ("w8a8", "ragged"), ("int4", "ragged")])
def test_quantized_engine_on_card_matches_engine_on_cpu(cuda_device, mode,
                                                        impl):
    """Greedy fp32 streams of a quantized tiny model are identical on the
    card (through K5 or K6) and on the CPU (their plain versions)."""
    kern = int4_mm._W8A8_KERNEL if mode == "w8a8" else int4_mm._INT4_KERNEL
    other = int4_mm._INT4_KERNEL if mode == "w8a8" else int4_mm._W8A8_KERNEL
    before, other_before = kern.launches, other.launches
    _serve_tiny_on_card_and_cpu(cuda_device, impl, A8_MODEL, mode)
    assert kern.launches > before and other.launches == other_before


def test_engine_on_card_matches_engine_on_cpu(cuda_device):
    """Greedy fp32 streams of a tiny model on the ragged path are
    identical on the card (through K1 and K2) and on the CPU (plain
    versions)."""
    assert _serve_tiny_on_card_and_cpu(cuda_device, "ragged") > 0


def test_phase_engine_on_card_matches_engine_on_cpu(cuda_device):
    """The same on the phase path, with pipelined bursts: greedy fp32
    streams identical on the card (K2, K3, K4, and K1 for the chunk
    attention) and on the CPU."""
    before = {k: kern.launches for k, kern in
              (("k1", ragged._KERNEL), ("k2", kernels._KERNEL),
               ("k3", kernels._PAGES_KERNEL),
               ("k4", attention._DECODE_KERNEL))}
    _serve_tiny_on_card_and_cpu(cuda_device, "phase")
    after = {"k1": ragged._KERNEL.launches, "k2": kernels._KERNEL.launches,
             "k3": kernels._PAGES_KERNEL.launches,
             "k4": attention._DECODE_KERNEL.launches}
    for k in ("k1", "k2", "k3", "k4"):
        assert after[k] > before[k], k


def _serve_tiny_on_card_and_cpu(cuda_device, impl: str, geometry=None,
                                quantize=None, moe=False) -> int:
    """Serve three greedy requests on the card and on the CPU through a
    tiny fp32 model (`geometry` overrides, `quantize` mode; with `moe`,
    a Mixtral-style MoE model) on path `impl`; assert identical streams;
    return the K1 launches the card run made."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.models.llama import LlamaConfig, init_params
    from dynamo_tpu_torch.models.mixtral import MoeConfig
    from dynamo_tpu_torch.runtime.context import Context

    mcfg = (MoeConfig if moe else LlamaConfig).tiny(
        dtype=torch.float32, **(geometry or dict(head_dim=32, page_size=8)))
    cpu_model = init_params(mcfg, 0, torch.device("cpu"))

    async def serve(device):
        model = cpu_model if device.type == "cpu" else \
            copy.deepcopy(cpu_model).to(device)
        eng = TorchEngine(TorchEngineConfig(
            model=mcfg, num_pages=64, max_batch_size=4, prefill_chunk=32,
            min_prefill_bucket=8, prefill_chunk_budget=12,
            attention_impl=impl, quantize=quantize, device=str(device)),
            model=model)

        async def one(prompt, n):
            toks = []
            async for o in eng.generate(
                    {"token_ids": prompt, "sampling": {"temperature": 0.0},
                     "stop": {"max_tokens": n}}, Context()):
                toks.extend(o.get("token_ids", ()))
            return toks

        try:
            return await asyncio.gather(
                one(list(range(1, 30)), 10), one(list(range(40, 45)), 12),
                one(list(range(7, 60)), 6))
        finally:
            await eng.close()

    kernels_before = ragged._KERNEL.launches
    on_card = asyncio.run(serve(cuda_device))
    k1_launches = ragged._KERNEL.launches - kernels_before
    assert on_card == asyncio.run(serve(torch.device("cpu")))
    return k1_launches


# --- CUDA graphs of the engine's fixed-shape steps (engine/graphs.py) -------

GRAPH_MODES = ("bf16", "w8a8", "int4")


def _graph_model(dev, mode):
    """A tiny bf16 Llama inside every kernel's gate (A8_MODEL), quantized
    for `mode`."""
    from dynamo_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig.tiny(dtype=torch.bfloat16, **A8_MODEL)
    model = init_params(cfg, 0, dev)
    if mode != "bf16":
        model = quant.quantize_params(model, mode=mode)
    return cfg, model


def _random_caches(cfg, dev, seed):
    """Two identical KV caches of random bf16 values (attention then reads
    real keys), eight lanes' pages each."""
    from dynamo_tpu_torch.models.llama import init_cache

    kc, vc = init_cache(cfg, 1 + 8 * cfg.max_pages_per_seq, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    for c in kc + vc:
        c.copy_(torch.randn(c.shape, generator=g, device=dev))
    return (kc, vc), ([c.clone() for c in kc], [c.clone() for c in vc])


def _lane_tables(cfg, lanes):
    mp = cfg.max_pages_per_seq
    return (1 + np.arange(lanes * mp, dtype=np.int32)).reshape(lanes, mp)


def _burst_inputs(cfg, shift=0):
    """A 4-lane burst's host arrays in `decode_multi_step`'s order: greedy
    and sampled lanes (top-p, top-k), one empty lane."""
    return [np.array([5, 77, 130, 9], np.int32) + shift,
            np.array([3, 17, 40, 0], np.int32) + shift,
            _lane_tables(cfg, 4), np.array([True, True, True, False]),
            np.array([11, 22, 33, 44], np.int64),
            np.array([0, 5, 2, 0], np.int64) + shift,
            np.array([0.0, 0.8, 1.2, 0.0], np.float32),
            np.array([1.0, 0.9, 1.0, 1.0], np.float32),
            np.array([0, 0, 20, 0], np.int64)]


def _ragged_inputs(cfg, chunk, tb, shift=0):
    """A ragged round's host arrays in `ragged_prefill_decode`'s order:
    `chunk` prompt rows of pick 0, the fixed block of 4 decode rows (one
    empty lane), padding rows to the `tb` bucket."""
    bmax, P = 4, cfg.page_size
    tables = _lane_tables(cfg, 2 * bmax)
    pos = list(range(shift, shift + chunk)) + [12 + shift, 30, 50, 7]
    lanes = [0] * chunk + list(range(bmax, 2 * bmax))
    n = len(pos)
    valid = np.zeros(tb, bool)
    valid[:n - 1] = True
    poss = np.zeros(tb, np.int32)
    poss[:n] = pos
    lane = np.zeros(tb, np.int32)
    lane[:n] = lanes
    pages = np.where(valid, tables[lane, poss // P], 0).astype(np.int32)
    offs = np.where(valid, poss % P, 0).astype(np.int32)
    toks = ((np.arange(tb) * 7 + shift) % 256).astype(np.int32)
    z = np.zeros(bmax, np.int64)
    return [toks, poss, pages, offs, valid, lane, tables,
            np.full(bmax, max(chunk - 1, 0), np.int32),
            (chunk + np.arange(bmax)).astype(np.int32), z + 3,
            np.arange(bmax, dtype=np.int64),
            np.array([0.0, 0.7, 0.0, 0.0], np.float32),
            np.ones(bmax, np.float32), z]


def _device(inputs, dev):
    return [torch.from_numpy(a).to(dev) for a in inputs]


def _assert_same_outputs(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _assert_same_caches(a, b):
    """Equal outside scratch page 0 (where padding rows race)."""
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(x[:, 1:], y[:, 1:])


def _burst_step(model, tk, k=4):
    from dynamo_tpu_torch.models.llama import decode_multi_step

    return lambda kc, vc, *a: decode_multi_step(model, kc, vc, *a,
                                                num_steps=k, topk_lp=tk)


def _ragged_step(model, tk):
    from dynamo_tpu_torch.models.llama import ragged_prefill_decode

    return lambda kc, vc, *a: ragged_prefill_decode(model, kc, vc, *a,
                                                    topk_lp=tk)


def _graph_vs_eager(dev, cfg, step, inputs_seq, launches=True):
    """Each inputs of `inputs_seq` through one graph (captured at the
    first) and through eager calls, on two identical random caches:
    outputs, caches and kernel launches equal call by call (`launches`:
    the step launches a hand-written kernel)."""
    from dynamo_tpu_torch.engine import cuda_build
    from dynamo_tpu_torch.engine.graphs import StepGraphs

    eager, graphed = _random_caches(cfg, dev, 7)
    graphs = StepGraphs(dev)
    for i, inputs in enumerate(inputs_seq):
        before = cuda_build.launch_counts()
        want = step(*eager, *_device(inputs, dev))
        torch.cuda.synchronize()
        eager_launches = cuda_build.launch_delta(
            before, cuda_build.launch_counts())
        before = cuda_build.launch_counts()
        got = graphs.run(("step",), lambda *a: step(*graphed, *a), inputs)
        torch.cuda.synchronize()
        delta = cuda_build.launch_delta(before, cuda_build.launch_counts())
        # the first call also ran the warm-up eagerly
        assert delta == {k: n * (2 if i == 0 else 1)
                         for k, n in eager_launches.items()}
        assert bool(eager_launches) == launches
        _assert_same_outputs(got, want)
        _assert_same_caches(eager, graphed)
    assert graphs.captures == 1 and graphs.replays == len(inputs_seq)
    assert graphs.pool_bytes() > 0


@pytest.mark.parametrize("tk", [0, 8])
@pytest.mark.parametrize("mode", GRAPH_MODES)
def test_burst_graph_replays_bit_identical_to_eager(cuda_device, mode, tk):
    """A decode burst (4 steps, sampled and greedy lanes) replayed from its
    graph equals the eager burst on the same inputs: packed output and
    both caches, bit for bit; the launch counts include the replays."""
    cfg, model = _graph_model(cuda_device, mode)
    with torch.inference_mode():
        _graph_vs_eager(cuda_device, cfg, _burst_step(model, tk),
                        [_burst_inputs(cfg), _burst_inputs(cfg, shift=9)])


@pytest.mark.parametrize("chunk,tb", [(0, 8), (20, 32)],
                         ids=["decode", "mixed"])
@pytest.mark.parametrize("mode", GRAPH_MODES)
def test_ragged_graph_replays_bit_identical_to_eager(cuda_device, mode,
                                                     chunk, tb):
    """A ragged round at a decode bucket and at a mixed bucket (chunk rows
    + decode block + padding) replayed from its graph equals the eager
    round: packed output, chunk logits and both caches."""
    cfg, model = _graph_model(cuda_device, mode)
    with torch.inference_mode():
        _graph_vs_eager(cuda_device, cfg, _ragged_step(model, 8),
                        [_ragged_inputs(cfg, chunk, tb),
                         _ragged_inputs(cfg, chunk, tb, shift=3)])


def test_two_pipelined_bursts_through_one_graph(cuda_device):
    """Burst 2 fed on the device from burst 1's output (the engine's
    pipelined dispatch) through the same graph equals two eager bursts;
    burst 1's output is copied out before the graph replays again."""
    from dynamo_tpu_torch.engine.graphs import StepGraphs

    cfg, model = _graph_model(cuda_device, "bf16")
    step, k = _burst_step(model, 0, k=4), 4
    first = _burst_inputs(cfg)
    second = [None, first[1] + k, *first[2:5], first[5] + k, *first[6:]]
    eager, graphed = _random_caches(cfg, cuda_device, 3)
    graphs = StepGraphs(cuda_device)
    with torch.inference_mode():
        want1 = step(*eager, *_device(first, cuda_device))
        want2 = step(*eager, want1[0, k - 1].to(torch.int32),
                     *_device(second[1:], cuda_device))
        run = lambda *a: step(*graphed, *a)
        got1 = graphs.run(("burst",), run, first)
        held = got1.clone()
        got2 = graphs.run(("burst",), run,
                          [got1[0, k - 1].to(torch.int32), *second[1:]])
        torch.cuda.synchronize()
    assert got2 is got1                       # the graph's static output
    assert torch.equal(held, want1) and torch.equal(got2, want2)
    assert not torch.equal(want1, want2)
    _assert_same_caches(eager, graphed)
    assert graphs.captures == 1 and graphs.replays == 2


def test_ragged_round_chunk_logits_outlive_the_next_replay(cuda_device):
    """The engine's ragged round hands back chunk logits that a later
    round of the same bucket (the same graph, replayed) leaves as they
    were: they are sampled only after later rounds."""
    import types

    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig

    cfg, model = _graph_model(cuda_device, "bf16")
    eng = TorchEngine(TorchEngineConfig(
        model=cfg, num_pages=64, max_batch_size=4, attention_impl="ragged",
        device="cuda"), model=model)
    # what the core reads of a sequence: its pages, prompt and trace
    picks = [types.SimpleNamespace(pages=list(range(1 + 4 * i, 5 + 4 * i)),
                                   prompt=[(7 * j + 50 * i) % 256
                                           for j in range(20)], trace=None)
             for i in range(2)]
    with torch.inference_mode():
        _, ch1 = eng._ragged_core(picks[:1], {id(picks[0]): 0}, [20], [], 0)
        held = ch1.clone()
        _, ch2 = eng._ragged_core(picks[1:], {id(picks[1]): 0}, [20], [], 0)
        torch.cuda.synchronize()
    assert eng.graphs.captures == 1 and eng.graphs.replays == 2
    assert eng.compile_tracker.total == 1
    assert torch.equal(ch1, held)
    assert not torch.equal(ch1[0], ch2[0])


def test_small_graph_replays_right_after_scratch_grows(cuda_device,
                                                       monkeypatch):
    """A round captured at a small bucket, then an eager round large
    enough to grow the kernels' scratch, then the small graph replayed
    (memory reused in between): still equal to eager. The scratch the
    graph was captured with stays alive."""
    from dynamo_tpu_torch.engine import paged_core
    from dynamo_tpu_torch.engine.graphs import StepGraphs

    monkeypatch.setattr(paged_core, "_SCRATCH", {})
    monkeypatch.setattr(int4_mm, "_SCRATCH", {})
    cfg, model = _graph_model(cuda_device, "w8a8")
    step = _ragged_step(model, 0)
    eager, graphed = _random_caches(cfg, cuda_device, 5)
    graphs = StepGraphs(cuda_device)
    with torch.inference_mode():
        graphs.run(("small",), lambda *a: step(*graphed, *a),
                   _ragged_inputs(cfg, 0, 8))
        step(*eager, *_device(_ragged_inputs(cfg, 0, 8), cuda_device))
        (dev_key, (_, small)), = paged_core._SCRATCH.items()
        big = _ragged_inputs(cfg, 100, 512)
        step(*graphed, *_device(big, cuda_device))
        step(*eager, *_device(big, cuda_device))
        assert paged_core._SCRATCH[dev_key][1].numel() > small.numel()
        assert any(t is small for t in paged_core._RETIRED)
        junk = [torch.full((1 << 20,), 7, dtype=torch.int32,
                           device=cuda_device) for _ in range(8)]
        new = _ragged_inputs(cfg, 0, 8, shift=5)
        want = step(*eager, *_device(new, cuda_device))
        got = graphs.run(("small",), lambda *a: step(*graphed, *a), new)
        torch.cuda.synchronize()
    del junk
    _assert_same_outputs(got, want)
    _assert_same_caches(eager, graphed)
    assert int(small.abs().sum()) == 0


def test_scratch_growth_during_capture_raises(cuda_device):
    """Asking either kernel family's persistent scratch to grow while a
    graph is being captured raises (its memory would be the graph's)."""
    from dynamo_tpu_torch.engine import paged_core

    for grow in (lambda: paged_core.core_scratch(
                     cuda_device, paged_core.grid_ctas(cuda_device), 128,
                     1 << 24),
                 lambda: int4_mm.stream_scratch(cuda_device, 1 << 24)):
        graph = torch.cuda.CUDAGraph()
        with pytest.raises(RuntimeError, match="eager call at this shape"):
            with torch.cuda.graph(graph):
                grow()
        del graph


# --- the constrained burst ("decode_guided") on its graph -------------------


def _guided_tables(specs, vocab=256):
    from dynamo_tpu_torch.llm.guided import compile_guided

    return [compile_guided(s, [bytes([i]) for i in range(256)]
                           + [None] * (vocab - 256)) for s in specs]


def _guided_stack(tables, rows, dev):
    """Resident tables in the engine's packed layout (row 0 all-allowed,
    each grammar at its first row, transitions offset there): (bits,
    next, eos_ok) and each grammar's first row."""
    v = tables[0].next_state.shape[1]
    bits = torch.zeros((1, rows, (v + 7) // 8), dtype=torch.uint8,
                       device=dev)
    nxt = torch.zeros((1, rows, v), dtype=torch.int16, device=dev)
    eos = torch.zeros((1, rows), dtype=torch.bool, device=dev)
    bits[0, 0] = 0xFF
    firsts = _write_grammars(tables, (bits, nxt, eos))
    return (bits, nxt, eos), firsts


def _write_grammars(tables, stack, first=1):
    bits, nxt, eos = stack
    firsts = []
    for t in tables:
        n = t.num_states
        bits[0, first:first + n] = torch.from_numpy(t.allowed_bits)
        nxt[0, first:first + n] = torch.from_numpy(
            (t.next_state.astype(np.int32) + first).astype(np.int16))
        eos[0, first:first + n] = torch.from_numpy(t.eos_ok)
        firsts.append(first)
        first += n
    return firsts


def _guided_inputs(cfg, lane_rows, shift=0):
    """A 4-lane constrained burst's graph inputs (`decode_multi_step_guided`
    without the tables): `_burst_inputs`, then min_p, the penalties, the
    prompt and output counts, grammar index 0 and each lane's table row,
    the stop ids (EOS 0)."""
    b, v = 4, cfg.vocab_size
    pc = np.zeros((b, v), np.int32)
    pc[:, 97:100] = 1
    oc = np.zeros((b, v), np.int32)
    oc[1, 98] = 2
    stop = np.full((b, 8), -1, np.int32)
    stop[:, 0] = 0
    return [*_burst_inputs(cfg, shift),
            np.array([0.0, 0.1, 0.0, 0.0], np.float32),
            np.array([1.0, 1.3, 1.0, 1.0], np.float32),
            np.array([0.0, 0.4, 0.0, 0.0], np.float32),
            np.array([0.0, 0.5, 0.0, 0.0], np.float32), pc, oc,
            np.zeros(b, np.int32), np.asarray(lane_rows, np.int32), stop]


def _guided_step(model, stack, tk, k=4):
    from dynamo_tpu_torch.models.llama import decode_multi_step_guided

    return lambda kc, vc, *a: decode_multi_step_guided(
        model, kc, vc, *a[:15], *stack, *a[15:], num_steps=k, topk_lp=tk)


@pytest.mark.parametrize("tk", [0, 8])
@pytest.mark.parametrize("mode", GRAPH_MODES)
def test_guided_graph_replays_bit_identical_to_eager(cuda_device, mode, tk):
    """A constrained burst (grammar lanes, a penalised min_p lane, a free
    lane, an empty lane) replayed from its graph equals the eager burst on
    the same inputs, bit for bit, outputs and caches; the replay leaves
    its static inputs as they were loaded (the burst advances copies of
    the counts and states)."""
    cfg, model = _graph_model(cuda_device, mode)
    stack, firsts = _guided_stack(_guided_tables(
        [{"choice": ["ab", "ba"]}, {"regex": "[a-d]+x"}]), 16, cuda_device)
    step = _guided_step(model, stack, tk)
    seq = [_guided_inputs(cfg, [firsts[0], 0, firsts[1], 0]),
           _guided_inputs(cfg, [firsts[0] + 1, firsts[1], 0, 0], shift=5)]
    with torch.inference_mode():
        _graph_vs_eager(cuda_device, cfg, step, seq)
        from dynamo_tpu_torch.engine.graphs import StepGraphs

        graphs = StepGraphs(cuda_device)
        _, caches = _random_caches(cfg, cuda_device, 7)
        for inputs in seq:
            out = graphs.run(("g",), lambda *a: step(*caches, *a), inputs)
            torch.cuda.synchronize()
            for buf, a in zip(graphs.graphs[("g",)].inputs, inputs):
                assert torch.equal(buf.cpu(), torch.from_numpy(a))
    toks = out[0].cpu().numpy().astype(int)
    assert bytes(toks[:, 0]).split(b"\0")[0] in (b"a", b"b", b"ab", b"ba")


def test_guided_graph_reads_grammar_written_in_place(cuda_device):
    """A grammar written into the resident tables after the capture is
    what the next replay reads: the replay equals an eager call on the new
    tables, and the lane's tokens follow the new grammar."""
    from dynamo_tpu_torch.engine.graphs import StepGraphs

    cfg, model = _graph_model(cuda_device, "bf16")
    first, second = _guided_tables([{"regex": "a{8}"}, {"regex": "z{8}"}])
    stack, (row,) = _guided_stack([first], 16, cuda_device)
    step = _guided_step(model, stack, 0)
    _, graphed = _random_caches(cfg, cuda_device, 11)
    inputs = _guided_inputs(cfg, [row, row, 0, 0])
    graphs = StepGraphs(cuda_device)
    with torch.inference_mode():
        got = graphs.run(("g",), lambda *a: step(*graphed, *a), inputs)
        assert set(got[0, :, :2].flatten().tolist()) == {ord("a")}
        _write_grammars([second], stack, first=row)
        # the replay rewrites every cache row it reads before reading it,
        # so fresh caches of the same seed give the eager answer
        _, eager = _random_caches(cfg, cuda_device, 11)
        want = step(*eager, *_device(inputs, cuda_device))
        got = graphs.run(("g",), None, inputs)
        torch.cuda.synchronize()
    assert graphs.captures == 1 and graphs.replays == 2
    assert set(got[0, :, :2].flatten().tolist()) == {ord("z")}
    assert torch.equal(got, want)


def test_guided_engine_buckets_on_card_match_cpu(cuda_device):
    """The engine on the card against the same engine on the CPU (fp32,
    greedy and seeded lanes): a small grammar captures "decode_guided" at
    one row bucket, a large one grows the tables into a new bucket (new
    buffers, a second capture), and after both are evicted a small
    grammar returns to the first bucket, whose graph replays on its kept
    buffers with the new rows written in place. Streams identical."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.models.llama import LlamaConfig, init_params
    from dynamo_tpu_torch.runtime.context import Context

    mcfg = LlamaConfig.tiny(dtype=torch.float32, head_dim=32, page_size=8)
    cpu_model = init_params(mcfg, 0, torch.device("cpu"))
    phases = [[{"regex": "[ab]{5}", "t": 0.0}],
              [{"regex": "[a-z]{40}", "t": 0.9},
               {"regex": "(xy)+", "t": 0.0}],
              [{"regex": "[cd]{5}", "t": 0.7}]]

    async def serve(device):
        model = cpu_model if device.type == "cpu" else \
            copy.deepcopy(cpu_model).to(device)
        eng = TorchEngine(TorchEngineConfig(
            model=mcfg, num_pages=64, max_batch_size=4, prefill_chunk=32,
            min_prefill_bucket=8, decode_steps_per_sync=4,
            device=str(device)), model=model,
            token_bytes=[bytes([i]) for i in range(256)], eos_token_id=0)
        eng.MAX_GUIDED_GRAMMARS = 2

        async def one(spec):
            sampling = {"temperature": spec.pop("t"), "seed": 3,
                        "guided": spec}
            toks = []
            async for o in eng.generate(
                    {"token_ids": [10, 20, 30], "sampling": sampling,
                     "stop": {"max_tokens": 12, "stop_token_ids": [0]}},
                    Context()):
                toks.extend(o.get("token_ids", ()))
            return toks

        out, buckets = [], []
        try:
            for specs in phases:
                # each request goes in once the one before has its grammar
                # registered: a burst that ran between two compiles of one
                # phase would otherwise capture at an intermediate row
                # bucket, as the host pool's timing decides
                tasks = []
                for spec in specs:
                    tasks.append(asyncio.ensure_future(one(dict(spec))))
                    key = eng._guided_key(
                        {k: v for k, v in spec.items() if k != "t"})
                    while key not in eng._guided_tables:
                        await asyncio.sleep(0.001)
                out.append(await asyncio.gather(*tasks))
                buckets.append(eng._guided_layout()[0])
        finally:
            await eng.close()
        return out, buckets, eng

    on_card, buckets, eng = asyncio.run(serve(cuda_device))
    on_cpu, cpu_buckets, _ = asyncio.run(serve(torch.device("cpu")))
    assert on_card == on_cpu and buckets == cpu_buckets
    small, big = buckets[0], buckets[1]
    assert big > small and buckets[2] == small
    keys = sorted(k for k in eng.graphs.graphs if k[0] == "decode_guided")
    assert [k[1][-1] for k in keys] == sorted({small, big})
    assert set(eng._guided_buffers) == {small, big}


# --- the phase path's prefill attention through K1 ---------------------------

PREFILL_CASES = {
    # (cached, seq_lens, T, geometry (H, KVH, P, D))
    "tiny-mid-page": ([3, 17, 0, 0], [10, 23, 1, 0], 16, (8, 2, 8, 64)),
    "8b-bp1-aligned": ([0], [480], 512, (32, 8, 16, 128)),
    "8b-bp8-chunk": ([0, 512, 0, 1024, 64, 0, 0, 0],
                     [512, 1024, 300, 1041, 576, 16, 100, 0], 512,
                     (32, 8, 16, 128)),
}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, FP32_TOL),
                                       (torch.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_prefill_attention_through_k1_matches_plain(cuda_device, case,
                                                    dtype, tol):
    """`prefill_attention` on CUDA tensors launches K1 once over the
    flattened chunk rows and equals the plain prefill attention on every
    valid row within K1's tolerance; padding rows (position >= seq_len)
    are exact zeros, where the plain version averages the valid keys."""
    cached, lens, t, (h, kvh, p, d) = PREFILL_CASES[case]
    bp = len(cached)
    gen = torch.Generator().manual_seed(bp * 1000 + t)
    max_pages = (max(lens) + t) // p + 2
    n_pages = 1 + bp * max_pages
    q = torch.randn(bp, t, h, d, generator=gen).to(cuda_device, dtype)
    k = torch.randn(kvh, n_pages, p, d, generator=gen).to(cuda_device, dtype)
    v = torch.randn(kvh, n_pages, p, d, generator=gen).to(cuda_device, dtype)
    tables = (1 + torch.randperm(bp * max_pages, generator=gen)).reshape(
        bp, max_pages).to(torch.int32).to(cuda_device)
    pos = (torch.tensor(cached, dtype=torch.int32)[:, None]
           + torch.arange(t, dtype=torch.int32)[None, :]).to(cuda_device)
    seq = torch.tensor(lens, dtype=torch.int32).to(cuda_device)
    before = ragged._KERNEL.launches
    got = attention.prefill_attention(q, k, v, tables, pos, seq)
    assert ragged._KERNEL.launches == before + 1
    want = attention.prefill_attention_ref(q, k, v, tables, pos, seq)
    torch.cuda.synchronize()
    valid = pos < seq[:, None]
    torch.testing.assert_close(got[valid].float(), want[valid].float(), **tol)
    assert torch.all(got[~valid] == 0)


def _prefill_inputs(cfg, bp, t, aligned, shift=0):
    """A chunk round's host arrays in `prefill_batch`'s order: lanes with
    cursors at page starts (aligned) or mid-page, one padding lane."""
    P = cfg.page_size
    starts = [0, 2 * P, 0, 0] if aligned else [3, P + 5, 1, 0]
    lens = [t, 2 * P + t - 5, 7, 0]
    toks = ((np.arange(bp * t).reshape(bp, t) * 13 + shift) % 256) \
        .astype(np.int32)
    return [toks, _lane_tables(cfg, bp),
            np.array(starts[:bp], np.int32),
            np.array([max(s, n) for s, n in zip(starts, lens)][:bp],
                     np.int32)]


@pytest.mark.parametrize("aligned", [True, False], ids=["K3", "K2"])
@pytest.mark.parametrize("mode", GRAPH_MODES)
def test_prefill_graph_replays_bit_identical_to_eager(cuda_device, mode,
                                                      aligned):
    """A "prefill" chunk round (K3 or K2 writes, K1 attention) replayed
    from its graph equals the eager round: last-token logits and both
    caches, bit for bit, with the inputs changed between replays."""
    from dynamo_tpu_torch.models.llama import prefill_batch

    cfg, model = _graph_model(cuda_device, mode)
    step = (lambda kc, vc, *a: prefill_batch(model, kc, vc, *a,
                                             aligned=aligned))
    with torch.inference_mode():
        _graph_vs_eager(cuda_device, cfg, step,
                        [_prefill_inputs(cfg, 4, 16, aligned),
                         _prefill_inputs(cfg, 4, 16, aligned, shift=5)])


@pytest.mark.parametrize("tk", [0, 8])
@pytest.mark.parametrize("mode", GRAPH_MODES)
def test_mixed_step_graph_replays_bit_identical_to_eager(cuda_device, mode,
                                                         tk):
    """A "mixed_step" (an aligned chunk sub-batch riding a 4-step burst)
    replayed from its graph equals the eager step: packed output, chunk
    logits and both caches."""
    from dynamo_tpu_torch.models.llama import mixed_prefill_decode

    cfg, model = _graph_model(cuda_device, mode)

    def step(kc, vc, *a):
        return mixed_prefill_decode(model, kc, vc, *a, num_steps=4,
                                    aligned=True, topk_lp=tk)

    def inputs(shift):
        ch = _prefill_inputs(cfg, 2, 16, True, shift)
        ch[1] = ch[1] + 4 * cfg.max_pages_per_seq       # other pages
        burst = _burst_inputs(cfg, shift)
        return ch + burst

    with torch.inference_mode():
        _graph_vs_eager(cuda_device, cfg, step, [inputs(0), inputs(9)])


@pytest.mark.parametrize("tk", [0, 8])
def test_sample_first_graph_replays_bit_identical_to_eager(cuda_device, tk):
    """"sample_first" (the first token's sampling over the fixed width,
    logits a device input) replayed from its graph equals eager
    sampling: greedy, temperature, top-p, top-k and min_p lanes."""
    from dynamo_tpu_torch.engine.sampling import sample_tokens_lp

    rng = np.random.default_rng(5)

    def inputs(shift):
        return [rng.standard_normal((8, 1000)).astype(np.float32) * 3,
                np.arange(8, dtype=np.int64) + 100 * shift,
                np.zeros(8, np.int64),
                np.array([0, 0.7, 1.0, 1.3, 0, 0.9, 1.0, 0.5], np.float32),
                np.array([1, 0.9, 1, 1, 1, 0.5, 1, 1], np.float32),
                np.array([0, 0, 40, 0, 0, 0, 5, 0], np.int64),
                np.array([0, 0, 0, 0.1, 0, 0, 0, 0.05], np.float32)]

    step = (lambda kc, vc, *a: sample_tokens_lp(*a, topk_lp=tk))
    cfg, _ = _graph_model(cuda_device, "bf16")
    with torch.inference_mode():
        _graph_vs_eager(cuda_device, cfg, step, [inputs(0), inputs(1)],
                        launches=False)


def test_first_tokens_of_one_prefill_key_survive_its_next_replay(
        cuda_device):
    """Prompts of 8 tokens finish in round 1 and prompts of 32 in round 2
    of one (4, 16, aligned) "prefill" graph: the engine copies the rows it
    keeps, so the card's streams (graphs replayed) are the CPU's."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.models.llama import LlamaConfig, init_params
    from dynamo_tpu_torch.runtime.context import Context

    mcfg = LlamaConfig.tiny(dtype=torch.float32, head_dim=32, page_size=4)
    cpu_model = init_params(mcfg, 0, torch.device("cpu"))
    prompts = [list(range(1, 9)), list(range(3, 35)), list(range(40, 48)),
               list(range(9, 41))]

    async def serve(device):
        model = cpu_model if device.type == "cpu" else \
            copy.deepcopy(cpu_model).to(device)
        eng = TorchEngine(TorchEngineConfig(
            model=mcfg, num_pages=64, max_batch_size=4, prefill_chunk=16,
            min_prefill_bucket=8, prefill_batch_widths=(4,),
            device=str(device)), model=model)

        async def one(prompt):
            toks = []
            async for o in eng.generate(
                    {"token_ids": prompt, "sampling": {"temperature": 0.0},
                     "stop": {"max_tokens": 4}}, Context()):
                toks.extend(o.get("token_ids", ()))
            return toks

        try:
            return (await asyncio.gather(*map(one, prompts)),
                    sorted(k for k in eng.graphs.graphs
                           if k[0] == "prefill"))
        finally:
            await eng.close()

    on_card, keys = asyncio.run(serve(cuda_device))
    assert keys == [("prefill", (4, 16, 1))]
    assert on_card == asyncio.run(serve(torch.device("cpu")))[0]


# --- the KV gather and the disagg import on the card ------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layers,kvh,p,d,n", [(2, 2, 4, 16, 5),
                                               (32, 8, 16, 128, 66)])
def test_kv_gather_kernel_bit_exact(cuda_device, dtype, layers, kvh, p, d,
                                    n):
    """One gather launch over 2L caches equals the plain per-layer
    index_select stack bit for bit, into a fresh tensor and into `out`."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    n_pages = 3 * n + 1
    kc = [torch.randn(kvh, n_pages, p, d, generator=gen, device=cuda_device)
          .to(dtype) for _ in range(layers)]
    vc = [torch.randn(kvh, n_pages, p, d, generator=gen, device=cuda_device)
          .to(dtype) for _ in range(layers)]
    ids = torch.randperm(n_pages - 1, device=cuda_device)[:n].to(
        torch.int32) + 1
    ptrs = kernels.cache_pointers(kc, vc)
    before = kernels._GATHER_KERNEL.launches
    got = kernels.paged_kv_gather(kc, vc, ids, ptrs)
    out = torch.empty_like(got)
    assert kernels.paged_kv_gather(kc, vc, ids, ptrs, out=out) is out
    assert kernels._GATHER_KERNEL.launches == before + 2
    want = kernels.paged_kv_gather_ref(kc, vc, ids)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(out, want)


def test_kv_export_import_on_card(cuda_device):
    """An engine's gathered pages, written into another engine's fresh
    pages through K3 (`write_kv_pages`), read back equal; a decode-first
    continuation from them equals the aggregated stream (fp32)."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.models.llama import LlamaConfig, init_params
    from dynamo_tpu_torch.runtime.context import Context

    mcfg = LlamaConfig.tiny(dtype=torch.float32, head_dim=32, page_size=8)
    model = init_params(mcfg, 0, cuda_device)
    prompt = list(range(1, 30))

    def engine():
        return TorchEngine(TorchEngineConfig(
            model=mcfg, num_pages=64, max_batch_size=4, prefill_chunk=32,
            min_prefill_bucket=8, device="cuda"), model=model)

    async def toks(eng, request):
        out, ktp = [], None
        request["sampling"] = {"temperature": 0.0}
        async for o in eng.generate(request, Context()):
            assert o.get("finish_reason") != "error", o
            out.extend(o.get("token_ids", ()))
            ktp = o.get("kv_transfer_params") or ktp
        return out, ktp

    async def main():
        agg, pe, de = engine(), engine(), engine()
        try:
            want, _ = await toks(agg, {"token_ids": prompt,
                                       "stop": {"max_tokens": 6}})
            (first,), ktp = await toks(pe, {
                "token_ids": prompt, "stop": {"max_tokens": 1},
                "kv_transfer_params": {"do_remote_decode": True}})
            pages, plen = pe.take_transfer(ktp["transfer_id"])
            data = await pe.read_kv_pages_device(pages)
            assert data.device.type == "cuda"
            host = await pe.read_kv_pages(pages)
            assert torch.equal(data.cpu(), host)
            pe.complete_transfer(ktp["transfer_id"])
            rest, _ = await toks(de, {
                "token_ids": prompt + [first], "stop": {"max_tokens": 5},
                "kv_transfer_params": {"kv_data": data,
                                       "prefill_len": plen}})
            return want, [first] + rest
        finally:
            for e in (agg, pe, de):
                await e.close()

    want, got = asyncio.run(main())
    assert got == want


_PRODUCER = r"""
import json, sys, torch
from dynamo_tpu_torch.disagg.transfer_plane import get_plane
gen = torch.Generator(device="cuda").manual_seed(int(sys.argv[1]))
pad = torch.empty(1000, dtype=torch.uint8, device="cuda")   # offset > 0
buf = torch.randn(2, 4, 2, 3, 16, 64, generator=gen, device="cuda").to(
    torch.bfloat16)
torch.cuda.synchronize()
desc = get_plane().publish("t1", buf)
desc["handle"] = desc["handle"].hex()
print(json.dumps(desc), flush=True)
sys.stdin.readline()              # until the consumer has copied
print(json.dumps({"released": get_plane().release("t1"),
                  "staged": get_plane().staged}), flush=True)
"""


def test_ipc_plane_pulls_across_two_processes(cuda_device):
    """A producer process stages a bf16 buffer that lies inside a larger
    allocation (a non-zero offset); this process pulls it through CUDA
    IPC: the copy is bit-exact, and the producer frees the buffer on the
    ack. A descriptor of this process's own buffer is refused."""
    import json
    import os
    import subprocess
    import sys

    from dynamo_tpu_torch.disagg.transfer_plane import TransferPlane

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.Popen([sys.executable, "-c", _PRODUCER, "7"], env=env,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True)
    try:
        desc = json.loads(proc.stdout.readline())
        assert desc["kind"] == "cuda_ipc" and desc["offset"] >= 0
        desc["handle"] = bytes.fromhex(desc["handle"])
        plane = TransferPlane()
        got = plane.pull(desc, cuda_device)
        proc.stdin.write("\n")
        proc.stdin.flush()
        done = json.loads(proc.stdout.readline())
    finally:
        proc.stdin.close()
        assert proc.wait(60) == 0
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    want = torch.randn(2, 4, 2, 3, 16, 64, generator=gen,
                       device=cuda_device).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert done == {"released": True, "staged": 0}
    mine = plane.publish("own", want)
    with pytest.raises(ValueError, match="process that exported it"):
        plane.pull(mine, cuda_device)
    assert plane.release("own")


# -- KVBM on the card ------------------------------------------------------------


def _kvbm_engine(dev, num_pages=200, **kvbm_kw):
    """A TorchEngine at Llama-3-8B's KV geometry (32 layers, 8 KV heads,
    pages of 16 rows of 128, bf16; narrow elsewhere) with a KvbmManager,
    its caches filled with random values."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.kvbm import KvbmConfig, KvbmManager
    from dynamo_tpu_torch.models.llama import LlamaConfig

    mcfg = LlamaConfig.tiny(num_layers=32, num_heads=8, num_kv_heads=8,
                            head_dim=128, page_size=16, hidden_size=256,
                            intermediate_size=512, max_pages_per_seq=80)
    eng = TorchEngine(TorchEngineConfig(model=mcfg, num_pages=num_pages,
                                        device="cuda"))
    gen = torch.Generator(device=dev).manual_seed(5)
    for c in (*eng.k_cache, *eng.v_cache):
        c.copy_(torch.randn(c.shape, generator=gen, device=dev))
    return eng, KvbmManager(eng, KvbmConfig(host_blocks=256, **kvbm_kw))


def test_kvbm_offload_onboard_round_trip_bit_exact_at_8b_geometry(
        cuda_device):
    """66 pages offloaded through the gather and the pinned copy (one
    block each, owning its storage, equal to the pages bit for bit), put
    in and read back from the host tier, then onboarded into 66 other
    pages through the pinned stack, one copy and K3: the new pages equal
    the old ones bit for bit; one gather launch, 32 K3 launches."""
    from dynamo_tpu_torch.engine import cuda_build
    from dynamo_tpu_torch.tokens import compute_seq_hashes

    eng, mgr = _kvbm_engine(cuda_device)
    src = list(range(1, 67))
    dst = list(range(100, 166))
    before = cuda_build.launch_counts()
    blocks = eng._read_kv_pages_sync(src)
    hashes = compute_seq_hashes(list(range(66 * 16)), 16)
    for i, (h, b) in enumerate(zip(hashes, blocks)):
        assert b.device.type == "cpu" and b.dtype == torch.bfloat16
        assert b.shape == (2, 32, 8, 16, 128) and b.is_contiguous()
        assert b.untyped_storage().nbytes() == b.nbytes == 2 << 20
        want = torch.stack([torch.stack([c[:, src[i]] for c in caches])
                            for caches in (eng.k_cache, eng.v_cache)])
        assert torch.equal(b, want.cpu())
        mgr.store.put(h, b)
    eng.write_kv_blocks(dst, [mgr.store.get(h) for h in hashes])
    torch.cuda.synchronize()
    delta = cuda_build.launch_delta(before, cuda_build.launch_counts())
    assert delta == {"paged_kv_gather": 1, "paged_kv_write_pages": 32}
    for caches in (eng.k_cache, eng.v_cache):
        for c in caches:
            assert torch.equal(c[:, dst], c[:, src])
    asyncio.run(eng.close())
    # one onboard and one offload read, each stage timed once (close
    # settles the onboard's copy and K3)
    for name, h in eng.metrics.kvbm_stage.items():
        assert h.count == 1 and h.sum > 0, name


def test_kvbm_pinned_staging_reused_across_onboards(cuda_device):
    """Onboards of 66, 40 and 66 blocks and offloads of 66 and 10 pages
    reuse one pinned host buffer each (and one device buffer each): the
    same allocation, page-locked, never replaced."""
    eng, _ = _kvbm_engine(cuda_device)
    blocks = eng._read_kv_pages_sync(list(range(1, 67)))
    offload = eng._kv_staging["offload"]
    offload_dev = eng._kv_staging["offload_dev"]
    eng._read_kv_pages_sync(list(range(70, 80)))
    assert eng._kv_staging["offload_dev"] is offload_dev
    ptrs = None
    for n in (66, 40, 66):
        eng.write_kv_blocks(list(range(100, 100 + n)), blocks[:n])
        now = {k: (v.data_ptr(), v.numel()) for k, v in
               eng._kv_staging.items()}
        assert ptrs is None or now == ptrs
        ptrs = now
    torch.cuda.synchronize()
    assert eng._kv_staging["offload"] is offload and offload.is_pinned()
    assert eng._kv_staging["onboard"].is_pinned()
    assert eng._kv_staging["onboard_dev"].device.type == "cuda"
    asyncio.run(eng.close())


def test_kvbm_pipelined_offload_across_graph_captures(cuda_device):
    """The pipelined offload worker (delayed 0.1 s a batch, so its pins
    stay out) runs while the engine captures new CUDA graphs: some
    captures happen with offload pins outstanding, and every stream —
    revisits onboarded from the host tier included — equals the same
    engine's with every graph replaced by its eager call, token and
    logprob bit for bit (fp32)."""
    from dynamo_tpu_torch.engine import graphs as graphs_mod
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.kvbm import KvbmConfig, KvbmManager
    from dynamo_tpu_torch.models.llama import LlamaConfig, init_params
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.faults import FaultInjector

    mcfg = LlamaConfig.tiny(dtype=torch.float32, head_dim=32, page_size=8)
    model = init_params(mcfg, 0, cuda_device)
    prompts = [list(range(b, b + n)) for b, n in
               ((1, 30), (40, 30), (80, 60), (1, 30), (150, 100),
                (40, 30), (200, 14))]

    class EagerGraphs(graphs_mod.StepGraphs):
        def run(self, key, fn, inputs):
            self.replays += 1
            return fn(*(graphs_mod._tensor(a).to(self.device)
                        for a in inputs))

    def run(eager: bool):
        eng = TorchEngine(TorchEngineConfig(
            model=mcfg, num_pages=24, max_batch_size=4, prefill_chunk=32,
            min_prefill_bucket=8, device="cuda"), model=model)
        mgr = KvbmManager(eng, KvbmConfig(
            host_blocks=256, offload_queue_depth=64, offload_workers=2),
            fault_injector=FaultInjector.from_spec(
                "kind=offload_delay,times=*,delay_s=0.1"))
        pins_at_capture = []
        if eager:
            eng.graphs = EagerGraphs(cuda_device)
        else:
            capture = eng.graphs._capture

            def counted(fn, inputs):
                pins_at_capture.append(eng.pool.pending_offload_pages)
                return capture(fn, inputs)

            eng.graphs._capture = counted

        async def main():
            outs = []
            try:
                for p in prompts:
                    toks, lps = [], []
                    async for o in eng.generate(
                            {"token_ids": p,
                             "sampling": {"temperature": 0.0},
                             "stop": {"max_tokens": 6}}, Context()):
                        assert o.get("finish_reason") != "error", o
                        toks.extend(o.get("token_ids", ()))
                        lps.extend(o.get("log_probs") or ())
                    outs.append((toks, lps))
                while eng.pool.pending_offload_pages or mgr._offload_q_blocks:
                    await asyncio.sleep(0.01)
                return outs, dict(vars(mgr.stats))
            finally:
                await eng.close()

        outs, stats = asyncio.run(main())
        return outs, stats, pins_at_capture, eng.graphs

    got, stats, pins, graphed = run(eager=False)
    want, _, _, _ = run(eager=True)
    assert got == want
    assert got[3] == got[0] and got[5] == got[1]
    assert stats["offloaded"] > 0 and stats["onboarded"] > 0
    assert graphed.captures == len(pins) and graphed.replays > len(pins)
    assert any(n > 0 for n in pins), pins


# --- speculative decoding's geometry and burst on the card -----------------

# Llama-3.2-1B's attention geometry, the draft's: H 32, KVH 8, D 64, P 16
DRAFT_GEOMETRY = dict(h=32, kvh=8, d=64, p=16)


def test_draft_geometry_kernels_match_plain(cuda_device):
    """K2 and K3 bit-exact outside page 0, K1 and K4 in bf16 within the
    bf16 tolerance and with q = 0 at the uniform one, at the draft's
    geometry (D 64); K1 also at a verify round's rows (8 lanes x 5 rows
    at unaligned cursors, D 128)."""
    h, kvh, d, p = (DRAFT_GEOMETRY[k] for k in ("h", "kvh", "d", "p"))
    gen = torch.Generator().manual_seed(64)
    n_pages, max_pages = 160, 16
    dt = torch.bfloat16
    kc = torch.randn(kvh, n_pages, p, d, generator=gen).to(cuda_device, dt)
    vc = torch.randn(kvh, n_pages, p, d, generator=gen).to(cuda_device, dt)
    rows = 24
    k_rows = torch.randn(rows, kvh, d, generator=gen).to(cuda_device, dt)
    v_rows = torch.randn(rows, kvh, d, generator=gen).to(cuda_device, dt)
    slots = torch.randperm((n_pages - 1) * p, generator=gen)[:rows]
    pages = (1 + slots // p).to(torch.int32)
    offs = (slots % p).to(torch.int32)
    pages[-3:], offs[-3:] = 0, 0
    pages, offs = pages.to(cuda_device), offs.to(cuda_device)
    want = (kc.clone(), vc.clone())
    kernels.paged_kv_write_ref(*want, k_rows, v_rows, pages, offs)
    got = (kc.clone(), vc.clone())
    kernels.paged_kv_write(*got, k_rows, v_rows, pages, offs)
    for g, w in zip(got, want):
        assert torch.equal(g[:, 1:], w[:, 1:])
    ids = (1 + torch.randperm(n_pages - 1, generator=gen)[:12]).to(
        torch.int32)
    ids[[2, 7]] = 0
    ids = ids.to(cuda_device)
    blocks = [torch.randn(12 * p, kvh, d, generator=gen).to(cuda_device, dt)
              .view(12, p, kvh, d).permute(0, 2, 1, 3) for _ in range(2)]
    want = (kc.clone(), vc.clone())
    kernels.paged_kv_write_pages_ref(*want, *blocks, ids)
    got = (kc.clone(), vc.clone())
    kernels.paged_kv_write_pages(*got, *blocks, ids)
    for g, w in zip(got, want):
        assert torch.equal(g[:, 1:], w[:, 1:])
    # K4: eight decode lanes, page edges and longer contexts
    lens = torch.tensor([1, 15, 16, 17, 0, 100, 200, 255], dtype=torch.int32)
    tables = (1 + torch.randperm(n_pages - 1, generator=gen)[:8 * max_pages]
              ).reshape(8, max_pages).to(torch.int32)
    q = torch.randn(8, h, d, generator=gen).to(cuda_device, dt)
    args = (kc, vc, lens.to(cuda_device), tables.to(cuda_device))
    torch.testing.assert_close(
        attention.paged_attention_decode(q, *args).float(),
        attention.paged_attention_decode_ref(q, *args).float(), **BF16_TOL)
    zq = torch.zeros_like(q)
    torch.testing.assert_close(
        attention.paged_attention_decode(zq, *args).float(),
        attention.paged_attention_decode_ref(
            zq.float(), kc.float(), vc.float(), *args[2:]), **UNIFORM_TOL)
    # K1: decode rows and a prompt chunk straddling pages, padding rows
    qpos = [0, 15, 16, 40, 100, 254] + list(range(30, 70)) + [-1, -1]
    lanes = [0, 1, 2, 3, 4, 5] + [6] * 40 + [0, 0]
    qpos_t = torch.tensor(qpos, dtype=torch.int32).to(cuda_device)
    lanes_t = torch.tensor(lanes, dtype=torch.int32).to(cuda_device)
    tab = tables.to(cuda_device)
    q1 = torch.randn(len(qpos), h, d, generator=gen).to(cuda_device, dt)
    got = ragged.ragged_paged_attention(q1, kc, vc, qpos_t, lanes_t, tab)
    want = ragged.ragged_attention_ref(q1, kc, vc, qpos_t, lanes_t, tab)
    valid = qpos_t >= 0
    torch.testing.assert_close(got[valid].float(), want[valid].float(),
                               **BF16_TOL)
    assert torch.all(got[~valid] == 0)
    z1 = torch.zeros_like(q1)
    got = ragged.ragged_paged_attention(z1, kc, vc, qpos_t, lanes_t, tab)
    want = ragged.ragged_attention_ref(z1.float(), kc.float(), vc.float(),
                                       qpos_t, lanes_t, tab)
    torch.testing.assert_close(got[valid].float(), want[valid], **UNIFORM_TOL)
    # K1 at a verify round (D 128): 8 lanes x 5 rows from unaligned cursors
    d8 = 128
    k8 = torch.randn(8, n_pages, p, d8, generator=gen).to(cuda_device, dt)
    v8 = torch.randn(8, n_pages, p, d8, generator=gen).to(cuda_device, dt)
    starts = [3, 17, 40, 61, 90, 130, 177, 230]
    vq = [s + j for s in starts for j in range(5)]
    vl = [i for i in range(8) for _ in range(5)]
    vq_t = torch.tensor(vq, dtype=torch.int32).to(cuda_device)
    vl_t = torch.tensor(vl, dtype=torch.int32).to(cuda_device)
    qv = torch.randn(40, 32, d8, generator=gen).to(cuda_device, dt)
    torch.testing.assert_close(
        ragged.ragged_paged_attention(qv, k8, v8, vq_t, vl_t, tab).float(),
        ragged.ragged_attention_ref(qv, k8, v8, vq_t, vl_t, tab).float(),
        **BF16_TOL)


def _spec_case(dev, cfg, dcfg, n_pages=96, self_draft=False):
    """A spec burst's inputs for 8 lanes (two of them seeded stochastic,
    one padding) on random caches of target and draft; with `self_draft`
    the draft's caches are a copy of the target's."""
    from dynamo_tpu_torch.models.llama import init_cache

    gen = torch.Generator().manual_seed(21)
    caches = []
    for c in (cfg, dcfg):
        if self_draft and caches:
            caches += [[t.clone() for t in pair] for pair in caches]
            break
        kc, vc = init_cache(c, n_pages, dev)
        for t in kc + vc:
            t.copy_(torch.randn(t.shape, generator=gen))
        caches += [kc, vc]
    tables = torch.zeros(8, cfg.max_pages_per_seq, dtype=torch.int32)
    for i in range(8):
        tables[i, :10] = torch.arange(1 + 10 * i, 11 + 10 * i)
    inputs = [torch.randint(0, 1000, (8,), generator=gen, dtype=torch.int32),
              torch.tensor([5, 17, 33, 60, 2, 90, 110, 0], dtype=torch.int32),
              tables, torch.tensor([True] * 7 + [False]),
              torch.arange(8, dtype=torch.int64) * 13 + 1,
              torch.arange(8, dtype=torch.int64),
              torch.tensor([0, 0.8, 0, 0, 1.1, 0, 0, 0]),
              torch.tensor([1, 0.9, 1, 1, 1, 1, 1, 1.0]),
              torch.tensor([0, 0, 0, 0, 20, 0, 0, 0])]
    return caches, [a.to(dev) for a in inputs]


def test_spec_burst_on_card_matches_cpu(cuda_device):
    """`spec_decode_multi_step` at 2 layers of full width in fp32 (an
    8B-shaped target, a 1B-shaped draft, D 64) on the card through K1, K2
    and K4 equals the same function on the CPU through the plain
    versions: identical tokens, counts and new positions on the live
    lanes."""
    from dynamo_tpu_torch.engine.spec import spec_decode_multi_step
    from dynamo_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig.llama3_8b(num_layers=2, dtype=torch.float32)
    dcfg = LlamaConfig.llama3_8b(
        num_layers=2, dtype=torch.float32, hidden_size=2048,
        intermediate_size=8192, head_dim=64)
    cpu = torch.device("cpu")
    cpu_models = init_params(cfg, 0, cpu), init_params(dcfg, 1, cpu)
    outs = {}
    for dev in (cuda_device, cpu):
        model, draft = cpu_models if dev.type == "cpu" else (
            copy.deepcopy(m).to(dev) for m in cpu_models)
        caches, inputs = _spec_case(dev, cfg, dcfg)
        with torch.inference_mode():
            packed, pos = spec_decode_multi_step(
                model, draft, *caches, *inputs, gamma=4, num_iters=2,
                topk_lp=2)
        outs[dev.type] = (packed.cpu(), pos.cpu())
        del model, draft, caches
    (pk, ppos), (pc, cpos) = outs["cuda"], outs["cpu"]
    # the padding lane (7) is not compared: K1 gives its rows zeros where
    # the plain version averages, so its garbage tokens differ
    live = inputs[3].cpu()
    assert torch.equal(pk[2][..., live], pc[2][..., live])
    assert torch.equal(ppos[live], cpos[live])
    counts = pc[2, :, 0, :].long()
    mask = (torch.arange(5)[None, :, None] < counts[:, None, :]) \
        & live[None, None, :]
    assert torch.equal(pk[0][mask], pc[0][mask])
    torch.testing.assert_close(pk[1][mask], pc[1][mask], atol=1e-3, rtol=0)


def test_spec_self_draft_on_card_matches_cpu(cuda_device):
    """A self-draft (the target is its own draft, with caches of its own
    that hold the target's KV) at 2 layers of full width in fp32: the
    burst on the card through K1, K2 and K4 accepts what the same burst
    on the CPU through the plain versions accepts (identical counts,
    tokens and new positions on the live lanes), and that is nearly every
    proposal, so the acceptance path itself is held: accepted prefixes,
    the stale draft KV they leave, and the emitted tokens."""
    from dynamo_tpu_torch.engine.spec import spec_decode_multi_step
    from dynamo_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig.llama3_8b(num_layers=2, dtype=torch.float32)
    cpu = torch.device("cpu")
    cpu_model = init_params(cfg, 0, cpu)
    outs = {}
    for dev in (cuda_device, cpu):
        model = cpu_model if dev.type == "cpu" else copy.deepcopy(
            cpu_model).to(dev)
        caches, inputs = _spec_case(dev, cfg, cfg, self_draft=True)
        with torch.inference_mode():
            packed, pos = spec_decode_multi_step(
                model, model, *caches, *inputs, gamma=4, num_iters=3,
                topk_lp=2)
        outs[dev.type] = (packed.cpu(), pos.cpu())
        del model, caches
    (pk, ppos), (pc, cpos) = outs["cuda"], outs["cpu"]
    live = inputs[3].cpu()
    assert torch.equal(pk[2][..., live], pc[2][..., live])
    assert torch.equal(ppos[live], cpos[live])
    counts = pc[2, :, 0, :].long()
    # 5 = gamma accepted + the target's extra token, every iteration
    assert counts[:, live].float().mean() >= 4.5, counts
    mask = (torch.arange(5)[None, :, None] < counts[:, None, :]) \
        & live[None, None, :]
    assert torch.equal(pk[0][mask], pc[0][mask])
    torch.testing.assert_close(pk[1][mask], pc[1][mask], atol=1e-3, rtol=0)


def test_spec_burst_graph_replay_bit_identical(cuda_device):
    """A spec burst (bf16, 2 layers at full width, an 8B-shaped target and
    a 1B-shaped draft) replayed from its CUDA graph equals the eager burst
    on copies of both cache pairs: packed output and all four caches, bit
    for bit."""
    from dynamo_tpu_torch.engine.graphs import StepGraphs
    from dynamo_tpu_torch.engine.spec import spec_decode_multi_step
    from dynamo_tpu_torch.models.llama import LlamaConfig, init_params

    cfg = LlamaConfig.llama3_8b(num_layers=2)
    dcfg = LlamaConfig.llama3_8b(num_layers=2, hidden_size=2048,
                                 intermediate_size=8192, head_dim=64)
    model, draft = (init_params(c, s, cuda_device)
                    for c, s in ((cfg, 0), (dcfg, 1)))
    caches, inputs = _spec_case(cuda_device, cfg, dcfg)
    eager = [[t.clone() for t in c] for c in caches]
    graphed = [[t.clone() for t in c] for c in caches]
    with torch.inference_mode():
        want = spec_decode_multi_step(model, draft, *eager, *inputs,
                                      gamma=4, num_iters=3, topk_lp=8)[0]
        graphs = StepGraphs(cuda_device)

        def step(*a):
            return spec_decode_multi_step(model, draft, *graphed, *a,
                                          gamma=4, num_iters=3,
                                          topk_lp=8)[0]

        got = graphs.run(("spec",), step, [a.cpu().numpy() for a in inputs])
        torch.cuda.synchronize()
    assert graphs.captures == 1 and graphs.replays == 1
    assert torch.equal(got, want)
    for e, g in zip(eager, graphed):
        for te, tg in zip(e, g):
            assert torch.equal(te[:, 1:], tg[:, 1:])


# --- the dispatch watchdog and the canary on the card ------------------------

def _sleep_cycles(seconds: float) -> int:
    """GPU clock cycles that `torch.cuda._sleep` spins for `seconds`,
    calibrated on this card (its clock depends on its power limit)."""
    probe = 50_000_000
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    end.synchronize()
    return int(probe * seconds * 1000.0 / start.elapsed_time(end))


def _card_engine(device):
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.models.llama import LlamaConfig, init_params

    mcfg = LlamaConfig.tiny(dtype=torch.float32, head_dim=32, page_size=8)
    return TorchEngine(TorchEngineConfig(
        model=mcfg, num_pages=64, max_batch_size=4, prefill_chunk=32,
        min_prefill_bucket=8, device=str(device)),
        model=init_params(mcfg, 0, device))


def test_watchdog_trips_once_on_a_real_device_stall(cuda_device):
    """One dispatch of a cuda TorchEngine launches `torch.cuda._sleep` for
    about twice the stall threshold and synchronises: the engine thread
    blocks in the device call as a wedged kernel would hold it. The
    watchdog (reading the queues and the progress token without the
    device lock) trips exactly once; quarantine in task mode completes:
    the engine is flagged, the instance leaves the store and the stream in
    flight gets the err frame Migration replays. The sleep stays well
    inside the hard-exit window (stall + 5 s), which is off here anyway."""
    from dynamo_tpu_torch.engine.watchdog import DispatchWatchdog
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.transport import STREAM_ERR_MSG
    from dynamo_tpu_torch.worker.quarantine import quarantine_worker

    stall_s = 0.5
    cycles = _sleep_cycles(2 * stall_s)

    async def main():
        eng = _card_engine(cuda_device)
        run, calls = eng.graphs.run, []

        def stalled(key, fn, inputs):
            calls.append(key[0])
            if len(calls) == 3:        # a decode dispatch, mid-stream
                torch.cuda._sleep(cycles)
                torch.cuda.synchronize()
            return run(key, fn, inputs)

        eng.graphs.run = stalled
        rt = await DistributedRuntime.create(RuntimeConfig())
        trips = []
        wd = DispatchWatchdog(eng, stall_s, runtime=rt, instance="9",
                              hard_exit=False)
        try:
            ep = rt.namespace("ns").component("c").endpoint("gen")
            served = await ep.serve(eng, instance_id=9)
            client = await ep.client()
            await client.start()
            await client.wait_ready()

            def on_trip(event):
                trips.append(event)
                asyncio.get_running_loop().create_task(quarantine_worker(
                    rt, served, eng, reason="test", exit_process=False,
                    watchdog=wd))

            wd.on_trip = on_trip
            wd.start()

            async def stream():
                async for _ in rt.transport_client.request(
                        rt.transport_address, served.instance.subject,
                        {"token_ids": list(range(1, 20)),
                         "sampling": {"temperature": 0.0},
                         "stop": {"max_tokens": 40, "ignore_eos": True}}):
                    pass

            task = asyncio.get_running_loop().create_task(stream())
            for _ in range(400):
                if getattr(eng, "_quarantined", False):
                    break
                await asyncio.sleep(0.01)
            with pytest.raises(ConnectionError, match=STREAM_ERR_MSG):
                await asyncio.wait_for(task, 10)
            for _ in range(100):
                if not client.instances():
                    break
                await asyncio.sleep(0.02)
            instances = client.instances()
            await client.stop()
            await asyncio.sleep(3 * stall_s)   # the stall is over: no re-trip
            return trips, instances, wd
        finally:
            wd.stop()
            await eng.close()
            await rt.close()

    trips, instances, wd = asyncio.run(main())
    assert len(trips) == 1 and wd.tripped == trips[0]
    assert trips[0]["pending"] >= 1 and trips[0]["stalled_s"] >= stall_s
    assert wd.quarantined.is_set()
    assert wd._counter.get(cause=trips[0]["cause"]) == 1
    assert instances == []


def test_canary_runs_through_the_card_engine(cuda_device):
    """Idle canaries through a cuda TorchEngine served with health checks
    on: the endpoint stays healthy, each canary is one greedy token, and
    the progress token advances once per canary's scheduler iteration."""
    from dynamo_tpu_torch.llm.entrypoint import serve_engine
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    async def main():
        eng = _card_engine(cuda_device)
        seen = []
        gen = eng.generate

        async def tapped(request, context):
            toks = []
            async for out in gen(request, context):
                toks.extend(out.get("token_ids") or ())
                yield out
            seen.append(((request.get("extra") or {}).get("canary"), toks))

        eng.generate = tapped
        rt = await DistributedRuntime.create(RuntimeConfig(
            health_check_enabled=True, health_check_interval=0.3,
            health_check_timeout=30.0))
        try:
            card = ModelDeploymentCard(name="tiny", component="c",
                                       tokenizer_kind="byte",
                                       context_length=128, kv_block_size=8)
            before = eng.progress_token()
            handle = await serve_engine(rt, eng, card, instance_id=5)
            for _ in range(600):
                if len(seen) >= 3:
                    break
                await asyncio.sleep(0.05)
            healthy = rt.health.healthy(handle.served.instance.subject)
            after = eng.progress_token()
            n = len(seen)
            await handle.stop()
            return healthy, seen[:n], after - before
        finally:
            await eng.close()
            await rt.close()

    healthy, seen, advanced = asyncio.run(main())
    assert healthy is True
    assert len(seen) >= 3
    assert all(c is True and len(t) == 1 for c, t in seen)
    assert len({tuple(t) for _, t in seen}) == 1     # greedy, same prompt
    assert advanced >= len(seen)


# --- MoE (Mixtral) and the image encoder on the card ---------------------------

MOE_MODEL = dict(A8_MODEL, num_experts=8, experts_per_token=2)
# bf16 moe_mlp against the fp32 per-token loop: gate, up and their product
# round to bf16 (measured on the CPU at 0.8% of the output's largest
# value); a token whose k-th and (k+1)-th fp32 router logits lie within
# ROUTER_TIE_TOL may route otherwise from the bf16 router product (its
# output rounded to bf16, 2^-8 relative at |logit| <= 6) and is counted,
# not compared
MOE_BF16_TOL = 0.02
ROUTER_TIE_TOL = 0.05


def _moe_model(dev, dtype, quantize=None):
    from dynamo_tpu_torch.models.llama import init_params
    from dynamo_tpu_torch.models.mixtral import MoeConfig

    cfg = MoeConfig.tiny(dtype=dtype, **MOE_MODEL)
    return cfg, init_params(cfg, 0, dev, quantize=quantize)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8"])
def test_moe_mlp_on_card_matches_reference_loop(cuda_device, mode):
    """`moe_mlp` (dense dispatch, cuBLAS products) on the card against
    `moe_mlp_reference`, the per-token fp32 loop (int8 stacks read
    dequantized): fp32 at FP32_TOL, bf16 and int8 within MOE_BF16_TOL of
    the output's largest value, tokens at a router near-tie apart."""
    from dynamo_tpu_torch.models.mixtral import (
        moe_mlp,
        moe_mlp_reference,
        top_k,
    )

    dtype = torch.float32 if mode == "fp32" else torch.bfloat16
    cfg, model = _moe_model(cuda_device, dtype,
                            "int8" if mode == "int8" else None)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    h = torch.randn((3, 7, cfg.hidden_size), generator=gen,
                    device=cuda_device).to(dtype)
    layer = model.layers[1]
    with torch.inference_mode():
        got = moe_mlp(h, layer, cfg).float()
        want = moe_mlp_reference(h, layer, cfg)
        logits = h.float() @ layer.router.float()
    assert got.shape == h.shape and torch.isfinite(got).all()
    if mode == "fp32":
        torch.testing.assert_close(got, want, **FP32_TOL)
        return
    top = logits.sort(dim=-1, descending=True).values
    clear = (top[..., 1] - top[..., 2]) >= ROUTER_TIE_TOL
    assert clear.float().mean() >= 0.5, clear
    err = (got - want).abs().amax(dim=-1)[clear].max().item()
    assert err <= MOE_BF16_TOL * want.abs().max().item(), err
    # the same routing as on the CPU, ties included
    _, on_card = top_k(logits, 2)
    _, on_cpu = top_k(logits.cpu(), 2)
    assert torch.equal(on_card.cpu(), on_cpu)


def test_moe_top_k_ties_on_card_take_the_lowest_index(cuda_device):
    from dynamo_tpu_torch.models.mixtral import top_k

    logits = torch.zeros(64, 8, device=cuda_device)
    logits[:, 3] = 1.0
    logits[:32, 6] = 1.0
    v, i = top_k(logits, 3)
    assert i[:32].tolist() == [[3, 6, 0]] * 32
    assert i[32:].tolist() == [[3, 0, 1]] * 32


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_moe_burst_graph_replays_bit_identical_to_eager(cuda_device, mode):
    """An MoE decode burst (dense dispatch: static shapes, no host read)
    captured in a CUDA graph and replayed equals the eager burst: packed
    output and both caches, bit for bit; K2 and K4 launched."""
    cfg, model = _moe_model(cuda_device, torch.bfloat16,
                            "int8" if mode == "int8" else None)
    with torch.inference_mode():
        _graph_vs_eager(cuda_device, cfg, _burst_step(model, 8),
                        [_burst_inputs(cfg), _burst_inputs(cfg, shift=9)])


@pytest.mark.parametrize("impl", ["phase", "ragged"])
def test_moe_engine_on_card_matches_engine_on_cpu(cuda_device, impl):
    """Greedy fp32 streams of a tiny int8 MoE model are identical on the
    card and on the CPU, on both paths."""
    assert _serve_tiny_on_card_and_cpu(
        cuda_device, impl, dict(MOE_MODEL), quantize="int8", moe=True) > 0


def test_encode_image_tokens_on_card(cuda_device):
    """The encoder on the card (fp32 products) gives the tokens of its
    plain numpy version and of the CPU on the same weights."""
    from dynamo_tpu_torch.multimodal.encoder import (
        ImageEncoderConfig,
        encode_image_tokens,
        init_encoder_params,
    )

    cfg = ImageEncoderConfig(vocab_offset=30000)
    params = init_encoder_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.RandomState(2)
    for _ in range(3):
        img = rng.rand(cfg.image_size, cfg.image_size, 3).astype(np.float32)
        on_card = encode_image_tokens(
            {k: v.to(cuda_device) for k, v in params.items()},
            torch.from_numpy(img).to(cuda_device), cfg)
        on_cpu = encode_image_tokens(params, torch.from_numpy(img), cfg)
        n = cfg.image_size // cfg.patch_size
        x = img.reshape(n, 16, n, 16, 3).transpose(0, 2, 1, 3, 4) \
            .reshape(-1, cfg.patch_dim).astype(np.float64)
        x -= x.mean(axis=-1, keepdims=True)
        emb = x @ params["proj"].double().numpy()
        cb = params["codebook"].double().numpy()
        plain = ((cb ** 2).sum(-1)[None] - 2 * emb @ cb.T).argmin(-1) \
            + cfg.vocab_offset
        assert on_card.device.type == "cuda"
        assert on_card.tolist() == on_cpu.tolist() == plain.tolist()


# --- the flight recorders on the card (engine/profiler.py, engine/memory.py)

def test_device_memory_stats_map_the_caching_allocator(cuda_device):
    """`device_memory_stats` is the caching allocator's allocated bytes
    (in use, peak) and free + reserved (the limit); a 64 MiB tensor adds
    exactly its bytes to in-use."""
    from dynamo_tpu_torch.engine.memory import device_memory_stats

    torch.cuda.synchronize()
    before = device_memory_stats(cuda_device)
    assert before["bytes_in_use"] == torch.cuda.memory_allocated(cuda_device)
    x = torch.empty(64 << 20, dtype=torch.uint8, device=cuda_device)
    got = device_memory_stats(cuda_device)
    free, total = torch.cuda.mem_get_info(cuda_device)
    assert got["bytes_in_use"] - before["bytes_in_use"] == x.numel()
    assert got["peak_bytes_in_use"] == \
        torch.cuda.max_memory_allocated(cuda_device)
    assert got["reserved_bytes"] == torch.cuda.memory_reserved(cuda_device)
    assert got["total_bytes"] == total
    assert got["bytes_limit"] == free + got["reserved_bytes"] <= total
    assert device_memory_stats(torch.device("cpu")) is None
    del x


def test_real_allocator_oom_is_resource_exhausted(cuda_device):
    """A request past the card's memory raises the caching allocator's
    `OutOfMemoryError`, which `is_resource_exhausted` matches, and the
    stats count it."""
    from dynamo_tpu_torch.engine.memory import (
        device_memory_stats,
        is_resource_exhausted,
    )

    total = torch.cuda.mem_get_info(cuda_device)[1]
    ooms = device_memory_stats(cuda_device)["num_ooms"]
    with pytest.raises(torch.cuda.OutOfMemoryError) as err:
        torch.empty(2 * total, dtype=torch.uint8, device=cuda_device)
    assert is_resource_exhausted(err.value)
    assert device_memory_stats(cuda_device)["num_ooms"] == ooms + 1


@pytest.mark.parametrize("impl", ["phase", "ragged"])
def test_armed_recorders_replay_like_unarmed(cuda_device, monkeypatch, impl):
    """A tiny bf16 engine on the card with `DYN_STEP_PROFILE` and
    `DYN_MEM_LEDGER` armed gives the unarmed engine's greedy streams bit
    for bit, with the same graph captures, replays and kernel launches;
    its ledger books the weights and the K/V caches exactly and the
    first-call workspace by device deltas."""
    from dynamo_tpu_torch.engine import cuda_build
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.models.loader import params_footprint
    from dynamo_tpu_torch.runtime.context import Context

    cfg, model = _graph_model(cuda_device, "bf16")

    async def serve():
        eng = TorchEngine(TorchEngineConfig(
            model=cfg, num_pages=64, max_batch_size=4, prefill_chunk=32,
            min_prefill_bucket=8, prefill_chunk_budget=12,
            attention_impl=impl, device="cuda"), model=model)

        async def one(prompt, n):
            toks = []
            async for o in eng.generate(
                    {"token_ids": prompt, "sampling": {"temperature": 0.0},
                     "stop": {"max_tokens": n}}, Context()):
                toks.extend(o.get("token_ids", ()))
            return toks

        before = cuda_build.launch_counts()
        try:
            out = await asyncio.gather(
                one(list(range(1, 30)), 10), one(list(range(40, 45)), 12),
                one(list(range(7, 60)), 6))
        finally:
            await eng.close()
        torch.cuda.synchronize()
        return eng, out, cuda_build.launch_delta(
            before, cuda_build.launch_counts())

    monkeypatch.delenv("DYN_STEP_PROFILE", raising=False)
    monkeypatch.delenv("DYN_MEM_LEDGER", raising=False)
    plain, want, want_launches = asyncio.run(serve())
    monkeypatch.setenv("DYN_STEP_PROFILE", "1")
    monkeypatch.setenv("DYN_MEM_LEDGER", "1")
    eng, got, launches = asyncio.run(serve())
    assert plain.step_recorder is None and plain.memory_ledger is None
    assert got == want
    assert (eng.graphs.captures, eng.graphs.replays) == \
        (plain.graphs.captures, plain.graphs.replays)
    assert launches == want_launches
    snap = eng.memory_ledger.poll()
    assert snap["classes"]["weights"] == params_footprint(model) == sum(
        p.numel() * p.element_size() for p in model.parameters())
    assert snap["classes"]["kv_pool"] == sum(
        t.numel() * t.element_size() for t in (*eng.k_cache, *eng.v_cache))
    shapes = eng.memory_ledger.summary()["workspace"]["shapes"]
    assert shapes and {s["source"] for s in shapes} == {"device-delta"}
    assert snap["device"]["bytes_in_use"] > 0
    recs = eng.step_recorder.snapshot()
    graphed = [r for r in recs if r["entry"] != "burst_sync"]
    assert sum(r["compiled"] for r in graphed) == eng.graphs.captures


# --- request tracing on the card (runtime/tracing.py) ------------------------

@pytest.mark.parametrize("impl", ["phase", "ragged"])
def test_armed_tracing_replays_like_unarmed(cuda_device, tmp_path, impl):
    """A tiny bf16 engine on the card under an enabled tracer gives the
    untraced engine's greedy streams bit for bit, with the same graph
    captures, replays and kernel launches; each request is one trace of
    engine.request with its queue wait, chunk, prefill and decode stages,
    and every span handed to the drain has host-only attributes."""
    from dynamo_tpu_torch.engine import cuda_build
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.runtime import tracing
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.recorder import Recorder

    cfg, model = _graph_model(cuda_device, "bf16")
    path = tmp_path / "trace.jsonl"
    handed: list = []

    async def serve(tr):
        tracing.set_tracer(tr)
        eng = TorchEngine(TorchEngineConfig(
            model=cfg, num_pages=64, max_batch_size=4, prefill_chunk=32,
            min_prefill_bucket=8, prefill_chunk_budget=12,
            attention_impl=impl, device="cuda"), model=model)

        async def one(prompt, n):
            toks = []
            async for o in eng.generate(
                    {"token_ids": prompt, "sampling": {"temperature": 0.0},
                     "stop": {"max_tokens": n}}, Context()):
                toks.extend(o.get("token_ids", ()))
            return toks

        before = cuda_build.launch_counts()
        try:
            out = await asyncio.gather(
                one(list(range(1, 30)), 10), one(list(range(40, 45)), 12),
                one(list(range(7, 60)), 6))
        finally:
            await eng.close()
            tracing.set_tracer(None)
        torch.cuda.synchronize()
        await tr.close()
        return eng, out, cuda_build.launch_delta(
            before, cuda_build.launch_counts())

    plain, want, want_launches = asyncio.run(
        serve(tracing.Tracer(enabled=False)))
    tr = tracing.Tracer(enabled=True, path=str(path))
    emit = tr._emit

    def spy(span):
        handed.append({k: type(v) for k, v in span.attributes.items()})
        emit(span)

    tr._emit = spy
    eng, got, launches = asyncio.run(serve(tr))
    assert got == want
    assert (eng.graphs.captures, eng.graphs.replays) == \
        (plain.graphs.captures, plain.graphs.replays)
    assert launches == want_launches
    assert handed and all(t in (int, str, bool, float)
                          for attrs in handed for t in attrs.values())
    rows = [e for _, e in Recorder.iter_events(path)]
    assert len(rows) == len(handed) == tr.exported and tr.dropped == 0
    roots = [r for r in rows if r["name"] == "engine.request"]
    assert len(roots) == 3
    for root in roots:
        names = {r["name"] for r in rows if r["traceId"] == root["traceId"]}
        assert {"engine.queue_wait", "engine.prefill.chunk",
                "engine.prefill", "engine.decode"} <= names
        assert root["status"]["code"] == "OK"
    # the first dispatches captured graphs: their compile events ride the
    # roots of the lanes they carried
    assert any(e["name"] == "compile" for r in roots for e in r["events"])


# --- the native radix index and the mocker on the card's machine -------------

def test_native_radix_builds_on_card_machine(cuda_device):
    """The router's C++ radix tree builds with the machine's g++ under
    `_build/dynamo_tpu_torch/` and serves the indexer by default, with
    the Python tree's answers."""
    from dynamo_tpu_torch import native
    from dynamo_tpu_torch.native import radix
    from dynamo_tpu_torch.protocols import KvCacheEvent, StoredBlock
    from dynamo_tpu_torch.router.indexer import KvIndexer, RadixTree

    assert radix.native_radix_available()
    assert native.library_path("radix").exists()
    idx = KvIndexer(16)
    assert idx.tree.kind == "native"
    ev = KvCacheEvent(kind="stored", worker_id=1,
                      blocks=[StoredBlock(11, 1), StoredBlock(12, 2)])
    py = RadixTree()
    for t in (idx.tree, py):
        t.apply_event(ev)
    assert idx.tree.find_matches([1, 2]).scores == \
        py.find_matches([1, 2]).scores == {(1, 0): 2}


def test_mock_worker_holds_no_cuda_context(cuda_device, tmp_path):
    """A `--mock` worker process beside a coordinator registers and never
    takes device memory (a CUDA context costs hundreds of MiB), while a
    process that touches the card does: the card's used memory, from
    nvidia-smi, is the witness (in a container the compute-process list
    may show pids of another namespace)."""
    import os
    import subprocess
    import sys
    import time

    from dynamo_tpu_torch.runtime.distributed import free_port

    def used_mib() -> int:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return int(out[torch.cuda.current_device()])

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    port = free_port()
    procs = []
    try:
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.coordinator", "--port",
             str(port)], env=env, stdout=subprocess.PIPE, text=True))
        assert procs[0].stdout.readline().startswith("COORDINATOR_READY")
        time.sleep(0.5)
        before = used_mib()
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.worker", "--mock",
             "--store", f"tcp://127.0.0.1:{port}"], env=env,
            stdout=subprocess.PIPE, text=True))
        assert procs[1].stdout.readline().startswith("WORKER_READY")
        time.sleep(1.0)
        with_mock = used_mib()
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             "import time, torch; torch.zeros(1, device='cuda'); "
             "print('up', flush=True); time.sleep(60)"],
            env=env, stdout=subprocess.PIPE, text=True))
        assert procs[2].stdout.readline().strip() == "up"
        with_context = used_mib()
        assert with_mock <= before, (before, with_mock)
        assert with_context - with_mock >= 100, (with_mock, with_context)
    finally:
        for p in reversed(procs):
            p.terminate()
            p.wait(30)


# --- flight control: a bucket rung adopted mid-serving ---------------------

RUNG_PROMPTS = (33, 35, 37, 39)      # the 48 bucket at page 8, lo 8
RUNG_T = 40                          # a rung below it, page-aligned


def test_rung_round_replays_bit_identical_to_eager(cuda_device):
    """A "prefill" round at the rung's T (off the static ladder) replayed
    from its graph equals the eager round, outputs and caches."""
    from dynamo_tpu_torch.models.llama import prefill_batch

    cfg, model = _graph_model(cuda_device, "bf16")
    step = (lambda kc, vc, *a: prefill_batch(model, kc, vc, *a,
                                             aligned=True))
    with torch.inference_mode():
        _graph_vs_eager(cuda_device, cfg, step,
                        [_prefill_inputs(cfg, 4, RUNG_T, True),
                         _prefill_inputs(cfg, 4, RUNG_T, True, shift=5)])


def test_rung_adopted_mid_serving_captures_after_eager(cuda_device):
    """A 2-layer fp32 phase engine on the card: while a long request
    decodes, a rung of RUNG_T is proposed to its ladder; the scheduler
    adopts it at its safe point, the next prompts' prefill rounds run at
    T = RUNG_T (each new key's step called eagerly, then under capture),
    a second pass replays them, and both passes' streams equal an
    engine's without the rung."""
    from dynamo_tpu_torch.engine.bucketing import BucketLadder
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.models.llama import LlamaConfig, init_params
    from dynamo_tpu_torch.runtime.context import Context

    mcfg = LlamaConfig.tiny(dtype=torch.float32, head_dim=32, page_size=8,
                            max_pages_per_seq=16)
    cpu_model = init_params(mcfg, 0, torch.device("cpu"))
    # two passes of the same lengths and no shared prefix: the second
    # meets the first's shapes, not its cached pages (a release deferred
    # behind the long request's in-flight burst would outlive a clear)
    passes = [[list(range(3 + i + shift, 3 + i + shift + n))
               for i, n in enumerate(RUNG_PROMPTS)] for shift in (0, 100)]

    async def serve(rung: bool):
        eng = TorchEngine(TorchEngineConfig(
            model=mcfg, num_pages=96, max_batch_size=8, prefill_chunk=64,
            min_prefill_bucket=8, device="cuda"),
            model=copy.deepcopy(cpu_model).to(cuda_device))
        capture = eng.graphs._capture
        calls = {}

        def spy(fn, inputs):
            seen = calls.setdefault(len(calls), [])

            def logged(*a):
                seen.append(torch.cuda.is_current_stream_capturing())
                return fn(*a)
            return capture(logged, inputs)

        eng.graphs._capture = spy

        async def one(prompt, n):
            toks = []
            async for o in eng.generate(
                    {"token_ids": prompt, "sampling": {"temperature": 0.0},
                     "stop": {"max_tokens": n}}, Context()):
                toks.extend(o.get("token_ids", ()))
            return toks

        try:
            long = asyncio.ensure_future(one(list(range(1, 12)), 48))
            while not any(s.prefilled for s in eng._running):
                await asyncio.sleep(0.001)
            if rung:
                eng.bucket_ladder = BucketLadder()
                assert eng.bucket_ladder.propose([RUNG_T])
            first = await asyncio.gather(*(one(p, 6) for p in passes[0]))
            keys = set(eng.graphs.graphs)
            replays = eng.graphs.replays
            second = await asyncio.gather(*(one(p, 6) for p in passes[1]))
            # the second pass's prefill rounds replay the first's graphs
            # (its decode bursts may meet new lane counts)
            assert {k for k in eng.graphs.graphs if k[0] == "prefill"} \
                == {k for k in keys if k[0] == "prefill"}
            assert eng.graphs.replays > replays
            await long
            return first, second, keys, calls, eng.bucket_ladder
        finally:
            await eng.close()

    want, want2, plain_keys, _, _ = asyncio.run(serve(False))
    got, got2, keys, calls, ladder = asyncio.run(serve(True))
    assert (got, got2) == (want, want2)
    assert ladder.state()["rungs"] == [RUNG_T] and ladder.applied == 1
    rung_keys = [k for k in keys if k[0] == "prefill" and k[1][1] == RUNG_T]
    assert rung_keys and not any(
        k[0] == "prefill" and k[1][1] == RUNG_T for k in plain_keys)
    # every capture ran its step eagerly first, then under capture
    assert calls and all(seq == [False, True] for seq in calls.values())

