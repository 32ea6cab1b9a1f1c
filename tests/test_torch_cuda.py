"""The port's hand-written CUDA kernels on the card, against their plain
versions on the same inputs; and the torch engine on the card against the
same engine on the CPU. Every test here is `cuda`-marked and skips where
torch.cuda.is_available() is false.

This file imports neither jax nor dynamo_tpu, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: K2 and K3 are copies, bit-exact outside scratch page 0. K1
and K4 in fp32 at atol/rtol 2e-5 (the
reference's kernel-parity tolerance); in bf16 at rtol 1.6e-2, two bf16
ulps (2^-7 relative), since the kernel rounds P to bf16 before PV and
both sides round the output to bf16 once, with atol 4e-3 (2^-8) for rows
whose output is small beside its V values. With q = 0 every score is 0
and P = 1 is exact in bf16, so the bf16 kernel's output is each row's
fp32 mean of the V rows it can see, rounded once: held to the fp32 plain
version at rtol 4e-3 (half a bf16 ulp), atol 1e-5. K4 in bf16 is held to
K1's bf16 tolerances (it computes in fp32 and rounds once, so it sits well
inside them), and with q = 0 to the same half ulp. K5 and K6 (the A8
GEMMs) compute an exact int32 product between two roundings that both
sides make alike: bit-identical with their plain versions.
"""

import asyncio
import copy

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
    streams identical on the card (K2, K3, K4) and on the CPU."""
    before = {k: kern.launches for k, kern in
              (("k1", ragged._KERNEL), ("k2", kernels._KERNEL),
               ("k3", kernels._PAGES_KERNEL),
               ("k4", attention._DECODE_KERNEL))}
    _serve_tiny_on_card_and_cpu(cuda_device, "phase")
    after = {"k1": ragged._KERNEL.launches, "k2": kernels._KERNEL.launches,
             "k3": kernels._PAGES_KERNEL.launches,
             "k4": attention._DECODE_KERNEL.launches}
    assert after["k1"] == before["k1"]
    for k in ("k2", "k3", "k4"):
        assert after[k] > before[k], k


def _serve_tiny_on_card_and_cpu(cuda_device, impl: str, geometry=None,
                                quantize=None) -> int:
    """Serve three greedy requests on the card and on the CPU through a
    tiny fp32 model (`geometry` overrides, `quantize` mode) on path
    `impl`; assert identical streams; return the K1 launches the card run
    made."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.models.llama import LlamaConfig, init_params
    from dynamo_tpu_torch.runtime.context import Context

    mcfg = LlamaConfig.tiny(dtype=torch.float32, **(
        geometry or dict(head_dim=32, page_size=8)))
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
