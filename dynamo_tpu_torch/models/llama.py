"""Llama-family model over a paged KV cache, in PyTorch.

Port of `dynamo_tpu/models/llama.py`: `LlamaConfig` (`:41`), random init
(`:91`), `init_cache` (`:143`), fp32 `rms_norm` (`:161`), split-halves
`rope` (`:167`), `_write_kv` (`:179`), `_swiglu` (`:206`), `qkv_proj`
with the Qwen2 bias (`:236`); the phase path — `prefill_step` (`:252`),
`paged_forward` (`:270`), `prefill_batch` (`:345`), `_decode_once`
(`:375`), `decode_step` (`:413`), the fused k-step burst
`decode_multi_step` (`:428`), its constrained variant
`decode_multi_step_guided` (`:742`: grammar masks, min_p and the sampling
penalties on the device), `_mixed_forward` (`:487`) and
`mixed_prefill_decode` (`:586`); and the flat-token ragged step
`ragged_prefill_decode` (`:656`); and the cache-free embedding forward,
`dense_attention` (`:826`) and `embed_batch` (`:853`), which the
reference computes in XLA outside any kernel, and so the port in plain
PyTorch ops. Every forward reaches its FFN through one dispatch, `_mlp`
(`:211`): SwiGLU for dense configs, `models/mixtral.py` `moe_mlp` for an
MoE config (`num_experts`), whose layers are `mixtral.MoeLayer`s.

Prompt ids at or above the vocabulary (image tokens at the encode
worker's default offset) read the embedding as the reference's jitted
gather does: a negative id counts from the end, then the index clamps
into the table (`embed_rows`). A CUDA gather with such an index would
raise a device-side assert instead.

Kernels per layer: the phase path writes K/V with K3
`paged_kv_write_pages` (page-aligned prefill chunks) or K2
`paged_kv_write` (decode rows, unaligned chunks) and reads them with K4
`paged_attention_decode` (decode) or `prefill_attention` (chunks: K1 on
the card, the plain version on the CPU); the ragged step writes with K2
and reads with K1. No phase-path step reads the card on the host, so the
engine captures each in a CUDA graph. Every write runs on
torch's current stream before the same layer's attention reads the cache.

Layout kept from the reference, so the two packages compute with the same
weights (models/convert.py carries them across):
- weights are applied as `x @ w` (`wq: (E, H·D)`, `lm_head: (E, V)`),
  under the reference's names, through `engine/quant.py` `qm` as the
  reference's every projection: a bf16 Parameter takes exactly `x @ w`; a
  `QTensor` (quantized serving) takes the W8A16 product or, inside the
  kernel gate, K5 (w8a8) / K6 (int4). The JAX `(L, ...)` stacks are split
  into one `LlamaLayer` per layer in an `nn.ModuleList`;
- dense weights in `cfg.dtype` (bf16 by default), norm gains in fp32;
  norm, softmax and logits computed in fp32;
- the KV cache is one (KVH, num_pages, page_size, D) tensor per layer for
  K and for V, updated in place; page 0 is scratch (padding rows write
  their K/V there; engine/pages.py never allocates it).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from dynamo_tpu_torch.engine import attention, kernels, sampling
from dynamo_tpu_torch.engine.quant import qm, qm_group, quantize_params


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # Qwen2-family attention: q/k/v projections carry additive biases
    attention_bias: bool = False
    # paged KV cache geometry
    page_size: int = 16
    max_pages_per_seq: int = 512          # context = page_size * this

    @property
    def context_length(self) -> int:
        return self.page_size * self.max_pages_per_seq

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Test-sized config (the reference's `LlamaConfig.tiny`)."""
        defaults = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                        num_layers=2, num_heads=4, num_kv_heads=2,
                        head_dim=16, page_size=4, max_pages_per_seq=16)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        defaults = dict(vocab_size=128256, hidden_size=4096,
                        intermediate_size=14336, num_layers=32, num_heads=32,
                        num_kv_heads=8, head_dim=128, rope_theta=500000.0)
        defaults.update(kw)
        return cls(**defaults)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class LlamaLayer(nn.Module):
    """One decoder layer's weights (the reference's `_layer_params`)."""

    def __init__(self, cfg: LlamaConfig, device: torch.device) -> None:
        super().__init__()
        E, Fd = cfg.hidden_size, cfg.intermediate_size
        HD, KD = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
        dt = cfg.dtype
        self.attn_norm = _param((E,), torch.float32, device)
        self.wq = _param((E, HD), dt, device)
        self.wk = _param((E, KD), dt, device)
        self.wv = _param((E, KD), dt, device)
        self.wo = _param((HD, E), dt, device)
        self.mlp_norm = _param((E,), torch.float32, device)
        self._init_mlp(cfg, device)
        if cfg.attention_bias:
            self.bq = _param((HD,), dt, device)
            self.bk = _param((KD,), dt, device)
            self.bv = _param((KD,), dt, device)

    def _init_mlp(self, cfg: LlamaConfig, device: torch.device) -> None:
        E, Fd, dt = cfg.hidden_size, cfg.intermediate_size, cfg.dtype
        self.w_gate = _param((E, Fd), dt, device)
        self.w_up = _param((E, Fd), dt, device)
        self.w_down = _param((Fd, E), dt, device)


def _layer_cls(cfg: LlamaConfig) -> type:
    """`LlamaLayer`, or `mixtral.MoeLayer` for an MoE config."""
    if getattr(cfg, "num_experts", 0):
        from dynamo_tpu_torch.models.mixtral import MoeLayer

        return MoeLayer
    return LlamaLayer


class LlamaModel(nn.Module):
    """All weights of one model, on one device. Parameters are allocated
    uninitialised; fill them with `init_params`, `models/convert.py` or
    `models/loader.py`."""

    def __init__(self, cfg: LlamaConfig, device: torch.device) -> None:
        super().__init__()
        self.cfg = cfg
        E, V = cfg.hidden_size, cfg.vocab_size
        self.embed = _param((V, E), cfg.dtype, device)
        layer = _layer_cls(cfg)
        self.layers = nn.ModuleList(
            layer(cfg, device) for _ in range(cfg.num_layers))
        self.final_norm = _param((E,), torch.float32, device)
        self.lm_head = _param((E, V), cfg.dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device


@torch.inference_mode()
def init_params(cfg: LlamaConfig, seed: int, device: torch.device,
                quantize: "str | None" = None) -> LlamaModel:
    """Random-init weights from a seeded `torch.Generator` on `device`:
    dense weights N(0, 1/fan_in) in cfg.dtype, norm gains 1, Qwen2 biases
    nonzero (so a dropped bias cannot pass a test). The draws differ from
    the reference's `jax.random` ones; tests carry JAX weights across with
    models/convert.py instead. An MoE config draws its expert-stacked
    layout (`mixtral.init_moe_params`), as the reference's `init_params`
    dispatches. `quantize` ("int8" | "w8a8" | "int4") returns the model
    `engine/quant.py` `quantize_params` makes of these weights; an MoE
    model quantizes each expert as it is drawn, so no bf16 expert stack
    is ever whole on the device (Mixtral-8x7B's are 90 GB)."""
    if getattr(cfg, "num_experts", 0):
        from dynamo_tpu_torch.models.mixtral import init_moe_params

        return init_moe_params(cfg, seed, device, quantize=quantize)
    model = LlamaModel(cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def dense(p: torch.Tensor, fan_in: int) -> None:
        noise = torch.randn(p.shape, generator=gen, device=device,
                            dtype=torch.float32)
        p.copy_(noise.mul_(1.0 / math.sqrt(fan_in)))

    E, HD = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    dense(model.embed, E)
    for layer in model.layers:
        layer.attn_norm.fill_(1.0)
        layer.mlp_norm.fill_(1.0)
        for name, fan_in in (("wq", E), ("wk", E), ("wv", E), ("wo", HD),
                             ("w_gate", E), ("w_up", E),
                             ("w_down", cfg.intermediate_size)):
            dense(getattr(layer, name), fan_in)
        if cfg.attention_bias:
            for name in ("bq", "bk", "bv"):
                dense(getattr(layer, name), E)
    model.final_norm.fill_(1.0)
    dense(model.lm_head, E)
    if quantize:
        model = quantize_params(model, mode=quantize, inplace=True)
    return model


def init_cache(cfg: LlamaConfig, num_pages: int, device: torch.device
               ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """(k_cache, v_cache): each a list of L per-layer zero tensors of
    shape (KVH, num_pages, page_size, D), updated in place by every
    step. Page 0 is scratch."""
    shape = (cfg.num_kv_heads, num_pages, cfg.page_size, cfg.head_dim)

    def one() -> torch.Tensor:
        return torch.zeros(shape, dtype=cfg.dtype, device=device)

    return ([one() for _ in range(cfg.num_layers)],
            [one() for _ in range(cfg.num_layers)])


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale * w).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of shape (..., T, 1, D/2) in fp32 for `apply_rope`;
    computed once per step and shared by every layer."""
    d_half = head_dim // 2
    exps = torch.arange(d_half, dtype=torch.float32,
                        device=positions.device) / d_half
    # torch.full, not torch.tensor: no host-to-device copy, which would
    # synchronise the stream once per step
    freqs = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                       device=positions.device), exps)
    angles = positions[..., :, None].float() * freqs
    return torch.cos(angles)[..., :, None, :], torch.sin(angles)[..., :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, split-halves. x: (..., T, H, D), positions:
    (..., T)."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def _kv_targets(page_ids: torch.Tensor, offsets: torch.Tensor,
                valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's targets for a step's rows, computed once and handed to every
    layer: (page_ids, offsets) (T,) int32 with invalid (padding) rows
    redirected to scratch page 0, offset 0, which no sequence owns, so
    their racing writes touch nothing that is read unmasked. One multiply
    each (a `where` with a scalar costs a second launch on the card)."""
    return ((page_ids * valid).to(torch.int32),
            (offsets * valid).to(torch.int32))


def _write_kv(k_cache: torch.Tensor, v_cache: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, page_ids: torch.Tensor, offsets: torch.Tensor,
              valid: torch.Tensor) -> None:
    """Scatter new K/V rows into one layer's paged caches, in place: the
    reference's `_write_kv`, as `_kv_targets` (once per step) then K2 (in
    every layer). caches: (KVH, N, P, D); k/v: (T, KVH, D), any strides
    on T and KVH; page_ids/offsets/valid: (T,). CUDA: the paged_kv_write
    kernel; CPU: its plain version (engine/kernels.py)."""
    kernels.paged_kv_write(k_cache, v_cache, k, v,
                           *_kv_targets(page_ids, offsets, valid))


def _swiglu(h: torch.Tensor, layer: LlamaLayer) -> torch.Tensor:
    """gate and up read the same h: one A8 call for both under w8a8 and
    int4 (`qm_group`), the same function as two."""
    gate, up = qm_group(h, [layer.w_gate, layer.w_up])
    return qm(F.silu(gate) * up, layer.w_down)


def _mlp(h: torch.Tensor, layer: LlamaLayer, cfg: LlamaConfig
         ) -> torch.Tensor:
    """THE per-layer FFN dispatch (the reference's `_mlp`): SwiGLU for
    dense configs, the top-k routed experts (`mixtral.moe_mlp`) for MoE
    configs. Every forward flavour calls it, so an MoE model serves
    through the same engine, scheduler, spec and guided machinery."""
    if getattr(cfg, "num_experts", 0):
        from dynamo_tpu_torch.models import mixtral

        return mixtral.moe_mlp(h, layer, cfg)
    return _swiglu(h, layer)


def embed_rows(model: LlamaModel, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of `tokens`, indexed as the reference's jitted
    gather indexes: a negative id counts from the end of the table, then
    every index clamps into [0, V - 1]."""
    V = model.embed.shape[0]
    t = tokens.long()
    t = torch.where(t < 0, t + V, t).clamp_(0, V - 1)
    return model.embed[t]


def qkv_proj(hn: torch.Tensor, layer: LlamaLayer, cfg: LlamaConfig
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q/k/v projections with the optional Qwen2-family additive bias (one
    A8 call for all three under w8a8 and int4, `qm_group`)."""
    q, k, v = qm_group(hn, [layer.wq, layer.wk, layer.wv])
    if cfg.attention_bias:
        q = q + layer.bq
        k = k + layer.bk
        v = v + layer.bv
    return q, k, v


# ---------------------------------------------------------------------------
# The phase path: batched prefill, fused decode bursts, mixed steps
# ---------------------------------------------------------------------------


def _page_ids(page_tables: torch.Tensor, positions: torch.Tensor,
              page_size: int) -> torch.Tensor:
    """page_tables[b, positions[b, t] // P] (int32, like positions).
    Positions past the table (padding past a full context) clamp to its
    last entry; the caller masks or redirects them."""
    idx = torch.clamp(positions.long() // page_size,
                      max=page_tables.shape[1] - 1)
    return torch.gather(page_tables, 1, idx)


def _chunk_kv_writer(cfg: LlamaConfig, page_tables: torch.Tensor,
                     positions: torch.Tensor, seq_lens: torch.Tensor,
                     aligned: bool):
    """write(kc, vc, k, v) for one layer's (Bp, T, KVH, D) chunk K/V, its
    targets computed here, once per step; each layer's write is one
    launch on views of k and v, no copy.

    aligned and T % P == 0 (the caller guarantees every cached_len is a
    multiple of P): whole pages through K3 — one slot per (sequence, page
    of the chunk), its block the (P, KVH, D) rows of the page viewed as
    (KVH, P, D); a slot whose first row lies past seq_len goes to scratch
    page 0, and a partly filled last page also takes the padding rows in
    its tail (masked by length, overwritten by decode later). Otherwise
    one row per token through K2, padding rows to page 0."""
    Bp, T = positions.shape
    P, KVH, D = cfg.page_size, cfg.num_kv_heads, cfg.head_dim
    valid = positions < seq_lens[:, None]
    page_ids = _page_ids(page_tables, positions, P)
    if aligned and T % P == 0:
        M = Bp * (T // P)
        slot_pages = (page_ids[:, ::P] * valid[:, ::P]).reshape(M) \
            .to(torch.int32)

        def blocks(a: torch.Tensor) -> torch.Tensor:   # → (M, KVH, P, D)
            return a.view(M, P, KVH, D).permute(0, 2, 1, 3)

        def write(kc, vc, k, v) -> None:
            kernels.paged_kv_write_pages(kc, vc, blocks(k), blocks(v),
                                         slot_pages)
        return write

    f_pages, f_offs = _kv_targets(page_ids.reshape(-1),
                                  (positions % P).reshape(-1),
                                  valid.reshape(-1))

    def write(kc, vc, k, v) -> None:
        kernels.paged_kv_write(kc, vc, k.view(Bp * T, KVH, D),
                               v.view(Bp * T, KVH, D), f_pages, f_offs)
    return write


def _chunk_attention_args(cfg: LlamaConfig, page_tables: torch.Tensor,
                          positions: torch.Tensor, seq_lens: torch.Tensor):
    """What every layer's chunk attention shares, computed once per step:
    (kv_pages, row_tags). CPU: the pages the longest chunk can see, read
    on the host for the plain version. CUDA: K1's row tags
    (`attention.chunk_rows`) and no host read, so nothing in the step
    waits for the card and the step can be captured in a CUDA graph."""
    if positions.device.type == "cpu":
        return attention.visible_pages(seq_lens, cfg.page_size,
                                       page_tables.shape[1]), None
    return None, attention.chunk_rows(positions, seq_lens)


def paged_forward(model: LlamaModel, k_cache: list, v_cache: list,
                  tokens: torch.Tensor, page_tables: torch.Tensor,
                  cached_lens: torch.Tensor, seq_lens: torch.Tensor,
                  aligned: bool = False) -> torch.Tensor:
    """Paged multi-token forward of a batch of prefill chunks: writes the
    chunks' K/V into the caches (in place), attends causally against
    cache + chunk, returns the FINAL-NORMED hidden states (Bp, T, E).

    tokens: (Bp, T) int32 chunks, padded; page_tables: (Bp, max_pages)
    int32; cached_lens/seq_lens: (Bp,) int32 — positions cached_len ..
    cached_len+T-1, valid below seq_len."""
    cfg = model.cfg
    Bp, T = tokens.shape
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = embed_rows(model, tokens)                          # (Bp, T, E)
    positions = cached_lens[:, None] + torch.arange(
        T, dtype=cached_lens.dtype, device=tokens.device)[None, :]
    write = _chunk_kv_writer(cfg, page_tables, positions, seq_lens, aligned)
    kv_pages, row_tags = _chunk_attention_args(cfg, page_tables, positions,
                                               seq_lens)
    cos, sin = rope_tables(positions, D, cfg.rope_theta)
    for l, layer in enumerate(model.layers):
        hn = rms_norm(x, layer.attn_norm, cfg.rms_eps)
        q, k, v = qkv_proj(hn, layer, cfg)
        q = apply_rope(q.reshape(Bp, T, H, D), cos, sin)
        k = apply_rope(k.reshape(Bp, T, KVH, D), cos, sin)
        write(k_cache[l], v_cache[l], k, v.view(Bp, T, KVH, D))
        attn = attention.prefill_attention(q, k_cache[l], v_cache[l],
                                           page_tables, positions, seq_lens,
                                           kv_pages, row_tags)
        x = x + qm(attn.reshape(Bp, T, H * D), layer.wo)
        hn = rms_norm(x, layer.mlp_norm, cfg.rms_eps)
        x = x + _mlp(hn, layer, cfg)
    return rms_norm(x, model.final_norm, cfg.rms_eps)


def _last_logits(model: LlamaModel, x: torch.Tensor,
                 cached_lens: torch.Tensor,
                 seq_lens: torch.Tensor) -> torch.Tensor:
    """(Bp, V) fp32 logits of each chunk's last valid token."""
    last = torch.clamp(seq_lens - cached_lens - 1, min=0).long()
    x_last = x[torch.arange(x.shape[0], device=x.device), last]
    return qm(x_last, model.lm_head).float()


def prefill_batch(model: LlamaModel, k_cache: list, v_cache: list,
                  tokens: torch.Tensor, page_tables: torch.Tensor,
                  cached_lens: torch.Tensor, seq_lens: torch.Tensor,
                  aligned: bool = False) -> torch.Tensor:
    """Prefill a BATCH of sequences' chunks in one pass (one weight
    stream for all Bp). Arguments as `paged_forward`; `aligned`: every
    cached_len and T are multiples of page_size, so whole pages go
    through K3. Padding lanes (seq_len == cached_len) write only scratch
    page 0 and give logits the engine ignores. Returns last-token logits
    (Bp, V) fp32; the caches are updated in place."""
    x = paged_forward(model, k_cache, v_cache, tokens, page_tables,
                      cached_lens, seq_lens, aligned)
    return _last_logits(model, x, cached_lens, seq_lens)


def prefill_step(model: LlamaModel, k_cache: list, v_cache: list,
                 tokens: torch.Tensor, page_table: torch.Tensor,
                 cached_len: int, seq_len: int) -> torch.Tensor:
    """Prefill one sequence: the Bp = 1 case of `prefill_batch`. tokens:
    (T,) the uncached suffix, padded; page_table: (max_pages,). Returns
    the last token's logits (V,)."""
    dev = tokens.device
    return prefill_batch(
        model, k_cache, v_cache, tokens[None], page_table[None],
        torch.full((1,), int(cached_len), dtype=torch.int32, device=dev),
        torch.full((1,), int(seq_len), dtype=torch.int32, device=dev))[0]


def _decode_once(model: LlamaModel, k_cache: list, v_cache: list,
                 tokens: torch.Tensor, positions: torch.Tensor,
                 page_tables: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """One decode iteration: tokens/positions (B,) int32, valid (B,) bool,
    page_tables (B, max_pages) int32. Each layer writes the lane's K/V
    row (K2) before K4 reads the cache. Returns logits (B, V) fp32."""
    cfg = model.cfg
    B = tokens.shape[0]
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = embed_rows(model, tokens)                          # (B, E)
    pages, offsets = _kv_targets(
        _page_ids(page_tables, positions[:, None], cfg.page_size)[:, 0],
        positions % cfg.page_size, valid)
    lengths = torch.where(valid, positions + 1,
                          torch.zeros_like(positions)).to(torch.int32)
    cos, sin = rope_tables(positions, D, cfg.rope_theta)   # (B, 1, D/2)
    for l, layer in enumerate(model.layers):
        hn = rms_norm(x, layer.attn_norm, cfg.rms_eps)
        q, k, v = qkv_proj(hn, layer, cfg)
        q = apply_rope(q.reshape(B, H, D), cos, sin)
        k = apply_rope(k.reshape(B, KVH, D), cos, sin)
        kernels.paged_kv_write(k_cache[l], v_cache[l], k,
                               v.view(B, KVH, D), pages, offsets)
        attn = attention.paged_attention_decode(
            q.contiguous(), k_cache[l], v_cache[l], lengths, page_tables)
        x = x + qm(attn.reshape(B, H * D), layer.wo)
        hn = rms_norm(x, layer.mlp_norm, cfg.rms_eps)
        x = x + _mlp(hn, layer, cfg)
    x = rms_norm(x, model.final_norm, cfg.rms_eps)
    return qm(x, model.lm_head).float()


def decode_step(model: LlamaModel, k_cache: list, v_cache: list,
                tokens: torch.Tensor, positions: torch.Tensor,
                page_tables: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """One decode iteration for a (padded) batch: logits (B, V) fp32."""
    return _decode_once(model, k_cache, v_cache, tokens, positions,
                        page_tables, valid)


def _burst(model: LlamaModel, k_cache: list, v_cache: list,
           logits0: torch.Tensor, positions: torch.Tensor,
           page_tables: torch.Tensor, valid: torch.Tensor,
           seeds: torch.Tensor, steps0: torch.Tensor,
           temperature: torch.Tensor, top_p: torch.Tensor,
           top_k: torch.Tensor, num_steps: int,
           topk_lp: int) -> torch.Tensor:
    """Sample step 0 from `logits0`, then run steps 1..num_steps-1 of
    decode, each fed the previous step's sampled tokens on the device.
    Returns packed (2 + 2*topk_lp, num_steps, B) f32."""
    out = torch.empty((2 + 2 * topk_lp, num_steps, logits0.shape[0]),
                      dtype=torch.float32, device=logits0.device)
    logits = logits0
    for i in range(num_steps):
        if i:
            logits = _decode_once(model, k_cache, v_cache, toks,
                                  positions + i, page_tables, valid)
        out[:, i] = sampling.sample_tokens_lp(
            logits, seeds, steps0 + i, temperature, top_p, top_k,
            topk_lp=topk_lp)
        toks = out[0, i].to(torch.int32)    # ids are exact in f32
    return out


def decode_multi_step(model: LlamaModel, k_cache: list, v_cache: list,
                      tokens: torch.Tensor, positions: torch.Tensor,
                      page_tables: torch.Tensor, valid: torch.Tensor,
                      seeds: torch.Tensor, steps0: torch.Tensor,
                      temperature: torch.Tensor, top_p: torch.Tensor,
                      top_k: torch.Tensor, num_steps: int,
                      topk_lp: int = 0) -> torch.Tensor:
    """`num_steps` fused decode+sample iterations with ONE host sync for
    the caller: sampling runs on the device and each step's tokens feed
    the next step there. Pages for positions .. positions+num_steps-1 must
    already be in `page_tables`. Returns packed (2 + 2*topk_lp, num_steps,
    B) f32: sampled ids, chosen-token logprobs, then top-k ids / logprobs
    — the reference's layout. The caches are updated in place."""
    logits0 = _decode_once(model, k_cache, v_cache, tokens, positions,
                           page_tables, valid)
    return _burst(model, k_cache, v_cache, logits0, positions, page_tables,
                  valid, seeds, steps0, temperature, top_p, top_k,
                  num_steps, topk_lp)


def decode_multi_step_guided(model: LlamaModel, k_cache: list,
                             v_cache: list, tokens: torch.Tensor,
                             positions: torch.Tensor,
                             page_tables: torch.Tensor, valid: torch.Tensor,
                             seeds: torch.Tensor, steps0: torch.Tensor,
                             temperature: torch.Tensor, top_p: torch.Tensor,
                             top_k: torch.Tensor, min_p: torch.Tensor,
                             rep_pen: torch.Tensor, freq_pen: torch.Tensor,
                             pres_pen: torch.Tensor,
                             prompt_counts: torch.Tensor,
                             out_counts: torch.Tensor, g_bits: torch.Tensor,
                             g_next: torch.Tensor, g_eos_ok: torch.Tensor,
                             g_ids: torch.Tensor, g_states: torch.Tensor,
                             stop_ids: torch.Tensor, num_steps: int,
                             topk_lp: int = 0) -> torch.Tensor:
    """The constrained decode burst: `decode_multi_step` with the grammar
    mask, min_p and the sampling penalties applied on the device before
    each step samples, so constrained lanes keep one host sync per burst.

    min_p / rep_pen / freq_pen / pres_pen: (B,); prompt_counts /
    out_counts: (B, V) int32 token counts (the output counts advance as
    the burst samples, so repeats within it are penalised too). g_bits
    (G, S, ceil(V/8)) uint8 allowed-token rows, g_next (G, S, V) int16
    transitions, g_eos_ok (G, S) bool (where a lane's stop tokens are
    legal); g_ids / g_states (B,) each lane's grammar and DFA state (a
    free lane sits in the trivial all-allowed grammar); stop_ids (B, K)
    the lanes' stop ids, -1 padded. Each sampled token moves its lane's
    state for the next step. The top-k rows come from the post-mask
    logits. Returns packed (2 + 2*topk_lp, num_steps, B) f32, the layout
    of `decode_multi_step`; the caches are updated in place and no input
    is written (the burst advances copies of the counts and states)."""
    B = tokens.shape[0]
    is_stop = sampling.stop_token_mask(stop_ids, model.cfg.vocab_size)
    states = g_states.long()
    counts = out_counts.clone()
    add = valid.to(counts.dtype)[:, None]
    g_lane = g_ids.long()
    out = torch.empty((2 + 2 * topk_lp, num_steps, B), dtype=torch.float32,
                      device=tokens.device)
    toks = tokens
    for i in range(num_steps):
        logits = _decode_once(model, k_cache, v_cache, toks, positions + i,
                              page_tables, valid)
        logits = sampling.constrained_logits(
            logits, prompt_counts, counts, rep_pen, freq_pen, pres_pen,
            g_bits, g_eos_ok, g_ids, states, is_stop)
        out[:, i] = sampling.sample_tokens_lp(
            logits, seeds, steps0 + i, temperature, top_p, top_k, min_p,
            topk_lp=topk_lp)
        sampled = out[0, i].long()              # ids are exact in f32
        states = g_next[g_lane, states, sampled].long()
        counts.scatter_add_(1, sampled[:, None], add)
        toks = sampled.to(torch.int32)
    return out


def _mixed_forward(model: LlamaModel, k_cache: list, v_cache: list,
                   ch_tokens: torch.Tensor, ch_tables: torch.Tensor,
                   ch_cached: torch.Tensor, ch_seq_lens: torch.Tensor,
                   d_tokens: torch.Tensor, d_positions: torch.Tensor,
                   d_tables: torch.Tensor, d_valid: torch.Tensor,
                   aligned: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer sweep over a prefill chunk sub-batch AND one decode
    step. Each side's ops mirror `paged_forward` / `_decode_once` with
    separate matmuls per sub-batch, so neither side's numerics move. Per
    layer the chunk K/V are written (K3 or K2), then the decode rows (K2),
    then `mixed_attention` reads. Returns (chunk hidden (Bp, T, E),
    decode hidden (B, E)), both final-normed."""
    cfg = model.cfg
    Bp, T = ch_tokens.shape
    B = d_tokens.shape[0]
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xc = embed_rows(model, ch_tokens)                      # (Bp, T, E)
    c_positions = ch_cached[:, None] + torch.arange(
        T, dtype=ch_cached.dtype, device=ch_tokens.device)[None, :]
    write = _chunk_kv_writer(cfg, ch_tables, c_positions, ch_seq_lens,
                             aligned)
    kv_pages, row_tags = _chunk_attention_args(cfg, ch_tables, c_positions,
                                               ch_seq_lens)
    c_cos, c_sin = rope_tables(c_positions, D, cfg.rope_theta)
    xd = embed_rows(model, d_tokens)                       # (B, E)
    d_pages, d_offsets = _kv_targets(
        _page_ids(d_tables, d_positions[:, None], cfg.page_size)[:, 0],
        d_positions % cfg.page_size, d_valid)
    d_lengths = torch.where(d_valid, d_positions + 1,
                            torch.zeros_like(d_positions)).to(torch.int32)
    d_cos, d_sin = rope_tables(d_positions, D, cfg.rope_theta)
    for l, layer in enumerate(model.layers):
        kc, vc = k_cache[l], v_cache[l]
        hn = rms_norm(xc, layer.attn_norm, cfg.rms_eps)
        q, k, v = qkv_proj(hn, layer, cfg)
        q = apply_rope(q.reshape(Bp, T, H, D), c_cos, c_sin)
        k = apply_rope(k.reshape(Bp, T, KVH, D), c_cos, c_sin)
        hnd = rms_norm(xd, layer.attn_norm, cfg.rms_eps)
        qd, kd, vd = qkv_proj(hnd, layer, cfg)
        qd = apply_rope(qd.reshape(B, H, D), d_cos, d_sin)
        kd = apply_rope(kd.reshape(B, KVH, D), d_cos, d_sin)
        write(kc, vc, k, v.view(Bp, T, KVH, D))
        kernels.paged_kv_write(kc, vc, kd, vd.view(B, KVH, D), d_pages,
                               d_offsets)
        attn_d, attn_c = attention.mixed_attention(
            qd.contiguous(), q, kc, vc, d_lengths, d_tables, ch_tables,
            c_positions, ch_seq_lens, kv_pages, row_tags)
        xc = xc + qm(attn_c.reshape(Bp, T, H * D), layer.wo)
        xc = xc + _mlp(rms_norm(xc, layer.mlp_norm, cfg.rms_eps), layer,
                       cfg)
        xd = xd + qm(attn_d.reshape(B, H * D), layer.wo)
        xd = xd + _mlp(rms_norm(xd, layer.mlp_norm, cfg.rms_eps), layer,
                       cfg)
    return (rms_norm(xc, model.final_norm, cfg.rms_eps),
            rms_norm(xd, model.final_norm, cfg.rms_eps))


def mixed_prefill_decode(model: LlamaModel, k_cache: list, v_cache: list,
                         ch_tokens: torch.Tensor, ch_tables: torch.Tensor,
                         ch_cached: torch.Tensor, ch_seq_lens: torch.Tensor,
                         tokens: torch.Tensor, positions: torch.Tensor,
                         page_tables: torch.Tensor, valid: torch.Tensor,
                         seeds: torch.Tensor, steps0: torch.Tensor,
                         temperature: torch.Tensor, top_p: torch.Tensor,
                         top_k: torch.Tensor, num_steps: int,
                         aligned: bool = False, topk_lp: int = 0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """One MIXED step: a prefill chunk sub-batch rides along with a full
    decode burst, so decode lanes keep emitting between a long prompt's
    chunks. Step 0 of the burst shares the chunk's layer sweep
    (`_mixed_forward`); steps 1..num_steps-1 are plain decode steps.
    Sampling is `decode_multi_step`'s, so a lane's stream is the same
    whether its burst ran mixed or plain. Chunk arguments are
    `prefill_batch`'s, decode arguments `decode_multi_step`'s. Returns
    (packed (2 + 2*topk_lp, num_steps, B) f32, chunk last-token logits
    (Bp, V) f32); the caches are updated in place."""
    xc, xd = _mixed_forward(model, k_cache, v_cache, ch_tokens, ch_tables,
                            ch_cached, ch_seq_lens, tokens, positions,
                            page_tables, valid, aligned)
    ch_logits = _last_logits(model, xc, ch_cached, ch_seq_lens)
    logits0 = qm(xd, model.lm_head).float()
    packed = _burst(model, k_cache, v_cache, logits0, positions,
                    page_tables, valid, seeds, steps0, temperature, top_p,
                    top_k, num_steps, topk_lp)
    return packed, ch_logits


# ---------------------------------------------------------------------------
# Embeddings: a dense forward with no cache
# ---------------------------------------------------------------------------


def dense_attention(x: torch.Tensor, layer: LlamaLayer,
                    positions: torch.Tensor, mask: torch.Tensor,
                    cfg: LlamaConfig) -> torch.Tensor:
    """One layer's attention sub-block over a dense (unpaged) sequence:
    pre-norm, RoPE'd GQA attention under `mask` in fp32, wo projection,
    residual add. x: (B, T, E); positions: (1, T); mask: (T, T) bool."""
    B, T, _ = x.shape
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rms_norm(x, layer.attn_norm, cfg.rms_eps)
    q, k, v = qkv_proj(h, layer, cfg)
    q = rope(q.reshape(B, T, H, D), positions, cfg.rope_theta)
    k = rope(k.reshape(B, T, KVH, D), positions, cfg.rope_theta)
    v = v.reshape(B, T, KVH, D)
    if KVH != H:
        k = k.repeat_interleave(H // KVH, dim=2)
        v = v.repeat_interleave(H // KVH, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(D)
    scores = torch.where(mask[None, None], scores,
                         torch.full_like(scores, -1e30))
    attn = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1),
                        v.float()).to(x.dtype)
    return x + qm(attn.reshape(B, T, H * D), layer.wo)


@torch.inference_mode()
def embed_batch(model: LlamaModel, tokens: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """Mean-pooled sentence embeddings: (B, T) padded prompts and (B,)
    valid lengths → (B, E) L2-normalized fp32 vectors. Causal attention
    over the whole padded row (padding rows come after the valid ones, so
    no valid row sees them), final norm, mean over the valid positions."""
    cfg = model.cfg
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device)[None, :]
    valid = positions < lengths[:, None]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                 device=tokens.device))
    x = embed_rows(model, tokens)
    for layer in model.layers:
        x = dense_attention(x, layer, positions, mask, cfg)
        x = x + _mlp(rms_norm(x, layer.mlp_norm, cfg.rms_eps), layer, cfg)
    h = rms_norm(x, model.final_norm, cfg.rms_eps).float()
    h = torch.where(valid[..., None], h, torch.zeros_like(h))
    pooled = h.sum(dim=1) / torch.clamp(lengths[:, None].float(), min=1.0)
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.clamp(norm, min=1e-12)


# ---------------------------------------------------------------------------
# The ragged step
# ---------------------------------------------------------------------------


def ragged_prefill_decode(model: LlamaModel, k_cache: list, v_cache: list,
                          tokens: torch.Tensor, positions: torch.Tensor,
                          page_ids: torch.Tensor, offsets: torch.Tensor,
                          valid: torch.Tensor, token_lanes: torch.Tensor,
                          lane_tables: torch.Tensor, ch_rows: torch.Tensor,
                          d_rows: torch.Tensor, seeds: torch.Tensor,
                          steps0: torch.Tensor, temperature: torch.Tensor,
                          top_p: torch.Tensor, top_k: torch.Tensor,
                          topk_lp: int = 0
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """THE flat-token ragged step: prefill chunk tokens and decode lanes
    ride one (Tb,) token array through one forward.

    tokens/positions/page_ids/offsets/valid/token_lanes: (Tb,) flat rows
    (int32 ids, bool valid) — each a chunk token or one decode lane's next
    token; padding rows have valid=False (KV to scratch page 0, attention
    fully masked). lane_tables: (L, max_pages) int32, one row per lane.
    ch_rows: (Bp,) flat row of each chunk's LAST token (→ ch_logits);
    d_rows: (B,) flat row of each decode lane (→ sampled). Each layer
    writes a row's K/V BEFORE attention reads the cache (the inclusive
    mask attends the row's own position). The caches are updated in
    place. Returns (packed (2 + 2*topk_lp, 1, B) f32 in the reference's
    decode_multi_step layout, ch_logits (Bp, V) f32)."""
    cfg = model.cfg
    Tb = tokens.shape[0]
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = embed_rows(model, tokens)                          # (Tb, E)
    qpos = torch.where(valid, positions,
                       torch.full_like(positions, -1)).to(torch.int32)
    pages, offs = _kv_targets(page_ids, offsets, valid)
    cos, sin = rope_tables(positions, D, cfg.rope_theta)
    for l, layer in enumerate(model.layers):
        hn = rms_norm(x, layer.attn_norm, cfg.rms_eps)
        q, k, v = qkv_proj(hn, layer, cfg)
        q = apply_rope(q.reshape(Tb, H, D), cos, sin)
        k = apply_rope(k.reshape(Tb, KVH, D), cos, sin)
        kernels.paged_kv_write(k_cache[l], v_cache[l], k,
                               v.view(Tb, KVH, D), pages, offs)
        attn = attention.ragged_attention(
            q.contiguous(), k_cache[l], v_cache[l], qpos, token_lanes,
            lane_tables, page_size=cfg.page_size)          # (Tb, H, D)
        x = x + qm(attn.reshape(Tb, H * D), layer.wo)
        hn = rms_norm(x, layer.mlp_norm, cfg.rms_eps)
        x = x + _mlp(hn, layer, cfg)
    x = rms_norm(x, model.final_norm, cfg.rms_eps)
    ch_logits = qm(x[ch_rows.long()], model.lm_head).float()
    d_logits = qm(x[d_rows.long()], model.lm_head).float()
    packed = sampling.sample_tokens_lp(d_logits, seeds, steps0, temperature,
                                       top_p, top_k, topk_lp=topk_lp)
    return packed[:, None, :], ch_logits
