"""Mixtral-style MoE transformer: top-k routed experts, in PyTorch.

Port of `dynamo_tpu/models/mixtral.py`: `MoeConfig` (`:43`) with its
`tiny` and `mixtral_8x7b` presets, `init_moe_params` (`:67`), `_qe`
(`:102`) as `_qe_in` / `_qe_out` (one per contraction `moe_mlp` makes),
the serving FFN `moe_mlp` (`:124`), the GShard-style
`moe_mlp_capacity` (`:150`), the per-token loop `moe_mlp_reference`
(`:204`) and the cache-free `moe_forward` (`:232`). The expert-parallel
specs (`ep_param_specs`, `:260`) wait with the multi-device paths.

Dense dispatch, as the reference serves it: every expert computes every
token and the top-k softmax weights zero the rest, so every step keeps
static shapes and no host sync, and the engine's CUDA graphs capture MoE
steps unchanged. The expert products are plain PyTorch matmuls (the
reference leaves them to XLA, outside any Pallas kernel); attention,
norms and the embedding are `models/llama.py`'s.

Layout, as the reference's per layer: `router` (E, X) in cfg.dtype and
the expert stacks `w_gate` / `w_up` (X, E, F) and `w_down` (X, F, E),
applied as `x @ w`; under quantize "int8" each stack is an
`engine/quant.py` `QStack` (q int8 in the same layout, s (X, 1, out)).

Numerics kept from the reference: the router product runs in h's dtype
and is cast to fp32 afterwards; top-k breaks ties by the lowest expert
index, as `jax.lax.top_k` does (`top_k`); `_qe_in` / `_qe_out` convert
the int8 stack to the activation dtype, multiply, then scale by s.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.engine.quant import (
    MOE_QUANT_ERROR,
    QStack,
    qm,
    quantize_params,
    set_weight,
)
from dynamo_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaLayer,
    LlamaModel,
    _param,
    dense_attention,
    embed_rows,
    rms_norm,
)

# the reference loader's names of the expert stacks in a Mixtral
# checkpoint: (port key, HF `experts.{e}.<name>`)
MOE_FFN = (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2"))


@dataclasses.dataclass(frozen=True)
class MoeConfig(LlamaConfig):
    num_experts: int = 8
    experts_per_token: int = 2

    @classmethod
    def tiny(cls, **kw) -> "MoeConfig":
        defaults = dict(vocab_size=256, hidden_size=64, intermediate_size=96,
                        num_layers=2, num_heads=4, num_kv_heads=2,
                        head_dim=16, page_size=4, max_pages_per_seq=16,
                        num_experts=4, experts_per_token=2)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def mixtral_8x7b(cls, **kw) -> "MoeConfig":
        defaults = dict(vocab_size=32000, hidden_size=4096,
                        intermediate_size=14336, num_layers=32,
                        num_heads=32, num_kv_heads=8, head_dim=128,
                        rope_theta=1e6, num_experts=8, experts_per_token=2)
        defaults.update(kw)
        return cls(**defaults)


class MoeLayer(LlamaLayer):
    """One MoE decoder layer's weights: Llama's attention and norms, a
    router (E, X) and the expert stacks in place of the dense FFN."""

    def _init_mlp(self, cfg: MoeConfig, device: torch.device) -> None:
        E, Fd, X, dt = (cfg.hidden_size, cfg.intermediate_size,
                        cfg.num_experts, cfg.dtype)
        self.router = _param((E, X), dt, device)
        self.w_gate = _param((X, E, Fd), dt, device)
        self.w_up = _param((X, E, Fd), dt, device)
        self.w_down = _param((X, Fd, E), dt, device)


@torch.inference_mode()
def init_moe_params(cfg: MoeConfig, seed: int, device: torch.device,
                    quantize: "str | None" = None) -> LlamaModel:
    """`llama.init_params` for an MoE config: dense weights N(0, 1/fan_in)
    in cfg.dtype from a seeded `torch.Generator`, norm gains 1. Each
    expert's (in, out) weight is drawn on its own and, under `quantize`
    ("int8" only, as the reference refuses w8a8 and int4 for experts),
    quantized into its `QStack` slot at once: the model is built on the
    meta device and every tensor is placed as it is drawn, so the device
    holds the result plus one expert's transients. The draws are the
    same with and without `quantize`; the quantized model equals
    `quantize_params` of the unquantized one."""
    if quantize and quantize != "int8":
        raise ValueError(MOE_QUANT_ERROR)
    dev = torch.device(device)
    model = LlamaModel(cfg, torch.device("meta"))
    gen = torch.Generator(device=dev).manual_seed(seed)

    def place(owner: torch.nn.Module, name: str) -> torch.Tensor:
        meta = getattr(owner, name)
        t = torch.empty(meta.shape, dtype=meta.dtype, device=dev)
        set_weight(owner, name, torch.nn.Parameter(t, requires_grad=False))
        return t

    def draw(shape: tuple, fan_in: int) -> torch.Tensor:
        noise = torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32)
        return noise.mul_(1.0 / math.sqrt(fan_in)).to(cfg.dtype)

    def dense(owner: torch.nn.Module, name: str, fan_in: int) -> None:
        t = place(owner, name)
        t.copy_(draw(t.shape, fan_in))

    E, HD = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    dense(model, "embed", E)
    for layer in model.layers:
        place(layer, "attn_norm").fill_(1.0)
        place(layer, "mlp_norm").fill_(1.0)
        for name, fan_in in (("wq", E), ("wk", E), ("wv", E), ("wo", HD),
                             ("router", E)):
            dense(layer, name, fan_in)
        for name, fan_in in (("w_gate", E), ("w_up", E),
                             ("w_down", cfg.intermediate_size)):
            shape = tuple(getattr(layer, name).shape)
            if quantize:
                stack = QStack.empty(shape, dev)
                for x in range(shape[0]):
                    stack.fill(x, draw(shape[1:], fan_in))
                set_weight(layer, name, stack)
            else:
                t = place(layer, name)
                for x in range(shape[0]):
                    t[x].copy_(draw(shape[1:], fan_in))
        if cfg.attention_bias:
            for name in ("bq", "bk", "bv"):
                dense(layer, name, E)
    place(model, "final_norm").fill_(1.0)
    dense(model, "lm_head", E)
    if quantize:
        # the attention projections and the lm_head, as quantize_params
        # does them (the stacks pass through)
        model = quantize_params(model, mode=quantize, inplace=True)
    return model


def top_k(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis: the k largest values in
    descending order, ties broken by the LOWEST index (a stable
    descending sort; `torch.topk` gives no order for ties on CUDA)."""
    v, i = torch.sort(logits, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _qe_in(x: torch.Tensor, w) -> torch.Tensor:
    """The reference's `_qe("...te,xef->...txf", x, w)`: every expert's
    product with the same rows (the gate and up stacks). The stack is
    converted (int8 → x's dtype, or a bf16 stack copied) straight into
    an (E, X, F) buffer, so all experts take ONE product of (..., T, E)
    by (E, X·F); a QStack's scale then multiplies the product."""
    q = w.q if isinstance(w, QStack) else w
    X, E, Fd = q.shape
    w16 = torch.empty((E, X, Fd), dtype=x.dtype, device=x.device)
    w16.copy_(q.permute(1, 0, 2))
    y = (x @ w16.view(E, X * Fd)).view(*x.shape[:-1], X, Fd)
    if isinstance(w, QStack):
        y = y * w.s[:, 0, :].to(x.dtype)
    return y


def _qe_out(y: torch.Tensor, w) -> torch.Tensor:
    """The reference's `_qe("...txf,xfe->...txe", y, w)`: each expert's
    own rows through its own weight, one batched product over X."""
    q = w.q if isinstance(w, QStack) else w
    X, Fd, E = q.shape
    lead = y.shape[:-2]
    rows = y.reshape(-1, X, Fd).transpose(0, 1)            # (X, N, F)
    out = torch.bmm(rows, q.to(y.dtype)).transpose(0, 1)   # (N, X, E)
    out = out.reshape(*lead, X, E)
    if isinstance(w, QStack):
        out = out * w.s[:, 0, :].to(y.dtype)
    return out


def _routing(h: torch.Tensor, router: torch.Tensor, k: int
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(fp32 router logits, top-k ids, their softmax gates): the product
    in h's dtype, then the cast, as the reference computes it."""
    logits = (h @ router).float()
    topv, topi = top_k(logits, k)
    return logits, topi, torch.softmax(topv, dim=-1)


def moe_mlp(h: torch.Tensor, layer: MoeLayer, cfg: MoeConfig
            ) -> torch.Tensor:
    """Top-k routed expert FFN. h: (..., T, E) → (..., T, E).

    Dense dispatch: every expert computes every token, the top-k softmax
    weights (scattered back to a dense (..., T, X) mask) zero the rest."""
    logits, topi, gates = _routing(h, layer.router, cfg.experts_per_token)
    dense_w = torch.zeros_like(logits).scatter_(-1, topi, gates)
    gate = F.silu(_qe_in(h, layer.w_gate))
    up = _qe_in(h, layer.w_up)
    down = _qe_out(gate * up, layer.w_down)
    # "...txe,...tx->...te": the gate-weighted sum over the experts
    return (dense_w.to(down.dtype).unsqueeze(-2) @ down).squeeze(-2)


def moe_mlp_capacity(h: torch.Tensor, layer: MoeLayer, cfg: MoeConfig,
                     capacity_factor: float = 1.25) -> torch.Tensor:
    """Capacity-based (GShard-style) expert dispatch. h: (B, T, E).

    Each expert processes at most C = ceil(T·k/X · capacity_factor)
    tokens; earlier tokens win slots, and an overflow token is DROPPED
    (its residual passes the hidden state through unchanged). Unquantized
    stacks only, as the reference's."""
    B, T, E = h.shape
    X, k = cfg.num_experts, cfg.experts_per_token
    C = max(k, int(math.ceil(T * k / X * capacity_factor)))
    _, topi, gates = _routing(h, layer.router, k)           # (B, T, k)
    sel = F.one_hot(topi, X).float()                        # (B, T, k, X)
    sel_flat = sel.reshape(B, T * k, X)
    # exclusive cumsum per expert: each (t, j) choice's position within
    # its expert's capacity, earlier tokens first
    pos = torch.cumsum(sel_flat, dim=1) - sel_flat          # (B, S, X)
    pos_tk = (pos * sel_flat).sum(dim=-1).reshape(B, T, k)
    keep = (pos_tk < C).float()                             # (B, T, k)
    slot = F.one_hot(pos_tk.long().clamp(max=C), C + 1)[..., :C].float()
    dispatch_t = torch.einsum("btkx,btkc->btxc", sel * keep[..., None], slot)
    combine_t = torch.einsum("btkx,btkc->btxc",
                             sel * (keep * gates)[..., None], slot)
    xin = torch.einsum("btxc,bte->bxce", dispatch_t, h.float()).to(h.dtype)
    gate = F.silu(torch.einsum("bxce,xef->bxcf", xin, layer.w_gate))
    up = torch.einsum("bxce,xef->bxcf", xin, layer.w_up)
    down = torch.einsum("bxcf,xfe->bxce", gate * up, layer.w_down)
    return torch.einsum("btxc,bxce->bte", combine_t,
                        down.float()).to(h.dtype)


def _expert_fp32(w, x: int) -> torch.Tensor:
    """Expert x's (in, out) weight in fp32 (a QStack's dequantized)."""
    if isinstance(w, QStack):
        return w.q[x].float() * w.s[x]
    return w[x].float()


@torch.inference_mode()
def moe_mlp_reference(h: torch.Tensor, layer: MoeLayer, cfg: MoeConfig
                      ) -> torch.Tensor:
    """Per-token loop (slow, obviously correct), in fp32 on h's device:
    the plain version `moe_mlp` is held against. Ties in the router
    logits go to the lowest expert index. A QStack is read dequantized
    (q · s in fp32)."""
    flat = h.float().reshape(-1, h.shape[-1])
    out = torch.zeros_like(flat)
    router = layer.router.float()
    for t in range(flat.shape[0]):
        logits = flat[t] @ router
        top = torch.argsort(-logits, stable=True)[:cfg.experts_per_token]
        ex = torch.exp(logits[top] - logits[top].max())
        gates = ex / ex.sum()
        for g, x in zip(gates, top.tolist()):
            a = flat[t] @ _expert_fp32(layer.w_gate, x)
            silu = a / (1.0 + torch.exp(-a))
            u = flat[t] @ _expert_fp32(layer.w_up, x)
            out[t] += g * ((silu * u) @ _expert_fp32(layer.w_down, x))
    return out.reshape(h.shape)


@torch.inference_mode()
def moe_forward(model: LlamaModel, tokens: torch.Tensor,
                dispatch: str = "dense",
                capacity_factor: float = 1.25) -> torch.Tensor:
    """Full-sequence forward (no KV cache): last-token logits (B, V) fp32.
    The serving engine runs the paged forwards of `models/llama.py`; this
    entry is the reference's parity forward. dispatch: "dense"
    (`moe_mlp`) or "capacity" (`moe_mlp_capacity`)."""
    if dispatch not in ("dense", "capacity"):
        raise ValueError(f"unknown dispatch mode {dispatch!r}")
    cfg = model.cfg
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device)[None, :]
    x = embed_rows(model, tokens)
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                 device=tokens.device))
    for layer in model.layers:
        x = dense_attention(x, layer, positions, mask, cfg)
        hn = rms_norm(x, layer.mlp_norm, cfg.rms_eps)
        if dispatch == "dense":
            y = moe_mlp(hn, layer, cfg)
        else:
            y = moe_mlp_capacity(hn, layer, cfg, capacity_factor)
        x = x + y.to(x.dtype)
    xf = rms_norm(x[:, -1], model.final_norm, cfg.rms_eps)
    return qm(xf, model.lm_head).float()
