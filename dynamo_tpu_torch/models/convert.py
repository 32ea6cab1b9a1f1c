"""Carry the reference's weights across: JAX param pytree → `LlamaModel`.

The tree is `dynamo_tpu/models/llama.py` `init_params`' (or the reference
loader's) layout with its leaves as numpy arrays — `{"embed", "layers":
{name: (L, ...)}, "final_norm", "lm_head"}`. bf16 arrives as
`ml_dtypes.bfloat16`, which `torch.from_numpy` rejects: it is viewed as
int16 and then as `torch.bfloat16`, so the bits carry over exactly.

A quantized tree (the reference's `quantize_params`, or
`load_llama_params_device(quantize=...)`) carries its weights as
reference `QTensor`s (`jax.tree.map(np.asarray, ...)` keeps them, with
numpy q and s): each becomes the port's `QTensor` with q, s, bits and
act_bits exact, q transposed once to the port's K-major layout.

An MoE tree (`dynamo_tpu/models/mixtral.py` `init_moe_params`, or the
reference loader's for a Mixtral checkpoint) adds `router` (L, E, X) and
stacks `w_gate` / `w_up` / `w_down` as (L, X, in, out); a quantized stack
(q (L, X, in, out), s (L, X, 1, out)) becomes one `QStack` per layer,
q and s as they are (the port keeps the reference's expert layout).
"""

from __future__ import annotations

import numpy as np
import torch

from dynamo_tpu_torch.engine.quant import QStack, QTensor, set_weight
from dynamo_tpu_torch.models.llama import LlamaConfig, LlamaModel

_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
               "w_up", "w_down")
_EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """numpy → torch with bf16 bits preserved (ml_dtypes.bfloat16 is a
    2-byte numpy dtype named 'bfloat16')."""
    a = np.array(a, order="C")      # owned, writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _is_qtensor(leaf) -> bool:
    """A reference QTensor (duck-typed: the port imports no dynamo_tpu)."""
    return all(hasattr(leaf, a) for a in ("q", "s", "bits", "act_bits"))


def _qtensor(q: np.ndarray, s: np.ndarray, bits: int, act_bits: int,
             device: torch.device) -> QTensor:
    """One 2-D reference QTensor → the port's: q (K, N or N/2) becomes
    K-major (N or N/2, K); s (1, N) as is."""
    return QTensor(tensor_from_numpy(q).T.contiguous().to(device),
                   tensor_from_numpy(s).to(device), bits=int(bits),
                   act_bits=int(act_bits))


@torch.inference_mode()
def params_from_jax(tree: dict, cfg: LlamaConfig,
                    device: "str | torch.device") -> LlamaModel:
    """Build the port's module from a JAX param pytree of numpy arrays.
    Each tensor is copied into the parameter of the same name (cast to the
    parameter's dtype when the tree holds another); a quantized leaf
    replaces its parameter with a `QTensor` (a `QStack` for an expert
    stack)."""
    dev = torch.device(device)
    model = LlamaModel(cfg, dev)
    model.embed.copy_(tensor_from_numpy(tree["embed"]))
    model.final_norm.copy_(tensor_from_numpy(tree["final_norm"]))
    lm = tree["lm_head"]
    if _is_qtensor(lm):
        set_weight(model, "lm_head", _qtensor(lm.q, lm.s, lm.bits,
                                              lm.act_bits, dev))
    else:
        model.lm_head.copy_(tensor_from_numpy(lm))
    moe = bool(getattr(cfg, "num_experts", 0))
    keys = _LAYER_KEYS + (("bq", "bk", "bv") if cfg.attention_bias else ()) \
        + (("router",) if moe else ())
    for key in keys:
        stack = tree["layers"][key]
        quantized = _is_qtensor(stack)
        n = (stack.q if quantized else stack).shape[0]
        if n != cfg.num_layers:
            raise ValueError(f"params_from_jax: {key} has {n} layers, "
                             f"config has {cfg.num_layers}")
        for l, layer in enumerate(model.layers):
            if quantized and moe and key in _EXPERT_KEYS:
                set_weight(layer, key, QStack(
                    tensor_from_numpy(stack.q[l]).to(dev),
                    tensor_from_numpy(stack.s[l]).to(dev)))
            elif quantized:
                set_weight(layer, key, _qtensor(
                    stack.q[l], stack.s[l], stack.bits, stack.act_bits, dev))
            else:
                getattr(layer, key).copy_(tensor_from_numpy(stack[l]))
    return model
