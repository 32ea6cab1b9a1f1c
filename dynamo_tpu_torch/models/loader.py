"""Checkpoint loading: HF-style safetensors → `LlamaModel`.

Port of `dynamo_tpu/models/loader.py` `resolve_model` (`:52`),
`config_from_hf` (`:75`) and `load_llama_params` (`:162`), over the port's
own minimal safetensors reader (the port does not depend on the
`safetensors` package): an 8-byte little-endian header length, a JSON
header naming each tensor's dtype, shape and byte range, then the raw
data, read with `torch.frombuffer` from a memory map.

Layout mapping (HF `LlamaForCausalLM` → the reference's names, applied as
`x @ w`): `*_proj.weight` (out, in) is transposed to (in, out); norms load
as fp32; `lm_head.weight` (V, E) → (E, V), tied to `embed`ᵀ when absent.
Qwen2 checkpoints add q/k/v biases. Mixtral checkpoints (any config with
`num_local_experts`) load as `models/mixtral.py` `MoeConfig` (reference
`:103-113`): `block_sparse_moe.gate` is the router and
`block_sparse_moe.experts.{e}.w1/w3/w2` the gate/up/down expert stacks,
each expert written into its stack slot as it is read (reference
`:195-217`), in the reference device loader's read order (`:366-390`).
"""

from __future__ import annotations

import glob
import json
import logging
import mmap
import os
from typing import Any, Optional

import torch

from dynamo_tpu_torch.engine.quant import (
    MOE_QUANT_ERROR,
    QUANT_KEYS,
    QStack,
    _act_bits_of,
    _bits_of,
    _lm_head_quant_ok,
    quantize as quant_fn,
    set_weight,
)
from dynamo_tpu_torch.models.llama import LlamaConfig, LlamaModel
from dynamo_tpu_torch.models.mixtral import MOE_FFN, MoeConfig

logger = logging.getLogger(__name__)

_ST_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def resolve_model(name_or_path: str) -> str:
    """Local dir, or an already-downloaded HF-cache snapshot for
    `org/name`. Raises FileNotFoundError otherwise (no download path)."""
    if os.path.isdir(name_or_path):
        return name_or_path
    cache_root = os.environ.get(
        "HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    repo_dir = os.path.join(
        cache_root, "hub", "models--" + name_or_path.replace("/", "--"))
    snapshots = sorted(
        glob.glob(os.path.join(repo_dir, "snapshots", "*")),
        key=os.path.getmtime, reverse=True)
    for snap in snapshots:
        if glob.glob(os.path.join(snap, "*.safetensors")) or \
                os.path.exists(os.path.join(snap, "config.json")):
            return snap
    raise FileNotFoundError(
        f"model '{name_or_path}' is neither a directory nor a cached HF "
        f"snapshot (looked in {repo_dir}; this environment cannot download)")


def config_from_hf(path: str, **overrides: Any) -> LlamaConfig:
    """LlamaConfig (MoeConfig for a Mixtral-family config) from a
    checkpoint dir's config.json."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    arch = (hf.get("architectures") or ["LlamaForCausalLM"])[0]
    if not any(f in arch.lower()
               for f in ("llama", "mistral", "mixtral", "qwen2")):
        logger.warning("loading %s with the llama-family loader", arch)
    hidden = hf["hidden_size"]
    heads = hf["num_attention_heads"]
    cfg = dict(
        vocab_size=hf["vocab_size"],
        hidden_size=hidden,
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=hf.get("num_key_value_heads", heads),
        head_dim=hf.get("head_dim") or hidden // heads,
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rms_eps=float(hf.get("rms_norm_eps", 1e-5)),
        # Qwen2 attention carries q/k/v biases architecturally (its
        # config.json has no attention_bias key)
        attention_bias=bool(hf.get("attention_bias",
                                   "qwen2" in arch.lower())),
    )
    cls = LlamaConfig
    if "mixtral" in arch.lower() or hf.get("num_local_experts"):
        n_exp = hf.get("num_local_experts")
        if not n_exp:
            raise ValueError(
                f"{arch} checkpoint at {path} has no num_local_experts "
                f"in config.json — cannot size the expert stacks")
        cls = MoeConfig
        cfg["num_experts"] = int(n_exp)
        cfg["experts_per_token"] = int(hf.get("num_experts_per_tok", 2))
    cfg.update(overrides)
    return cls(**cfg)


class SafetensorsFile:
    """One .safetensors file, memory-mapped; `get` copies a tensor out."""

    def __init__(self, path: str) -> None:
        with open(path, "rb") as f:
            header_len = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(header_len))
            # copy-on-write map: writable for torch.frombuffer, never
            # written back to the file
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        header.pop("__metadata__", None)
        self._entries = header
        self._data_start = 8 + header_len

    def keys(self) -> list[str]:
        return list(self._entries)

    def get(self, name: str) -> torch.Tensor:
        e = self._entries[name]
        dtype = _ST_DTYPES[e["dtype"]]
        start, end = e["data_offsets"]
        count = (end - start) // torch.empty((), dtype=dtype).element_size()
        t = torch.frombuffer(self._map, dtype=dtype, count=count,
                             offset=self._data_start + start)
        return t.reshape(e["shape"]).clone()

    def close(self) -> None:
        self._map.close()


class _TensorIndex:
    """name → tensor across one or many .safetensors shards."""

    def __init__(self, path: str) -> None:
        self.path = path
        index_path = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(index_path):
            with open(index_path) as f:
                self._map = json.load(f)["weight_map"]
        else:
            files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
            if not files:
                raise FileNotFoundError(f"no .safetensors under {path}")
            self._map = {}
            for fp in files:
                sf = SafetensorsFile(fp)
                for name in sf.keys():
                    self._map[name] = os.path.basename(fp)
                sf.close()
        self._files: dict[str, SafetensorsFile] = {}

    def __contains__(self, name: str) -> bool:
        return name in self._map

    def get(self, name: str) -> torch.Tensor:
        fname = self._map[name]
        sf = self._files.get(fname)
        if sf is None:
            sf = SafetensorsFile(os.path.join(self.path, fname))
            self._files[fname] = sf
        return sf.get(name)

    def close(self) -> None:
        for sf in self._files.values():
            sf.close()
        self._files.clear()


@torch.inference_mode()
def load_llama_params(path: str, cfg: LlamaConfig,
                      device: "str | torch.device",
                      quantize: Optional[str] = None) -> LlamaModel:
    """`LlamaModel` on `device` from a checkpoint dir. Each tensor is read,
    moved to the device, then transposed and cast there into its
    parameter, one tensor at a time (host memory holds one tensor), in
    the reference device loader's order: the attention projections layer
    by layer, the routers and every expert (MoE), the norms, the biases,
    the embedding, the final norm, the lm_head.

    `quantize` ("int8" | "w8a8" | "int4"): each projection is quantized as
    it lands on the device, as the reference's
    `load_llama_params_device(quantize=...)` quantizes before it stacks,
    and the lm_head under the vocab rule (int8, act_bits 16). An MoE
    model's experts take int8 only (w8a8 and int4 raise, as in the
    reference), each quantized into its `QStack` slot as it is read. The
    model is built on the meta device and every tensor is placed as it is
    loaded, so device memory peaks at the quantized model plus one tensor
    being quantized. The result is bit-identical to quantizing after
    load."""
    dev = torch.device(device)
    moe = bool(getattr(cfg, "num_experts", 0))
    if moe and quantize and quantize != "int8":
        raise ValueError(MOE_QUANT_ERROR)
    bits, act_bits = _bits_of(quantize), _act_bits_of(quantize)
    model = LlamaModel(cfg, torch.device("meta"))
    idx = _TensorIndex(path)
    try:
        def read(name: str, transpose: bool = False) -> torch.Tensor:
            t = idx.get(name).to(dev)
            return t.T if transpose else t

        def place(owner: torch.nn.Module, key: str, t: torch.Tensor) -> None:
            dtype = getattr(owner, key).dtype
            if quantize and key in QUANT_KEYS:
                set_weight(owner, key, quant_fn(t.to(dtype), bits, act_bits))
            else:
                set_weight(owner, key, torch.nn.Parameter(
                    t.to(dtype).contiguous(), requires_grad=False))

        def put(owner: torch.nn.Module, key: str, name: str,
                transpose: bool = False) -> None:
            place(owner, key, read(name, transpose))

        p = "model.layers.{}."
        attn = [("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj")]
        if not moe:
            attn += [("w_gate", "mlp.gate_proj"), ("w_up", "mlp.up_proj"),
                     ("w_down", "mlp.down_proj")]
        for key, hf_name in attn:
            for i, layer in enumerate(model.layers):
                put(layer, key, p.format(i) + hf_name + ".weight",
                    transpose=True)
        if moe:
            bs = p + "block_sparse_moe."
            for i, layer in enumerate(model.layers):
                put(layer, "router", bs.format(i) + "gate.weight",
                    transpose=True)
            for key, w in MOE_FFN:
                for i, layer in enumerate(model.layers):
                    _load_stack(layer, key, read, dev, quantize,
                                bs.format(i) + "experts.{}." + w + ".weight")
        for i, layer in enumerate(model.layers):
            put(layer, "attn_norm", p.format(i) + "input_layernorm.weight")
        for i, layer in enumerate(model.layers):
            put(layer, "mlp_norm",
                p.format(i) + "post_attention_layernorm.weight")
        if cfg.attention_bias:
            for key, hf_name in (("bq", "q_proj"), ("bk", "k_proj"),
                                 ("bv", "v_proj")):
                for i, layer in enumerate(model.layers):
                    put(layer, key, p.format(i) + f"self_attn.{hf_name}.bias")
        put(model, "embed", "model.embed_tokens.weight")
        put(model, "final_norm", "model.norm.weight")
        if "lm_head.weight" in idx:
            lm = read("lm_head.weight", transpose=True)
        else:  # tie_word_embeddings
            lm = model.embed.T
        if quantize and _lm_head_quant_ok(lm):
            # int8 even under int4 (logit quality), as the reference
            set_weight(model, "lm_head",
                       quant_fn(lm.to(model.lm_head.dtype), 8))
        else:
            place(model, "lm_head", lm)
    finally:
        idx.close()
    left = [n for n, t in [*model.named_parameters(), *model.named_buffers()]
            if t.is_meta]
    if left:
        raise ValueError(f"load_llama_params: {path} lacks {left[:4]}")
    return model


def _load_stack(layer: torch.nn.Module, key: str, read, dev: torch.device,
                quantize: Optional[str], fmt: str) -> None:
    """One (X, in, out) expert stack from its X per-expert (out, in)
    tensors: each is transposed and cast (and under "int8" quantized)
    into its slot as it is read."""
    meta = getattr(layer, key)
    shape = tuple(meta.shape)
    if quantize:
        stack = QStack.empty(shape, dev)
        for e in range(shape[0]):
            stack.fill(e, read(fmt.format(e), True).to(meta.dtype))
        set_weight(layer, key, stack)
        return
    t = torch.empty(shape, dtype=meta.dtype, device=dev)
    for e in range(shape[0]):
        t[e].copy_(read(fmt.format(e), True))
    set_weight(layer, key, torch.nn.Parameter(t, requires_grad=False))
