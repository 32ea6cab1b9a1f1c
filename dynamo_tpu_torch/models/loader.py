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
Qwen2 checkpoints add q/k/v biases. Mixtral (MoE) checkpoints are not
served by this slice and raise.
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
    QUANT_KEYS,
    _act_bits_of,
    _bits_of,
    _lm_head_quant_ok,
    quantize as quant_fn,
    set_weight,
)
from dynamo_tpu_torch.models.llama import LlamaConfig, LlamaModel

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
    """LlamaConfig from a checkpoint dir's config.json."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    arch = (hf.get("architectures") or ["LlamaForCausalLM"])[0]
    if "mixtral" in arch.lower() or hf.get("num_local_experts"):
        raise ValueError(f"{arch}: MoE checkpoints are not served by "
                         f"dynamo_tpu_torch yet")
    if not any(f in arch.lower() for f in ("llama", "mistral", "qwen2")):
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
    cfg.update(overrides)
    return LlamaConfig(**cfg)


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
    parameter, one tensor at a time (host memory holds one tensor).

    `quantize` ("int8" | "w8a8" | "int4"): each projection is quantized as
    it lands on the device, as the reference's
    `load_llama_params_device(quantize=...)` quantizes before it stacks,
    and the lm_head under the vocab rule (int8, act_bits 16). The model is
    built on the meta device and every tensor is placed as it is loaded,
    so device memory peaks at the quantized model plus one tensor being
    quantized. The result is bit-identical to quantizing after load."""
    dev = torch.device(device)
    bits, act_bits = _bits_of(quantize), _act_bits_of(quantize)
    model = LlamaModel(cfg, torch.device("meta"))
    idx = _TensorIndex(path)
    try:
        def place(owner: torch.nn.Module, key: str, t: torch.Tensor) -> None:
            dtype = getattr(owner, key).dtype
            if quantize and key in QUANT_KEYS:
                set_weight(owner, key, quant_fn(t.to(dtype), bits, act_bits))
            else:
                set_weight(owner, key, torch.nn.Parameter(
                    t.to(dtype).contiguous(), requires_grad=False))

        def put(owner: torch.nn.Module, key: str, name: str,
                transpose: bool = False) -> None:
            t = idx.get(name).to(dev)
            place(owner, key, t.T if transpose else t)

        p = "model.layers.{}."
        for i, layer in enumerate(model.layers):
            put(layer, "attn_norm", p.format(i) + "input_layernorm.weight")
            put(layer, "mlp_norm",
                p.format(i) + "post_attention_layernorm.weight")
            for key, hf_name in (("wq", "self_attn.q_proj"),
                                 ("wk", "self_attn.k_proj"),
                                 ("wv", "self_attn.v_proj"),
                                 ("wo", "self_attn.o_proj"),
                                 ("w_gate", "mlp.gate_proj"),
                                 ("w_up", "mlp.up_proj"),
                                 ("w_down", "mlp.down_proj")):
                put(layer, key, p.format(i) + hf_name + ".weight",
                    transpose=True)
            if cfg.attention_bias:
                for key, hf_name in (("bq", "q_proj"), ("bk", "k_proj"),
                                     ("bv", "v_proj")):
                    put(layer, key, p.format(i) + f"self_attn.{hf_name}.bias")
        put(model, "embed", "model.embed_tokens.weight")
        put(model, "final_norm", "model.norm.weight")
        if "lm_head.weight" in idx:
            lm = idx.get("lm_head.weight").to(dev).T
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
