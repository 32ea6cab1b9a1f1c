"""Build a serving engine + card from a checkpoint directory.

Port of `dynamo_tpu/llm/entrypoint.py` `build_tpu_engine` (`:418-566`) as
`build_torch_engine`: resolve the checkpoint, read its config.json,
load the weights through the port's own loader (or random-init them from
a seed), and fill the card so the pipeline builds the matching
tokenizer. The engine runs on `device` — "cuda" by default, which raises
when no card is present — on the phase path, or on the ragged path when
`DYN_ATTENTION_IMPL=ragged`, as the reference reads that variable
(`dynamo_tpu/engine/attention.py:36`). Guided decoding gets the serving
tokenizer's token-bytes map as a lazy provider and its EOS id
(`:508-545`).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from dynamo_tpu_torch.device import resolve_device
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.llm.guided import token_bytes_of
from dynamo_tpu_torch.llm.model_card import (
    ModelDeploymentCard,
    ModelRuntimeConfig,
)
from dynamo_tpu_torch.llm.tokenizer import make_tokenizer
from dynamo_tpu_torch.models.loader import (
    config_from_hf,
    load_llama_params,
    resolve_model,
)

logger = logging.getLogger(__name__)

_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json",
                    "tokenizer.model")


def attention_impl_from_env() -> str:
    """The engine path DYN_ATTENTION_IMPL selects: "ragged" for "ragged";
    the phase path for anything else ("auto", "xla", "pallas" are all the
    reference's phase path)."""
    impl = os.environ.get("DYN_ATTENTION_IMPL", "auto").strip().lower()
    return "ragged" if impl == "ragged" else "phase"


def build_torch_engine(model: str, served_name: Optional[str] = None, *,
                       num_pages: int = 2048, max_batch_size: int = 8,
                       prefill_chunk_budget: int = 0,
                       decode_steps_per_sync: int = 8,
                       pipeline_bursts: bool = True,
                       random_init: bool = False, rng_seed: int = 0,
                       quantize: Optional[str] = None,
                       device: str = "cuda", **model_overrides
                       ) -> tuple[TorchEngine, ModelDeploymentCard]:
    """(TorchEngine, ModelDeploymentCard) for a checkpoint dir (or an
    already-downloaded HF-cache name). `random_init=True` skips the weight
    read and draws weights from `rng_seed` (benchmarks on synthetic
    weights). `quantize` ("int8" | "w8a8" | "int4") serves quantized
    weights: the loader quantizes each projection as it lands (the
    reference's `load_llama_params_device(quantize=...)`), and a random
    init is quantized by the engine. The path is
    `attention_impl_from_env()`'s. `model_overrides` tune the config, e.g.
    ``max_pages_per_seq`` or ``num_layers`` (depth cut)."""
    dev = resolve_device(device)
    path = resolve_model(model)
    cfg = config_from_hf(path, **model_overrides)
    params = None if random_init else load_llama_params(path, cfg, dev,
                                                        quantize=quantize)
    has_tok = any(os.path.exists(os.path.join(path, f))
                  for f in _TOKENIZER_FILES)
    # guided decoding needs the tokenizer's id -> bytes map; the provider
    # is lazy, so the O(vocab) build runs only if a guided request arrives
    token_bytes, eos_id = None, 0
    try:
        tok = make_tokenizer("hf" if has_tok else "byte",
                             path if has_tok else "")

        def token_bytes(tok=tok, vocab=cfg.vocab_size):
            return token_bytes_of(tok, vocab)

        eos_id = tok.eos_token_id or 0
    except Exception as e:
        logger.warning("guided decoding disabled (tokenizer unavailable: "
                       "%s)", e)
    engine = TorchEngine(
        TorchEngineConfig(model=cfg, num_pages=num_pages,
                          max_batch_size=max_batch_size,
                          prefill_chunk_budget=prefill_chunk_budget,
                          decode_steps_per_sync=decode_steps_per_sync,
                          pipeline_bursts=pipeline_bursts,
                          attention_impl=attention_impl_from_env(),
                          quantize=quantize, rng_seed=rng_seed,
                          device=str(dev)),
        model=params, token_bytes=token_bytes, eos_token_id=eos_id)
    card = ModelDeploymentCard(
        name=served_name or os.path.basename(path.rstrip("/")),
        tokenizer_kind="hf" if has_tok else "byte",
        tokenizer_path=path if has_tok else "",
        model_path=path,
        context_length=cfg.context_length, kv_block_size=cfg.page_size,
        runtime_config=ModelRuntimeConfig(
            total_kv_blocks=engine.pool.capacity,
            max_batch_size=max_batch_size))
    return engine, card
