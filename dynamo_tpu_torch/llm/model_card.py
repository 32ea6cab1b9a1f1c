"""ModelDeploymentCard: everything a pipeline needs to serve a model.

Port of `dynamo_tpu/llm/model_card.py` (the port keeps its own copy of the
card): published to the KV store under ``v1/mdc/...`` with a checksum,
attached to the worker's lease, watched by frontends. The card carries
the reference's tool-call and reasoning-parser names, which the frontend's
preprocessor serves (`dynamo_tpu_torch/parsers`), and its
`encode_component`: the component of the encode workers that turn the
model's image parts into tokens (`dynamo_tpu_torch/multimodal`). A card
from the reference loads with its known fields (`from_dict`).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field

MDC_PREFIX = "v1/mdc/"


@dataclass
class ModelRuntimeConfig:
    """Engine-reported capacity."""

    total_kv_blocks: int = 0
    max_batch_size: int = 0
    data_parallel_size: int = 1
    tensor_parallel_size: int = 1

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class ModelDeploymentCard:
    name: str                       # served model name ("model" in requests)
    namespace: str = "dynamo"
    component: str = "backend"
    endpoint: str = "generate"
    tokenizer_kind: str = "word"    # word | byte | hf
    tokenizer_path: str = ""
    model_path: str = ""            # checkpoint dir
    context_length: int = 8192
    kv_block_size: int = 16
    migration_limit: int = 0
    router_mode: str = "kv"         # kv | round_robin | random
    tool_call_parser: str = ""      # see dynamo_tpu_torch.parsers (hermes, ...)
    reasoning_parser: str = ""      # basic | deepseek_r1 | granite | ...
    encode_component: str = ""      # multimodal encode-worker component
    runtime_config: ModelRuntimeConfig = field(
        default_factory=ModelRuntimeConfig)

    def store_key(self, lease_id: int) -> str:
        """Per-worker key: each serving process publishes its own copy, so
        the model stays discoverable until the *last* worker's lease drops."""
        return (f"{MDC_PREFIX}{self.namespace}/{self.component}/"
                f"{self.name}/{lease_id:x}")

    def to_dict(self) -> dict:
        d = asdict(self)
        d["checksum"] = self.checksum()
        return d

    def checksum(self) -> str:
        return hashlib.blake2b(
            json.dumps(asdict(self), sort_keys=True).encode(),
            digest_size=8).hexdigest()

    def to_json(self) -> bytes:
        return json.dumps(self.to_dict()).encode()

    @classmethod
    def from_dict(cls, d: dict) -> "ModelDeploymentCard":
        rc = d.get("runtime_config") or {}
        known_rc = {k: v for k, v in rc.items()
                    if k in ModelRuntimeConfig.__dataclass_fields__}
        known = {k: v for k, v in d.items()
                 if k in cls.__dataclass_fields__ and k != "runtime_config"}
        return cls(runtime_config=ModelRuntimeConfig(**known_rc), **known)

    @classmethod
    def from_json(cls, raw: bytes) -> "ModelDeploymentCard":
        return cls.from_dict(json.loads(raw))


async def register_llm(runtime, card: ModelDeploymentCard) -> None:
    """Publish the card under the process lease (worker side, the analog of
    the reference's `register_llm`, bindings lib.rs:123 → model_card.rs:463).
    The lease attachment means a dead worker's card disappears, and the
    frontend drops the model when its last card vanishes. Re-published
    automatically after a coordinator restart (the key embeds the lease
    id, so the replay publishes under the re-created lease)."""
    await runtime.store.put(card.store_key(runtime.lease_id), card.to_json(),
                            runtime.lease_id)

    async def _reput() -> None:
        await runtime.store.put(card.store_key(runtime.lease_id),
                                card.to_json(), runtime.lease_id)

    # the card object keeps its own hook handle (same shape as
    # ServedEndpoint._reput) so unregister can drop exactly this replay
    card._replay_hook = _reput
    runtime.replay_on_reconnect(_reput)

