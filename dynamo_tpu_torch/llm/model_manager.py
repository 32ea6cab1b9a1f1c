"""ModelManager + ModelWatcher: discovery-driven pipeline assembly.

Port of `dynamo_tpu/llm/model_manager.py`. When a ModelDeploymentCard
appears under ``v1/mdc/``, build preprocessor → backend → migration →
router and expose it by model name; when the last card for a model
vanishes, tear it down. The port routes `kv` through a `KvPushRouter`
over the card's endpoint (its block size always the card's
`kv_block_size`, the granularity the engine hashes its KV events at), and
round-robin and random through `runtime/push.py`. The card's tool-call
and reasoning parsers go to the preprocessor (`:122-124`), and a card with
an `encode_component` gives it a round-robin `PushRouter` over that
component's encode workers (`:111-131`), stopped with the model.

Reference: `lib/llm/src/discovery/{watcher.rs:49,model_manager.rs:38}` and
the pipeline assembly in `entrypoint/input/common.rs:261-325`
(`build_routed_pipeline_with_preprocessor`).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
from typing import Optional

from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.migration import Migration
from dynamo_tpu_torch.llm.model_card import MDC_PREFIX, ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.tokenizer import make_tokenizer
from dynamo_tpu_torch.router.kv_router import KvPushRouter, KvRouterConfig
from dynamo_tpu_torch.runtime.engine import AsyncEngine, build_pipeline
from dynamo_tpu_torch.runtime.push import RANDOM, ROUND_ROBIN, PushRouter
from dynamo_tpu_torch.runtime.store import DELETE, PUT, RESET

logger = logging.getLogger(__name__)

KV = "kv"
ROUTER_MODES = (KV, ROUND_ROBIN, RANDOM)


def check_router_mode(mode: str) -> None:
    """Raise unless the port can route `mode` (kv | round_robin |
    random)."""
    if mode not in ROUTER_MODES:
        raise ValueError(f"unknown router mode {mode!r}; expected one of "
                         f"{ROUTER_MODES}")


class ModelEntry:
    def __init__(self, card: ModelDeploymentCard, engine: AsyncEngine,
                 kv_router: Optional[KvPushRouter], client,
                 encode_client=None) -> None:
        self.card = card
        self.engine = engine
        self.kv_router = kv_router
        self.client = client
        self.encode_client = encode_client
        self.card_keys: set[str] = set()

    async def stop_clients(self) -> None:
        if self.kv_router is not None:
            await self.kv_router.stop()
        await self.client.stop()
        if self.encode_client is not None:
            await self.encode_client.stop()


class ModelManager:
    """model name → serving pipeline (discovery/model_manager.rs:38)."""

    def __init__(self, runtime,
                 router_config: Optional[KvRouterConfig] = None) -> None:
        self.runtime = runtime
        self.router_config = router_config
        # CLI `--router-mode` overrides every card's router_mode
        # (frontend/main.py:4-16 flag semantics)
        self.router_mode_override: Optional[str] = None
        self._models: dict[str, ModelEntry] = {}

    def model_names(self) -> list[str]:
        return sorted(self._models)

    def get(self, model: str) -> Optional[ModelEntry]:
        return self._models.get(model)

    def engine_for(self, model: str) -> Optional[AsyncEngine]:
        e = self._models.get(model)
        return e.engine if e else None

    def kv_routers(self) -> dict[str, KvPushRouter]:
        """model name → its KV router, for the models routed `kv`."""
        return {name: e.kv_router for name, e in sorted(self._models.items())
                if e.kv_router is not None}

    async def add_model(self, card: ModelDeploymentCard,
                        card_key: str) -> ModelEntry:
        entry = self._models.get(card.name)
        if entry is not None:
            entry.card_keys.add(card_key)
            return entry
        router_mode = self.router_mode_override or card.router_mode
        check_router_mode(router_mode)
        rt = self.runtime
        ep = (rt.namespace(card.namespace).component(card.component)
              .endpoint(card.endpoint))
        client = await ep.client()
        await client.start()
        kv_router: Optional[KvPushRouter] = None
        if router_mode == KV:
            cfg = dataclasses.replace(
                self.router_config or KvRouterConfig(),
                block_size=card.kv_block_size)
            try:
                kv_router = await KvPushRouter(client, rt.events,
                                               cfg).start()
            except BaseException:
                await client.stop()
                raise
            router_engine: AsyncEngine = kv_router
        else:
            router_engine = PushRouter(client, mode=router_mode)
        tokenizer = make_tokenizer(card.tokenizer_kind, card.tokenizer_path)
        encode_router = None
        if card.encode_component:
            from dynamo_tpu_torch.multimodal.worker import ENCODE_ENDPOINT

            enc_client = await (rt.namespace(card.namespace)
                                .component(card.encode_component)
                                .endpoint(ENCODE_ENDPOINT).client())
            await enc_client.start()
            encode_router = PushRouter(enc_client)
        engine = build_pipeline(
            OpenAIPreprocessor(tokenizer, card.name, card.context_length,
                               tool_call_parser=card.tool_call_parser,
                               reasoning_parser=card.reasoning_parser,
                               encode_router=encode_router),
            Backend(tokenizer),
            Migration(card.migration_limit),
            sink=router_engine,
        )
        entry = ModelEntry(card, engine, kv_router, client,
                           encode_client=encode_router.client
                           if encode_router is not None else None)
        entry.card_keys.add(card_key)
        self._models[card.name] = entry
        logger.info("model added: %s (router=%s)", card.name, router_mode)
        return entry

    async def remove_card(self, model: str, card_key: str) -> None:
        entry = self._models.get(model)
        if entry is None:
            return
        entry.card_keys.discard(card_key)
        if entry.card_keys:
            return  # other workers still serve this model
        del self._models[model]
        await entry.stop_clients()
        logger.info("model removed: %s", model)

    async def close(self) -> None:
        for name in list(self._models):
            entry = self._models.pop(name)
            await entry.stop_clients()


class ModelWatcher:
    """Watches ``v1/mdc/`` and drives the ModelManager
    (discovery/watcher.rs:49,60+)."""

    def __init__(self, manager: ModelManager,
                 namespace: Optional[str] = None) -> None:
        self.manager = manager
        # only cards in this namespace are served (None = all)
        self.namespace = namespace
        self._task: Optional[asyncio.Task] = None
        self._watch = None
        # card_key -> model name (DELETE events carry only the key)
        self._key_model: dict[str, str] = {}

    async def start(self) -> "ModelWatcher":
        store = self.manager.runtime.store
        self._watch = await store.watch_prefix(MDC_PREFIX)
        for kv in await store.get_prefix(MDC_PREFIX):
            await self._on_put(kv.key, kv.value)
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def _run(self) -> None:
        assert self._watch is not None
        async for ev in self._watch:
            try:
                if ev.kind == PUT:
                    await self._on_put(ev.key, ev.value)
                elif ev.kind == DELETE:
                    model = self._key_model.pop(ev.key, None)
                    if model is not None:
                        await self.manager.remove_card(model, ev.key)
                elif ev.kind == RESET:
                    # coordinator restarted: drop every discovered card;
                    # surviving workers re-publish (replayed as PUTs)
                    for key, model in list(self._key_model.items()):
                        self._key_model.pop(key, None)
                        await self.manager.remove_card(model, key)
            except Exception:
                logger.exception("model watcher failed on %s", ev.key)

    async def _on_put(self, key: str, value: bytes) -> None:
        card = ModelDeploymentCard.from_json(value)
        if self.namespace is not None and card.namespace != self.namespace:
            return
        try:
            await self.manager.add_model(card, key)
        except Exception:
            # one broken card (bad tokenizer path, malformed config, a
            # router mode the port cannot serve) must not take down
            # discovery for every other model — the reference's watcher
            # logs and skips too (watcher.rs)
            logger.exception("failed to add model %s from %s; skipping",
                             card.name, key)
            return
        self._key_model[key] = card.name

    async def stop(self) -> None:
        if self._watch is not None:
            self._watch.cancel()
        if self._task is not None:
            self._task.cancel()
