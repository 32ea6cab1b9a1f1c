"""The port's KV-event recorder (`dynamo_tpu_torch/router/recorder.py`)
held to the JAX package's: capture, replay, and equality with the live
index.

- The same seeded event stream recorded by each package's `KvRecorder`
  gives the same JSONL rows (one per event, the event's dict; only the
  timestamps differ), and a capture made by either package replays into
  the other's indexer.
- Replayed into a fresh indexer (the port's native and Python trees, the
  reference's), a capture gives the same scores, matched blocks and
  per-worker block counts as an indexer fed the events live.
- A live KV-routed deployment: mock workers behind a port `KvPushRouter`
  armed with `kv_record_path`; after traffic the capture replays equal to
  the router's own index, and its row count is the router's consumed
  event count.
"""

import asyncio
import json

import pytest

from dynamo_tpu.protocols import KvCacheEvent as RefEvent
from dynamo_tpu.router import indexer as ri
from dynamo_tpu.router import recorder as r_rec
from dynamo_tpu_torch.protocols import KvCacheEvent
from dynamo_tpu_torch.router import indexer as ti
from dynamo_tpu_torch.router import recorder as t_rec
from dynamo_tpu_torch.runtime.recorder import Recorder
from tests.test_torch_native_radix import _stream


def _rows(path) -> list:
    return [e for _, e in Recorder.iter_events(path)]


async def _record(mod, event_cls, path, events) -> int:
    rec = mod.KvRecorder(path)
    for ev in events:
        rec.record(event_cls.from_dict(ev.to_dict()))
    await rec.close()
    return rec.event_count


def _indexers(bs: int = 4):
    return {"port-native": ti.KvIndexer(bs),
            "port-python": ti.KvIndexer(bs, use_native=False),
            "ref": ri.KvIndexer(bs, use_native=False)}


def _view(idx, queries) -> tuple:
    tree = idx.tree
    return (tree.workers(), [tree.block_count(w) for w in tree.workers()],
            [(dict(s.scores), s.matched_blocks)
             for s in (tree.find_matches(q) for q in queries)])


@pytest.mark.parametrize("seed", [3, 4])
async def test_captures_are_row_for_row_and_replay_across_packages(
        tmp_path, seed):
    events, queries = _stream(seed, 300)
    paths = {"port": tmp_path / "port.jsonl", "ref": tmp_path / "ref.jsonl"}
    assert await _record(t_rec, KvCacheEvent, paths["port"], events) == 300
    assert await _record(r_rec, RefEvent, paths["ref"], events) == 300
    assert _rows(paths["port"]) == _rows(paths["ref"]) == \
        [json.loads(json.dumps(e.to_dict())) for e in events]
    live = ti.KvIndexer(4, use_native=False)
    for ev in events:
        live.apply_event(ev)
    want = _view(live, queries)
    for src, path in paths.items():
        for name, idx in _indexers().items():
            mod = r_rec if name == "ref" else t_rec
            n = await mod.KvRecorder.replay_into(path, idx)
            assert n == 300
            assert _view(idx, queries) == want, (src, name)


async def test_live_router_capture_replays_equal_to_its_index(tmp_path):
    from dynamo_tpu_torch.llm import entrypoint as t_entry
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.mocker import MockEngine, MockEngineConfig
    from dynamo_tpu_torch.protocols import PreprocessedRequest
    from dynamo_tpu_torch.router.kv_router import (
        KvPushRouter,
        KvRouterConfig,
    )
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.context import Context
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    path = tmp_path / "live.jsonl"
    prompts = [[p] * 40 + list(range(i)) for p in (3, 5, 7) for i in (0, 9)]

    async def main():
        rt = await DistributedRuntime.create(RuntimeConfig())
        card = ModelDeploymentCard(name="m", router_mode="kv",
                                   kv_block_size=16)
        engines, handles = [], []
        for wid in (1, 2):
            eng = MockEngine(MockEngineConfig(block_size=16, worker_id=wid,
                                              speedup=200.0,
                                              total_kv_blocks=3))
            eng.attach_sinks(*t_entry.wire_engine_events(rt, card))
            engines.append(eng)
            handles.append(await t_entry.serve_engine(rt, eng, card,
                                                      instance_id=wid))
        client = await rt.namespace(card.namespace).component(
            card.component).endpoint(card.endpoint).client()
        router = await KvPushRouter(client, rt.events, KvRouterConfig(
            block_size=16, kv_record_path=str(path))).start()
        try:
            while len(client.instances()) < 2:
                await asyncio.sleep(0.01)
            for toks in prompts * 2:
                req = PreprocessedRequest(token_ids=toks, model="m")
                req.stop.max_tokens = 4
                async for _ in router.generate(req.to_dict(), Context()):
                    pass
            published = sum(e.kv._event_id for e in engines)
            while router.router.indexer.events_applied < published:
                await asyncio.sleep(0.01)
            idx = router.router.indexer
            want = ({w: idx.tree.block_count(w) for w in idx.tree.workers()},
                    [dict(idx.find_matches_for_tokens(p).scores)
                     for p in prompts])
            recorder = router.kv_recorder
        finally:
            await router.stop()
            await client.stop()
            for h in handles:
                await h.stop()
            for e in engines:
                await e.close()
            await rt.close()
        return want, recorder.event_count, published

    want, consumed, published = await main()
    assert consumed == published == len(_rows(path)) > 0
    assert any(r["kind"] == "removed" for r in _rows(path))
    for name, idx in _indexers(16).items():
        mod = r_rec if name == "ref" else t_rec
        await mod.KvRecorder.replay_into(path, idx)
        got = ({w: idx.tree.block_count(w) for w in idx.tree.workers()},
               [dict(idx.find_matches_for_tokens(p).scores)
                for p in prompts])
        assert got == want, name
