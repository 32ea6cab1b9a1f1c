"""Disaggregated prefill/decode serving in the port
(`dynamo_tpu_torch/disagg/`, the engine's transfer hooks), on the CPU.

The in-process cases of the reference's tests/test_disagg.py, on the
port's engines: the router's threshold and store watch, the engine's
export/import round trip, the decode-first stream equal to the
aggregated stream, a short prompt kept local, max_tokens 1, no prefill
pool, the same-process device path, the chunked host wire, single frames,
an abandoned pull, a transfer reaped mid-stream, logprobs preserved. Then
what the port adds: the decode-first stream against the JAX package's
disagg stream on the same fp32 weights, the host-wire frames between the
two packages in both directions (bytes and streams), the gather's plain
version against `_gather_kv_jit`, the transfer entries and KV events
against TpuEngine's, the counted fallback, and the two disagg workers as
subprocesses that load no jax. The queue-mode tests wait with the queue
mode. The CUDA IPC plane and the gather kernel need the card:
tests/test_torch_cuda.py."""

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamo_tpu.disagg import handlers as ref_handlers
from dynamo_tpu.disagg.disagg_router import DisaggRouter as RefDisaggRouter
from dynamo_tpu.engine import attention as jattn
from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.engine.engine import _gather_kv_jit
from dynamo_tpu.models import llama as jl
from dynamo_tpu.runtime import config as ref_config
from dynamo_tpu.runtime import distributed as ref_dist
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu.runtime.push import PushRouter as RefPushRouter
from dynamo_tpu_torch.disagg import handlers as H
from dynamo_tpu_torch.disagg import transfer_plane
from dynamo_tpu_torch.disagg.disagg_router import (
    DisaggRouter,
    disagg_config_key,
)
from dynamo_tpu_torch.disagg.handlers import (
    KV_PULL_ENDPOINT,
    DecodeWorkerHandler,
    PrefillWorkerHandler,
)
from dynamo_tpu_torch.engine import kernels
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.runtime import config as t_config
from dynamo_tpu_torch.runtime import distributed as t_dist
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.push import PushRouter
from dynamo_tpu_torch.runtime.topology import link_for_pull_path

KW = dict(num_pages=64, max_batch_size=4, prefill_chunk=32,
          min_prefill_bucket=8, default_max_tokens=8)


@pytest.fixture
def xla_impl():
    """The reference's disagg tests run its XLA attention; restored
    afterwards."""
    prev = jattn._impl
    jattn.set_attention_impl("xla")
    yield
    jattn.set_attention_impl(prev)


def make_engine(**kw):
    cfg = dict(model=tl.LlamaConfig.tiny(dtype=torch.float32), device="cpu",
               **KW)
    cfg.update(kw)
    return TorchEngine(TorchEngineConfig(**cfg))


def engine_pair(seed: int = 0):
    """(TpuEngine, TorchEngine) on the same fp32 weights."""
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    params = jl.init_params(jax.random.PRNGKey(seed), jcfg)
    jax_eng = TpuEngine(TpuEngineConfig(model=jcfg, **KW), params=params)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    torch_eng = TorchEngine(TorchEngineConfig(model=tcfg, device="cpu",
                                              **KW), model=model)
    return jax_eng, torch_eng, params, model


def req(tokens, max_tokens=6):
    return {"token_ids": list(tokens), "model": "m",
            "sampling": {"temperature": 0.0},
            "stop": {"max_tokens": max_tokens}}


def _ctx(eng):
    return JaxContext() if isinstance(eng, TpuEngine) else Context()


async def collect(engine, request, ctx=None):
    outs = [o async for o in engine.generate(request, ctx or Context())]
    assert not any(o.get("finish_reason") == "error" for o in outs), outs
    return outs


def tokens_of(outs):
    return [t for o in outs for t in o.get("token_ids", ())]


async def exported(eng, prompt):
    """Prefill `prompt` with do_remote_decode: (first token, ktp)."""
    p_req = req(prompt, max_tokens=1)
    p_req["kv_transfer_params"] = {"do_remote_decode": True}
    outs = [o async for o in eng.generate(p_req, _ctx(eng))]
    ktp = next(o["kv_transfer_params"] for o in outs
               if o.get("kv_transfer_params"))
    return outs[0]["token_ids"][0], ktp


# -- the router ---------------------------------------------------------------

@pytest.mark.parametrize("max_local,conditional", [(100, True), (0, True),
                                                   (512, False)])
def test_disagg_router_threshold(max_local, conditional):
    """The reference's cases, and the same answers as the reference's
    router over a grid of lengths and prefix hits."""
    r = DisaggRouter(max_local_prefill_length=100)
    assert not r.prefill_remote(80)
    assert r.prefill_remote(150)
    assert not r.prefill_remote(150, prefix_hit_len=100)
    assert DisaggRouter(conditional=False).prefill_remote(1)
    ours = DisaggRouter(max_local, conditional)
    ref = RefDisaggRouter(max_local, conditional)
    for n in (0, 1, 99, 100, 101, 600):
        for hit in (0, 16, 96, 512):
            assert ours.prefill_remote(n, hit) == ref.prefill_remote(n, hit)


async def test_disagg_router_store_watch():
    rt = await DistributedRuntime.create(RuntimeConfig(store_url="memory"))
    try:
        r = await DisaggRouter(max_local_prefill_length=100).start_watch(
            rt, "ns", "decode")
        assert disagg_config_key("ns", "decode") == "v1/disagg/ns/decode"
        await rt.store.put(disagg_config_key("ns", "decode"),
                           b'{"max_local_prefill_length": 5}')
        for _ in range(50):
            if r.max_local_prefill_length == 5:
                break
            await asyncio.sleep(0.01)
        assert r.max_local_prefill_length == 5
        await rt.store.put(disagg_config_key("ns", "decode"), b"not json")
        await rt.store.put(disagg_config_key("ns", "decode"),
                           b'{"conditional": false}')
        for _ in range(50):
            if not r.conditional:
                break
            await asyncio.sleep(0.01)
        assert not r.conditional and r.max_local_prefill_length == 5
        await r.stop()
    finally:
        await rt.close()


# -- the engine's transfer hooks ----------------------------------------------

async def test_engine_export_import_roundtrip():
    """Prefill with do_remote_decode pins the pages; importing them into a
    second engine reproduces the aggregated continuation."""
    prompt = list(range(1, 12))
    agg = make_engine()
    ref = tokens_of(await collect(agg, req(prompt, max_tokens=6)))
    await agg.close()

    prefill_eng, decode_eng = make_engine(), make_engine()
    try:
        first, ktp = await exported(prefill_eng, prompt)
        assert ktp["prefill_len"] == len(prompt)
        assert prefill_eng.pool.active_pages > 0         # pinned
        pages, plen = prefill_eng.take_transfer(ktp["transfer_id"])
        assert len(pages) == 3                           # 11 tokens of 4
        data = await prefill_eng.read_kv_pages(pages)
        assert data.device.type == "cpu" and tuple(data.shape) == (
            2, 2, 2, 3, 4, 16)
        prefill_eng.complete_transfer(ktp["transfer_id"])
        assert prefill_eng.pool.active_pages == 0
        d_req = req(prompt + [first], max_tokens=5)
        d_req["kv_transfer_params"] = {"kv_data": data, "prefill_len": plen}
        rest = tokens_of(await collect(decode_eng, d_req))
        assert [first] + rest == ref
        # the import wrote the pages, then one mid-page row was prefilled
        seen = decode_eng.compile_tracker._seen
        assert ("write_kv", (3,)) in seen
        assert any(k[0] == "prefill" and k[1][2] == 0 for k in seen)
    finally:
        await prefill_eng.close()
        await decode_eng.close()


@pytest.mark.parametrize("plen,shape_fix", [(11, -1), (0, 0), (12, 0)],
                         ids=["bad-shape", "zero-len", "whole-prompt"])
async def test_bad_import_fails_only_its_request(plen, shape_fix):
    eng = make_engine()
    try:
        n_pages = (plen + 3) // 4 + shape_fix
        bad = req(range(1, 13), max_tokens=3)
        bad["kv_transfer_params"] = {
            "kv_data": torch.zeros(2, 2, 2, max(n_pages, 0), 4, 16),
            "prefill_len": plen}
        outs = [o async for o in eng.generate(bad, Context())]
        assert outs[-1]["finish_reason"] == "error"
        assert "bad kv import" in outs[-1]["extra"]["error"]
        good = tokens_of(await collect(eng, req(range(1, 13), 3)))
        assert len(good) == 3 and eng.pool.active_pages == 0
    finally:
        await eng.close()


async def test_unpulled_transfer_is_reaped_after_its_ttl():
    eng = make_engine()
    eng.transfer_ttl = 0.05
    try:
        _, ktp = await exported(eng, list(range(1, 12)))
        assert eng.pool.active_pages == 3
        for _ in range(100):       # the idle scheduler loop reaps it
            if not eng._transfers:
                break
            await asyncio.sleep(0.05)
        assert not eng._transfers and eng.pool.active_pages == 0
        with pytest.raises(KeyError):
            eng.take_transfer(ktp["transfer_id"])
    finally:
        await eng.close()


def test_gather_plain_matches_gather_kv_jit():
    """`paged_kv_gather_ref` (and the wrapper on CPU tensors) has
    `_gather_kv_jit`'s layout exactly: (2, L, KVH, n, P, D)."""
    rng = np.random.default_rng(0)
    L, kvh, n_pages, p, d = 3, 2, 9, 4, 16
    ks = [rng.standard_normal((kvh, n_pages, p, d)).astype(np.float32)
          for _ in range(L)]
    vs = [rng.standard_normal((kvh, n_pages, p, d)).astype(np.float32)
          for _ in range(L)]
    ids = np.array([7, 2, 2, 5, 1], dtype=np.int32)
    want = np.asarray(_gather_kv_jit(tuple(map(jnp.asarray, ks)),
                                     tuple(map(jnp.asarray, vs)),
                                     jnp.asarray(ids)))
    kt, vt = list(map(torch.from_numpy, ks)), list(map(torch.from_numpy, vs))
    ids_t = torch.from_numpy(ids)
    got = kernels.paged_kv_gather_ref(kt, vt, ids_t)
    assert got.shape == want.shape == (2, L, kvh, 5, p, d)
    np.testing.assert_array_equal(got.numpy(), want)
    out = torch.empty_like(got)
    assert kernels.paged_kv_gather(kt, vt, ids_t, out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)


async def test_transfer_entries_and_kv_events_match_tpu_engine(xla_impl):
    """The export, the pull and the import on both packages' engines (the
    same fp32 weights): the same first token and continuation, the same
    pulled bytes, the same "gather_kv" / "write_kv" tracker keys, and the
    importing engine's pool publishes the KV events TpuEngine's publishes,
    one for one."""
    prompt = list(range(1, 14))
    runs = {}
    for label in ("jax", "torch"):
        p_eng, d_eng = [engine_pair()[0 if label == "jax" else 1]
                        for _ in range(2)]
        events = []
        if label == "jax":
            d_eng.pool.event_sink = lambda ev: events.append(ev.to_dict())
        else:
            d_eng.attach_sinks(lambda ev: events.append(ev.to_dict()), None)
        try:
            first, ktp = await exported(p_eng, prompt)
            pages, plen = p_eng.take_transfer(ktp["transfer_id"])
            data = await p_eng.read_kv_pages(pages)
            p_eng.complete_transfer(ktp["transfer_id"])
            d_req = req(prompt + [first], max_tokens=5)
            d_req["kv_transfer_params"] = {"kv_data": data,
                                           "prefill_len": plen}
            outs = [o async for o in d_eng.generate(d_req, _ctx(d_eng))]
            track = (p_eng.metrics.compile._seen
                     | d_eng.metrics.compile._seen)
            runs[label] = (first, tokens_of(outs), np.asarray(data),
                           sorted(k for k in track
                                  if k[0] in ("gather_kv", "write_kv")),
                           events)
        finally:
            await p_eng.close()
            await d_eng.close()
    jr, tr = runs["jax"], runs["torch"]
    assert tr[:2] == jr[:2]
    # the rows past prefill_len in the last page are padding either side
    # wrote (masked until decode overwrites them): compare written rows
    flat = (2, 2, 2, 4 * 4, 16)
    np.testing.assert_allclose(tr[2].reshape(flat)[:, :, :, :len(prompt)],
                               jr[2].reshape(flat)[:, :, :, :len(prompt)],
                               rtol=2e-5, atol=2e-5)
    assert tr[3] == jr[3] == [("gather_kv", (4,)), ("write_kv", (4,))]
    assert tr[4] == jr[4] and tr[4]


# -- the handlers, in one process ---------------------------------------------

async def setup_disagg_stack(max_local=0, registry=False, **engine_kw):
    """A decode and a prefill handler over one in-process runtime; with
    `registry`, the prefill handler is in the same-process registry."""
    rt = await DistributedRuntime.create(RuntimeConfig(store_url="memory"))
    prefill_eng = make_engine(**engine_kw)
    decode_eng = make_engine(**engine_kw)
    p_handler = PrefillWorkerHandler(prefill_eng, instance_id=11)
    ep_gen = rt.namespace("ns").component("prefill").endpoint("generate")
    await ep_gen.serve(p_handler, instance_id=11)
    if registry:
        await H.serve_kv_pull(rt, "ns", "prefill", p_handler, 11)
    else:
        await (rt.namespace("ns").component("prefill")
               .endpoint(KV_PULL_ENDPOINT).serve(p_handler.kv_pull,
                                                 instance_id=11))
    gen_client = await ep_gen.client()
    await gen_client.start()
    await gen_client.wait_ready()
    pull_client = await (rt.namespace("ns").component("prefill")
                         .endpoint(KV_PULL_ENDPOINT).client())
    await pull_client.start()
    await pull_client.wait_ready()
    d_handler = DecodeWorkerHandler(
        decode_eng, prefill_router=PushRouter(gen_client),
        kv_pull_router=PushRouter(pull_client),
        disagg_router=DisaggRouter(max_local_prefill_length=max_local))
    return rt, prefill_eng, decode_eng, d_handler


async def _close(rt, *engines):
    H._LOCAL_PREFILL.pop(11, None)
    await rt.close()
    for e in engines:
        await e.close()


async def test_disagg_e2e_matches_aggregated():
    prompt = list(range(1, 14))
    agg = make_engine()
    ref = tokens_of(await collect(agg, req(prompt, max_tokens=6)))
    await agg.close()
    rt, pe, de, handler = await setup_disagg_stack(max_local=0)
    try:
        outs = await collect(handler, req(prompt, max_tokens=6))
        assert tokens_of(outs) == ref
        assert handler.last_pull_path == "wire"   # no card: no plane
        assert pe.pool.active_pages == 0 and de.pool.active_pages == 0
        assert pe.pool.used_pages > 0             # its prefix stays cached
        (rec,) = handler.transfer_log
        assert rec["path"] == "wire" and rec["link"] == "dcn"
        assert rec["bytes"] == 2 * 2 * 2 * 4 * 4 * 16 * 4
        assert de.metrics.kv_pull.count == 1
        assert de.metrics.kv_pull_bytes.get(path="wire", link="dcn") == \
            rec["bytes"]
        assert not handler.fallbacks
    finally:
        await _close(rt, pe, de)


async def test_decode_first_stream_equals_the_jax_package_disagg_stream(
        xla_impl):
    """The decode-first stream of the port (its handlers and engines) and
    of the JAX package (its handlers and TpuEngines) on the same fp32
    weights (tiny: 2 layers), each equal to its aggregated stream."""
    prompts = [list(range(1, 14)), list(range(5, 40)), [7] * 9]

    async def jax_side():
        rt = await ref_dist.DistributedRuntime.create(
            ref_config.RuntimeConfig(store_url="memory"))
        pe, de = engine_pair()[0], engine_pair()[0]
        agg = engine_pair()[0]
        ph = ref_handlers.PrefillWorkerHandler(pe, instance_id=11)
        comp = rt.namespace("ns").component("prefill")
        await comp.endpoint("generate").serve(ph, instance_id=11)
        await comp.endpoint(KV_PULL_ENDPOINT).serve(ph.kv_pull,
                                                    instance_id=11)
        gen = await comp.endpoint("generate").client()
        pull = await comp.endpoint(KV_PULL_ENDPOINT).client()
        for c in (gen, pull):
            await c.start()
            await c.wait_ready()
        dh = ref_handlers.DecodeWorkerHandler(
            de, prefill_router=RefPushRouter(gen),
            kv_pull_router=RefPushRouter(pull),
            disagg_router=RefDisaggRouter(max_local_prefill_length=0))
        try:
            out = []
            for p in prompts:
                got = [o async for o in dh.generate(req(p), JaxContext())]
                want = [o async for o in agg.generate(req(p), JaxContext())]
                assert tokens_of(got) == tokens_of(want)
                out.append(tokens_of(got))
            return out
        finally:
            await rt.close()
            for e in (pe, de, agg):
                await e.close()

    async def torch_side():
        rt = await DistributedRuntime.create(RuntimeConfig(store_url="memory"))
        pe, de, agg = (engine_pair()[1] for _ in range(3))
        ph = PrefillWorkerHandler(pe, instance_id=11)
        comp = rt.namespace("ns").component("prefill")
        await comp.endpoint("generate").serve(ph, instance_id=11)
        await comp.endpoint(KV_PULL_ENDPOINT).serve(ph.kv_pull,
                                                    instance_id=11)
        gen = await comp.endpoint("generate").client()
        pull = await comp.endpoint(KV_PULL_ENDPOINT).client()
        for c in (gen, pull):
            await c.start()
            await c.wait_ready()
        dh = DecodeWorkerHandler(
            de, prefill_router=PushRouter(gen), kv_pull_router=PushRouter(pull),
            disagg_router=DisaggRouter(max_local_prefill_length=0))
        try:
            out = []
            for p in prompts:
                got = tokens_of(await collect(dh, req(p)))
                assert got == tokens_of(await collect(agg, req(p)))
                assert dh.last_pull_path == "wire"
                out.append(got)
            return out
        finally:
            await rt.close()
            for e in (pe, de, agg):
                await e.close()

    want = await jax_side()
    got = await torch_side()
    assert got == want
    assert all(len(t) == 6 for t in got)


async def test_disagg_short_prompt_stays_local():
    rt, pe, de, handler = await setup_disagg_stack(max_local=100)
    try:
        outs = await collect(handler, req(range(1, 9), max_tokens=4))
        assert len(tokens_of(outs)) == 4
        assert pe.pool.used_pages == 0              # prefill pool untouched
        assert handler.last_pull_path is None and not handler.transfer_log
    finally:
        await _close(rt, pe, de)


async def test_disagg_max_tokens_one():
    rt, pe, de, handler = await setup_disagg_stack(max_local=0)
    try:
        outs = await collect(handler, req(range(1, 9), max_tokens=1))
        assert len(tokens_of(outs)) == 1
        assert outs[-1]["finish_reason"] == "length"
        assert pe.pool.active_pages == 0 and de.pool.used_pages == 0
    finally:
        await _close(rt, pe, de)


async def test_disagg_fallback_when_no_prefill_pool():
    de = make_engine()
    handler = DecodeWorkerHandler(de)       # no routers at all
    try:
        outs = await collect(handler, req(range(1, 9), max_tokens=3))
        assert len(tokens_of(outs)) == 3
    finally:
        await de.close()


async def test_read_kv_pages_device_matches_host():
    """The device-resident gather == the host copy, value for value (on
    the CPU both lie on the CPU; the card test holds the kernel)."""
    eng = make_engine()
    try:
        _, ktp = await exported(eng, list(range(1, 12)))
        pages, _ = eng.take_transfer(ktp["transfer_id"])
        host = await eng.read_kv_pages(pages)
        dev = await eng.read_kv_pages_device(pages)
        assert dev.device == eng.device
        assert torch.equal(dev, host)
        want = torch.stack([torch.stack([c[:, pages] for c in eng.k_cache]),
                            torch.stack([c[:, pages] for c in eng.v_cache])])
        assert torch.equal(host, want)
        eng.complete_transfer(ktp["transfer_id"])
    finally:
        await eng.close()


async def test_disagg_device_path_e2e():
    """A same-process prefill engine registered through serve_kv_pull: the
    decode handler pulls on the device (no wire frames), the output still
    matches aggregated serving, and the registry entry goes with the
    endpoint."""
    prompt = list(range(1, 14))
    agg = make_engine()
    ref = tokens_of(await collect(agg, req(prompt, max_tokens=6)))
    await agg.close()
    rt, pe, de, handler = await setup_disagg_stack(max_local=0,
                                                   registry=True)
    try:
        assert 11 in H._LOCAL_PREFILL
        outs = await collect(handler, req(prompt, max_tokens=6))
        assert tokens_of(outs) == ref
        assert handler.last_pull_path == "device"
        assert handler.transfer_log[-1]["link"] == link_for_pull_path(
            "device") == "local"
        assert pe.pool.active_pages == 0 and not pe._transfers
        assert not handler.fallbacks
    finally:
        await _close(rt, pe, de)


async def test_stale_registry_entry_falls_back_to_the_wire_counted():
    """A registry entry whose engine does not hold the transfer (an
    instance id reused): the pull goes on over the wire, the stream is
    right, and the fallback is counted by path."""
    prompt = list(range(1, 14))
    agg = make_engine()
    ref = tokens_of(await collect(agg, req(prompt, max_tokens=6)))
    await agg.close()
    rt, pe, de, handler = await setup_disagg_stack(max_local=0)
    stranger = make_engine()
    H._LOCAL_PREFILL[11] = PrefillWorkerHandler(stranger, 11)
    try:
        outs = await collect(handler, req(prompt, max_tokens=6))
        assert tokens_of(outs) == ref
        assert handler.last_pull_path == "wire"
        assert handler.fallbacks == {("device", "wire"): 1}
        assert de.metrics.kv_pull_fallbacks.get(path="device",
                                                to="wire") == 1
    finally:
        await _close(rt, pe, de, stranger)


async def test_disagg_chunked_wire_path(monkeypatch):
    """Wire path with 1-page chunks: many frames, assembled in order,
    output still matches aggregated (DYN_KV_PLANE=0, as the reference's
    test runs it)."""
    monkeypatch.setenv("DYN_KV_PLANE", "0")
    prompt = list(range(1, 14))
    agg = make_engine()
    ref = tokens_of(await collect(agg, req(prompt, max_tokens=6)))
    await agg.close()
    rt, pe, de, handler = await setup_disagg_stack(max_local=0)
    handler.pull_chunk_pages = 1
    try:
        outs = await collect(handler, req(prompt, max_tokens=6))
        assert tokens_of(outs) == ref
        assert handler.last_pull_path == "wire"
        assert pe.pool.active_pages == 0
    finally:
        await _close(rt, pe, de)


async def test_disagg_plane_stage_unknown_transfer():
    """A stage request for an unknown transfer errors cleanly; on the CPU
    a stage request for a live one is refused (no card: no plane) and
    leaves the transfer pinned for the wire."""
    rt, pe, de, handler = await setup_disagg_stack(max_local=0)
    try:
        frames = [f async for f in handler.kv_pull_router.direct(
            {"transfer_id": "deadbeef", "stage": True,
             "plane": transfer_plane.PLANE_KIND}, 11, Context())]
        assert "error" in frames[0]
        _, ktp = await exported(pe, list(range(1, 14)))
        frames = [f async for f in handler.kv_pull_router.direct(
            {"transfer_id": ktp["transfer_id"], "stage": True,
             "plane": transfer_plane.PLANE_KIND}, 11, Context())]
        assert "kv plane unavailable" in frames[0]["error"]
        assert ktp["transfer_id"] in pe._transfers
        frames = [f async for f in handler.kv_pull_router.direct(
            {"transfer_id": ktp["transfer_id"], "release": True}, 11,
            Context())]
        assert frames == [{"released": False}]
        frames = [f async for f in handler.kv_pull_router.direct(
            {"transfer_id": ktp["transfer_id"], "abort": True}, 11,
            Context())]
        assert frames == [{"aborted": True}] and not pe._transfers
    finally:
        await _close(rt, pe, de)


def test_plane_is_off_without_a_card_or_when_switched_off(monkeypatch):
    """The plane needs a card; DYN_KV_PLANE=0 turns it off anyway; a
    descriptor exported by this process is refused before any CUDA call
    (cudaIpcOpenMemHandle refuses it)."""
    cpu = torch.device("cpu")
    assert not transfer_plane.plane_enabled(cpu)
    monkeypatch.setenv("DYN_KV_PLANE", "0")
    assert not transfer_plane.plane_enabled(torch.device("cuda"))
    plane = transfer_plane.TransferPlane()
    with pytest.raises(ValueError, match="process that exported it"):
        plane.pull({"kind": "cuda_ipc", "pid": __import__("os").getpid(),
                    "dtype": "float32", "shape": [1], "offset": 0,
                    "handle": b"\0" * 64}, cpu)
    with pytest.raises(ValueError, match="not a cuda_ipc"):
        plane.pull({"kind": "jax"}, cpu)
    assert plane.release("nothing") is False and plane.staged == 0
    # an IPC handle is 64 raw bytes, NULs included, both ways
    raw = bytes([0, 7, 0, 0, 255] + list(range(59)))
    assert bytes(transfer_plane._IpcHandle.from_buffer_copy(raw)
                 .reserved) == raw


async def test_kv_pull_single_frame_when_unchunked():
    eng = make_engine()
    try:
        _, ktp = await exported(eng, list(range(1, 14)))
        h = PrefillWorkerHandler(eng, instance_id=1)
        frames = [f async for f in h.kv_pull(
            {"transfer_id": ktp["transfer_id"]}, Context())]
        assert len(frames) == 1
        assert frames[0]["total_pages"] == frames[0]["shape"][3] == 4
        assert frames[0]["dtype"] == "float32"
        assert eng.pool.active_pages == 0
    finally:
        await eng.close()


async def test_kv_pull_releases_on_consumer_abandon():
    eng = make_engine()
    try:
        _, ktp = await exported(eng, list(range(1, 14)))
        h = PrefillWorkerHandler(eng, instance_id=1)
        gen = h.kv_pull({"transfer_id": ktp["transfer_id"],
                         "chunk_pages": 1}, Context())
        await gen.__anext__()      # one frame of four
        await gen.aclose()         # abandon
        assert eng.pool.active_pages == 0
    finally:
        await eng.close()


async def test_kv_pull_emits_chunked_frames():
    eng = make_engine()
    try:
        _, ktp = await exported(eng, list(range(1, 14)))   # 4 pages
        h = PrefillWorkerHandler(eng, instance_id=1)
        frames = [f async for f in h.kv_pull(
            {"transfer_id": ktp["transfer_id"], "chunk_pages": 2},
            Context())]
        assert len(frames) == 2
        assert [f["page_offset"] for f in frames] == [0, 2]
        assert all(f["total_pages"] == 4 for f in frames)
        assert eng.pool.active_pages == 0
    finally:
        await eng.close()


async def test_kv_pull_detects_reaped_transfer_mid_stream():
    eng = make_engine()
    try:
        _, ktp = await exported(eng, list(range(1, 14)))
        h = PrefillWorkerHandler(eng, instance_id=1)
        gen = h.kv_pull({"transfer_id": ktp["transfer_id"],
                         "chunk_pages": 1}, Context())
        first = await gen.__anext__()
        assert "kv" in first
        eng.complete_transfer(ktp["transfer_id"])     # reaped between
        second = await gen.__anext__()
        assert "expired mid-pull" in second.get("error", "")
        await gen.aclose()
    finally:
        await eng.close()


async def test_disagg_preserves_logprobs():
    """N tokens, N logprobs, when the first token came from the remote
    prefill worker."""
    prompt = list(range(1, 14))
    agg = make_engine()
    agg_outs = await collect(agg, req(prompt, max_tokens=6))
    agg_lps = [lp for o in agg_outs for lp in (o.get("log_probs") or ())]
    await agg.close()
    assert len(agg_lps) == 6
    rt, pe, de, handler = await setup_disagg_stack(max_local=0)
    try:
        outs = await collect(handler, req(prompt, max_tokens=6))
        lps = [lp for o in outs for lp in (o.get("log_probs") or ())]
        assert len(lps) == len(tokens_of(outs)) == 6
        np.testing.assert_allclose(lps, agg_lps, rtol=1e-5, atol=1e-5)
    finally:
        await _close(rt, pe, de)


# -- the host wire between the two packages ------------------------------------

@pytest.mark.parametrize("direction", ["torch-decode-jax-prefill",
                                       "jax-decode-torch-prefill"])
def test_wire_frames_interoperate_with_the_jax_package(xla_impl,
                                                       direction):
    """A decode handler of one package pulls host-wire frames from the
    other package's PrefillWorkerHandler over TCP: the frames' bytes equal
    the producing package's own (its kv_pull read directly), and the
    decode-first stream equals the aggregated one."""
    from tests.test_torch_serving import StoreThread

    prompt = list(range(1, 14))
    torch_decodes = direction.startswith("torch")

    async def main(url):
        jax_pe, torch_pe, _, _ = engine_pair()
        jax_de, torch_de, _, _ = engine_pair()
        agg = engine_pair()[1]
        want = tokens_of(await collect(agg, req(prompt)))
        await agg.close()
        ref_rt = await ref_dist.DistributedRuntime.create(
            ref_config.RuntimeConfig(store_url=url))
        t_rt = await t_dist.DistributedRuntime.create(
            t_config.RuntimeConfig(store_url=url))
        try:
            if torch_decodes:
                p_rt, ph = ref_rt, ref_handlers.PrefillWorkerHandler(
                    jax_pe, 21)
                d_rt, d_eng = t_rt, torch_de
            else:
                p_rt, ph = t_rt, PrefillWorkerHandler(torch_pe, 21)
                d_rt, d_eng = ref_rt, jax_de
            comp = p_rt.namespace("ns").component("prefill")
            await comp.endpoint("generate").serve(ph, instance_id=21)
            await comp.endpoint(KV_PULL_ENDPOINT).serve(ph.kv_pull,
                                                        instance_id=21)
            dcomp = d_rt.namespace("ns").component("prefill")
            gen = await dcomp.endpoint("generate").client()
            pull = await dcomp.endpoint(KV_PULL_ENDPOINT).client()
            for c in (gen, pull):
                await c.start()
                await c.wait_ready(10)
            if torch_decodes:
                dh = DecodeWorkerHandler(
                    d_eng, prefill_router=PushRouter(gen),
                    kv_pull_router=PushRouter(pull),
                    disagg_router=DisaggRouter(max_local_prefill_length=0))
                dh.pull_chunk_pages = 2
                ctx = Context
            else:
                dh = ref_handlers.DecodeWorkerHandler(
                    d_eng, prefill_router=RefPushRouter(gen),
                    kv_pull_router=RefPushRouter(pull),
                    disagg_router=RefDisaggRouter(max_local_prefill_length=0))
                dh.pull_chunk_pages = 2
                ctx = JaxContext
            got = [o async for o in dh.generate(req(prompt), ctx())]
            assert dh.last_pull_path == "wire"
            # frames over TCP from the producer, single and chunked, vs
            # the producer's own kv_pull output for a fresh export
            frames_remote, frames_local = [], []
            for frames, local in ((frames_remote, False),
                                  (frames_local, True)):
                _, ktp = await exported(ph.engine, prompt)
                if local:
                    frames += [f async for f in ph.kv_pull(
                        {"transfer_id": ktp["transfer_id"],
                         "chunk_pages": 3}, ctx())]
                else:
                    frames += [f async for f in dh.kv_pull_router.direct(
                        {"transfer_id": ktp["transfer_id"],
                         "chunk_pages": 3}, 21, ctx())]
            await gen.stop()
            await pull.stop()
            return tokens_of(got), want, frames_remote, frames_local
        finally:
            await ref_rt.close()
            await t_rt.close()
            for e in (jax_pe, torch_pe, jax_de, torch_de):
                await e.close()

    with StoreThread() as store:
        got, want, remote, local = asyncio.run(
            asyncio.wait_for(main(store.url), 60))
    assert got == want and len(got) == 6
    assert len(remote) == len(local) == 2
    for r, lo in zip(remote, local):
        assert bytes(r["kv"]) == bytes(lo["kv"])
        assert {k: v for k, v in r.items() if k != "kv"} == \
            {k: v for k, v in lo.items() if k != "kv"}
    assert remote[0]["dtype"] == "float32"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_wire_bytes_match_the_reference_encoding(dtype):
    """`_tensor_bytes` / `_tensor_from` against the reference's
    `_bf16_bytes` / `_bf16_from` (ml_dtypes bf16): the same bytes, shape
    and dtype name, both ways."""
    import ml_dtypes

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 2, 2, 3, 4, 16)).astype(np.float32)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    ref = x.astype(np_dt)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    raw, shape, name = H._tensor_bytes(t)
    assert (raw, shape, name) == ref_handlers._bf16_bytes(ref)
    back = H._tensor_from(*ref_handlers._bf16_bytes(ref))
    assert torch.equal(back, t)
    theirs = ref_handlers._bf16_from(raw, shape, name)
    assert theirs.tobytes() == raw and theirs.dtype == np.dtype(np_dt)


# -- the workers as processes --------------------------------------------------

def test_disagg_workers_serve_and_load_no_foreign_module(tmp_path):
    """The coordinator, a `--is-prefill-worker` worker, an
    `--enable-disagg --max-local-prefill-length 32` worker (both `--device
    cpu`, one synthetic checkpoint) and the frontend as subprocesses: a
    long prompt is prefilled remotely and pulled over the wire, a short
    one stays local, both answer; the prefill worker registers under
    `backend_prefill`; none of the processes loaded jax, any dynamo_tpu
    module, msgpack or aiohttp."""
    import time

    from dynamo_tpu.models.synth_ckpt import write_synthetic_hf_checkpoint
    from dynamo_tpu_torch.runtime.distributed import free_port
    from tests.test_torch_run import _Proc

    def run_chat(url, model, text):
        import http.client
        import json
        from urllib.parse import urlsplit

        u = urlsplit(url)
        conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
        try:
            conn.request("POST", "/v1/chat/completions", body=json.dumps({
                "model": model, "max_tokens": 4, "temperature": 0,
                "messages": [{"role": "user", "content": text}]}),
                headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, json.loads(r.read())
        finally:
            conn.close()

    ckpt = write_synthetic_hf_checkpoint(str(tmp_path / "tiny"),
                                         preset="tiny")
    procs = []
    try:
        coord = _Proc(tmp_path, "coordinator",
                      "dynamo_tpu_torch.coordinator", "--port",
                      str(free_port()))
        procs.append(coord)
        store = coord.wait_line("COORDINATOR_READY")
        common = ["--model", ckpt, "--device", "cpu", "--store", store,
                  "--num-pages", "64", "--router-mode", "round_robin"]
        # the frontend binds a model name to the first card it sees: the
        # prefill pool publishes its own name
        prefill = _Proc(tmp_path, "prefill", "dynamo_tpu_torch.worker",
                        *common, "--is-prefill-worker", "--instance-id", "1",
                        "--served-model-name", "tiny-prefill")
        procs.append(prefill)
        decode = _Proc(tmp_path, "decode", "dynamo_tpu_torch.worker",
                       *common, "--served-model-name", "tiny",
                       "--enable-disagg",
                       "--max-local-prefill-length", "32",
                       "--instance-id", "2")
        procs.append(decode)
        frontend = _Proc(tmp_path, "frontend", "dynamo_tpu_torch.frontend",
                         "--store", store, "--host", "127.0.0.1",
                         "--port", "0", "--router-mode", "round_robin")
        procs.append(frontend)
        assert prefill.wait_line("WORKER_READY") == \
            "dynamo/backend_prefill/generate/1"
        assert decode.wait_line("WORKER_READY") == \
            "dynamo/backend/generate/2"
        url = frontend.wait_line("FRONTEND_READY")
        deadline = time.monotonic() + 30
        while True:                 # the frontend discovers the card
            status, body = run_chat(url, "tiny", text="x" * 40)
            if status != 404 or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        assert status == 200, body
        assert body["usage"]["completion_tokens"] == 4
        status, body = run_chat(url, "tiny", text="hi")
        assert status == 200, body
    finally:
        rcs = [p.stop() for p in reversed(procs)]
    for p, rc in zip(reversed(procs), rcs):
        assert rc == 0, p.err_path.read_text()[-3000:]
        assert "FOREIGN []\n" in p.out, (p.out, p.err_path.read_text())
    log = decode.err_path.read_text()
    assert log.count("kv pull ") == 1 and "path wire" in log, log[-3000:]


def test_worker_disagg_flags():
    from dynamo_tpu_torch.worker import main as worker_main

    base = ["--model", "x", "--router-mode", "round_robin"]
    args = worker_main.parse_args(base + ["--enable-disagg",
                                          "--max-local-prefill-length",
                                          "256"])
    worker_main.check_args(args)
    assert args.enable_disagg and args.max_local_prefill_length == 256
    assert worker_main.parse_args(base).max_local_prefill_length == 512
    with pytest.raises(SystemExit, match="give one"):
        worker_main.check_args(worker_main.parse_args(
            base + ["--enable-disagg", "--is-prefill-worker"]))
    with pytest.raises(SystemExit, match="needs --model"):
        worker_main.check_args(worker_main.parse_args(
            ["--echo", "--router-mode", "round_robin",
             "--is-prefill-worker"]))
    with pytest.raises(SystemExit, match="prefill_queue.py"):
        worker_main.check_args(worker_main.parse_args(
            base + ["--enable-disagg", "--prefill-queue"]))
