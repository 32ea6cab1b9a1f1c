"""Wire parity of the port's control plane and message plane with the
reference's: the port's `StoreClient` against the reference's
`StoreServer` and the reference's client against the port's server (put,
create, get, prefix reads, deletes, watch events with replay, lease expiry,
a coordinator restart with RESET, re-registration and a re-created
lease), and the same both ways for `TransportClient` → `TransportServer`
(a stream, a cancel mid-stream, an error frame, an unknown subject, an
expired deadline). Every wait is bounded by `asyncio.wait_for`; every
port is a fresh `free_port()`."""

import asyncio

import pytest

from dynamo_tpu.runtime import context as ref_context
from dynamo_tpu.runtime import store as ref_store
from dynamo_tpu.runtime import store_net as ref_store_net
from dynamo_tpu.runtime import transport as ref_transport
from dynamo_tpu_torch.runtime import context as t_context
from dynamo_tpu_torch.runtime import store as t_store
from dynamo_tpu_torch.runtime import store_net as t_store_net
from dynamo_tpu_torch.runtime import transport as t_transport
from dynamo_tpu_torch.runtime.distributed import free_port

PKGS = {
    "ref": (ref_store, ref_store_net, ref_transport, ref_context),
    "port": (t_store, t_store_net, t_transport, t_context),
}
# (client side, server side): both cross directions, and the port alone
PAIRS = [("port", "ref"), ("ref", "port"), ("port", "port")]
IDS = [f"{c}-client-{s}-server" for c, s in PAIRS]


async def _next(watch, timeout=5.0):
    return await asyncio.wait_for(watch.__anext__(), timeout)


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS, ids=IDS)
def test_store_wire_parity(client_pkg, server_pkg):
    store_mod = PKGS[client_pkg][0]
    net_c, net_s = PKGS[client_pkg][1], PKGS[server_pkg][1]

    async def main():
        port = free_port()
        server = net_s.StoreServer(port=port)
        await server.start()
        client = net_c.StoreClient("127.0.0.1", port)
        await client.connect()
        try:
            watch = await client.watch_prefix("svc/")
            rev = await client.put("svc/a", b"\x00one")
            assert rev > 0
            ev = await _next(watch)
            assert (ev.kind, ev.key, ev.value) == (store_mod.PUT, "svc/a",
                                                   b"\x00one")
            assert await client.create("svc/a", b"two") is False
            assert await client.create("svc/b", b"two") is True
            assert (await _next(watch)).key == "svc/b"
            kv = await client.get("svc/a")
            assert (kv.key, kv.value, kv.revision) == ("svc/a", b"\x00one",
                                                       rev)
            assert await client.get("svc/none") is None
            assert [k.key for k in await client.get_prefix("svc/")] == [
                "svc/a", "svc/b"]
            assert await client.delete("svc/a") is True
            ev = await _next(watch)
            assert (ev.kind, ev.key) == (store_mod.DELETE, "svc/a")
            assert await client.delete_prefix("svc/") == 1
            assert (await _next(watch)).kind == store_mod.DELETE

            # a lease nobody keeps alive expires; its key goes with it
            lease = (await client._call({"op": "lease_create",
                                         "ttl": 0.4}))["lease"]
            await client.put("svc/leased", b"x", lease)
            assert (await _next(watch)).kind == store_mod.PUT
            ev = await _next(watch, timeout=5.0)
            assert (ev.kind, ev.key) == (store_mod.DELETE, "svc/leased")
            # a kept-alive lease outlives its TTL
            kept = await client.create_lease(1.0)
            await client.put("svc/kept", b"y", kept)
            assert (await _next(watch)).kind == store_mod.PUT
            await asyncio.sleep(1.6)
            assert (await client.get("svc/kept")).value == b"y"
            # a replaying watch sees the current state first
            replay = await client.watch_prefix("svc/")
            ev = await _next(replay)
            assert (ev.kind, ev.key) == (store_mod.PUT, "svc/kept")
            replay.cancel()

            # coordinator restart: RESET into the live watch, the
            # on_reconnect hook re-creates what the empty store lost
            reconnected = asyncio.Event()

            async def hook():
                new_lease = await client.create_lease(1.0)
                await client.put("svc/kept", b"again", new_lease)
                reconnected.set()

            client.on_reconnect.append(hook)
            await server.stop()
            server = net_s.StoreServer(port=port)
            await server.start()
            await asyncio.wait_for(reconnected.wait(), 10)
            kinds = []
            while True:
                ev = await _next(watch)
                kinds.append(ev.kind)
                if ev.kind == store_mod.PUT:
                    break
            assert kinds == [store_mod.RESET, store_mod.PUT]
            assert (await client.get("svc/kept")).value == b"again"
            watch.cancel()
        finally:
            await client.close()
            await server.stop()

    asyncio.run(asyncio.wait_for(main(), 30))


class _Engine:
    """Streams `n` items, or fails, or stalls, per request; records the
    cancellations it saw."""

    def __init__(self) -> None:
        self.cancelled = asyncio.Event()

    async def generate(self, request, context):
        try:
            for i in range(request["n"]):
                if request.get("fail_at") == i:
                    raise ValueError("engine failed on purpose")
                await asyncio.sleep(request.get("delay", 0.0))
                yield {"i": i, "token_ids": [i, i + 1], "lp": -0.5 * i,
                       "text": f"t{i}", "blob": bytes([i])}
        except asyncio.CancelledError:
            self.cancelled.set()
            raise


@pytest.mark.parametrize("client_pkg,server_pkg", PAIRS, ids=IDS)
def test_transport_wire_parity(client_pkg, server_pkg):
    tr_c, ctx_c = PKGS[client_pkg][2], PKGS[client_pkg][3]
    tr_s = PKGS[server_pkg][2]

    async def collect(client, addr, subject, payload, ctx=None, **kw):
        out = []
        async for item in client.request(addr, subject, payload, ctx, **kw):
            out.append(item)
        return out

    async def main():
        engine = _Engine()
        server = tr_s.TransportServer(port=free_port())
        server.register("ns.comp.gen-1", engine)
        addr = await server.start()
        client = tr_c.TransportClient()
        try:
            got = await asyncio.wait_for(
                collect(client, addr, "ns.comp.gen-1", {"n": 4}), 5)
            assert got == [{"i": i, "token_ids": [i, i + 1], "lp": -0.5 * i,
                            "text": f"t{i}", "blob": bytes([i])}
                           for i in range(4)]

            # cancel mid-stream: the server's handler is cancelled
            ctx = ctx_c.Context()
            seen = []

            async def cancel_after_two():
                async for item in client.request(
                        addr, "ns.comp.gen-1", {"n": 1000, "delay": 0.01},
                        ctx):
                    seen.append(item)
                    if len(seen) == 2:
                        ctx.cancel()

            await asyncio.wait_for(cancel_after_two(), 5)
            await asyncio.wait_for(engine.cancelled.wait(), 5)
            assert 2 <= len(seen) < 1000

            # an error frame: the handler's exception, as ConnectionError
            with pytest.raises(ConnectionError, match="on purpose"):
                await asyncio.wait_for(collect(
                    client, addr, "ns.comp.gen-1", {"n": 3, "fail_at": 1}),
                    5)
            with pytest.raises(ConnectionError, match="no such endpoint"):
                await asyncio.wait_for(
                    collect(client, addr, "ns.comp.none", {"n": 1}), 5)

            # a deadline: the client gives up with STREAM_ERR_MSG and the
            # server aborts the handler (the header carried the budget)
            engine.cancelled.clear()
            with pytest.raises(ConnectionError) as err:
                await asyncio.wait_for(collect(
                    client, addr, "ns.comp.gen-1",
                    {"n": 1000, "delay": 0.05}, deadline=0.3), 5)
            assert str(err.value) == tr_c.STREAM_ERR_MSG
            await asyncio.wait_for(engine.cancelled.wait(), 5)
            assert tr_c.DEADLINE_HEADER == t_transport.DEADLINE_HEADER
            assert tr_c.STREAM_ERR_MSG == t_transport.STREAM_ERR_MSG

            # the builtin stats scrape answers both ways
            stats = await asyncio.wait_for(collect(
                client, addr, tr_s.TransportServer.STATS_SUBJECT, {}), 5)
            assert stats[0]["stats"]["ns.comp.gen-1"]["requests"] == 4
        finally:
            await client.close()
            await server.stop()

    asyncio.run(asyncio.wait_for(main(), 30))
