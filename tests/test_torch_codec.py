"""The port's MessagePack codec (`dynamo_tpu_torch/runtime/codec.py`, on
the standard library) against the reference's (`dynamo_tpu/runtime/
codec.py`, msgpack): `pack` byte-identical on hypothesis-made objects of
the supported types and at every int and length boundary, each side
decoding the other's frames to equal objects (tuples come back as lists),
and the same exception types for what neither packs."""

import asyncio
import math

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.runtime import codec as ref_codec
from dynamo_tpu_torch.runtime import codec

INT_EDGES = sorted({s * (b + d) for b in (2**5, 2**7, 2**8, 2**15, 2**16,
                                          2**31, 2**32, 2**63)
                    for d in (-1, 0, 1) for s in (1, -1)
                    if -2**63 <= s * (b + d) < 2**64} | {0, 2**64 - 1})
LEN_EDGES = (0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536)

scalars = (st.none() | st.booleans()
           | st.integers(min_value=-2**63, max_value=2**64 - 1)
           | st.sampled_from(INT_EDGES)
           | st.floats(allow_nan=False) | st.text() | st.binary())
objects = st.recursive(
    scalars,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.lists(inner, max_size=20).map(tuple)
                   | st.dictionaries(st.text(max_size=8) | st.binary(
                       max_size=4), inner, max_size=20)),
    max_leaves=60)


def _listify(obj):
    """What msgpack decodes `obj` to: tuples become lists."""
    if isinstance(obj, (list, tuple)):
        return [_listify(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _listify(v) for k, v in obj.items()}
    return obj


def _frame_body(frame: bytes) -> bytes:
    assert int.from_bytes(frame[:4], "big") == len(frame) - 4
    return frame[4:]


@settings(max_examples=300, deadline=None)
@given(objects)
def test_pack_bytes_equal_reference(obj):
    mine, ref = codec.pack(obj), ref_codec.pack(obj)
    assert mine == ref
    want = _listify(obj)
    assert codec.unpackb(_frame_body(ref)) == want
    assert msgpack.unpackb(_frame_body(mine), raw=False) == want


@pytest.mark.parametrize("n", INT_EDGES)
def test_int_boundaries(n):
    assert codec.packb(n) == msgpack.packb(n, use_bin_type=True)
    assert codec.unpackb(codec.packb(n)) == n
    assert type(codec.unpackb(codec.packb(n))) is int


@pytest.mark.parametrize("n", LEN_EDGES)
@pytest.mark.parametrize("kind", ["str", "bin", "array", "map"])
def test_length_boundaries(kind, n):
    obj = {"str": lambda: "é" * (n // 2) + "a" * (n % 2),
           "bin": lambda: bytes(range(256)) * (n // 256) + bytes(n % 256),
           "array": lambda: list(range(n)),
           "map": lambda: {str(i): i for i in range(n)}}[kind]()
    mine = codec.packb(obj)
    assert mine == msgpack.packb(obj, use_bin_type=True)
    assert codec.unpackb(mine) == obj
    if kind == "str":       # the byte length picks the header
        assert len(obj.encode()) == n


def test_floats_are_float64_and_special_values_round_trip():
    for x in (0.0, -0.0, 1.5, 1e300, -1e-300, math.inf, -math.inf,
              np.float64(2.5)):
        b = codec.packb(x)
        assert b[0] == 0xCB and b == msgpack.packb(x, use_bin_type=True)
        assert codec.unpackb(b) == x
    nan = codec.packb(math.nan)
    assert nan == msgpack.packb(math.nan, use_bin_type=True)
    assert math.isnan(codec.unpackb(nan))
    # a float32 from another writer decodes too
    f32 = msgpack.packb(0.5, use_single_float=True)
    assert f32[0] == 0xCA and codec.unpackb(f32) == 0.5


@pytest.mark.parametrize("bad", [object(), {1, 2}, complex(1, 2),
                                 np.int64(3), np.bool_(True),
                                 {"k": [1, object()]}])
def test_unsupported_types_raise_type_error(bad):
    with pytest.raises(TypeError):
        msgpack.packb(bad, use_bin_type=True)
    with pytest.raises(TypeError):
        codec.pack(bad)


@pytest.mark.parametrize("n", [2**64, -2**63 - 1])
def test_out_of_range_ints_raise_overflow_error(n):
    with pytest.raises(OverflowError):
        msgpack.packb(n, use_bin_type=True)
    with pytest.raises(OverflowError):
        codec.pack(n)


def test_decode_refuses_what_msgpack_refuses():
    for data in (b"\x92\x01",                       # truncated array
                 b"\x01\x02",                       # extra data
                 b"\xc1",                           # never-used byte
                 msgpack.packb({1: 2})):            # non-str map key
        with pytest.raises(ValueError):
            msgpack.unpackb(data, raw=False)
        with pytest.raises(ValueError):
            codec.unpackb(data)
    # ext types: no frame carries one; the port refuses them
    with pytest.raises(ValueError):
        codec.unpackb(b"\xd4\x01\x00")


def test_frames_cross_read_over_streams():
    """A frame written by either codec reads back through the other's
    `read_frame` on an asyncio stream, and the length cap holds."""
    msg = {"t": "data", "rid": "r.1", "payload": {
        "token_ids": [1, 2, 300], "log_probs": [-0.5], "text": "hé",
        "finish_reason": None, "blob": b"\x00\xff"}}

    async def read_with(mod, data: bytes):
        reader = asyncio.StreamReader()
        reader.feed_data(data)
        reader.feed_eof()
        return await asyncio.wait_for(mod.read_frame(reader), 5)

    async def main():
        assert await read_with(codec, ref_codec.pack(msg)) == msg
        assert await read_with(ref_codec, codec.pack(msg)) == msg
        huge = (codec.MAX_FRAME + 1).to_bytes(4, "big")
        with pytest.raises(ConnectionError):
            await read_with(codec, huge)
        with pytest.raises(ConnectionError):
            await read_with(codec, codec.pack(msg)[:-1])

    asyncio.run(main())
    assert codec.MAX_FRAME == ref_codec.MAX_FRAME
