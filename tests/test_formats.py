"""SigMF, data_stream protocol, and IL2P."""

import os

import numpy as np
import pytest
from test_models_extra import IL2P_BITS

from rustradio_tpu.io import data_stream as ds
from rustradio_tpu.io import sigmf


def test_sigmf_roundtrip(tmp_path):
    base = str(tmp_path / "rec")
    x = (np.random.RandomState(0).randn(256) + 1j).astype(np.complex64)
    sigmf.write(base, x, sample_rate=50_000.0, frequency=144.8e6)
    got, meta = sigmf.read(base)
    np.testing.assert_array_equal(got, x)
    assert meta.global_.sample_rate == 50_000.0
    assert meta.captures[0].frequency == 144.8e6
    assert meta.global_.datatype == "cf32_le"


def test_sigmf_sample_rate_override(tmp_path):
    base = str(tmp_path / "rec")
    sigmf.write(base, np.zeros(8, np.complex64), sample_rate=1000.0)
    _, meta = sigmf.read(base, sample_rate=2000.0)
    assert meta.global_.sample_rate == 2000.0


def test_sigmf_ci16(tmp_path):
    base = str(tmp_path / "rec16")
    x = (np.asarray([0.5, -0.25, 0.125]) + 1j * np.asarray([0.0, 0.5, -0.5])).astype(
        np.complex64
    )
    sigmf.write(base, x, sample_rate=1e6, datatype="ci16_le")
    got, meta = sigmf.read(base)
    np.testing.assert_allclose(got, x, atol=1e-4)


def test_sigmf_parse_meta_extra_fields():
    doc = """{"global": {"core:datatype": "cf32_le", "core:sample_rate": 8000,
               "core:author": "M0THC", "custom:thing": 42},
              "captures": [{"core:sample_start": 0, "core:frequency": 1e6}],
              "annotations": [{"core:sample_start": 5, "core:label": "x"}]}"""
    m = sigmf.parse_meta(doc)
    assert m.global_.author == "M0THC"
    assert m.global_.extra["custom:thing"] == 42
    assert m.captures[0].frequency == 1e6
    assert m.annotations[0].label == "x"


def test_sigmf_rejects_unknown_datatype(tmp_path):
    base = str(tmp_path / "bad")
    with open(base + ".sigmf-meta", "w") as f:
        f.write('{"global": {"core:datatype": "cf99"}}')
    with open(base + ".sigmf-data", "wb") as f:
        f.write(b"\x00" * 8)
    with pytest.raises(ValueError, match="unsupported SigMF datatype"):
        sigmf.read(base)


# ---------------------------------------------------------------- data_stream


def test_data_stream_version_first():
    r = ds.BytesReader()
    events = r.feed(ds.encode_version())
    assert events == [("version", 0)]
    with pytest.raises(ds.ProtocolError, match="first packet"):
        ds.BytesReader().feed(ds.encode_data("s", b"x"))


def test_data_stream_roundtrip_fragmented():
    wire = (
        ds.encode_version()
        + ds.encode_request_data("iq", 1024)
        + ds.encode_data("iq", b"hello world")
    )
    r = ds.BytesReader()
    events = []
    # feed a byte at a time — framing must survive arbitrary fragmentation
    for i in range(len(wire)):
        events += r.feed(wire[i : i + 1])
    assert events == [
        ("version", 0),
        ("request_data", "iq", 1024),
        ("data", "iq", b"hello world"),
    ]


def test_data_stream_flow_control():
    sent = []
    w = ds.SyncWriter(sent.append)
    assert w.send("iq", b"x" * 100) == 0  # no window granted
    w.grant("iq", 10)
    assert w.send("iq", b"x" * 100) == 10
    assert w.send("iq", b"x") == 0  # window exhausted
    w.grant("iq", 5)  # replaces window
    assert w.send("iq", b"abcdefgh") == 5


def test_data_stream_reader_requests():
    sent = []
    r = ds.SyncReader(sent.append)
    r.request("iq", 4096)
    assert sent[0] == ds.encode_version()
    assert sent[1] == ds.encode_request_data("iq", 4096)
    r.feed(ds.encode_version() + ds.encode_data("iq", b"\x01\x02"))
    assert r.take("iq") == b"\x01\x02"
    assert r.take("iq") == b""


def test_data_stream_rejects_oversize():
    r = ds.BytesReader(max_packet=100)
    bad = ds.encode_data("s", b"x" * 200)
    with pytest.raises(ds.ProtocolError, match="exceeds cap"):
        r.feed(bad)


def test_data_stream_rejects_zero_len():
    import struct

    with pytest.raises(ds.ProtocolError, match="zero-length"):
        ds.BytesReader().feed(struct.pack("<I", 0))


# ---------------------------------------------------------------- IL2P


@pytest.mark.skipif(not os.path.exists(IL2P_BITS), reason="reference testdata absent")
def test_il2p_header_decode():
    # reference test (src/il2p_deframer.rs:374-388) expects exactly one packet
    from rustradio_tpu.ops.il2p import il2p_deframe

    bits = np.fromfile(IL2P_BITS, np.uint8)
    hdrs = il2p_deframe(bits)
    assert len(hdrs) == 1
    h = hdrs[0]
    assert h.src == "M0THC-1" and h.dst == "2E0QQQ-1"
    assert h.describe() == "SABM"
    assert h.payload_size == 0 and h.fec


@pytest.mark.skipif(not os.path.exists(IL2P_BITS), reason="reference testdata absent")
def test_il2p_block_in_graph():
    from rustradio_tpu import blocks
    from rustradio_tpu.graph import Graph

    bits = np.fromfile(IL2P_BITS, np.uint8)
    g = Graph()
    deframer = blocks.Il2pDeframer()
    g.chain(blocks.VectorSource(bits), deframer, blocks.NullSink())
    # NullSink takes a stream; PDU list works fine since it only discards.
    g.run()
    assert deframer.decoded == 1
    assert deframer.headers[0].src == "M0THC-1"


def test_il2p_callsign_decode():
    from rustradio_tpu.ops.il2p import decode_callsign

    # SIXBIT: char = (c & 63) + 0x20
    data = [ord(c) - 0x20 for c in "M0THC "]
    assert decode_callsign(np.asarray(data)) == "M0THC"


# ------------------------------------------------------- async data_stream


def test_async_reader_writer_roundtrip():
    # reference src/data_stream.rs:546-716 asynchronous module
    import asyncio

    async def go():
        srv_done = asyncio.Event()
        got = []

        async def handle(reader, writer):
            r = ds.AsyncReader(reader)
            w = ds.AsyncWriter(writer)
            await w.write_version()
            assert await r.read_version()
            got.append(await r.read_packet())
            await w.write_data("s", b"payload")
            await srv_done.wait()
            writer.close()

        server = await asyncio.start_server(handle, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        r = ds.AsyncReader(reader)
        w = ds.AsyncWriter(writer)
        await w.write_version()
        assert await r.read_version()
        await w.write_request_data("s", 1024)
        pkt = await r.read_packet()
        assert pkt == ("data", "s", b"payload")
        srv_done.set()
        writer.close()
        server.close()
        await server.wait_closed()
        assert got == [("request_data", "s", 1024)]

    asyncio.run(go())


def test_data_stream_server_multi_client():
    # one slow client with a tiny window must not block a fast client
    import asyncio

    payload = bytes(range(256)) * 64  # 16 KiB

    def payload_at(pos, n):
        return payload[pos : pos + n]

    async def client(port, window, expect):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        r = ds.AsyncReader(reader)
        w = ds.AsyncWriter(writer)
        await w.write_version()
        assert await r.read_version()
        await w.write_request_data("rtl-sdr", window)
        buf = b""
        while len(buf) < expect:
            pkt = await r.read_packet()
            assert pkt[0] == "data"
            buf += pkt[2]
        writer.close()
        return buf

    async def go():
        srv = ds.DataStreamServer(payload_at, packet_bytes=1024)
        _, port = await srv.serve()
        fast = client(port, len(payload), len(payload))
        slow = client(port, 512, 512)
        r_fast, r_slow = await asyncio.wait_for(
            asyncio.gather(fast, slow), timeout=10
        )
        assert r_fast == payload
        assert r_slow == payload[:512]
        await srv.close()

    asyncio.run(go())


def test_data_stream_server_window_replacement():
    # a second RequestData REPLACES the window (DATA_STREAM.md semantics)
    import asyncio

    def payload_at(pos, n):
        return bytes([pos % 256]) * n

    async def go():
        srv = ds.DataStreamServer(payload_at, packet_bytes=128)
        _, port = await srv.serve()
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        r = ds.AsyncReader(reader)
        w = ds.AsyncWriter(writer)
        await w.write_version()
        assert await r.read_version()
        await w.write_request_data("rtl-sdr", 128)
        pkt = await r.read_packet()
        assert len(pkt[2]) == 128
        # window now 0: grant more and keep reading
        await w.write_request_data("rtl-sdr", 256)
        total = 0
        while total < 256:
            pkt = await r.read_packet()
            total += len(pkt[2])
        assert total == 256
        writer.close()
        await srv.close()

    asyncio.run(go())
