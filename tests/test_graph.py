"""Graph construction, offline run, streaming run, tags, stats."""

import numpy as np
import pytest

from rustradio_tpu import blocks, ops
from rustradio_tpu.graph import Graph
from rustradio_tpu.streams import Tag


def test_simple_chain_offline():
    # reference examples/simple_graph.rs: signal -> filter -> sink
    g = Graph()
    src = g.add(blocks.VectorSource(np.arange(16, dtype=np.float32)))
    add = g.add(blocks.AddConst(1.0), src)
    mul = g.add(blocks.MultiplyConst(2.0), add)
    sink = g.add(blocks.VectorSink(), mul)
    g.run()
    np.testing.assert_array_equal(
        sink.block.data(), (np.arange(16) + 1) * 2
    )


def test_chain_macro():
    g = Graph()
    sink = blocks.VectorSink()
    g.chain(
        blocks.VectorSource(np.ones(8, np.float32)),
        blocks.AddConst(2.0),
        sink,
    )
    g.run()
    np.testing.assert_array_equal(sink.data(), np.full(8, 3.0))


def test_tee_and_two_sinks():
    g = Graph()
    src = g.add(blocks.VectorSource(np.arange(4, dtype=np.float32)))
    tee = g.add(blocks.Tee(), src)
    s1 = g.add(blocks.VectorSink(), tee[0])
    s2 = g.add(blocks.VectorSink(), tee[1])
    g.run()
    np.testing.assert_array_equal(s1.block.data(), s2.block.data())


def test_vector_source_tags_propagate():
    g = Graph()
    src = g.add(blocks.VectorSource(np.ones(4, np.float32), repeat=2))
    sink = g.add(blocks.VectorSink(), g.add(blocks.AddConst(0.0), src))
    g.run()
    tags = sink.block.tags()
    keys = [(t.pos, t.key) for t in tags]
    assert (0, "VectorSource::start") in keys
    assert (4, "VectorSource::repeat") in keys
    assert (0, "VectorSource::first") in keys


def test_fir_graph_matches_op():
    rng = np.random.RandomState(0)
    x = rng.randn(300).astype(np.float32)
    taps = rng.randn(31).astype(np.float32)
    g = Graph()
    sink = blocks.VectorSink()
    g.chain(blocks.VectorSource(x), blocks.FirFilter(taps, deci=3), sink)
    g.run()
    np.testing.assert_allclose(
        sink.data(), np.asarray(ops.fir_filter(x, taps, 3)), rtol=1e-5
    )


def test_streaming_equals_offline_dense_chain():
    rng = np.random.RandomState(1)
    x = (rng.randn(4096) + 1j * rng.randn(4096)).astype(np.complex64)
    taps = rng.randn(33).astype(np.float32).astype(np.complex64)

    def build():
        g = Graph()
        sink = blocks.VectorSink()
        g.chain(
            blocks.VectorSource(x),
            blocks.FftFilter(taps),
            blocks.QuadratureDemod(0.5),
            blocks.SinglePoleIirFilter(0.3),
            sink,
        )
        return g, sink

    g1, s1 = build()
    g1.run()
    g2, s2 = build()
    g2.run_stream(chunk_size=500)
    a, b = s1.data(), s2.data()
    assert len(b) == len(a)
    np.testing.assert_allclose(a, b, atol=2e-3)


def test_streaming_equals_offline_decimating_fir():
    rng = np.random.RandomState(2)
    x = rng.randn(1000).astype(np.float32)
    taps = rng.randn(21).astype(np.float32)

    g1 = Graph()
    s1 = blocks.VectorSink()
    g1.chain(blocks.VectorSource(x), blocks.FirFilter(taps, deci=3), s1)
    g1.run()

    g2 = Graph()
    s2 = blocks.VectorSink()
    g2.chain(blocks.VectorSource(x), blocks.FirFilter(taps, deci=3), s2)
    g2.run_stream(chunk_size=170)
    np.testing.assert_allclose(s1.data(), s2.data(), rtol=1e-5)


def test_streaming_resampler_matches_offline():
    x = np.arange(1000, dtype=np.float32)
    for interp, deci in [(50000, 44100), (2, 3), (7, 2)]:
        g1 = Graph()
        s1 = blocks.VectorSink()
        g1.chain(blocks.VectorSource(x), blocks.RationalResampler(interp, deci), s1)
        g1.run()
        g2 = Graph()
        s2 = blocks.VectorSink()
        g2.chain(blocks.VectorSource(x), blocks.RationalResampler(interp, deci), s2)
        g2.run_stream(chunk_size=123)
        np.testing.assert_array_equal(s1.data(), s2.data())


def test_streaming_digital_chain():
    rng = np.random.RandomState(3)
    bits = rng.randint(0, 2, 500).astype(np.uint8)

    def build():
        g = Graph()
        sink = blocks.VectorSink()
        g.chain(
            blocks.VectorSource(bits),
            blocks.NrziEncode(),
            blocks.Scrambler.g3ruh(),
            blocks.Descrambler.g3ruh(),
            blocks.NrziDecode(),
            sink,
        )
        return g, sink

    g1, s1 = build()
    g1.run()
    g2, s2 = build()
    g2.run_stream(chunk_size=64)
    np.testing.assert_array_equal(s1.data(), s2.data())
    # Round trip: the scrambler emits the oldest register bit, so the chain
    # is a 17-bit delay (reference descrambler.rs test long_random_nrzi_g3ruh
    # skips 17 samples).
    np.testing.assert_array_equal(s1.data()[17:], bits[: len(bits) - 17])


def test_burst_pipeline_graph():
    # power-gated burst -> PDU -> back to stream
    rng = np.random.RandomState(4)
    data = np.zeros(1000, np.float32)
    data[300:400] = rng.randn(100).astype(np.float32) + 3
    trigger = np.zeros(1000, np.float32)
    trigger[295:405] = 1.0

    g = Graph()
    dsrc = g.add(blocks.VectorSource(data))
    tsrc = g.add(blocks.VectorSource(trigger))
    bt = g.add(blocks.BurstTagger(0.5, "burst"), dsrc, tsrc)
    pdu = g.add(blocks.StreamToPdu("burst", 10_000, 0), bt)
    back = g.add(blocks.PduToStream(), pdu)
    sink = g.add(blocks.VectorSink(), back)
    g.run()
    np.testing.assert_array_equal(sink.block.data(), data[295:405])


def test_hdlc_graph_end_to_end():
    payload = np.frombuffer(b"GRAPH HDLC TEST", np.uint8)
    framed = ops.hdlc_frame(ops.fcs_add(payload))
    g = Graph()
    src = g.add(blocks.VectorSource(framed))
    nrzi_in = g.add(blocks.NrziEncode(), src)
    nrzi_out = g.add(blocks.NrziDecode(), nrzi_in)
    hdlc = blocks.HdlcDeframer(1, 100)
    deframer = g.add(hdlc, nrzi_out)
    pdus = []
    sink = g.add(blocks.Map(lambda p: pdus.extend(p) or (), "collect"), deframer)
    sink.block.n_out = 0
    g.run()
    assert hdlc.stats["decoded"] == 1


def test_stats_table():
    g = Graph()
    g.chain(blocks.VectorSource(np.ones(64, np.float32)), blocks.AddConst(1.0), blocks.NullSink())
    g.run()
    stats = g.generate_stats()
    assert "AddConst" in stats and "TOTAL" in stats


def test_cancellation():
    g = Graph()
    sink = blocks.VectorSink()
    g.chain(blocks.VectorSource(np.ones(10, np.float32)), sink)
    g.cancel_token().cancel()
    g.run()
    assert len(sink.data()) == 0


def test_bad_connections():
    g = Graph()
    src = g.add(blocks.VectorSource(np.ones(4)))
    with pytest.raises(ValueError, match="takes 2 inputs"):
        g.add(blocks.Add(), src)
    with pytest.raises(IndexError):
        src[1]


def test_head_and_skip_streaming():
    x = np.arange(100, dtype=np.float32)
    g = Graph()
    sink = blocks.VectorSink()
    g.chain(blocks.VectorSource(x), blocks.Skip(10), blocks.Head(20), sink)
    g.run_stream(chunk_size=7)
    np.testing.assert_array_equal(sink.data(), x[10:30])


def test_hdlc_streaming_no_duplicates():
    # frames spanning chunk boundaries must decode exactly once
    payload1 = np.frombuffer(b"FRAME NUMBER ONE X", np.uint8)
    payload2 = np.frombuffer(b"SECOND FRAME HERE!", np.uint8)
    bits = np.concatenate(
        [ops.hdlc_frame(ops.fcs_add(p)) for p in (payload1, payload2)]
    )
    g = Graph()
    hdlc = blocks.HdlcDeframer(1, 100)
    collected = []
    n = g.add(blocks.VectorSource(bits))
    d = g.add(hdlc, n)
    sink = g.add(blocks.Map(lambda p: collected.extend(p) or (), "collect"), d)
    sink.block.n_out = 0
    g.run_stream(chunk_size=97)  # misaligned with frame boundaries
    assert hdlc.stats["decoded"] == 2
    assert [bytes(np.asarray(p.data)) for p in collected] == [
        bytes(payload1), bytes(payload2)
    ]


def test_au_codec_blocks_roundtrip():
    x = (np.sin(np.linspace(0, 20, 500)) * 0.5).astype(np.float32)
    g = Graph()
    sink = blocks.VectorSink()
    g.chain(blocks.VectorSource(x), blocks.AuEncode(48000), blocks.AuDecode(48000), sink)
    g.run_stream(chunk_size=77)
    got = sink.data()
    want = np.trunc(x * 32767).astype(np.float32) / 32767
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_rtlsdr_codec_blocks():
    iq = ((np.random.RandomState(0).randint(0, 256, 64) - 127) * 0.008).astype(np.float32)
    x = (iq[0::2] + 1j * iq[1::2]).astype(np.complex64)
    g = Graph()
    sink = blocks.VectorSink()
    g.chain(blocks.VectorSource(x), blocks.RtlSdrEncode(), blocks.RtlSdrDecode(), sink)
    g.run()
    np.testing.assert_allclose(sink.data(), x, atol=1e-5)


def test_cma_equalizer_window_slides():
    # reference src/cma.rs test: step_size 0, identity taps => passthrough
    x = np.asarray([1, 2, 3], np.complex64)
    g = Graph()
    sink = blocks.VectorSink()
    g.chain(blocks.VectorSource(x), blocks.CmaEqualizer(2, 1.0, 0.0), sink)
    g.run()
    np.testing.assert_allclose(sink.data(), x[:2])


def test_cma_equalizer_converges_on_gain_error():
    # QPSK scaled by 0.5: CMA must restore unit modulus (tap0 -> 2.0)
    rng = np.random.RandomState(5)
    sym = np.exp(2j * np.pi * rng.randint(0, 4, 6000) / 4).astype(np.complex64)
    g = Graph()
    sink = blocks.VectorSink()
    g.chain(
        blocks.VectorSource((0.5 * sym).astype(np.complex64)),
        blocks.CmaEqualizer(3, 1.0, 1e-2),
        sink,
    )
    g.run()
    out = sink.data()
    assert np.abs(np.abs(out[-200:]) - 1).mean() < 1e-3


def test_cma_streaming_matches_offline():
    rng = np.random.RandomState(6)
    x = (rng.randn(1000) + 1j * rng.randn(1000)).astype(np.complex64)

    def build():
        g = Graph()
        s = blocks.VectorSink()
        g.chain(blocks.VectorSource(x), blocks.CmaEqualizer(4, 1.0, 1e-3), s)
        return g, s

    g1, s1 = build(); g1.run()
    g2, s2 = build(); g2.run_stream(chunk_size=173)
    np.testing.assert_allclose(s1.data(), s2.data(), atol=1e-4)


def test_reader_writer_blocks(tmp_path):
    import io as pyio

    data = np.random.RandomState(7).randint(0, 256, 300).astype(np.uint8)
    out = pyio.BytesIO()
    g = Graph()
    g.chain(blocks.ReaderSource(pyio.BytesIO(data.tobytes())), blocks.WriterSink(out))
    g.run()
    assert out.getvalue() == data.tobytes()


def test_fused_segment_tags_and_values():
    # A fused device segment containing a decimating block must still
    # rescale tag positions per block and produce the same values as the
    # unfused ops (segment fusion: graph.Graph._segments).
    from rustradio_tpu import ops, taps as tg
    from rustradio_tpu.streams import Tag

    rng = np.random.RandomState(0)
    x = (rng.randn(4096) + 1j * rng.randn(4096)).astype(np.complex64)
    taps = tg.low_pass_complex(8000.0, 1000.0, 500.0, "hamming")
    src = blocks.VectorSource(x, tags=[Tag(100, "mark", 1), Tag(2000, "mark", 2)])
    fir = blocks.FirFilter(taps, deci=2)
    demod = blocks.QuadratureDemod(1.0)
    mul = blocks.MultiplyConst(3.0)
    sink = blocks.VectorSink()
    g = Graph()
    g.chain(src, fir, demod, mul, sink)
    assert any(len(s) >= 3 for s in g._segments().values())  # fusion engaged
    g.run()
    want = np.asarray(
        ops.quadrature_demod(ops.fir_filter(x, taps, 2), 1.0)
    ) * np.float32(3.0)
    np.testing.assert_allclose(sink.data(), want, atol=2e-5)
    keys = {(t.key, t.pos) for t in sink.tags()}
    assert ("mark", 50) in keys and ("mark", 1000) in keys


def test_fused_segment_streaming_matches_offline():
    from rustradio_tpu import taps as tg

    rng = np.random.RandomState(1)
    x = (rng.randn(50_000) + 1j * rng.randn(50_000)).astype(np.complex64)
    taps = tg.low_pass_complex(8000.0, 1000.0, 500.0, "hamming")

    def build():
        g = Graph()
        sink = blocks.VectorSink()
        g.chain(
            blocks.VectorSource(x),
            blocks.FftFilter(taps),
            blocks.QuadratureDemod(1.0),
            blocks.AddConst(0.25),
            sink,
        )
        return g, sink

    g1, s1 = build()
    g1.run()
    g2, s2 = build()
    g2.run_stream(chunk_size=7000)
    # chunked overlap-save picks a different fft_size than offline, so
    # roundoff differs slightly near block boundaries
    np.testing.assert_allclose(s2.data(), s1.data(), atol=1e-3)


def test_fused_segment_with_tee_fanout():
    # A Tee and both its consumers inside ONE fused segment (two external
    # outputs from the composite program).
    from rustradio_tpu import taps as tg

    rng = np.random.RandomState(2)
    x = rng.randn(4096).astype(np.float32)
    taps = tg.low_pass(8000.0, 1000.0, 500.0, "hamming")
    g = Graph()
    src = g.add(blocks.VectorSource(x))
    fir = g.add(blocks.FirFilter(taps), src)
    tee = g.add(blocks.Tee(), fir)
    a = g.add(blocks.AddConst(1.0), tee[0])
    m = g.add(blocks.MultiplyConst(2.0), tee[1])
    s1, s2 = blocks.VectorSink(), blocks.VectorSink()
    g.add(s1, a)
    g.add(s2, m)
    segs = g._segments()
    assert any(len(s) >= 4 for s in segs.values())
    g.run()
    from rustradio_tpu import ops

    want = np.asarray(ops.fir_filter(x, taps))
    np.testing.assert_allclose(s1.data(), want + 1.0, atol=1e-5)
    np.testing.assert_allclose(s2.data(), want * 2.0, atol=1e-5)


def test_profile_dir_writes_trace_and_costs(tmp_path):
    # SURVEY §5 tracing row: jax.profiler trace with one rr:: region per
    # block/segment, plus XLA cost analysis in the stats table
    import glob

    d = str(tmp_path / "trace")
    g = Graph()
    g.chain(
        blocks.VectorSource(np.random.randn(1 << 14).astype(np.float32)),
        blocks.AddConst(1.0),
        blocks.MultiplyConst(2.0),
        blocks.NullSink(),
    )
    g.run(profile_dir=d)
    assert glob.glob(d + "/**/*.xplane.pb", recursive=True)
    assert g.costs(), "XLA cost analysis should be recorded"
    stats = g.generate_stats()
    assert "GFLOP" in stats and "roof%" in stats


def test_run_stream_profile_dir(tmp_path):
    import glob

    d = str(tmp_path / "trace")
    g = Graph()
    g.chain(
        blocks.VectorSource(np.random.randn(1 << 14).astype(np.float32)),
        blocks.AddConst(1.0),
        blocks.NullSink(),
    )
    g.run_stream(chunk_size=1 << 12, profile_dir=d)
    assert glob.glob(d + "/**/*.xplane.pb", recursive=True)


def test_segments_fuse_device_chain():
    # a run of fusable device blocks compiles into ONE segment
    g = Graph()
    b1, b2 = blocks.AddConst(1.0), blocks.MultiplyConst(2.0)
    g.chain(blocks.VectorSource(np.ones(8, np.float32)), b1, b2, blocks.NullSink())
    segs = g._segments()
    assert any(len(s) == 2 for s in segs.values())


def test_segments_split_around_host_block():
    # a host block between device blocks ends one segment and starts the
    # next; the graph still computes the composed chain
    g = Graph()
    sink = blocks.VectorSink()
    g.chain(
        blocks.VectorSource(np.arange(16, dtype=np.float32)),
        blocks.AddConst(1.0),
        blocks.MultiplyConst(2.0),
        blocks.Inspect(lambda x: None),
        blocks.AddConst(3.0),
        blocks.MultiplyConst(4.0),
        sink,
    )
    members = [[n.block.name() for n in s] for s in g._segments().values()]
    assert all("Inspect" not in m for m in members)
    g.run()
    np.testing.assert_allclose(sink.data(), ((np.arange(16) + 1) * 2 + 3) * 4)


def test_scan_runner_preserves_tags():
    # tags must ride identically through the scan-over-chunks runner,
    # including tags carried across chunk boundaries by static Delay
    from rustradio_tpu.streams import Tag

    x = np.arange(4000, dtype=np.float32)
    tags = [Tag(500, "a", 1), Tag(1010, "b", 2), Tag(3900, "c", 3)]

    def run(scan):
        g = Graph()
        sink = blocks.VectorSink()
        g.chain(
            blocks.VectorSource(x, tags=tags),
            blocks.FirFilter(np.asarray([0.25, 0.5, 0.25], np.float32)),
            blocks.Delay(40),
            sink,
        )
        g.run_stream(chunk_size=512, scan_chunks=scan)
        return sink.data(), [(t.pos, t.key, t.val) for t in sink.tags()]

    d0, t0 = run(None)
    d1, t1 = run(4)
    np.testing.assert_allclose(d0, d1)
    assert [t for t in t1 if t[1] in "abc"] == [t for t in t0 if t[1] in "abc"]
    assert len([t for t in t0 if t[1] in "abc"]) == 3


def test_scan_runner_fanout_graph():
    # a value consumed by TWO downstream paths (device + host sink on one
    # side, filter chain on the other) must batch correctly
    x = np.random.RandomState(0).randn(4096).astype(np.float32)

    def run(scan):
        g = Graph()
        src = g.add(blocks.VectorSource(x))
        f1 = g.add(blocks.FirFilter(np.asarray([0.5, 0.5], np.float32)), src)
        s1 = g.add(blocks.VectorSink(), f1)
        f2 = g.add(blocks.MultiplyConst(2.0), f1)
        s2 = g.add(blocks.VectorSink(), f2)
        g.run_stream(chunk_size=512, scan_chunks=scan)
        return s1.block.data(), s2.block.data()

    a0, b0 = run(None)
    a1, b1 = run(4)
    np.testing.assert_allclose(a0, a1, atol=1e-6)
    np.testing.assert_allclose(b0, b1, atol=1e-6)


def test_scan_runner_composes_with_checkpoint_resume(tmp_path):
    # scan_chunks + checkpoint_every + resume_from in ONE run must
    # reproduce the plain offline stream (VERDICT r3 weak item 4)
    rng = np.random.RandomState(11)
    x = rng.randn(8192).astype(np.float32)
    ck = str(tmp_path / "scan.ckpt")

    def build_f(sink):
        g = Graph()
        g.chain(
            blocks.VectorSource(x),
            blocks.FirFilter(np.asarray([0.25, 0.5, 0.25], np.float32)),
            blocks.Delay(7),
            blocks.MultiplyConst(0.5),
            sink,
        )
        return g

    s_ref = blocks.VectorSink()
    build_f(s_ref).run_stream(chunk_size=512)

    # first half under the scan runner, checkpointing every batch
    s1 = blocks.VectorSink()
    build_f(s1).run_stream(chunk_size=512, scan_chunks=4, max_chunks=8,
                           checkpoint_path=ck, checkpoint_every=4)
    # resume the second half, still under the scan runner
    s2 = blocks.VectorSink()
    build_f(s2).run_stream(chunk_size=512, scan_chunks=4, resume_from=ck)

    got = np.concatenate([s1.data(), s2.data()])
    np.testing.assert_allclose(got, s_ref.data(), atol=1e-6)


def test_compile_device_loop_matches_run_stream():
    # the device-resident runner (r5): one jitted program advancing the
    # whole graph; its fold equals the per-chunk runner's output reduced
    # the same way, and the FM lowering shapes compose inside it
    import jax.numpy as jnp

    from rustradio_tpu import blocks
    from rustradio_tpu.graph import Graph

    rng = np.random.RandomState(21)
    n, chunk = 32768, 4096
    data = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    taps = (rng.randn(49) / 7).astype(np.float32)

    def build(sink):
        g = Graph()
        g.chain(
            blocks.VectorSource(data),
            blocks.FirFilter(taps, deci=4),
            blocks.QuadratureDemod(1.0),
            sink,
        )
        return g

    s = blocks.VectorSink()
    build(s).run_stream(chunk_size=chunk)
    want = float(np.sum(np.asarray(s.data())))

    sink = blocks.DeviceFoldSink()
    fn = build(sink).compile_device_loop(chunk, n // chunk)
    carries = fn(0)
    got = float(list(carries.values())[0])
    np.testing.assert_allclose(got, want, rtol=1e-5)

    # offset0 advances the source (second call, no recompile)
    got2 = float(list(fn(chunk).values())[0])
    assert got2 != got


def test_compile_device_loop_rejects_host_blocks():
    import pytest as _pytest

    from rustradio_tpu import blocks
    from rustradio_tpu.graph import Graph

    g = Graph()
    g.chain(
        blocks.VectorSource(np.zeros(1024, np.float32)),
        blocks.SymbolSync(8.0),
        blocks.DeviceFoldSink(),
    )
    with _pytest.raises(ValueError):
        g.compile_device_loop(256, 2)
