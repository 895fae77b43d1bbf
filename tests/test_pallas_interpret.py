"""The fused FM kernel (ops/fm.py) under the Pallas interpreter.

The kernel compiles only for the GPU (Triton route); on the CPU the
``interpret_kernels`` fixture sets ``backend.INTERPRET`` so the real kernel
body — tile loads, masks, tap rows, the carried previous sample across
program seams — runs in the interpreter and is compared with float64
ground truth.  chip_smoke.py runs the compiled kernel on the card.
"""

import numpy as np
import pytest

from rustradio_tpu import backend
import rustradio_tpu.ops.fm as fc


@pytest.fixture
def interpret_kernels(monkeypatch):
    monkeypatch.setattr(backend, "INTERPRET", True)


@pytest.fixture
def small_blocks(interpret_kernels, monkeypatch):
    # 16 tile rows per program: several programs and seams at test sizes
    monkeypatch.setattr(fc, "ROWS", 16)


def _fir_deci_f64(x, taps, deci):
    """y[m] = sum_j taps[j] x[m*deci - j], zero history, f64."""
    x = np.asarray(x, np.float64)
    y = np.convolve(x, np.asarray(taps, np.float64))[: len(x)]
    return y[::deci]


def _fm_chain_f64(xr, xi, taps, deci, gain, dc=0.0):
    t = np.asarray(taps, np.float64)
    yr = _fir_deci_f64(xr, taps, deci) + dc * t.sum()
    yi = _fir_deci_f64(xi, taps, deci) + dc * t.sum()
    y = yr + 1j * yi
    d = np.conj(y[:-1]) * y[1:]
    return gain * np.arctan2(d.imag, d.real)


def _wire(rng, n):
    """Planes on the 8-bit (u8 - 127)/128 wire grid: exact in bf16."""
    return (rng.randint(0, 256, n).astype(np.float32) - 127.0) / 128.0


def _taps(ntaps, cutoff=0.2):
    return np.asarray(
        np.hamming(ntaps) * np.sinc(cutoff * (np.arange(ntaps) - ntaps // 2)),
        np.float32,
    )


# (deci, ntaps, n): several programs at 16 rows plus ragged tails, odd
# lengths, deci 1 and 4, a non-power-of-two deci (padded tile columns),
# long taps, and the 1-tap chain (the bare discriminator)
_SHAPES = [(4, 49, 2 * 128 * 4 + 123), (1, 31, 3001), (3, 50, 4097),
           (4, 130, 9000), (1, 1, 2000), (2, 2, 999)]


@pytest.mark.parametrize("precision", ["highest", "w3"])
@pytest.mark.parametrize("deci,ntaps,n", _SHAPES)
def test_fm_kernel_matches_f64(small_blocks, precision, deci, ntaps, n):
    rng = np.random.RandomState(3 + deci + ntaps)
    a, b = _wire(rng, n), _wire(rng, n)
    taps = _taps(ntaps)
    got = np.asarray(fc.fm_chain_kernel(a, b, taps, deci, 0.9, precision))
    want = _fm_chain_f64(a, b, taps, deci, 0.9)
    assert got.shape == want.shape
    # fast_atan2 polynomial: |err| < ~1e-4 rad, plus f32 accumulation
    np.testing.assert_allclose(got, want, atol=3e-4)


@pytest.mark.parametrize("precision", ["highest", "w3"])
def test_fm_kernel_offset_fold(small_blocks, precision):
    # DC offset folds in post-filter: filter(x + c) = filter(x) + c*sum(taps)
    rng = np.random.RandomState(4)
    n = 128 * 4 * 3 + 7
    a, b = _wire(rng, n), _wire(rng, n)
    taps = np.asarray(np.hamming(33), np.float32)
    c = 0.3125
    got = np.asarray(fc.fm_chain_kernel(a, b, taps, 4, 1.0, precision, c))
    want = _fm_chain_f64(a, b, taps, 4, 1.0, dc=c)
    np.testing.assert_allclose(got, want, atol=3e-4)


def test_fm_kernel_bf16_planes_equal_rounded_f32(small_blocks):
    # w3 rounds f32 planes to bf16 in registers, so a producer that writes
    # bf16 planes gets the same audio bit for bit
    import jax.numpy as jnp

    rng = np.random.RandomState(5)
    a = (0.3 * rng.randn(3000)).astype(np.float32)
    b = (0.3 * rng.randn(3000)).astype(np.float32)
    taps = _taps(49)
    f32 = np.asarray(fc.fm_chain_kernel(a, b, taps, 4, 1.0, "w3"))
    b16 = np.asarray(fc.fm_chain_kernel(jnp.asarray(a, jnp.bfloat16),
                                        jnp.asarray(b, jnp.bfloat16), taps, 4,
                                        1.0, "w3"))
    np.testing.assert_array_equal(f32, b16)


def test_fm_kernel_block_size_invariant(interpret_kernels, monkeypatch):
    # each output's accumulation order is fixed by the taps, not the
    # program size: every block size gives the same bits
    rng = np.random.RandomState(6)
    a, b = _wire(rng, 5000), _wire(rng, 5000)
    taps = _taps(49)
    outs = []
    for rows in (16, 64):
        monkeypatch.setattr(fc, "ROWS", rows)
        outs.append(np.asarray(fc.fm_chain_kernel(a, b, taps, 4, 1.0, "highest")))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_fm_kernel_short_input(interpret_kernels):
    # fewer than two filtered samples: no demod output at all
    taps = _taps(9)
    got = fc.fm_chain_kernel(np.ones(3, np.float32), np.ones(3, np.float32),
                             taps, 4, 1.0)
    assert got.shape == (0,)
    got = fc.fm_chain_kernel(np.ones(5, np.float32), np.ones(5, np.float32),
                             taps, 4, 1.0)
    assert got.shape == (1,)


def test_fm_kernel_equals_plain_form(small_blocks):
    # the dispatch's two forms agree within the fast-atan2 budget
    rng = np.random.RandomState(7)
    a, b = _wire(rng, 4096), _wire(rng, 4096)
    taps = _taps(49)
    k = np.asarray(fc.fm_chain_kernel(a, b, taps, 4, 1.0, "w3"))
    p = np.asarray(fc.fm_chain_plain(a, b, taps, 4, 1.0, "w3"))
    np.testing.assert_allclose(k, p, atol=2e-4)


def test_tap_rows_layout():
    # T_0[i, c] = taps[(c + 1)*deci + ntaps - 1 - i] makes y[t0 + c] from a
    # row x[base + i]; T_1 is the same one output earlier; the three bf16
    # terms of each sum back to the f32 taps
    taps = np.arange(1, 8, dtype=np.float32)  # 7 taps, exact in bf16
    t = fc._toeplitz(taps, 3, *fc._geometry(7, 3)).astype(np.float32)
    assert t.shape == (6, 64, 16)
    t0, t1 = t[0:3].sum(axis=0), t[3:6].sum(axis=0)
    np.testing.assert_array_equal(t0[:, 0][:11], [0, 0, 0, 7, 6, 5, 4, 3, 2, 1, 0])
    np.testing.assert_array_equal(t1[:, 0][:8], [7, 6, 5, 4, 3, 2, 1, 0])
    # T_1 is T_0 one output earlier; one output later is deci samples later
    np.testing.assert_array_equal(t1[:, 1:], t0[:, :-1])
    np.testing.assert_array_equal(t0[3:, 1:], t0[:-3, :-1])
    # a row of input, filtered through the matrices, is the direct FIR
    rng = np.random.RandomState(2)
    x = rng.randn(200)
    base, t_0 = 30, (30 + 6) // 3 + 1  # base = (t0 - 1)*deci - (ntaps - 1)
    row = x[base : base + 64]
    for c in range(16):
        want = sum(taps[j] * x[(t_0 + c) * 3 - j] for j in range(7))
        np.testing.assert_allclose(row @ t0[:, c], want, rtol=1e-6)
        want = sum(taps[j] * x[(t_0 + c - 1) * 3 - j] for j in range(7))
        np.testing.assert_allclose(row @ t1[:, c], want, rtol=1e-6)


@pytest.mark.parametrize("ntaps,deci,want", [
    (49, 4, (16, 128)),    # the bench chain: 2x load redundancy
    (49, 1, (64, 128)),    # rtl_fm's chain: P grows to fill the span
    (1, 1, (16, 32)),
    (50, 3, (16, 128)),
    (240, 1, (16, 256)),
])
def test_kernel_geometry(ntaps, deci, want):
    p, k = fc._geometry(ntaps, deci)
    assert (p, k) == want
    assert p >= 16 and p * deci + ntaps <= k


@pytest.mark.parametrize(
    "taps,deci,precision,want",
    [
        (np.ones(49, np.float32), 4, "w3", True),
        (np.ones(49, np.float32), 4, "highest", True),
        (np.ones(49, np.float32), 4, "i8", False),  # plain form only
        (np.ones(49, np.complex64) * (1 + 1j), 4, "w3", False),
        (np.ones(fc.KERNEL_MAX_SPAN, np.float32), 4, "w3", False),
        (np.ones(192, np.float32), 4, "w3", True),   # span 256 at deci 4
        (np.ones(112, np.float32), 1, "w3", True),   # span 128 at deci 1
        (np.ones(113, np.float32), 1, "w3", False),  # span 256 at deci 1
    ],
)
def test_fm_chain_dispatch(interpret_kernels, taps, deci, precision, want):
    assert fc.kernel_takes(taps, deci, precision) is want


def test_fm_chain_dispatch_cpu_takes_plain():
    # without the interpreter, the CPU never runs the kernel
    assert fc.kernel_takes(np.ones(49, np.float32), 4, "w3") is False


def test_fm_chain_rejects_unknown_precision():
    with pytest.raises(ValueError):
        fc.fm_chain(np.ones(64, np.float32), np.ones(64, np.float32),
                    np.ones(9, np.float32), 4, precision="w2")


# ---------------------------------------------------------------- lowering

def _demod_f64(y, gain):
    d = np.conj(y[:-1].astype(np.complex128)) * y[1:].astype(np.complex128)
    return gain * np.arctan2(d.imag, d.real)


def _fir_valid_f64(x, taps, deci):
    x = np.asarray(x, np.complex128)
    t = np.asarray(taps, np.float64)
    m = (len(x) - len(t)) // deci + 1
    return np.stack(
        [np.dot(t[::-1], x[k * deci : k * deci + len(t)]) for k in range(m)]
    )


def test_graph_fm_lowering_offline(interpret_kernels):
    # [FloatToComplex ->] FirFilter -> QuadratureDemod lowers to ONE
    # fused kernel call; output matches the f64
    # composed chain within the kernel's documented fast-atan2 budget.
    from rustradio_tpu import blocks
    from rustradio_tpu.graph import Graph
    from rustradio_tpu.lowering import find_fm_pairs

    rng = np.random.RandomState(7)
    taps = rng.randn(49).astype(np.float32) / 7
    n = 4096
    re = rng.randn(n).astype(np.float32)
    im = rng.randn(n).astype(np.float32)
    want = _demod_f64(_fir_valid_f64(re + 1j * im, taps, 4), 2.5)

    # pattern A: complex stream in
    g = Graph()
    s = blocks.VectorSink()
    g.chain(
        blocks.VectorSource((re + 1j * im).astype(np.complex64)),
        blocks.FirFilter(taps, deci=4),
        blocks.QuadratureDemod(2.5),
        s,
    )
    seg = list(g._segments().values())[0]
    plans, consumed = find_fm_pairs(seg, set())
    assert len(plans) == 1 and len(consumed) == 2
    g.run()
    got = np.asarray(s.data())
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=3e-4)

    # pattern B: planes in, the complex stream never materializes
    g = Graph()
    s = blocks.VectorSink()
    src_r = g.add(blocks.VectorSource(re))
    src_i = g.add(blocks.VectorSource(im))
    f2c = g.add(blocks.FloatToComplex(), src_r, src_i)
    fir = g.add(blocks.FirFilter(taps, deci=4), f2c)
    q = g.add(blocks.QuadratureDemod(2.5), fir)
    g.add(s, q)
    seg = list(g._segments().values())[0]
    plans, consumed = find_fm_pairs(seg, set())
    assert len(plans) == 1 and len(consumed) == 3
    assert next(iter(plans.values()))["f2c"] is not None
    g.run()
    got = np.asarray(s.data())
    np.testing.assert_allclose(got, want, atol=3e-4)


def test_graph_fm_lowering_streaming_equals_offline(interpret_kernels):
    # chunked lowered execution over the ORIGINAL blocks' states matches
    # the lowered offline stream (seam samples recomputed by full-window
    # dots differ from the in-kernel accumulation by <1e-5)
    from rustradio_tpu import blocks
    from rustradio_tpu.graph import Graph

    rng = np.random.RandomState(8)
    taps = rng.randn(49).astype(np.float32) / 7
    n = 6000
    data = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)

    def build(sink):
        g = Graph()
        g.chain(
            blocks.VectorSource(data),
            blocks.FirFilter(taps, deci=4),
            blocks.QuadratureDemod(1.0),
            sink,
        )
        return g

    s0 = blocks.VectorSink()
    build(s0).run()
    want = np.asarray(s0.data())
    for chunk in (2048, 1900):
        s = blocks.VectorSink()
        build(s).run_stream(chunk_size=chunk)
        got = np.asarray(s.data())
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_graph_fm_lowering_streaming_w3_off_grid(interpret_kernels):
    # under w3 the kernel rounds the planes to bf16; the seam samples and
    # the carried demod state must be rounded the same way, so chunked
    # output equals offline output even for input off the 8-bit grid
    from rustradio_tpu import blocks
    from rustradio_tpu.graph import Graph

    rng = np.random.RandomState(10)
    taps = rng.randn(49).astype(np.float32) / 7
    data = (rng.randn(6000) + 1j * rng.randn(6000)).astype(np.complex64)

    def run(chunk):
        g = Graph()
        s = blocks.VectorSink()
        g.chain(blocks.VectorSource(data),
                blocks.FirFilter(taps, deci=4, precision="w3"),
                blocks.QuadratureDemod(1.0), s)
        if chunk:
            g.run_stream(chunk_size=chunk)
        else:
            g.run()
        return np.asarray(s.data())

    want = run(None)
    for chunk in (2048, 1900):
        got = run(chunk)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_graph_fm_lowering_skips_tee_consumer(interpret_kernels):
    # a mid-pattern consumer (Tee on the filtered stream) blocks the
    # lowering; the composed path still runs and stays correct
    from rustradio_tpu import blocks
    from rustradio_tpu.graph import Graph
    from rustradio_tpu.lowering import find_fm_pairs

    rng = np.random.RandomState(9)
    taps = rng.randn(33).astype(np.float32) / 5
    data = (rng.randn(3000) + 1j * rng.randn(3000)).astype(np.complex64)
    g = Graph()
    s1, s2 = blocks.VectorSink(), blocks.VectorSink()
    src = g.add(blocks.VectorSource(data))
    fir = g.add(blocks.FirFilter(taps, deci=2), src)
    tee = g.add(blocks.Tee(), fir)
    q = g.add(blocks.QuadratureDemod(1.0), tee[0])
    g.add(s1, q)
    g.add(blocks.ComplexToMag2(), tee[1])
    g.add(s2, g.nodes[-1])
    for seg in g._segments().values():
        plans, _ = find_fm_pairs(seg, set())
        assert plans == {}
    g.run()
    want = _demod_f64(_fir_valid_f64(data, taps, 2), 1.0)
    np.testing.assert_allclose(np.asarray(s1.data()), want, atol=3e-4)


def test_graph_fm_lowering_takes_complex_stored_taps(interpret_kernels):
    # low_pass_complex designs are real taps stored as complex64: the
    # lowering still fuses them, with the real part as the kernel's taps
    from rustradio_tpu import blocks
    from rustradio_tpu import taps as tg
    from rustradio_tpu.graph import Graph
    from rustradio_tpu.lowering import find_fm_pairs

    lp = np.asarray(tg.low_pass_complex(1_024_000.0, 100_000.0, 50_000.0))
    rng = np.random.RandomState(12)
    data = (rng.randn(4000) + 1j * rng.randn(4000)).astype(np.complex64)
    g = Graph()
    s = blocks.VectorSink()
    g.chain(blocks.VectorSource(data), blocks.FirFilter(lp, deci=4),
            blocks.QuadratureDemod(1.0), s)
    plans, _ = find_fm_pairs(list(g._segments().values())[0], set())
    assert len(plans) == 1
    assert next(iter(plans.values()))["taps"].dtype == np.float32
    g.run()
    want = _demod_f64(_fir_valid_f64(data, np.real(lp), 4), 1.0)
    np.testing.assert_allclose(np.asarray(s.data()), want, atol=3e-4)
