"""FM chain numerics on the plain (XLA) form, fast_atan2, and the FIR
dispatch between direct conv and overlap-save.  The kernel form is covered
in tests/test_pallas_interpret.py."""

import numpy as np
import pytest

from rustradio_tpu import ops
from rustradio_tpu.ops.demod import fast_atan2
from rustradio_tpu.ops.fir import CONV_MAX_TAPS_PER_DECI, _conv1d, use_conv


def test_fast_atan2_accuracy():
    rng = np.random.RandomState(0)
    y = rng.randn(10000).astype(np.float32)
    x = rng.randn(10000).astype(np.float32)
    got = np.asarray(fast_atan2(y, x))
    want = np.arctan2(y, x)
    assert np.abs(got - want).max() < 2e-4


def test_fast_atan2_axes():
    # exact axes and quadrant boundaries
    pts = [(0.0, 1.0, 0.0), (1.0, 0.0, np.pi / 2), (0.0, -1.0, np.pi),
           (-1.0, 0.0, -np.pi / 2), (1.0, 1.0, np.pi / 4)]
    for y, x, want in pts:
        got = float(np.asarray(fast_atan2(np.float32(y), np.float32(x))))
        assert abs(got - want) < 2e-4, (y, x, got, want)


def _fir_full_f64(x, taps, deci):
    y = np.convolve(np.asarray(x, np.complex128), np.asarray(taps, np.complex128))
    return y[: len(x)][::deci]


@pytest.mark.parametrize("deci,ntaps", [(1, 5), (4, 8), (1, 9), (2, 33), (3, 49),
                                        (4, 49), (5, 128), (7, 300)])
def test_fir_filter_full_matches_f64(deci, ntaps):
    # both sides of the conv / overlap-save threshold, power-of-two and
    # other decimations, complex input
    rng = np.random.RandomState(deci * 1000 + ntaps)
    x = (rng.randn(5000) + 1j * rng.randn(5000)).astype(np.complex64)
    taps = (rng.randn(ntaps) / ntaps).astype(np.float32)
    got = np.asarray(ops.fir_filter_full(x, taps, deci))
    want = _fir_full_f64(x, taps, deci)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("ntaps", [4 * CONV_MAX_TAPS_PER_DECI, 4 * CONV_MAX_TAPS_PER_DECI + 1, 65])
def test_fir_filter_valid_real_matches_conv(ntaps):
    # valid alignment and a real output whatever the tap count
    rng = np.random.RandomState(ntaps)
    x = rng.randn(3001).astype(np.float32)
    taps = rng.randn(ntaps).astype(np.float32)
    got = np.asarray(ops.fir_filter(x, taps, 4))
    want = np.asarray(_conv1d(x, taps, stride=4))[: (len(x) - ntaps) // 4 + 1]
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("ntaps,deci,want", [(5, 1, True), (9, 1, False),
                                              (17, 4, True), (33, 4, False)])
def test_fir_dispatch_threshold(ntaps, deci, want):
    # the crossover measured on the card: conv cost grows with ntaps/deci
    assert use_conv(ntaps, deci) is want


def test_conv1d_real_taps_stored_complex():
    # a real design stored as complex64 (low_pass_complex) filters the
    # same as its real taps
    from rustradio_tpu import taps as tg

    rng = np.random.RandomState(2)
    lp = np.asarray(tg.low_pass_complex(1_024_000.0, 100_000.0, 50_000.0))
    x = (rng.randn(4096) + 1j * rng.randn(4096)).astype(np.complex64)
    got = np.asarray(_conv1d(x, lp, 4, len(lp) - 1))
    want = np.asarray(_conv1d(x, np.real(lp).astype(np.float32), 4, len(lp) - 1))
    np.testing.assert_array_equal(got, want)


def _chain_f64(xr, xi, lp, n, deci):
    x64 = xr.astype(np.float64) + 1j * xi.astype(np.float64)
    yd = np.convolve(x64, lp.astype(np.float64))[np.arange(-(-n // deci)) * deci]
    d = np.conj(yd[:-1]) * yd[1:]
    return np.arctan2(d.imag, d.real)


@pytest.mark.parametrize("precision", ["highest", "w3", "i8"])
def test_fm_chain_w3_parity_budget(precision):
    """Every precision stays within the framework's 1e-3 rad parity budget
    vs float64 on its contract domain: 8-bit-grid input (exact in bf16
    and on the s8 grid)."""
    from rustradio_tpu import taps as tg

    rng = np.random.RandomState(5)
    n = 1 << 15
    deci = 4
    lp = np.real(np.asarray(
        tg.low_pass_complex(1_024_000.0, 100_000.0, 50_000.0, "hamming"))
    ).astype(np.float32)
    # the rtl-sdr wire grid: (u8 - 127) / 128
    u8 = np.clip(np.round(0.3 * rng.randn(2, n) * 128 + 127), 0, 255)
    xr, xi = ((u8 - 127.0) / 128.0).astype(np.float32)
    got = np.asarray(ops.fm_chain(xr, xi, lp, deci, 1.0, precision))
    want = _chain_f64(xr, xi, lp, n, deci)
    assert got.shape == want.shape
    err = np.abs(got[8:-8] - want[8:-8]).max()
    assert err < 1e-3, err


def test_fm_chain_offset_folds_exactly():
    # filter(x + c) == filter(x) + c*sum(taps): the offset rides
    # post-filter.  Compared against float64 ground truth of the offset
    # signal with a DC-passing low-pass, so the filtered samples sit well
    # away from the atan2 singularity.
    from rustradio_tpu import taps as tg

    rng = np.random.RandomState(6)
    n = 1 << 13
    deci = 4
    lp = np.real(np.asarray(
        tg.low_pass_complex(1_024_000.0, 100_000.0, 50_000.0, "hamming"))
    ).astype(np.float32)
    xr = (0.2 * rng.randn(n)).astype(np.float32)
    xi = (0.2 * rng.randn(n)).astype(np.float32)
    c = 0.37
    got = np.asarray(ops.fm_chain(xr, xi, lp, deci, 1.0, dc_offset=c))
    want = _chain_f64(xr + c, xi + c, lp, n, deci)
    # skip the zero-history warm-up: the DC fold offsets the synthetic
    # history too (c*sum(taps) uniformly), while np.convolve's implied
    # history stays zero — they agree only once the filter fills
    warm = len(lp) // deci + 2
    np.testing.assert_allclose(got[warm:-8], want[warm:-8], atol=3e-4)


def test_fm_demod_chain_planar_equals_complex_entry():
    # the planar and complex entry points are the same chain
    from rustradio_tpu.models.fm import fm_demod_chain, fm_demod_chain_planar

    rng = np.random.RandomState(7)
    x = (0.3 * (rng.randn(8192) + 1j * rng.randn(8192))).astype(np.complex64)
    a = np.asarray(fm_demod_chain(x))
    b = np.asarray(fm_demod_chain_planar(x.real.copy(), x.imag.copy()))
    np.testing.assert_array_equal(a, b)
