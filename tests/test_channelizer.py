"""Polyphase channelizer vs explicit per-channel DDC."""

import jax
import numpy as np
import pytest

from rustradio_tpu.parallel.channelizer import (
    channelizer_fm_bank,
    channelizer_taps,
    pfb_channelize,
    sharded_channelizer_fm,
)


def ddc_reference(x, h, M, k):
    """Direct digital downconvert channel k: mix, filter, decimate."""
    n = len(x)
    t = np.arange(n)
    mixed = x * np.exp(-2j * np.pi * k * t / M)
    filt = np.convolve(mixed, h, mode="full")[:n]  # zero history
    return filt[::M]


def test_pfb_matches_ddc():
    M = 8
    rng = np.random.RandomState(0)
    x = (rng.randn(4096) + 1j * rng.randn(4096)).astype(np.complex64)
    h = channelizer_taps(M, taps_per_branch=6)
    y = np.asarray(pfb_channelize(x, h, M))
    assert y.shape == (4096 // M, M)
    for k in [0, 1, 3, 7]:
        want = ddc_reference(x, h, M, k)[: y.shape[0]]
        np.testing.assert_allclose(y[:, k], want, atol=1e-3)


def test_pfb_isolates_tones():
    # a tone centered in channel 5 of 16 appears only there
    M = 16
    fs = 16000.0
    n = 1 << 14
    t = np.arange(n) / fs
    k = 5
    x = np.exp(2j * np.pi * (k * fs / M) * t).astype(np.complex64)
    h = channelizer_taps(M, taps_per_branch=8)
    y = np.asarray(pfb_channelize(x, h, M))[20:, :]  # skip transient
    powers = np.abs(y).mean(axis=0)
    assert powers[k] > 10 * np.delete(powers, k).max()


def test_fm_bank_recovers_per_channel_audio():
    M = 8
    fs = 256_000.0
    n = 1 << 16
    t = np.arange(n) / fs
    # FM signals on channels 2 and 6 with different audio tones
    chans = {2: 700.0, 6: 1900.0}
    x = np.zeros(n, np.complex64)
    for k, fa in chans.items():
        audio = np.sin(2 * np.pi * fa * t)
        phase = 2 * np.pi * 4000.0 / fs * np.cumsum(audio)
        x += (np.exp(1j * (2 * np.pi * (k * fs / M) * t + phase))).astype(np.complex64)
    h = channelizer_taps(M, taps_per_branch=8)
    out = np.asarray(channelizer_fm_bank(x, h, M))
    ch_rate = fs / M
    for k, fa in chans.items():
        seg = out[100:, k]
        spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
        freqs = np.fft.rfftfreq(len(seg), 1 / ch_rate)
        peak = freqs[np.argmax(spec[1:]) + 1]
        assert abs(peak - fa) < 20, (k, fa, peak)
    # a quiet channel demodulates to noise with much less coherent tone
    quiet = out[100:, 0]
    assert np.abs(quiet).mean() < 10 * np.abs(out[100:, 2]).mean()


def test_sharded_channel_bank_matches_local():
    from rustradio_tpu.parallel import make_mesh

    M = 16
    rng = np.random.RandomState(1)
    x = (rng.randn(1 << 13) + 1j * rng.randn(1 << 13)).astype(np.complex64)
    h = channelizer_taps(M, taps_per_branch=4)
    mesh = make_mesh(8, axis="chan")
    got = np.asarray(sharded_channelizer_fm(x, h, M, mesh))
    want = np.asarray(channelizer_fm_bank(x, h, M))
    # per-shard demod loses the cross-shard sample at shard boundaries of
    # the TIME axis only; channels are independent so results match exactly
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_pfb_matches_f64_polyphase_256():
    # 256 channels against a float64 polyphase reference (branch FIR on the
    # reversed frame matrix, then an IDFT over the branches)
    rng = np.random.RandomState(7)
    M = 256
    x = (rng.randn(M * 64) + 1j * rng.randn(M * 64)).astype(np.complex64)
    h = channelizer_taps(M, taps_per_branch=4).astype(np.float64)
    got = np.asarray(pfb_channelize(x, h, M))
    nframes = len(x) // M
    xp = np.concatenate([np.zeros(M - 1), x.astype(np.complex128)])[: nframes * M]
    f = xp.reshape(nframes, M)[:, ::-1]
    hl = h.reshape(-1, M)
    v = sum(hl[l] * np.concatenate([np.zeros((l, M)), f])[:nframes]
            for l in range(hl.shape[0]))
    want = np.fft.ifft(v, axis=1) * M
    err = np.abs(got - want) / np.abs(want).max()
    assert err.max() < 1e-5
