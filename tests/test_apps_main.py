"""Run each CLI app's main() end-to-end with real files.

These are the closest analogue to executing the reference's
examples/*.rs binaries in CI: every app's file plumbing, flag handling,
and output writing runs for real (TX apps feed RX apps).
"""

import io
import os

import numpy as np
import pytest

from rustradio_tpu.apps import (
    am_decode,
    ax25_1200_rx,
    ax25_9600_wpcr,
    bell202_tx,
    burst_saver,
    capture,
    fm_tx,
    g3ruh,
    morse_beacon,
    rtl_fm,
    scanner,
    spectrum,
    tone,
)
from rustradio_tpu.io import au as au_io
from rustradio_tpu.io import rawfile


@pytest.fixture(scope="module")
def tone_c32(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tone") / "tone.c32")
    assert tone.main(["--freq", "5k", "--sample_rate", "48k",
                      "--seconds", "0.25", "--out", path]) == 0
    return path


def test_tone_writes_complex_sine(tone_c32):
    iq = rawfile.read_samples(tone_c32, "c32")
    assert len(iq) == 12_000
    spec = np.abs(np.fft.fft(iq))
    peak = np.fft.fftfreq(len(iq), 1 / 48_000.0)[int(np.argmax(spec))]
    assert abs(peak - 5_000.0) < 10


def test_spectrum_renders(tone_c32, capsys):
    assert spectrum.main(["-r", tone_c32, "--sample_rate", "48k",
                          "--fft_size", "256", "--width", "60",
                          "--height", "8"]) == 0
    assert capsys.readouterr().out.strip()


def test_capture_writes_sigmf(tone_c32, tmp_path):
    base = str(tmp_path / "cap")
    assert capture.main(["-r", tone_c32, "--sample_rate", "48k",
                         "--frequency", "145M", "--out", base]) == 0
    made = [f for f in os.listdir(tmp_path) if f.startswith("cap")]
    assert made, "SigMF output files expected"


def test_am_decode_runs(tone_c32, tmp_path):
    out = str(tmp_path / "audio.f32")
    assert am_decode.main(["-r", tone_c32, "-o", out,
                           "--sample_rate", "48k", "--audio_rate", "12k"]) == 0
    assert os.path.getsize(out) > 0


def test_morse_fm_rtl_fm_chain(tmp_path):
    # morse_beacon -> .au audio; fm_tx modulates it; rtl_fm demodulates back
    au_path = str(tmp_path / "morse.au")
    assert morse_beacon.main(["--msg", "hi", "--wpm", "25",
                              "--sample_rate", "12k", "--out", au_path]) == 0
    audio, rate = au_io.au_decode(open(au_path, "rb").read(), 12_000)
    assert len(audio) > 0

    iq_path = str(tmp_path / "fm.c32")
    assert fm_tx.main(["-r", au_path, "--sample_rate", "48k",
                       "--out", iq_path]) == 0
    assert os.path.getsize(iq_path) > 0

    out_au = str(tmp_path / "demod.au")
    assert rtl_fm.main(["-r", iq_path, "--sample_rate", "48k",
                        "--audio_rate", "12k", "--cutoff", "10k",
                        "--out", out_au]) == 0
    assert os.path.getsize(out_au) > 24


def test_bell202_tx_feeds_ax25_rx(tmp_path, monkeypatch, capsys):
    au_path = str(tmp_path / "aprs.au")
    monkeypatch.setattr("sys.stdin", io.StringIO("HELLO APP TEST\nSECOND LINE\n"))
    assert bell202_tx.main(["--src", "N0CALL", "--sample_rate", "24000",
                            "--out", au_path]) == 0
    outdir = str(tmp_path / "pkts")
    assert ax25_1200_rx.main(["-a", "-r", au_path, "-o", outdir,
                              "--sample_rate", "24k"]) == 0
    assert len(os.listdir(outdir)) == 2
    blobs = b"".join(
        open(os.path.join(outdir, f), "rb").read() for f in os.listdir(outdir)
    )
    assert b"HELLO APP TEST" in blobs and b"SECOND LINE" in blobs


def test_g3ruh_tx_feeds_9600_wpcr(tmp_path, capsys):
    # KISS frames -> g3ruh TX baseband -> ax25_9600_wpcr app decodes
    from rustradio_tpu.blocks.packets import KissEncode
    from rustradio_tpu.streams import Pdu

    payload = b"M0AAA>APRS:g3ruh app chain"
    kiss = KissEncode().apply([Pdu(np.frombuffer(payload, np.uint8))])
    kiss_path = str(tmp_path / "frames.kiss")
    with open(kiss_path, "wb") as f:
        f.write(np.asarray(kiss[0].data, np.uint8).tobytes())

    tx_path = str(tmp_path / "tx.c32")
    assert g3ruh.main(["--tx_in", kiss_path, "--tx_out", tx_path,
                       "--sample_rate", "50k"]) == 0
    # surround with silence so the burst gate sees edges
    iq = rawfile.read_samples(tx_path, "c32")
    padded = np.concatenate(
        [np.zeros(20_000, np.complex64), iq, np.zeros(20_000, np.complex64)]
    )
    rx_path = str(tmp_path / "rx.c32")
    rawfile.write_samples(rx_path, padded, "c32")
    outdir = str(tmp_path / "pkts")
    assert ax25_9600_wpcr.main(["-r", rx_path, "--sample_rate", "50k",
                                "-o", outdir]) == 0
    blobs = b"".join(
        open(os.path.join(outdir, f), "rb").read() for f in os.listdir(outdir)
    )
    assert payload in blobs


def test_burst_saver_writes_bursts(tmp_path):
    rng = np.random.RandomState(0)
    iq = np.zeros(60_000, np.complex64)
    iq[20_000:30_000] = (rng.randn(10_000) + 1j * rng.randn(10_000)).astype(
        np.complex64
    )
    path = str(tmp_path / "in.c32")
    rawfile.write_samples(path, iq, "c32")
    outdir = str(tmp_path / "bursts")
    os.makedirs(outdir)
    assert burst_saver.main(["-r", path, "-o", outdir, "--sample_rate", "60k",
                             "--threshold", "0.01", "--delay", "100",
                             "--tail", "200"]) == 0
    assert len(os.listdir(outdir)) >= 1


def test_scanner_file_mode_demods_channel(tone_c32, tmp_path, capsys):
    out = str(tmp_path / "ch.f32")
    # 5 kHz tone at fs=48k with 64 channels -> channel round(5k/750)
    assert scanner.main(["-r", tone_c32, "--sample_rate", "48k", "-n", "64",
                         "--top", "3", "--demod", "7", "-o", out]) == 0
    assert "chan" in capsys.readouterr().out
    assert os.path.getsize(out) > 0


def test_soapy_fm_sim(tmp_path, capsys):
    from rustradio_tpu.apps import soapy_fm
    from rustradio_tpu.io import au as au_io

    out = str(tmp_path / "fm.au")
    assert soapy_fm.main(["-d", "sim", "--freq", "100M", "-o", out,
                          "--sample_rate", "256k", "--audio_rate", "16k",
                          "--seconds", "0.5"]) == 0
    audio, rate = au_io.au_decode(open(out, "rb").read(), 16_000)
    assert len(audio) > 4_000
    # the sim FM carrier is modulated with a 1 kHz tone
    spec = np.abs(np.fft.rfft(audio[1000:5096]))
    peak_hz = np.argmax(spec[10:]) + 10
    peak_hz = peak_hz * 16_000 / 4096
    assert abs(peak_hz - 1_000.0) < 50


def test_pw_tone_file_backend(tmp_path):
    from rustradio_tpu.apps import pw_tone

    out = str(tmp_path / "tone.f32")
    assert pw_tone.main(["--freq", "2k", "--audio_rate", "16k",
                         "--seconds", "0.5", "--backend", "file",
                         "--out", out]) == 0
    audio = np.fromfile(out, "<f4")
    assert len(audio) == 8_000
    spec = np.abs(np.fft.rfft(audio))
    assert abs(np.argmax(spec) * 16_000 / len(audio) - 2_000.0) < 20


def test_rtl_fm_u8_fused_path(tmp_path):
    # u8 wire-format input takes the fused w3 planar path (bf16-exact
    # planes); the demodulated tone must match the c32 path's output
    fs = 256_000.0
    n = 1 << 16
    t = np.arange(n) / fs
    # FM carrier at baseband: 1 kHz tone, 10 kHz deviation
    ph = 2 * np.pi * 10_000.0 * np.cumsum(np.sin(2 * np.pi * 1000.0 * t)) / fs
    iq = (0.6 * np.exp(1j * ph)).astype(np.complex64)
    from rustradio_tpu.io import rawfile

    u8 = np.asarray(rawfile.rtlsdr_encode(iq))
    u8_path = str(tmp_path / "cap.u8")
    u8.tofile(u8_path)
    c32_path = str(tmp_path / "cap.c32")
    iq.tofile(c32_path)

    out_u8 = str(tmp_path / "a_u8.au")
    out_c32 = str(tmp_path / "a_c32.au")
    args = ["--sample_rate", "256k", "--audio_rate", "32k",
            "--cutoff", "25k", "--deviation", "10k"]
    assert rtl_fm.main(["-r", u8_path, "--rtl_u8", "--out", out_u8] + args) == 0
    assert rtl_fm.main(["-r", c32_path, "--out", out_c32] + args) == 0
    # the i8 path (the s8 wire grid, plain XLA form) recovers the same
    # audio (scale-invariant demod)
    out_i8 = str(tmp_path / "a_i8.au")
    assert rtl_fm.main(["-r", u8_path, "--rtl_u8", "--precision", "i8",
                        "--out", out_i8] + args) == 0
    a_i8, _ = au_io.au_decode(open(out_i8, "rb").read(), 32_000)
    a_u8, _ = au_io.au_decode(open(out_u8, "rb").read(), 32_000)
    a_c32, _ = au_io.au_decode(open(out_c32, "rb").read(), 32_000)
    m = min(len(a_u8), len(a_c32))
    assert m > 1000
    # same recovered audio up to 8-bit quantization noise + path skew
    corr = np.corrcoef(a_u8[200:m - 200], a_c32[200:m - 200])[0, 1]
    assert corr > 0.99, corr
    mi = min(len(a_i8), len(a_u8))
    corr_i8 = np.corrcoef(a_i8[200:mi - 200], a_u8[200:mi - 200])[0, 1]
    assert corr_i8 > 0.999, corr_i8
