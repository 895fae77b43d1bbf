"""Synthetic Bell-202 AX.25 corpus: the decode-rate gate's test signal.

The reference's quality gate decodes a 30-minute real capture
(tests/ax25-decode.rs:58-103) that is not redistributable.  This corpus
stands in for it: ``n`` frames of AFSK audio at 24 kHz, sweeping amplitude
(0.05-1.0), clock drift (±1.5%) and SNR (noise up to 0.4×amplitude),
generated from a seed.
"""

from __future__ import annotations

import numpy as np

from .. import ops

FS = 24_000.0


def nrzi_line(bits):
    """Transition-on-0 NRZI line (initial state arbitrary for the decoder)."""
    return (1 + np.cumsum(1 - np.asarray(bits))) % 2


def afsk(line, baud, amp, lead=400, fs=FS):
    """Bell-202 AFSK audio (mark 1200 Hz, space 2200 Hz) for an NRZI line,
    with ``lead`` zero samples before and after."""
    sps = fs / baud
    n = int(len(line) * sps)
    bit_at = np.minimum((np.arange(n) / sps).astype(int), len(line) - 1)
    freqs = np.where(line[bit_at] == 1, 1200.0, 2200.0)
    phase = np.cumsum(2 * np.pi * freqs / fs)
    a = (amp * np.sin(phase)).astype(np.float32)
    z = np.zeros(lead, np.float32)
    return np.concatenate([z, a, z])


def framed(payload: bytes):
    """HDLC-framed bits of a payload with its FCS."""
    return np.asarray(ops.hdlc_frame(ops.fcs_add(np.frombuffer(payload, np.uint8))))


def corpus(n: int = 1000, seed: int = 0):
    """(audio at FS, payloads): n frames laid end to end."""
    noises = [0.0, 0.15, 0.3, 0.35, 0.4]
    rng = np.random.RandomState(seed)
    parts, payloads = [], []
    for i in range(n):
        p = f"N0CALL-{i%16}>APRS:T#{i:04d} corpus {'y'*(i%29)}".encode()
        payloads.append(p)
        amp = 0.05 + 0.95 * (i % 10) / 9
        drift = ((i % 7) - 3) / 3 * 0.015
        x = afsk(nrzi_line(framed(p)), 1200.0 * (1 + drift), amp)
        parts.append(x + rng.randn(len(x)).astype(np.float32) * (noises[i % 5] * amp))
    return np.concatenate(parts), payloads
