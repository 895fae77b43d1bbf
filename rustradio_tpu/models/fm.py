"""FM receive chains (the reference's rtl_fm.rs example path).

``fm_demod_chain_planar`` is the framework's headline benchmark chain:
channel low-pass + decimation + quadrature demod (ops.fm_chain) — the
Msamples/s metric in bench.py runs this.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import taps as tapgen
from .. import ops


def chain_taps(samp_rate: float = 1_024_000.0, cutoff: float = 100_000.0,
               twidth: float = 50_000.0) -> np.ndarray:
    """The chain's channel low-pass as real f32 taps; the defaults give
    the 49-tap bench design (reference benches/bench_rustradio.rs)."""
    return np.real(np.asarray(
        tapgen.low_pass_complex(samp_rate, cutoff, twidth, "hamming"))
    ).astype(np.float32)


@functools.partial(
    jax.jit, static_argnames=("samp_rate", "cutoff", "twidth", "deci", "gain")
)
def fm_demod_chain(
    iq,
    samp_rate: float = 1_024_000.0,
    cutoff: float = 100_000.0,
    twidth: float = 50_000.0,
    deci: int = 4,
    gain: float = 1.0,
):
    """IQ -> FM audio: channel low-pass + decimation + exact quadrature
    demod (ops.fm_chain_plain on every platform; the fast-atan2 kernel
    is ``fm_demod_chain_planar``'s)."""
    x = jnp.asarray(iq, jnp.complex64)
    return ops.fm_chain_plain(jnp.real(x), jnp.imag(x),
                              chain_taps(samp_rate, cutoff, twidth), deci, gain)


@functools.partial(
    jax.jit,
    static_argnames=("samp_rate", "cutoff", "twidth", "deci", "gain",
                     "precision"),
)
def fm_demod_chain_planar(
    i,
    q,
    samp_rate: float = 1_024_000.0,
    cutoff: float = 100_000.0,
    twidth: float = 50_000.0,
    deci: int = 4,
    gain: float = 1.0,
    precision: str = "highest",
    dc_offset: float = 0.0,
):
    """Planar-input FM chain: separate I/Q streams (the SDR wire format).

    Runs ops.fm_chain — on the GPU one fused kernel that reads the two
    planes once and writes the audio once.  For 8-bit-sourced data on
    the (u8-127)/128 wire grid pass ``precision="w3"`` (bf16 planes,
    exact there) or ``"i8"`` (the s8 wire grid), with any DC convention
    (e.g. (x-127.4)/128) riding ``dc_offset``: it folds in after the
    filter, exactly.
    """
    return ops.fm_chain(i, q, chain_taps(samp_rate, cutoff, twidth), deci,
                        gain, precision, dc_offset)


@functools.partial(jax.jit, static_argnames=("samp_rate", "audio_rate", "volume"))
def _am_rx(iq, samp_rate, audio_rate, volume):
    lp = tapgen.low_pass_complex(samp_rate, 12_500.0, 10_000.0, "hamming")
    x = ops.filter_complex(iq, lp)
    env = jnp.abs(x)
    lp2 = tapgen.low_pass(samp_rate, audio_rate, 500.0, "hamming")
    audio = ops.filter_float(env, lp2)
    audio = ops.rational_resampler(audio, int(audio_rate), int(samp_rate))
    return audio * jnp.float32(volume)


def am_rx(
    iq,
    samp_rate: float,
    audio_rate: float = 48_000.0,
    volume: float = 1.0,
):
    """AM receiver (reference examples/airspy_am_decode.rs:48-83):
    12.5 kHz channel filter -> envelope (|x|) -> audio low-pass ->
    resample to audio rate -> volume.  One jit."""
    return _am_rx(jnp.asarray(iq), float(samp_rate), float(audio_rate), float(volume))


def wbfm_rx(
    iq,
    samp_rate: float,
    audio_rate: float = 48_000.0,
    channel_width: float = 100_000.0,
):
    """Broadcast WBFM: channelize, demod, resample to audio, deemphasize.
    One jit."""
    return _wbfm_rx(jnp.asarray(iq), float(samp_rate), float(audio_rate), float(channel_width))


@functools.partial(
    jax.jit, static_argnames=("samp_rate", "audio_rate", "channel_width")
)
def _wbfm_rx(iq, samp_rate, audio_rate, channel_width):
    lp = tapgen.low_pass_complex(samp_rate, channel_width, channel_width / 4, "hamming")
    x = ops.filter_complex(iq, lp)
    quad_rate = samp_rate
    demod = ops.quadrature_demod(x, float(quad_rate / (2 * np.pi * 75_000.0)))
    audio = ops.rational_resampler(demod, int(audio_rate), int(samp_rate))
    # 75 us deemphasis single-pole IIR
    dt = 1.0 / audio_rate
    alpha = float(dt / (75e-6 + dt))
    return ops.single_pole_iir(audio, alpha)
