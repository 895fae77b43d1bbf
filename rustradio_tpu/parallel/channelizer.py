"""Polyphase filterbank channelizer + per-channel demod bank.

Not present in the reference (its graphs are single-chain; SURVEY §2.6 item
6 calls this out as the channel-parallel dimension the model allows), but
it is the canonical wideband workload: the polyphase FIR is L row-shifted
FMAs, the channel combine is one batched FFT, and the per-channel demod
bank is vmapped — with the channel axis shardable across devices.

Semantics: channel k of ``pfb_channelize(x, taps, M)`` equals the DDC
``decimate_M(lowpass_h(x * exp(-2j pi k t / M)))`` with zero history:

    y_k[n] = sum_j h[j] * x[n*M - j] * exp(2j pi k j / M)

(the classic critically-sampled PFB identity).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

def channelizer_taps(n_channels: int, taps_per_branch: int = 8, atten_frac: float = 0.4):
    """Prototype lowpass for an M-channel PFB: cutoff at atten_frac of the
    channel spacing, length M * taps_per_branch (windowed sinc at fs=1)."""
    ntaps = n_channels * taps_per_branch
    h = _windowed_sinc(ntaps, atten_frac / n_channels)
    return (h / h.sum()).astype(np.float32)


def _windowed_sinc(ntaps: int, cutoff: float) -> np.ndarray:
    n = np.arange(ntaps) - (ntaps - 1) / 2.0
    h = np.sinc(2 * cutoff * n)
    return (h * np.hamming(ntaps)).astype(np.float32)


def pfb_channelize(x, taps, n_channels: int):
    """Critically-sampled polyphase channelizer.

    Returns (nframes, n_channels) complex64; channel k is centered at
    k * fs / M (wrapping to negative frequencies above M/2).

    Formulation: the branch FIR is L row-shifted elementwise FMAs on the
    (nframes, M) frame matrix (exact f32, fused by XLA), instead of a
    feature_group_count=M grouped conv whose groups of one channel map
    poorly to matrix units.  The channel combine is one batched IFFT
    along the channel axis.
    """
    M = n_channels
    x = jnp.asarray(x, jnp.complex64)
    taps = np.asarray(taps, np.float32)
    if len(taps) % M:
        taps = np.pad(taps, (0, M - len(taps) % M))
    L = len(taps) // M
    n = x.shape[0]
    nframes = n // M
    # Frame decomposition: f[i, m] = x[i*M - m], via a left pad of M-1 and
    # a reshape with reversed columns.
    xq = jnp.pad(x, (M - 1, 0))[: nframes * M]
    f = xq.reshape(nframes, M)[:, ::-1]  # (nframes, M)
    # Per-branch causal FIR: v[i, m] = sum_l h[l*M + m] * f[i-l, m] —
    # L shifted rows, each scaled by its tap row (exact f32 FMAs).
    h = taps.reshape(L, M)  # h[l, m]
    acc = jnp.zeros_like(f)
    for l in range(L):
        fl = jnp.pad(f, ((l, 0), (0, 0)))[:nframes]
        acc = acc + h[l] * fl
    # y_k[i] = sum_m e^{2 pi i k m / M} v[i, m]  ==  M * IFFT over m
    # (cuFFT on the GPU; a dense DFT matmul measured slower, PERF.md).
    return jnp.fft.ifft(acc, axis=1) * M  # (nframes, M)


def channelizer_fm_bank(x, taps, n_channels: int, gain: float = 1.0):
    """Wideband FM bank: channelize then FM-demod every channel.

    Returns (nframes-1, n_channels) float32 — the aggregate-Msps headline
    workload (BASELINE.json config 5).
    """
    ch = pfb_channelize(x, taps, n_channels)  # (nframes, M)
    d = jnp.conj(ch[:-1, :]) * ch[1:, :]
    return jnp.float32(gain) * jnp.arctan2(
        jnp.imag(d).astype(jnp.float32), jnp.real(d).astype(jnp.float32)
    )


def sharded_channelizer_fm(x, taps, n_channels: int, mesh, gain: float = 1.0,
                           axis: str = "chan"):
    """Channel-sharded FM bank: the PFB front half runs replicated on the
    time axis; the channel FFT output is resharded over ``axis`` and each
    shard demodulates its channels.  For a 1-D mesh this is a shard_map
    over the channel dimension of the channelized matrix."""
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    ch = pfb_channelize(x, taps, n_channels)  # (nframes, M)

    def demod(block):  # block: (nframes, M/n_shards)
        d = jnp.conj(block[:-1, :]) * block[1:, :]
        return jnp.float32(gain) * jnp.arctan2(
            jnp.imag(d).astype(jnp.float32), jnp.real(d).astype(jnp.float32)
        )

    f = shard_map(demod, mesh=mesh, in_specs=(P(None, axis),), out_specs=P(None, axis))
    return f(ch)
