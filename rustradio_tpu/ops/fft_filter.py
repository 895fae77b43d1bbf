"""FFT fast convolution (overlap-save).

The reference implements overlap-ADD with fft_size = 2*next_pow2(ntaps)
(src/fft_filter.rs:36-42), taps pre-FFT'd with 1/N normalization folded in
(:151-161), tail carried between rounds (:336-348).  Its stream output is
the full zero-history convolution ``y[n] = sum_k taps[k] x[n-k]``.

Here overlap-SAVE maps better: one batched FFT over a reshaped
(nblocks, fft_size) array, pointwise multiply with the tap spectrum,
batched IFFT, then a static slice — no scatter-add dependency chain between
blocks, so every block is independent and the whole thing is one big
batched kernel.  The fft_size is auto-tuned to a few times the tap count
(bounded at 32768) rather than the reference's fixed 2*next_pow2.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _pick_fft_size(ntaps: int, n: int) -> int:
    """Pick an FFT size: at least 2*next_pow2(ntaps) like the reference,
    but grow up to 32768 while it reduces total work for large inputs."""
    base = 2 * _next_pow2(ntaps)
    best = base
    size = base
    while size < 32768 and size * 2 - (ntaps - 1) < n:
        size *= 2
        best = size
    return best


def overlap_save_frames(x, overlap: int, hop: int):
    """Frame x (left-padded with `overlap` zeros) into overlapping windows of
    length overlap+hop with the given hop, using only reshapes/slices (no
    gather).  Requires overlap <= hop.  Returns (frames, nblocks)."""
    n = x.shape[0]
    nblocks = -(-n // hop)
    total = nblocks * hop
    xp = jnp.pad(x, (overlap, total + overlap - n))
    # xp layout: [zeros(overlap) | x | pad]; frame b = xp[b*hop : b*hop+fft]
    rows = xp[:total].reshape(nblocks, hop)  # first hop samples of each frame
    heads = jnp.concatenate(
        [rows[1:, :overlap], xp[total : total + overlap][None, :]], axis=0
    )  # trailing overlap samples of each frame
    frames = jnp.concatenate([rows, heads], axis=1)
    return frames, nblocks


def fft_filter(x, taps, fft_size: int | None = None):
    """Full zero-history convolution via overlap-save batched FFT.

    y[n] = sum_k taps[k] * x[n-k], x[<0] = 0; len(y) == len(x).
    Matches reference FftFilter output (src/fft_filter.rs:289-354) to
    float32 FFT accuracy.
    """
    x = jnp.asarray(x)
    taps = np.asarray(taps)
    n = x.shape[0]
    ntaps = len(taps)
    overlap = ntaps - 1
    if fft_size is None:
        fft_size = _pick_fft_size(ntaps, n)
    hop = fft_size - overlap
    frames, _ = overlap_save_frames(x, overlap, hop)
    taps_fft = jnp.asarray(
        np.fft.fft(np.asarray(taps, np.complex128), fft_size).astype(np.complex64)
    )
    spec = jnp.fft.fft(frames.astype(jnp.complex64), axis=-1)
    conv = jnp.fft.ifft(spec * taps_fft[None, :], axis=-1)
    # Valid region of each frame: the last `hop` samples.
    y = conv[:, overlap:].reshape(-1)[:n]
    return y


def fft_filter_decimate(x, taps, deci: int, fft_size: int | None = None):
    """Fused filter + decimation in the frequency domain.

    Computes ``fft_filter(x, taps)[::deci]`` with zero gathers: decimation
    in time is spectrum aliasing, so each overlap-save frame folds its
    spectrum ``deci``-fold and takes a ``fft_size/deci``-point IFFT — less
    FFT work than the undecimated filter and contiguous outputs.
    """
    if deci == 1:
        return fft_filter(x, taps, fft_size)
    x = jnp.asarray(x)
    taps = np.asarray(taps)
    n = x.shape[0]
    ntaps = len(taps)
    overlap = ntaps - 1
    if fft_size is None:
        fft_size = max(_pick_fft_size(ntaps, n), 4 * deci)
    if fft_size % deci:
        raise ValueError(f"fft_size {fft_size} not divisible by deci {deci}")
    # hop must be a multiple of deci so every frame starts on the global
    # decimation grid; then the frame-local overlap o' = fft_size - hop is
    # also a deci multiple (fft_size % deci == 0), so the in-frame grid is
    # t = o' + deci*j with no fractional phase.
    hop = (fft_size - overlap) // deci * deci
    o2 = fft_size - hop
    if hop <= 0 or o2 > hop:
        raise ValueError("fft_size too small for taps and deci")
    frames, nblocks = overlap_save_frames(x, o2, hop)
    taps_fft = np.fft.fft(np.asarray(taps, np.complex128), fft_size)
    h = jnp.asarray((taps_fft / deci).astype(np.complex64))
    spec = jnp.fft.fft(frames.astype(jnp.complex64), axis=-1) * h[None, :]
    # Decimation in time == aliasing in frequency: fold deci-fold, small IFFT.
    folded = spec.reshape(nblocks, deci, fft_size // deci).sum(axis=1)
    w = jnp.fft.ifft(folded, axis=-1)  # w[b, u] = z_b[deci*u]
    ofs = o2 // deci
    y = w[:, ofs : ofs + hop // deci].reshape(-1)
    m = -(-n // deci)
    return y[:m]


def filter_float(x, taps, fft_size: int | None = None):
    """Real-taps filter, same semantics as ``fft_filter_float`` (zero
    history, y[m] = sum_j taps[j] x[m-j]): a direct conv for short
    filters (``fir.use_conv``), overlap-save above."""
    from .fir import fir_filter_full, use_conv

    taps = np.asarray(taps)
    if fft_size is None and not np.iscomplexobj(taps) and use_conv(len(taps)):
        return fir_filter_full(jnp.asarray(x, jnp.float32), taps)
    return fft_filter_float(x, taps, fft_size)


def filter_complex(x, taps, fft_size: int | None = None):
    """Complex-stream filter, same semantics as ``fft_filter`` (zero
    history): a direct conv for short filters (``fir.use_conv``),
    overlap-save above."""
    from .fir import fir_filter_full, use_conv

    taps = np.asarray(taps)
    if fft_size is None and use_conv(len(taps)):
        return fir_filter_full(jnp.asarray(x, jnp.complex64), taps)
    return fft_filter(x, taps, fft_size)


def fft_filter_float(x, taps, fft_size: int | None = None):
    """Float-in/float-out FFT filter (reference FftFilterFloat,
    src/fft_filter.rs:357-491, which runs the complex filter and takes re).

    Real input uses rfft/irfft — half the FFT work of the reference's
    complex-filter-in-a-trenchcoat approach."""
    taps = np.asarray(taps)
    if np.iscomplexobj(taps):  # reference takes float taps; guard anyway
        y = fft_filter(jnp.asarray(x, jnp.float32).astype(jnp.complex64), taps, fft_size)
        return jnp.real(y)
    x = jnp.asarray(x, jnp.float32)
    n = x.shape[0]
    ntaps = len(taps)
    overlap = ntaps - 1
    if fft_size is None:
        fft_size = _pick_fft_size(ntaps, n)
    hop = fft_size - overlap
    frames, _ = overlap_save_frames(x, overlap, hop)
    taps_fft = jnp.asarray(
        np.fft.rfft(np.asarray(taps, np.float64), fft_size).astype(np.complex64)
    )
    spec = jnp.fft.rfft(frames, axis=-1)
    conv = jnp.fft.irfft(spec * taps_fft[None, :], n=fft_size, axis=-1)
    return conv[:, overlap:].reshape(-1)[:n]
