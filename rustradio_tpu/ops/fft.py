"""FFT ops on PDUs and streams.

* ``fft_pdu`` — FFT one burst, optional window + fftshift (reference
  src/fft.rs:18-46; window/shift options live on the block there).
* ``fft_stream`` — frame a stream into size-N chunks and FFT each frame
  (reference src/fft_stream.rs:74-118); here this is one batched FFT over
  a (nframes, size) reshape instead of the reference's per-frame loop.
  Returns the flattened frame stream plus the number of frames; leftover
  samples (< size) are the caller's carry.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def fft_pdu(x, window=None, shift: bool = False):
    x = jnp.asarray(x, jnp.complex64)
    if window is not None:
        x = x * jnp.asarray(window, jnp.float32)
    y = jnp.fft.fft(x)
    if shift:
        y = jnp.fft.fftshift(y)
    return y


def fft_stream(x, size: int):
    """Batched FFT frames.  Returns (flat_output, nframes, leftover)."""
    if size <= 0:
        raise ValueError("FFT size must be nonzero")
    x = jnp.asarray(x, jnp.complex64)
    nframes = x.shape[0] // size
    frames = x[: nframes * size].reshape(nframes, size)
    out = jnp.fft.fft(frames, axis=-1)
    return out.reshape(-1), nframes, x[nframes * size :]
