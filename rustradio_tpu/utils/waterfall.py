"""Spectrogram / waterfall rendering (the reference's UI visualizations:
rustradio-ui plots and the rtl_fm ratatui waterfall, examples/rtl_fm.rs:81-120).

Device side: one batched FFT over framed samples -> dB power matrix.
Host side: render to ASCII (terminal waterfall) — no display deps needed.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("fft_size", "hop", "window"))
def _spectrogram_jit(x, fft_size: int, hop: int, window: str):
    n = x.shape[0]
    nframes = max((n - fft_size) // hop + 1, 0)
    if nframes == 0:
        return jnp.zeros((0, fft_size), jnp.float32)
    if hop == fft_size:
        # gather-free framing for the common non-overlapping case
        frames = x[: nframes * fft_size].reshape(nframes, fft_size)
    else:
        idx = np.arange(nframes)[:, None] * hop + np.arange(fft_size)[None, :]
        frames = jnp.take(x, jnp.asarray(idx), axis=0)
    w = jnp.asarray(getattr(np, window)(fft_size).astype(np.float32))
    spec = jnp.fft.fftshift(jnp.fft.fft(frames * w, axis=-1), axes=-1)
    p = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
    return 10.0 * jnp.log10(p + jnp.float32(1e-20))


def spectrogram(x, fft_size: int = 1024, hop: int | None = None, window: str = "hanning"):
    """Returns (nframes, fft_size) power in dB, DC-centered."""
    hop = hop or fft_size
    return _spectrogram_jit(jnp.asarray(x, jnp.complex64), fft_size, hop, window)


_RAMP = " .:-=+*#%@"


def render_ascii(db: np.ndarray, width: int = 80, height: int = 24,
                 floor: float | None = None, ceil: float | None = None) -> str:
    """Render a dB matrix as an ASCII waterfall."""
    db = np.asarray(db)
    if db.size == 0:
        return "(no data)"
    # resample to (height, width)
    ri = np.linspace(0, db.shape[0] - 1, height).astype(int)
    ci = np.linspace(0, db.shape[1] - 1, width).astype(int)
    img = db[np.ix_(ri, ci)]
    lo = floor if floor is not None else np.percentile(img, 10)
    hi = ceil if ceil is not None else img.max()
    t = np.clip((img - lo) / max(hi - lo, 1e-9), 0, 1)
    chars = (t * (len(_RAMP) - 1)).astype(int)
    return "\n".join("".join(_RAMP[c] for c in row) for row in chars)
