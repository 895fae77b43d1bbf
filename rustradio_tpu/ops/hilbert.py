"""Hilbert transformer.

Reference semantics (src/hilbert.rs:68-125): history of ``ntaps`` zeros is
prepended to the stream; with xp = zeros(ntaps) ++ x,

    y[i] = Complex(xp[i + ntaps//2],  sum_j taps[j] * xp[i + ntaps-1 - j])

and len(y) == len(x).  The real part is the input delayed by
ntaps - ntaps//2 = ceil(ntaps/2) samples; the imaginary part is the FIR
output over the same zero-padded stream.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from .. import taps as tapgen
from .fir import _conv1d


def hilbert_transform(x, ntaps: int = 65, window: str = "hamming", taps=None):
    """Float stream -> complex analytic-ish stream, reference-aligned."""
    x = jnp.asarray(x, jnp.float32)
    if taps is None:
        taps = tapgen.hilbert(ntaps, window)
    ntaps = len(taps)
    n = x.shape[0]
    # Imag: FIR over zeros(ntaps) ++ x, windows ending inside the stream:
    # y_im[i] = sum_j taps[j] x[i-1-j].
    y_im = _conv1d(jnp.pad(x, (ntaps, 0)), taps, stride=1, pad_left=0)[:n]
    # Real: xp[i + ntaps//2] with xp = zeros(ntaps) ++ x
    # = x[i + ntaps//2 - ntaps] = x[i - (ntaps - ntaps//2)]
    d = ntaps - ntaps // 2
    y_re = jnp.pad(x, (d, 0))[:n]
    return jax.lax.complex(y_re, y_im)
