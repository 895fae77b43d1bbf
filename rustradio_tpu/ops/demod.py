"""FM demodulation kernels.

* ``quadrature_demod`` — reference src/quadrature_demod.rs:46-113:
  y[n] = gain * atan2(im, re) of conj(x[n]) * x[n+1].  One-sample halo.
* ``fast_fm`` — reference src/quadrature_demod.rs:144-165 (Lyons p.760):
  y[n] = (x[n].im - x[n-2].im) * x[n-1].re - (x[n].re - x[n-2].re) * x[n-1].im
  with q1 = q2 = 0 at stream start.  Two-sample halo, no atan.

Both are pure elementwise math over shifted views, which XLA fuses into
one pass.  ``fast_atan2`` is the polynomial atan2 of the fused FM chain
(ops/fm.py), the trade the reference ships as its ``fast-math``
feature (src/quadrature_demod.rs:28-29).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_PI = np.float32(np.pi)


def _atan_poly(z):
    """Minimax-ish arctan approximation on [-1, 1] (|err| < 1e-4 rad),
    the classic 7th-order odd polynomial used by fast-math libraries."""
    z2 = z * z
    return z * (
        jnp.float32(0.9998660)
        + z2
        * (
            jnp.float32(-0.3302995)
            + z2 * (jnp.float32(0.1801410) + z2 * (jnp.float32(-0.0851330) + z2 * jnp.float32(0.0208351)))
        )
    )


def fast_atan2(y, x):
    """Branch-free atan2 via the octant reduction + odd polynomial."""
    abs_y = jnp.abs(y)
    abs_x = jnp.abs(x)
    # z in [0, 1]: ratio of smaller to larger magnitude
    mx = jnp.maximum(abs_x, abs_y)
    mn = jnp.minimum(abs_x, abs_y)
    z = mn / jnp.maximum(mx, jnp.float32(1e-37))
    a = _atan_poly(z)
    a = jnp.where(abs_y > abs_x, jnp.float32(np.pi / 2) - a, a)
    a = jnp.where(x < 0, _PI - a, a)
    return jnp.where(y < 0, -a, a)


def quadrature_demod(x, gain: float = 1.0):
    """y[n] = gain * arg(conj(x[n]) * x[n+1]); output length N-1."""
    x = jnp.asarray(x)
    d = jnp.conj(x[:-1]) * x[1:]
    return jnp.float32(gain) * jnp.arctan2(
        jnp.imag(d).astype(jnp.float32), jnp.real(d).astype(jnp.float32)
    )


def fast_fm(x):
    """FastFM discriminator; output length N, zero-initialized history.

    out[n] = (x[n].im - x[n-2].im) * x[n-1].re
           - (x[n].re - x[n-2].re) * x[n-1].im,  x[<0] = 0.
    """
    x = jnp.asarray(x)
    re = jnp.real(x).astype(jnp.float32)
    im = jnp.imag(x).astype(jnp.float32)
    re1 = jnp.pad(re, (1, 0))[:-1]  # x[n-1]
    im1 = jnp.pad(im, (1, 0))[:-1]
    re2 = jnp.pad(re, (2, 0))[:-2]  # x[n-2]
    im2 = jnp.pad(im, (2, 0))[:-2]
    return (im - im2) * re1 - (re - re2) * im1
