"""IIR filters.

* ``single_pole_iir`` — y[n] = alpha*x[n] + (1-alpha)*y[n-1], y[-1]=0
  (reference src/single_pole_iir_filter.rs:31-44).  A linear first-order
  recurrence: parallelized with ``jax.lax.associative_scan`` (log-depth on
  the device instead of the reference's sample-serial loop).
* ``iir_filter`` — the reference's odd "IIR" (src/iir_filter.rs:84-101):
  ret = taps[0]*x[n] + sum_i taps[i+1]*y[n-1-i]; general order, via scan.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def single_pole_iir(x, alpha: float, y0=None):
    """First-order low-pass; log-depth associative scan.

    y[n] = alpha*x[n] + (1-alpha)*y[n-1].  ``y0`` is the carried previous
    output (scalar) for streaming; defaults to 0.
    """
    if not (0.0 <= alpha <= 1.0):
        raise ValueError(f"alpha {alpha} out of [0,1]")
    x = jnp.asarray(x)
    a = jnp.asarray(alpha, x.dtype if not jnp.iscomplexobj(x) else jnp.float32)
    one_m = jnp.asarray(1.0 - alpha, a.dtype)
    # y[n] = one_m * y[n-1] + a*x[n]  ==  composition of affine maps
    # (m, b): y -> m*y + b, composed left-to-right with associative_scan.
    m0 = jnp.full(x.shape, one_m, dtype=a.dtype)
    b0 = (x * a).astype(x.dtype)

    def compose(l, r):
        ml, bl = l
        mr, br = r
        return ml * mr, bl * mr + br

    m, b = jax.lax.associative_scan(compose, (m0, b0))
    if y0 is None:
        return b
    return jnp.asarray(y0, x.dtype) * m.astype(x.dtype) + b


def iir_filter(x, taps, history=None):
    """Reference IirFilter (src/iir_filter.rs:84-101), order len(taps)-1.

    y[n] = taps[0]*x[n] + sum_{i>=1} taps[i]*y[n-i]; history (most recent
    first) may be provided for streaming.  Sequential lax.scan.
    """
    taps = np.asarray(taps, np.float32)
    order = len(taps) - 1
    x = jnp.asarray(x, jnp.float32)
    if order == 0:
        return x * taps[0]
    h0 = (
        jnp.zeros(order, jnp.float32)
        if history is None
        else jnp.asarray(history, jnp.float32)
    )
    fb = jnp.asarray(taps[1:])  # feedback taps, index i -> y[n-1-i]

    def step(h, xn):
        # f32 dots may run in TF32 by default; a feedback path compounds
        # that error sample after sample, so ask for full f32
        yn = taps[0] * xn + jnp.dot(fb, h, precision=jax.lax.Precision.HIGHEST)
        h = jnp.concatenate([yn[None], h[:-1]])
        return h, yn

    _, y = jax.lax.scan(step, h0, x)
    return y
