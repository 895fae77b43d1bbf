"""Rational resampler (no filtering, like the reference).

Reference algorithm (src/rational_resampler.rs:154-206): counter += interp
per input; emit current sample while counter > 0, counter -= deci.  Closed
form: after consuming i+1 inputs the cumulative output count is
ceil((i+1)*interp/deci), so output k comes from input floor(k*deci/interp).
Total outputs for N inputs: ceil(N*interp/deci).

Here it is a pure gather with a statically computable index map —
trivially parallel, unlike the reference's sequential counter loop.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np


def _reduce(interp: int, deci: int) -> tuple[int, int]:
    g = math.gcd(interp, deci)
    return interp // g, deci // g


def resampler_indices(n: int, interp: int, deci: int) -> np.ndarray:
    """Input index for each output sample; host-side (static shapes)."""
    interp, deci = _reduce(interp, deci)
    m = -(-n * interp // deci)  # ceil
    k = np.arange(m, dtype=np.int64)
    return (k * deci) // interp


def rational_resampler(x, interp: int, deci: int):
    """out[k] = x[floor(k*deci/interp)], len = ceil(N*interp/deci)."""
    interp, deci = _reduce(interp, deci)
    if interp == 1 and deci == 1:
        return jnp.asarray(x)
    n = x.shape[0]
    if deci % interp == 0:
        return jnp.asarray(x)[:: deci // interp]
    if interp % deci == 0:
        # Pure interpolation: repeat, no gather.
        r = interp // deci
        return jnp.repeat(jnp.asarray(x), r, axis=0, total_repeat_length=n * r)
    idx = jnp.asarray(resampler_indices(n, interp, deci))
    return jnp.take(jnp.asarray(x), idx, axis=0)
