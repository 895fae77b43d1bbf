"""Signal sources (reference src/signal_source.rs).

The reference advances phase *before* emitting each sample and outputs
Complex(sin(t), sin(t - pi/2)) == sin(t) - i*cos(t)
(src/signal_source.rs:38-50).  We generate the phase ramp directly:
t[n] = (n+1) * rad_per_sample  (mod 2*pi), computed at f64-equivalent
accuracy by taking the multiple mod 2*pi on the host grid.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _phases(n: int, samp_rate: float, freq: float, offset: int) -> jnp.ndarray:
    rad = 2.0 * np.pi * float(freq) / float(samp_rate)
    # (offset+1 .. offset+n) * rad mod 2pi, computed in float64 on host grid
    # to avoid f32 phase drift over long streams.
    k = np.arange(1, n + 1, dtype=np.float64) + float(offset)
    return jnp.asarray(np.mod(k * rad, 2.0 * np.pi), jnp.float32)


# jitted tails (one fused dispatch); amplitude is traced so
# offsets/gains don't recompile.
@jax.jit
def _sig_c(t, amplitude):
    return amplitude * jax.lax.complex(jnp.sin(t), -jnp.cos(t))


@jax.jit
def _sig_f(t, amplitude):
    return amplitude * jnp.sin(t)


def signal_source_c(
    n: int, samp_rate: float, freq: float, amplitude: float = 1.0, offset: int = 0
):
    """Complex sine: amplitude * (sin t - i cos t), t advancing per sample."""
    t = _phases(n, samp_rate, freq, offset)
    return _sig_c(t, jnp.float32(amplitude))


def signal_source_f(
    n: int, samp_rate: float, freq: float, amplitude: float = 1.0, offset: int = 0
):
    """Real sine: amplitude * sin(t)."""
    t = _phases(n, samp_rate, freq, offset)
    return _sig_f(t, jnp.float32(amplitude))
