"""FIR filtering.

Reference semantics (src/fir.rs):

* ``Fir::new`` reverses taps (src/fir.rs:156-161); ``filter(&input[i..])``
  computes ``sum_j taps[j] * input[i + ntaps-1 - j]`` — i.e. the stream
  output is ``y[m] = sum_j taps[j] * x[m*deci + ntaps-1 - j]``, a "valid"
  convolution decimated from phase 0 (src/fir.rs:166-194, work():489-547).
* ``FftFilter`` instead computes the *full* zero-history convolution
  ``y[n] = sum_k taps[k] * x[n-k]`` with ``x[<0]=0`` (overlap-add,
  src/fft_filter.rs:289-354).  ``fir_filter_full`` provides the same
  alignment so the two are interchangeable.

Both run as XLA's own forms.  ``fir_filter`` is always a strided
``conv_general_dilated`` at HIGHEST precision (decimation is the conv
stride, not a post-gather): its result does not depend on how a stream is
chunked, which FirFilter's streaming == offline contract needs.
``fir_filter_full`` takes the conv up to ``CONV_MAX_TAPS_PER_DECI * deci``
taps and overlap-save FFT (ops.fft_filter) above it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _conv1d(x, taps, stride: int = 1, pad_left: int = 0):
    """Correlate x with reversed taps via XLA conv. Returns float/complex 1-D.

    Computes z[m] = sum_j taps[j] * xpad[m*stride + ntaps-1 - j]
    where xpad = [zeros(pad_left), x].
    """
    x = jnp.asarray(x)
    if isinstance(taps, np.ndarray) and np.iscomplexobj(taps) and not np.any(np.imag(taps)):
        taps = np.real(taps)  # real designs stored complex: two convs, not four
    taps = jnp.asarray(taps)
    if jnp.iscomplexobj(x) and not jnp.iscomplexobj(taps):
        return jax.lax.complex(
            _conv1d(jnp.real(x), taps, stride, pad_left),
            _conv1d(jnp.imag(x), taps, stride, pad_left),
        )
    if jnp.iscomplexobj(x) or jnp.iscomplexobj(taps):
        # XLA conv doesn't take complex on all backends; expand to real pairs:
        # (xr + i xi) * (tr + i ti) -> (xr*tr - xi*ti) + i(xr*ti + xi*tr)
        xr, xi = jnp.real(x).astype(jnp.float32), jnp.imag(x).astype(jnp.float32)
        tr, ti = jnp.real(taps).astype(jnp.float32), jnp.imag(taps).astype(jnp.float32)
        rr = _conv1d(xr, tr, stride, pad_left)
        ii = _conv1d(xi, ti, stride, pad_left)
        ri = _conv1d(xr, ti, stride, pad_left)
        ir = _conv1d(xi, tr, stride, pad_left)
        return jax.lax.complex(rr - ii, ri + ir)
    x = x.astype(jnp.float32)
    taps = taps.astype(jnp.float32)
    # conv_general_dilated computes correlation with the kernel as given;
    # we want sum_j taps[j] x[t + ntaps-1-j] = correlation with reversed taps.
    lhs = x[None, None, :]  # NCW
    rhs = taps[::-1][None, None, :]  # OIW
    out = jax.lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(stride,),
        padding=[(pad_left, 0)],
        dimension_numbers=("NCW", "OIW", "NCW"),
        preferred_element_type=jnp.float32,
        # f32 convs may run in TF32 by default (~1e-3 relative);
        # HIGHEST keeps full f32.
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[0, 0]


#: Direct conv up to this many taps per unit of decimation, overlap-save
#: above: a strided conv's work per input sample grows with ntaps/deci,
#: overlap-save's hardly at all.  On an H100 (2^22 samples) the conv wins
#: at 5 taps / deci 1 and 17 taps / deci 4 and loses at 9 / deci 1 and
#: 33 / deci 4 (PERF.md).
CONV_MAX_TAPS_PER_DECI = 6


def use_conv(ntaps: int, deci: int = 1) -> bool:
    """Whether fir_filter_full takes the direct conv (else overlap-save)."""
    return ntaps <= CONV_MAX_TAPS_PER_DECI * deci


def fir_filter(x, taps, deci: int = 1):
    """Valid-mode decimating FIR: y[m] = sum_j taps[j] x[m*deci + ntaps-1-j].

    Matches the reference FirFilter stream semantics (src/fir.rs:489-547):
    output length ``(N - ntaps)//deci + 1`` for N >= ntaps.
    """
    n = x.shape[0]
    ntaps = len(taps)
    if n < ntaps:
        raise ValueError(f"input {n} shorter than taps {ntaps}")
    m = (n - ntaps) // deci + 1
    y = _conv1d(x, taps, stride=deci, pad_left=0)
    return y[:m]


def fir_filter_full(x, taps, deci: int = 1):
    """Zero-history full convolution: y[m] = sum_j taps[j] x[m*deci - j].

    Same alignment as the reference FftFilter (src/fft_filter.rs:289-354);
    output length ceil(N/deci) (== N when deci == 1).
    """
    n = x.shape[0]
    ntaps = len(taps)
    m = -(-n // deci)
    if not use_conv(ntaps, deci):
        from .fft_filter import fft_filter, fft_filter_decimate

        if deci & (deci - 1):
            # the spectrum fold needs deci | fft_size (a power of two)
            y = fft_filter(x, taps)[::deci]
        else:
            y = fft_filter_decimate(x, taps, deci)
        if not (jnp.iscomplexobj(x) or np.iscomplexobj(taps)):
            y = jnp.real(y)
        return y[:m]
    y = _conv1d(x, taps, stride=deci, pad_left=ntaps - 1)
    return y[:m]


def fir_filter_translating(x, taps, samp_rate: float, freq: float, deci: int = 1):
    """Frequency-translating FIR (reference src/fir.rs:413-483).

    Mixes the input by ``-freq`` Hz while filtering: equivalent to
    ``fir_filter(x * exp(-2j*pi*freq/samp_rate * n), taps, deci)``.
    Implemented exactly like the reference: taps pre-rotated by +freq so
    only one rotator per *output* sample is needed
    (src/fir.rs:427-459, translate_output :461-470).
    """
    taps = np.asarray(taps, np.complex64)
    ntaps = len(taps)
    if freq == 0.0:
        return fir_filter(x, taps, deci)
    input_step = 2.0 * np.pi * float(freq) / float(samp_rate)
    # Pre-rotate taps (rotator advances across taps).
    rot = np.exp(1j * input_step * np.arange(ntaps)).astype(np.complex64)
    taps_rot = (taps * rot).astype(np.complex64)
    y = fir_filter(x, taps_rot, deci)
    # Per-output rotator: first output aligned with newest sample of the
    # first window (index ntaps-1), advancing deci inputs per output.
    # Phases are reduced mod 2π in float64 BEFORE the f32 cast jnp applies
    # with x64 disabled — raw phases reach |step|·deci·m and an f32 cast
    # there costs ~2^-23·|phase| radians (measured 4e-3 rad by m ≈ 12k).
    m = y.shape[0]
    phases = np.mod(
        (-input_step) * (ntaps - 1 + deci * np.arange(m, dtype=np.float64)),
        2.0 * np.pi,
    )
    rotator = jnp.exp(1j * jnp.asarray(phases, np.float32)).astype(jnp.complex64)
    return y * rotator
