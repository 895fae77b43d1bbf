"""The FM receive chain on planar I/Q: decimating low-pass, then the
quadrature discriminator.

``fm_chain`` is the one entry point.  On the GPU it runs as one Pallas
kernel through the Triton route (``_fm_kernel``: the FIR as ``pl.dot``
on a Toeplitz tile, then the discriminator, in one pass) where
``kernel_takes`` says it wins; elsewhere as the plain XLA form
(``fm_chain_plain``).  Both keep the same numerical contract.

Output: ``m - 1`` samples, ``m = ceil(n / deci)``, where sample ``t - 1``
is ``gain * arg(conj(y[t-1]) y[t])`` and ``y[t] = sum_j taps[j]
x[t*deci - j]`` with zero history (``x[<0] = 0``), plus ``dc_offset *
sum(taps)`` on both planes: a DC offset of the input (the rtl-sdr 127.4
convention) folds in after the filter, by linearity.

``precision`` names what the planes are rounded to before the filter:

* ``"highest"`` — f32, the planes as given.
* ``"w3"`` — bf16.  Exact for 8-bit-sourced data on the (u8 - 127)/128
  wire grid (reference src/rtlsdr_decode.rs), so there it gives the same
  answer as ``"highest"`` while a bf16 plane is half the bytes.
* ``"i8"`` — the s8 wire grid, ``clip(round(128 x), -127, 128) / 128``:
  identity on 8-bit-sourced data, and the contract of a receiver that
  keeps its planes as int8.  Plain form only.

The filter accumulates in f32 in both forms; the kernel demodulates with
``fast_atan2`` (|err| < 1e-4 rad), the plain form with ``jnp.arctan2``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import backend
from .demod import fast_atan2, quadrature_demod

PRECISIONS = ("highest", "w3", "i8")

#: Longest tile row the kernel takes, in samples: a row holds the input
#: span of P outputs, P*deci + ntaps samples rounded up to a power of two;
#: and at most KERNEL_SPAN_PER_DECI samples of span per unit of
#: decimation.  Longer spans take the plain form: both limits are the
#: crossovers measured on an H100 (PERF.md).
KERNEL_MAX_SPAN = 256
KERNEL_SPAN_PER_DECI = 128

#: Tile rows per program (the dot's M side) at spans up to 128 samples;
#: longer spans take proportionally fewer, at least 16.
ROWS = 64


def round_planes(x, precision: str):
    """Planes as f32, rounded to what ``precision`` names."""
    x = jnp.asarray(x).astype(jnp.float32)
    if precision == "w3":
        return x.astype(jnp.bfloat16).astype(jnp.float32)
    if precision == "i8":
        return jnp.clip(jnp.round(x * 128), -127, 128) * jnp.float32(1 / 128)
    return x


def _real_taps(taps) -> np.ndarray:
    taps = np.asarray(taps)
    if np.iscomplexobj(taps):
        if np.any(np.imag(taps)):
            raise ValueError("the FM chain needs real taps")
        taps = np.real(taps)
    return taps.astype(np.float32)


def fm_chain_plain(xr, xi, taps, deci: int, gain: float = 1.0,
                   precision: str = "highest", dc_offset=0.0):
    """XLA form: rounded planes, decimating FIR on the complex stream
    (fir_filter_full picks direct conv or overlap-save; one complex FFT
    costs half of two real-plane ones), DC fold, demod."""
    from .fir import fir_filter_full

    taps = _real_taps(taps)
    dc = jnp.asarray(dc_offset, jnp.float32) * jnp.float32(np.sum(taps, dtype=np.float64))
    x = jax.lax.complex(round_planes(xr, precision), round_planes(xi, precision))
    y = fir_filter_full(x, taps, deci) + jax.lax.complex(dc, dc)
    return quadrature_demod(y, gain)


def _pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


def _geometry(ntaps: int, deci: int) -> tuple[int, int]:
    """(P, K): outputs per tile row and the row's span in samples, both
    powers of two, with P >= 16 (the dot's smallest side) and
    K >= P*deci + ntaps; P as large as K allows."""
    k = max(32, _pow2(16 * deci + ntaps))
    p = 16
    while 2 * p * deci + ntaps <= k:
        p *= 2
    return p, k


def _toeplitz(taps: np.ndarray, deci: int, p: int, k: int) -> np.ndarray:
    """(6, k, p) bf16 tap matrices for a tile row x[base + i], base =
    (t0 - 1)*deci - (ntaps - 1).  Matrix 3*s + b is term b of a 3-term
    bf16 split (f32 taps to ~24 bits) of T_s: column c of T_0 makes
    y[t0 + c], of T_1 makes y[t0 + c - 1], the discriminator's previous
    sample: T_s[i, c] = taps[(c + 1 - s)*deci + ntaps - 1 - i]."""
    ntaps = len(taps)
    i, c = np.ogrid[:k, :p]
    t = np.zeros((2, k, p), np.float32)
    for s in (0, 1):
        j = (c + 1 - s) * deci + ntaps - 1 - i
        ok = (j >= 0) & (j < ntaps)
        t[s][ok] = np.asarray(taps, np.float32)[j[ok]]
    terms = []
    for _ in range(3):
        hi = t.astype(jnp.bfloat16)
        terms.append(hi)
        t = t - hi.astype(np.float32)
    return np.stack(terms, axis=1).reshape(6, k, p)


def _fm_kernel(dc_ref, t_ref, xr_ref, xi_ref, out_ref, *, n, m, rows, p, k,
               deci, ntaps, gain, precision):
    """One program: rows x p outputs, row r holding t0 + [0, p) with
    t0 = (pid*rows + r)*p.

    Loads one (rows, k) tile per plane, row r the input span of its
    outputs, and filters it with ``pl.dot`` against the Toeplitz tap
    matrices on the tensor cores: planes in bf16 (one term under w3 or
    for bf16 planes; three under highest), taps in three bf16 terms,
    products of order <= 2 accumulated in f32, smallest first.  Zero
    history and the end of the stream are load masks."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    t0 = (pl.program_id(0) * rows + jnp.arange(rows, dtype=jnp.int32)) * p
    idx = ((t0 - 1) * deci - (ntaps - 1))[:, None] + jnp.arange(k, dtype=jnp.int32)[None, :]
    mask = (idx >= 0) & (idx < n)

    def plane_terms(ref):
        x = plgpu.load(ref.at[idx], mask=mask, other=0)
        if precision == "w3" or x.dtype == jnp.bfloat16:
            return [x.astype(jnp.bfloat16)]
        x = x.astype(jnp.float32)
        terms = []
        for _ in range(3):
            hi = x.astype(jnp.bfloat16)
            terms.append(hi)
            x = x - hi.astype(jnp.float32)
        return terms

    def fir(xs, s):
        acc = jnp.zeros((rows, p), jnp.float32)
        for order in (2, 1, 0):
            for a, x in enumerate(xs):
                if 0 <= order - a < 3:
                    acc = acc + pl.dot(x, t_ref[3 * s + order - a])
        return acc

    xr, xi = plane_terms(xr_ref), plane_terms(xi_ref)
    dc = dc_ref[0]
    yr, yi = fir(xr, 0) + dc, fir(xi, 0) + dc
    pr, pi = fir(xr, 1) + dc, fir(xi, 1) + dc
    audio = jnp.float32(gain) * fast_atan2(pr * yi - pi * yr, pr * yr + pi * yi)
    t = t0[:, None] + jnp.arange(p, dtype=jnp.int32)[None, :]
    plgpu.store(out_ref.at[jnp.maximum(t - 1, 0)], audio, mask=(t >= 1) & (t < m))


def fm_chain_kernel(xr, xi, taps, deci: int, gain: float = 1.0,
                    precision: str = "highest", dc_offset=0.0):
    """The fused kernel: both planes read once, f32 audio written once.

    Planes may be f32 or bf16; the kernel rounds them to ``precision`` in
    registers, so a producer that already writes bf16 planes halves the
    read bytes."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    if precision not in ("highest", "w3"):
        raise ValueError(f"the kernel takes highest or w3, not {precision!r}")
    taps = _real_taps(taps)
    xr, xi = jnp.asarray(xr), jnp.asarray(xi)
    n = xr.shape[0]
    m = -(-n // deci)
    if m < 2:
        return jnp.zeros(0, jnp.float32)
    p, k = _geometry(len(taps), deci)
    rows = max(16, min(ROWS, ROWS * 128 // k))
    dc = (jnp.asarray(dc_offset, jnp.float32)
          * jnp.float32(np.sum(taps, dtype=np.float64))).reshape(1)
    kern = functools.partial(
        _fm_kernel, n=n, m=m, rows=rows, p=p, k=k, deci=deci, ntaps=len(taps),
        gain=float(gain), precision=precision,
    )
    return pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((m - 1,), jnp.float32),
        grid=(pl.cdiv(m, rows * p),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4),
        interpret=backend.INTERPRET,
        name="fm_chain",
    )(dc, jnp.asarray(_toeplitz(taps, deci, p, k)), xr, xi)


def kernel_takes(taps, deci: int, precision: str) -> bool:
    """Whether fm_chain runs the kernel for this configuration."""
    taps = np.asarray(taps)
    return (
        backend.use_kernels()
        and precision in ("highest", "w3")
        and not (np.iscomplexobj(taps) and np.any(np.imag(taps)))
        and _geometry(len(taps), deci)[1]
        <= min(KERNEL_MAX_SPAN, KERNEL_SPAN_PER_DECI * deci)
    )


def fm_chain(xr, xi, taps, deci: int, gain: float = 1.0,
             precision: str = "highest", dc_offset=0.0):
    """Planar I/Q -> FM audio; the kernel where it runs, else plain XLA."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, not {precision!r}")
    if kernel_takes(taps, deci, precision):
        return fm_chain_kernel(xr, xi, taps, deci, gain, precision, dc_offset)
    return fm_chain_plain(xr, xi, taps, deci, gain, precision, dc_offset)
