"""Filter blocks with exact streaming state carry."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import ops
from .. import taps as tapgen
from ..streams import Tag
from .base import Block


class FirFilter(Block):
    """Decimating FIR, valid-conv alignment (reference src/fir.rs:485-547).

    Streaming: carries unconsumed raw input so chunked == offline exactly.
    Optional fused frequency translation (reference src/fir.rs:413-483).
    """

    def __init__(self, taps, deci: int = 1, translate: tuple[float, float] | None = None,
                 precision: str = "highest"):
        self.taps = np.asarray(taps)
        self.deci = deci
        self.translate = translate
        # Precision mode used when the segment lowering fuses this filter
        # into the FM kernel (see lowering.py and ops.fm_chain's precision
        # table — "w3"/"i8" are exact only for 8-bit-sourced wire grids).
        # Non-lowered paths always run the f32 form.
        self.precision = precision

    def shard_fn(self, di):
        """Mesh plan: valid-conv windows realigned to the global stream.

        With ``di`` zero samples prepended at stream start, the streaming
        output grid (windows starting at multiples of ``deci`` in true
        stream coordinates) sits at mesh positions ``≡ di (mod deci)``;
        ``q0`` places the halo-extended window on that grid and the
        first ``(di + ntaps - 1) // deci`` outputs (windows touching the
        zero prefix) are masked by the runner."""
        from .base import ShardFn
        from ..ops.fir import fir_filter

        ntaps, d = len(self.taps), self.deci
        h = ntaps - 1
        q0 = (di + h) % d
        taps = self.taps

        if self.translate is not None:
            sr, fq = self.translate
            step = 2.0 * np.pi * float(fq) / float(sr)

            def prep(in0: int) -> float:
                # fir_filter_translating on the local array phases its
                # rotator for window END at local index ntaps-1 + deci*p;
                # the true stream window end is in0 + k*L + q0 + deci*p
                # - di + ntaps - 1, so the correction phase is
                # -step*(in0 + k*L + q0 - di - (ntaps-1)).  This is the
                # chunk part, reduced mod 2π in float64.
                return float(np.mod(-step * (in0 + q0 - di - h), 2.0 * np.pi))

            def fn(ext, n_local, ctx):
                import math

                from ..ops.fir import fir_filter_translating

                y = fir_filter_translating(ext[q0:], taps, sr, fq, d)
                y = y[: n_local // d]
                # per-shard part of the correction: k * (-step * L) mod 2π
                phi_l = math.fmod(-step * float(n_local), 2.0 * math.pi)
                phase = ctx.aux + ctx.k.astype(jnp.float32) * jnp.float32(phi_l)
                return y * jnp.exp(1j * phase).astype(y.dtype)
        else:
            prep = None

            def fn(ext, n_local, ctx):
                return fir_filter(ext[q0:], taps, d)[: n_local // d]

        return ShardFn(halo=h, d_out=(di + h) // d, div=d, fn=fn, prep=prep)

    def shard_total_out(self, n):
        return max(0, (n - len(self.taps)) // self.deci + 1)

    def shard_state(self, tail, consumed):
        """apply_chunk's state (unconsumed raw buffer + output offset)
        after ``consumed`` samples: emitted windows cover w*deci inputs."""
        w = self.shard_total_out(consumed)
        buf_len = consumed - w * self.deci
        h = len(self.taps) - 1
        buf = jnp.asarray(tail)[h - buf_len :] if buf_len else jnp.zeros(
            0, self.taps.dtype
        )
        return {"buf": buf, "out_off": w}

    def apply(self, x):
        if self.translate is not None:
            sr, fq = self.translate
            return ops.fir_filter_translating(x, self.taps, sr, fq, self.deci)
        return ops.fir_filter(x, self.taps, self.deci)

    def init_state(self):
        return {"buf": np.zeros(0, self.taps.dtype), "out_off": 0}

    def apply_chunk(self, state, x):
        ntaps = len(self.taps)
        buf = jnp.concatenate(
            [jnp.asarray(state["buf"], jnp.asarray(x).dtype), jnp.asarray(x)]
        )
        n_avail = buf.shape[0]
        out_off = state["out_off"]
        if n_avail < ntaps:
            return {"buf": buf, "out_off": out_off}, jnp.zeros(0, buf.dtype)
        n_out = (n_avail - ntaps) // self.deci + 1
        consumed = n_out * self.deci
        if self.translate is not None:
            sr, fq = self.translate
            y = ops.fir_filter_translating(buf, self.taps, sr, fq, self.deci)
            # fix rotator phase for the global output offset (mod 2π in
            # float64 on the host — the raw product overflows f32)
            step = -2.0 * np.pi * fq / sr * self.deci
            ph = np.mod(step * out_off, 2.0 * np.pi)
            y = y * jnp.exp(1j * jnp.float32(ph)).astype(y.dtype)
        else:
            y = ops.fir_filter(buf, self.taps, self.deci)
        return {"buf": buf[consumed:], "out_off": out_off + int(n_out)}, y


class FftFilter(Block):
    """Fast-convolution filter, full-conv alignment
    (reference src/fft_filter.rs:289-354)."""

    def __init__(self, taps, fft_size: int | None = None):
        self.taps = np.asarray(taps)
        self.fft_size = fft_size

    @property
    def shard_halo(self):
        return len(self.taps) - 1  # zero-history full conv: state == tail

    def apply(self, x):
        return ops.filter_complex(x, self.taps, self.fft_size)

    def init_state(self):
        return jnp.zeros(len(self.taps) - 1, jnp.complex64)

    def apply_chunk(self, state, x):
        ntaps = len(self.taps)
        ext = jnp.concatenate([jnp.asarray(state, jnp.complex64), jnp.asarray(x, jnp.complex64)])
        y = ops.filter_complex(ext, self.taps, self.fft_size)[ntaps - 1 :]
        return ext[-(ntaps - 1) :], y


class FftFilterFloat(Block):
    """Float fast-convolution (reference src/fft_filter.rs:357-491)."""

    def __init__(self, taps, fft_size: int | None = None):
        self.taps = np.asarray(taps, np.float32)
        self.fft_size = fft_size

    @property
    def shard_halo(self):
        return len(self.taps) - 1  # zero-history full conv: state == tail

    def apply(self, x):
        return ops.filter_float(x, self.taps, self.fft_size)

    def init_state(self):
        return jnp.zeros(len(self.taps) - 1, jnp.float32)

    def apply_chunk(self, state, x):
        ntaps = len(self.taps)
        ext = jnp.concatenate([jnp.asarray(state, jnp.float32), jnp.asarray(x, jnp.float32)])
        y = ops.filter_float(ext, self.taps, self.fft_size)[ntaps - 1 :]
        return ext[-(ntaps - 1) :], y


class Hilbert(Block):
    """Hilbert transformer (reference src/hilbert.rs:68-125)."""

    def __init__(self, ntaps: int = 65, window: str = "hamming"):
        if ntaps % 2 != 1:
            raise ValueError("hilbert filter len must be odd")
        self.ntaps = ntaps
        self.taps = tapgen.hilbert(ntaps, window)

    @property
    def shard_halo(self):
        return self.ntaps  # reference keeps ntaps history (src/hilbert.rs)

    def apply(self, x):
        return ops.hilbert_transform(x, self.ntaps, taps=self.taps)

    def init_state(self):
        return jnp.zeros(self.ntaps, jnp.float32)

    def apply_chunk(self, state, x):
        x = jnp.asarray(x, jnp.float32)
        ext = jnp.concatenate([jnp.asarray(state, jnp.float32), x])
        n = x.shape[0]
        import jax

        # The same conv as ops.hilbert_transform, so streaming is bitwise
        # offline: the demod downstream amplifies even 1e-7 differences at
        # near-zero-magnitude samples.
        from ..ops.fir import _conv1d

        y_im = _conv1d(ext, self.taps, stride=1, pad_left=0)[:n]
        d = self.ntaps - self.ntaps // 2
        y_re = ext[self.ntaps - d : self.ntaps - d + n]
        return ext[-self.ntaps :], jax.lax.complex(y_re, y_im)


class SinglePoleIirFilter(Block):
    """y += alpha (x - y) (reference src/single_pole_iir_filter.rs)."""

    def __init__(self, alpha: float):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha out of range")
        self.alpha = alpha

    def apply(self, x):
        return ops.single_pole_iir(x, self.alpha)

    def init_state(self):
        return None  # y0 carried lazily (dtype depends on stream)

    def apply_chunk(self, state, x):
        y = ops.single_pole_iir(x, self.alpha, y0=state)
        return y[-1], y


class IqBalance(Block):
    """DC offset removal: out = x - running_mean(x)
    (reference src/iq_balance.rs:50-78: mean = mean*(1-a) + x*a, out = x - mean)."""

    def __init__(self, alpha: float | None = None, sample_rate: float | None = None, tau: float = 0.2):
        if alpha is None:
            if sample_rate is None:
                raise ValueError("need alpha or sample_rate")
            alpha = float(np.clip(1.0 - np.exp(-1.0 / (tau * sample_rate)), 0.0, 1.0))
        self.alpha = float(np.clip(alpha, 0.0, 1.0))

    def apply(self, x):
        x = jnp.asarray(x)
        return x - ops.single_pole_iir(x, self.alpha)

    def init_state(self):
        return None

    def apply_chunk(self, state, x):
        x = jnp.asarray(x)
        m = ops.single_pole_iir(x, self.alpha, y0=state)
        return m[-1], x - m
