"""Source blocks (reference src/vector_source.rs, signal_source.rs,
constant_source.rs, file_source.rs)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import ops
from ..io import rawfile
from ..streams import Tag
from .base import SourceBlock


def _canonical(a: np.ndarray) -> np.ndarray:
    """Canonicalize to the framework's stream dtypes (Float=f32,
    Complex=c64, reference src/lib.rs:245-249): Python scalars otherwise
    infer float64/complex128 and change the wire format of host sinks."""
    if a.dtype == np.float64:
        return a.astype(np.float32)
    if a.dtype == np.complex128:
        return a.astype(np.complex64)
    if a.dtype == np.int64:
        return a.astype(np.int32)
    return a


class VectorSource(SourceBlock):
    """In-memory source with repeat + start/repeat/first tags
    (reference src/vector_source.rs:50-80)."""

    def __init__(self, data, repeat: int = 1, tags: list[Tag] | None = None):
        self.data = _canonical(np.asarray(data))
        self.repeat = repeat
        self.user_tags = list(tags or [])

    def total_len(self):
        return len(self.data) * self.repeat

    def emit(self, offset, n):
        total = self.total_len()
        idx = (np.arange(offset, offset + n)) % len(self.data)
        if offset + n > total:
            raise ValueError("emit past end of VectorSource")
        return self.data[idx]

    def prepare_traced(self):
        """EAGER device staging for the compiled loop (must happen
        outside the trace — caching a traced constant would leak the
        tracer into later compilations)."""
        if getattr(self, "_dev", None) is None:
            self._dev = jnp.asarray(self.data)

    def device_resident(self):
        """The staged device copy, handed to the compiled loop as a jit
        ARGUMENT rather than a constant baked into the program."""
        self.prepare_traced()
        return self._dev

    def emit_period(self):
        # the emit pattern repeats every len(data) samples: lets the
        # device loop keep its traced offsets inside int32
        return len(self.data)

    def emit_traced(self, offset, n, resident=None):
        """Traced emit for ``Graph.compile_device_loop``: ONE
        device-resident copy of the data, dynamic-sliced per chunk with a
        modular offset for ``repeat``.  Requires the chunk grid to tile
        the data (len(data) % n == 0 when the loop wraps), since
        dynamic_slice clamps rather than wraps."""
        import jax

        dev = resident if resident is not None else getattr(self, "_dev", None)
        if dev is None:
            # un-prepared use inside someone else's trace: build the
            # constant but only CACHE it outside a trace (a cached
            # tracer would leak into later compilations)
            dev = jnp.asarray(self.data)
            try:
                if jax.core.trace_state_clean():
                    self._dev = dev
            except AttributeError:
                pass
        m = len(self.data)
        if self.repeat > 1 and m % n:
            raise ValueError("repeat wrap needs len(data) % chunk == 0")
        off = jax.lax.rem(jnp.asarray(offset, jnp.int32), jnp.int32(m))
        return jax.lax.dynamic_slice_in_dim(dev, off, n)

    def emit_tags(self, offset, n):
        out = []
        m = len(self.data)
        for rep in range(self.repeat):
            p = rep * m
            if offset <= p < offset + n:
                q = p - offset
                out.append(Tag(q, "VectorSource::start", True))
                out.append(Tag(q, "VectorSource::repeat", rep))
                if rep == 0:
                    out.append(Tag(q, "VectorSource::first", True))
        for t in self.user_tags:
            if offset <= t.pos < offset + n:
                out.append(Tag(t.pos - offset, t.key, t.val))
        return out


class ConstantSource(SourceBlock):
    """Constant generator; unbounded (use Head or n=...)."""

    def __init__(self, value, n: int | None = None):
        self.value = value
        self.n = n

    def total_len(self):
        return self.n

    def emit(self, offset, n):
        return _canonical(np.full(n, self.value))


class SignalSourceComplex(SourceBlock):
    """Complex sine (reference src/signal_source.rs:21-62)."""

    def __init__(self, samp_rate, freq, amplitude=1.0, n: int | None = None):
        self.samp_rate, self.freq, self.amplitude, self.n = samp_rate, freq, amplitude, n

    def total_len(self):
        return self.n

    def emit(self, offset, n):
        return ops.signal_source_c(n, self.samp_rate, self.freq, self.amplitude, offset)


class SignalSourceFloat(SourceBlock):
    def __init__(self, samp_rate, freq, amplitude=1.0, n: int | None = None):
        self.samp_rate, self.freq, self.amplitude, self.n = samp_rate, freq, amplitude, n

    def total_len(self):
        return self.n

    def emit(self, offset, n):
        return ops.signal_source_f(n, self.samp_rate, self.freq, self.amplitude, offset)


class NoiseSource(SourceBlock):
    """Gaussian noise source (no reference equivalent; handy for tests)."""

    def __init__(self, scale=1.0, seed=0, n: int | None = None, complex=False):
        self.scale, self.seed, self.n, self.complex = scale, seed, n, complex

    def total_len(self):
        return self.n

    def emit(self, offset, n):
        rng = np.random.RandomState(self.seed + offset % (2**31))
        if self.complex:
            return ((rng.randn(n) + 1j * rng.randn(n)) * self.scale).astype(np.complex64)
        return (rng.randn(n) * self.scale).astype(np.float32)


class FileSource(SourceBlock):
    """Raw sample file source (reference src/file_source.rs).

    Streams incrementally: ``emit`` seeks and reads only the requested
    sample window (the reference reads chunk-by-chunk with a partial-sample
    carry, src/file_source.rs:44-90; seeking at sample granularity makes
    the carry unnecessary here), so files larger than RAM stream fine.
    """

    domain = "host"

    def __init__(self, path: str, dtype="c32", repeat: int = 1):
        self.path, self.dtype, self.repeat = path, dtype, repeat
        self._dt = rawfile._resolve(dtype).newbyteorder("<")
        self._f = None
        self._file_samples = None

    def _open(self):
        if self._f is None:
            import os

            self._f = open(self.path, "rb")
            self._file_samples = os.path.getsize(self.path) // self._dt.itemsize
            if self._file_samples == 0:
                raise ValueError(f"{self.path}: no complete samples")
        return self._f

    def total_len(self):
        self._open()
        return self._file_samples * self.repeat

    def emit(self, offset, n):
        f = self._open()
        m = self._file_samples
        out = np.empty(n, self._dt)
        got = 0
        while got < n:
            pos = (offset + got) % m
            k = min(n - got, m - pos)
            f.seek(pos * self._dt.itemsize)
            buf = f.read(k * self._dt.itemsize)
            out[got : got + k] = np.frombuffer(buf, dtype=self._dt, count=k)
            got += k
        return out
