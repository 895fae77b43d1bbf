"""Host→device streaming feed.

Replaces the reference's source blocks + circular buffer with a pipelined
path: native reader thread → SPSC ring → format convert to planar f32 →
``jax.device_put`` double-buffered ahead of compute.  Planar f32 I/Q is
transferred and combined on device.
"""

from __future__ import annotations

import queue
import threading

import jax
import jax.numpy as jnp
import numpy as np

from . import native


class DeviceFeeder:
    """Iterate device-resident chunks of a sample file.

    Yields ``(i, q)`` f32 device arrays for complex formats ("c32", "u8iq")
    or a single f32 array for real formats ("f32", "i16be").
    """

    def __init__(
        self,
        path: str,
        fmt: str = "c32",
        chunk_samples: int = 1 << 20,
        repeat: int = 1,
        prefetch: int = 2,
        device=None,
    ):
        self.fmt = fmt
        self.chunk = chunk_samples
        self.device = device or jax.devices()[0]
        self._bytes_per_sample = {"c32": 8, "u8iq": 2, "f32": 4, "i16be": 2}[fmt]
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._ring = native.Ring(max(1 << 22, 4 * chunk_samples * self._bytes_per_sample)) if native.available() else None
        if self._ring is not None:
            self._reader = native.FileReader(self._ring, path, repeat)
        else:
            self._reader = None
            self._fallback = open(path, "rb")
            self._fallback_repeat = repeat
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _read_bytes(self, n: int) -> bytes:
        if self._ring is not None:
            return self._ring.read(n)
        data = self._fallback.read(n)
        while len(data) < n and self._fallback_repeat > 1:
            self._fallback_repeat -= 1
            self._fallback.seek(0)
            data += self._fallback.read(n - len(data))
        return data

    def _convert(self, raw: bytes):
        b = np.frombuffer(raw, np.uint8)
        if self.fmt == "c32":
            x = b.view(np.complex64)
            i, q = native.deinterleave_c64(x) if native.available() else (x.real.copy(), x.imag.copy())
            return i, q
        if self.fmt == "u8iq":
            return native.convert_u8iq_planar(b)
        if self.fmt == "i16be":
            return native.convert_i16be_f32(b)
        return b.view(np.float32).copy()

    def _pump(self):
        bps = self._bytes_per_sample
        while True:
            raw = self._read_bytes(self.chunk * bps)
            if not raw:
                break
            n = len(raw) - len(raw) % bps
            conv = self._convert(raw[:n])
            if isinstance(conv, tuple):
                dev = tuple(jax.device_put(c, self.device) for c in conv)
            else:
                dev = jax.device_put(conv, self.device)
            self._q.put(dev)
            if len(raw) < self.chunk * bps:
                break
        self._q.put(None)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                if self._ring is not None and self._ring.error():
                    raise OSError(
                        self._ring.error(), "native reader failed", )
                return
            yield item

    def close(self):
        if self._reader is not None:
            self._reader.stop()


def combine_iq(i, q):
    """Form complex64 on device from planar f32 (jit-safe)."""
    return jax.lax.complex(jnp.asarray(i, jnp.float32), jnp.asarray(q, jnp.float32))
