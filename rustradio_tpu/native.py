"""ctypes bindings for the native host runtime (native/rr_native.cpp).

Builds the shared library on first use (g++ is baked into the image) and
exposes the SPSC ring buffer, background file reader, and sample-format
converters.  Falls back cleanly (``available() == False``) if no compiler
is present; every consumer has a numpy fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "native", "rr_native.cpp")
_SO = os.path.join(_HERE, "..", "native", "librr_native.so")

_lib = None
_lock = threading.Lock()


def _build() -> str | None:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
             "-shared", "-fPIC",
             "-o", _SO, _SRC, "-lpthread"],
            check=True, capture_output=True,
        )
        return _SO
    except (OSError, subprocess.CalledProcessError):
        return None


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        lib.rr_ring_create.restype = ctypes.c_void_p
        lib.rr_ring_create.argtypes = [ctypes.c_size_t]
        lib.rr_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.rr_ring_capacity.restype = ctypes.c_size_t
        lib.rr_ring_capacity.argtypes = [ctypes.c_void_p]
        lib.rr_ring_readable.restype = ctypes.c_size_t
        lib.rr_ring_readable.argtypes = [ctypes.c_void_p]
        lib.rr_ring_writable.restype = ctypes.c_size_t
        lib.rr_ring_writable.argtypes = [ctypes.c_void_p]
        lib.rr_ring_write.restype = ctypes.c_size_t
        lib.rr_ring_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.rr_ring_read.restype = ctypes.c_size_t
        lib.rr_ring_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.rr_ring_eof.restype = ctypes.c_int
        lib.rr_ring_eof.argtypes = [ctypes.c_void_p]
        lib.rr_ring_error.restype = ctypes.c_int
        lib.rr_ring_error.argtypes = [ctypes.c_void_p]
        lib.rr_ring_set_eof.argtypes = [ctypes.c_void_p]
        lib.rr_reader_start.restype = ctypes.c_void_p
        lib.rr_reader_start.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.rr_reader_stop.argtypes = [ctypes.c_void_p]
        for name in (
            "rr_convert_i16be_f32", "rr_convert_i16le_f32",
        ):
            f = getattr(lib, name)
            f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.rr_convert_u8iq_f32_planar.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.c_float,
        ]
        lib.rr_deinterleave_c64.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t
        ]
        lib.rr_interleave_c64.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t
        ]
        lib.rr_convert_f32_i16be.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t
        ]
        lib.rr_hdlc_create.restype = ctypes.c_void_p
        lib.rr_hdlc_create.argtypes = [ctypes.c_int] * 4
        lib.rr_hdlc_destroy.argtypes = [ctypes.c_void_p]
        lib.rr_hdlc_feed.restype = ctypes.c_size_t
        lib.rr_hdlc_feed.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.rr_hdlc_pending_bytes.restype = ctypes.c_size_t
        lib.rr_hdlc_pending_bytes.argtypes = [ctypes.c_void_p]
        lib.rr_hdlc_drain.restype = ctypes.c_size_t
        lib.rr_hdlc_drain.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.rr_hdlc_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.rr_zero_crossing.restype = ctypes.c_size_t
        lib.rr_zero_crossing.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.rr_symbol_sync.restype = ctypes.c_size_t
        lib.rr_symbol_sync.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class Ring:
    """SPSC ring buffer backed by the native double-mapped region."""

    def __init__(self, min_size: int = 1 << 22):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable (no g++?)")
        self._lib = lib
        self._ptr = lib.rr_ring_create(min_size)
        if not self._ptr:
            raise RuntimeError("rr_ring_create failed")

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.rr_ring_destroy(self._ptr)
            self._ptr = None

    @property
    def capacity(self) -> int:
        return self._lib.rr_ring_capacity(self._ptr)

    def readable(self) -> int:
        return self._lib.rr_ring_readable(self._ptr)

    def write(self, data: bytes | np.ndarray) -> int:
        arr = np.ascontiguousarray(np.frombuffer(bytes(data), np.uint8) if isinstance(data, (bytes, bytearray)) else data)
        return self._lib.rr_ring_write(
            self._ptr, arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes
        )

    def read(self, n: int) -> bytes:
        out = np.empty(n, np.uint8)
        got = self._lib.rr_ring_read(
            self._ptr, out.ctypes.data_as(ctypes.c_void_p), n
        )
        return out[:got].tobytes()

    def set_eof(self):
        self._lib.rr_ring_set_eof(self._ptr)

    def eof(self) -> bool:
        return bool(self._lib.rr_ring_eof(self._ptr))

    def error(self) -> int:
        return self._lib.rr_ring_error(self._ptr)


class FileReader:
    """Background native reader thread filling a Ring from a file."""

    def __init__(self, ring: Ring, path: str, repeat: int = 1):
        self._lib = ring._lib
        self._ptr = self._lib.rr_reader_start(ring._ptr, path.encode(), repeat)
        self._ring = ring  # keep alive

    def stop(self):
        if self._ptr:
            self._lib.rr_reader_stop(self._ptr)
            self._ptr = None

    def __del__(self):
        self.stop()


def convert_i16be_f32(raw: np.ndarray) -> np.ndarray:
    raw = np.ascontiguousarray(raw, np.uint8)
    n = len(raw) // 2
    out = np.empty(n, np.float32)
    lib = _load()
    if lib is None:
        return (raw[: 2 * n].view(">i2").astype(np.float32) / 32767.0)
    lib.rr_convert_i16be_f32(
        raw.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p), n
    )
    return out


def convert_u8iq_planar(raw: np.ndarray, scale: float = 0.008):
    raw = np.ascontiguousarray(raw, np.uint8)
    n = len(raw) // 2
    i = np.empty(n, np.float32)
    q = np.empty(n, np.float32)
    lib = _load()
    if lib is None:
        f = raw.astype(np.float32) - 127.0
        return (f[0::2] * scale).astype(np.float32), (f[1::2] * scale).astype(np.float32)
    lib.rr_convert_u8iq_f32_planar(
        raw.ctypes.data_as(ctypes.c_void_p),
        i.ctypes.data_as(ctypes.c_void_p),
        q.ctypes.data_as(ctypes.c_void_p),
        n, ctypes.c_float(scale),
    )
    return i, q


def deinterleave_c64(x: np.ndarray):
    """complex64 -> planar (I, Q) f32 — the host-side staging conversion."""
    x = np.ascontiguousarray(x, np.complex64)
    n = len(x)
    i = np.empty(n, np.float32)
    q = np.empty(n, np.float32)
    lib = _load()
    if lib is None:
        return x.real.copy(), x.imag.copy()
    lib.rr_deinterleave_c64(
        x.view(np.float32).ctypes.data_as(ctypes.c_void_p),
        i.ctypes.data_as(ctypes.c_void_p),
        q.ctypes.data_as(ctypes.c_void_p),
        n,
    )
    return i, q


def convert_f32_i16be(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(2 * len(x), np.uint8)
    lib = _load()
    if lib is None:
        pcm = np.trunc(x * 32767.0).clip(-32768, 32767).astype(">i2")
        return np.frombuffer(pcm.tobytes(), np.uint8)
    lib.rr_convert_f32_i16be(
        x.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p), len(x)
    )
    return out


def symbol_sync_f32(x: np.ndarray, sps: float, max_deviation: float, clock_taps,
                    state: dict | None = None):
    """Native symbol sync (see rr_symbol_sync in native/rr_native.cpp).

    Returns (symbols, clocks, final_state_dict) or None when the native
    runtime is unavailable.  Exact f32 replication of ops.symbol_sync's
    scan; the state dict uses the scan's own keys, so streams can resume
    across the two backends (and through checkpoints).
    """
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    taps = np.ascontiguousarray(clock_taps, np.float32)
    nf = max(len(taps) - 1, 1)
    st = np.empty(5 + nf, np.float32)
    if state is None:
        st[0] = np.float32(sps)
        st[1] = 0.0
        st[2] = 0.0
        st[3] = 0.0
        st[4] = np.float32(sps) / np.float32(2.0)
        st[5:] = np.float32(sps)
    else:
        st[0] = np.float32(state["clock"])
        st[1] = 1.0 if bool(np.asarray(state["last_sign"])) else 0.0
        st[2] = np.float32(state["stream_pos"])
        st[3] = np.float32(state["last_sym_boundary_pos"])
        st[4] = np.float32(state["next_sym_middle"])
        st[5:] = np.asarray(state["fbuf"], np.float32)
    vals = np.empty(len(x), np.float32)
    clks = np.empty(len(x), np.float32)
    k = lib.rr_symbol_sync(
        x.ctypes.data_as(ctypes.c_void_p), len(x),
        ctypes.c_float(np.float32(sps)), ctypes.c_float(np.float32(max_deviation)),
        taps.ctypes.data_as(ctypes.c_void_p), len(taps),
        st.ctypes.data_as(ctypes.c_void_p),
        vals.ctypes.data_as(ctypes.c_void_p), clks.ctypes.data_as(ctypes.c_void_p),
    )
    final = dict(
        clock=np.float32(st[0]),
        last_sign=bool(st[1] != 0.0),
        stream_pos=np.float32(st[2]),
        last_sym_boundary_pos=np.float32(st[3]),
        next_sym_middle=np.float32(st[4]),
        fbuf=st[5:].copy(),
    )
    return vals[:k].copy(), clks[:k].copy(), final


class HdlcDeframer:
    """Native resumable HDLC deframer (rr_hdlc_* in native/rr_native.cpp).

    Exact port of ops.hdlc.HdlcStateMachine; feed() accepts consecutive
    bit chunks and returns the newly decoded (bytes, stream_pos) packets.
    """

    def __init__(self, min_size=1, max_size=1500, keep_checksum=False, fix_bits=False):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._ptr = lib.rr_hdlc_create(
            int(min_size), int(max_size), int(bool(keep_checksum)), int(bool(fix_bits))
        )

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.rr_hdlc_destroy(self._ptr)
            self._ptr = None

    def feed(self, bits) -> list:
        bits = np.ascontiguousarray(bits, np.uint8)
        k = self._lib.rr_hdlc_feed(
            self._ptr, bits.ctypes.data_as(ctypes.c_void_p), len(bits)
        )
        if k == 0:
            return []
        nbytes = self._lib.rr_hdlc_pending_bytes(self._ptr)
        data = np.empty(nbytes, np.uint8)
        lens = np.empty(k, np.uint32)
        poss = np.empty(k, np.uint64)
        got = self._lib.rr_hdlc_drain(
            self._ptr,
            data.ctypes.data_as(ctypes.c_void_p),
            lens.ctypes.data_as(ctypes.c_void_p),
            poss.ctypes.data_as(ctypes.c_void_p),
            k,
        )
        assert got == k
        out, off = [], 0
        for ln, pos in zip(lens, poss):
            out.append((data[off : off + int(ln)].copy(), int(pos)))
            off += int(ln)
        return out

    @property
    def stats(self) -> dict:
        buf = (ctypes.c_uint64 * 3)()
        self._lib.rr_hdlc_stats(self._ptr, buf)
        return {"decoded": int(buf[0]), "crc_error": int(buf[1]), "bitfixed": int(buf[2])}


def zero_crossing_f32(x: np.ndarray, sps: float, state: dict | None = None):
    """Native fixed-clock zero-crossing recovery (rr_zero_crossing).

    Returns (symbols, final_state_dict) or None when unavailable; exact
    replication of ops.zero_crossing_sync, state keys interoperable.
    """
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    st = np.zeros(3, np.float32)
    if state is not None:
        st[0] = 1.0 if bool(np.asarray(state["last_sign"])) else 0.0
        st[1] = np.float32(state["last_cross"])
        st[2] = np.float32(int(state["counter"]))
    vals = np.empty(len(x), np.float32)
    k = lib.rr_zero_crossing(
        x.ctypes.data_as(ctypes.c_void_p), len(x), ctypes.c_float(np.float32(sps)),
        st.ctypes.data_as(ctypes.c_void_p), vals.ctypes.data_as(ctypes.c_void_p),
    )
    final = dict(
        last_sign=bool(st[0] != 0.0),
        last_cross=np.float32(st[1]),
        counter=np.uint32(st[2]),
    )
    return vals[:k].copy(), final
