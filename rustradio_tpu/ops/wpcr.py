"""Whole-packet clock recovery (Ossmann method) and burst midpointing.

Reference src/wpcr.rs.  This is the accelerator-preferred clock recovery: one FFT
over the whole burst instead of a per-sample feedback loop.

``wpcr`` (src/wpcr.rs:130-197):
1. slice burst at 0, mark zero transitions: d[n] = (s[n]>0) - (s[n+1]>0), squared
2. FFT of d
3. best bin: first bin >= 2 whose magnitude is >80% of max and not rising
   (src/wpcr.rs:217-239)
4. sps = bin / len; clock_phase from bin phase; extract the sample wherever
   the phase accumulator wraps.

``midpoint`` (src/wpcr.rs:53-82): re-center a burst on the midpoint of the
median high/low levels.

Both are batchable across bursts via vmap once bursts are padded to a
common length; the scalar forms here take one burst.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _kth_smallest(v, valid, k):
    """Exact k-th smallest (0-indexed) float among ``valid`` entries.

    32-step binary search on the total-order integer image of f32 —
    selects the identical element a sort-then-index would, but compiles
    ~4x faster than a vmapped ``jnp.sort`` (the bitonic network
    dominated the WPCR bucket programs' compile time; the 32 masked
    reductions cost ~0.2 ms per 16x2048 batch at run time, noise next to
    the chain).
    """
    x = jax.lax.bitcast_convert_type(jnp.asarray(v, jnp.float32), jnp.int32)
    u = jnp.where(x < 0, ~x, x | np.int32(-2147483648)).astype(jnp.uint32)
    u = jnp.where(valid, u, jnp.uint32(0xFFFFFFFF))
    lo = jnp.uint32(0)
    for b in range(31, -1, -1):
        mid = lo | jnp.uint32(1 << b)
        c = jnp.sum((u < mid).astype(jnp.int32))
        lo = jnp.where(c <= k, mid, lo)
    key = lo.astype(jnp.int32)
    back = jnp.where(key < 0, key ^ np.int32(-2147483648), ~key)
    return jax.lax.bitcast_convert_type(back, jnp.float32)


def midpoint(v):
    """Re-center burst around midpoint of median high and median low.

    Mirrors reference Midpointer (src/wpcr.rs:53-82): partition by mean;
    high = sorted(above)[len/2], low = sorted(below)[len/2] (note the
    reference sorts "above mean" into ``a`` and takes a[len/2]).
    Returns None-equivalent (the input) if one side is empty; host-level
    code should drop such bursts like the reference does.
    """
    v = jnp.asarray(v, jnp.float32)
    mean = jnp.mean(v)
    above = v > mean
    n_above = jnp.sum(above)
    n_below = v.shape[0] - n_above
    high = _kth_smallest(v, above, n_above // 2)
    low = _kth_smallest(v, ~above, n_below // 2)
    offset = low + (high - low) / jnp.float32(2.0)
    return v - offset, (n_above > 0) & (n_below > 0)


def _find_best_bin(mag):
    """First bin >= 2 above 80% of max (excluding bins 0,1) and not rising.

    Returns (bin_index, found).  src/wpcr.rs:217-239.
    """
    n = mag.shape[0]
    idx = jnp.arange(n)
    eligible = idx >= 2
    thresh = jnp.max(jnp.where(eligible, mag, -jnp.inf)) * jnp.float32(0.8)
    nxt = jnp.concatenate([mag[1:], jnp.asarray([jnp.inf], mag.dtype)])
    ok = eligible & (mag > thresh) & (mag > nxt) & (idx < n - 1)
    found = jnp.any(ok)
    bin_ = jnp.argmax(ok)  # first True
    return bin_, found


def wpcr(samples, samp_rate: float | None = None):
    """Whole-packet clock recovery over one burst.

    Returns (syms, mask, info) where syms/mask are input-length with
    mask marking emitted symbols, and info is a dict with
    ``sps``, ``phase``, ``found``.  Matches reference process_one
    (src/wpcr.rs:130-197); bursts shorter than 4 samples or with no
    FFT peak yield mask=all-False.
    """
    samples = jnp.asarray(samples, jnp.float32)
    n = samples.shape[0]
    if n < 4:
        z = jnp.zeros_like(samples)
        return samples, jnp.zeros(n, bool), dict(
            sps=jnp.float32(0), phase=jnp.float32(0), found=jnp.asarray(False)
        )
    sliced = (samples > 0).astype(jnp.float32)
    d = sliced[:-1] - sliced[1:]
    d = d * d  # pulses at zero transitions
    # d has length n-1 (the reference zips sliced with its skip(1) self,
    # src/wpcr.rs:150-158) but the reference still normalizes the peak bin
    # by the full n: sps = bin / samples.len().  Keep both quirks.
    spec = jnp.fft.fft(d.astype(jnp.complex64))
    half = spec[: d.shape[0] // 2]
    mag = jnp.abs(half)
    bin_, found = _find_best_bin(mag)
    sps = bin_.astype(jnp.float32) / jnp.float32(n)
    arg = jnp.arctan2(jnp.imag(half[bin_]), jnp.real(half[bin_]))
    t = jnp.float32(0.5) + arg / jnp.float32(2.0 * np.pi)
    clock_phase0 = jnp.where(t > 0.5, t, t + jnp.float32(1.0))

    # Extract symbols: for each sample, if clock_phase >= 1: phase -= 1, emit;
    # phase += sps.   phase before sample k = clock_phase0 + k*sps - (#emitted)
    # Emission test uses the running (wrapped) phase; closed form:
    # emitted_before_k = floor(clock_phase0 + (k-1)*sps) ... derive directly:
    # phase_k (unwrapped) = clock_phase0 + k*sps; emit at k iff
    # floor(phase_unwrapped_before_increment) increments. Use cumulative form:
    # Closed form of the leaky accumulator: with u_k = phase0 + k*sps and
    # sps < 1, the cumulative emission count is floor(u_{k-1}); sample k
    # emits iff floor(u_k) > floor(u_{k-1}), except k=0 which emits iff
    # u_0 >= 1 (phase0 can reach 1.5, so the u_{-1} trick fails there).
    k = jnp.arange(n, dtype=jnp.float32)
    unwrapped = clock_phase0 + k * sps
    fl = jnp.floor(unwrapped)
    mask = jnp.concatenate([(unwrapped[:1] >= 1.0), fl[1:] > fl[:-1]])
    mask = mask & found
    info = dict(sps=sps, phase=clock_phase0, found=found)
    return samples, mask, info


def _bluestein_dft(d, M, N: int):
    """DFT of length ``M`` (traced scalar) over ``d[:M]``, static shapes.

    Bluestein/chirp-Z: X[j] = w[j] * IFFT(FFT(a)·FFT(b))[j] with
    w[t] = exp(-iπ t²/M), a = d·w zero-padded, b the circular chirp.
    Returns a length-``L`` complex64 array whose bins j < M equal
    ``np.fft.fft(d[:M])``; bins j >= M are garbage (mask them).  ``N``
    must be a static power of two >= 2L.  This is what lets bursts of
    *different* lengths batch into one fixed-shape program while keeping
    the reference's exact DFT length (src/wpcr.rs:150 FFTs the
    transition vector at the burst's own length).

    The quadratic phase is reduced mod 2M in int32 before the float
    multiply, so f32 twiddles stay accurate for any burst length
    (t² <= L² must stay below 2^31: L <= 46340).
    """
    L = d.shape[0]
    t = jnp.arange(L, dtype=jnp.int32)
    M32 = M.astype(jnp.int32)
    t2 = (t * t) % (2 * M32)
    ang = -jnp.pi * t2.astype(jnp.float32) / M.astype(jnp.float32)
    w = jax.lax.complex(jnp.cos(ang), jnp.sin(ang))
    if N != 2 * L:
        raise ValueError("bluestein buffer must be exactly 2L")
    valid = t < M32
    a = jnp.where(valid, d, 0.0).astype(jnp.complex64) * w
    a_pad = jnp.concatenate([a, jnp.zeros(L, jnp.complex64)])
    bvals = jnp.where(valid, jnp.conj(w), 0.0)
    # circular chirp: b[t] = conj(w[t]) and b[N-t] = conj(w[t]) — with
    # N == 2L the mirror is a reversed slice (a scatter here compiles
    # and runs far worse under vmap)
    b = jnp.concatenate(
        [bvals, jnp.zeros(1, jnp.complex64), bvals[1:][::-1]]
    )
    conv = jnp.fft.ifft(jnp.fft.fft(a_pad) * jnp.fft.fft(b))[:L]
    return w * conv.astype(jnp.complex64)


def _midpoint_masked(v, m):
    """midpoint() over the first ``m`` entries of a padded burst."""
    L = v.shape[0]
    k = jnp.arange(L)
    valid = k < m
    mean = jnp.sum(jnp.where(valid, v, 0.0)) / m.astype(jnp.float32)
    above = valid & (v > mean)
    n_above = jnp.sum(above)
    n_below = m - n_above
    high = _kth_smallest(v, above, n_above // 2)
    low = _kth_smallest(v, valid & ~(v > mean), n_below // 2)
    offset = low + (high - low) / jnp.float32(2.0)
    ok = (n_above > 0) & (n_below > 0)
    return jnp.where(valid, v - offset, 0.0), ok


def _wpcr_masked(v, m, N: int):
    """wpcr() over the first ``m`` entries of a padded burst."""
    L = v.shape[0]
    k = jnp.arange(L)
    valid = k < m
    sliced = jnp.where(valid, (v > 0).astype(jnp.float32), 0.0)
    s1 = jnp.concatenate([sliced[1:], jnp.zeros(1, jnp.float32)])
    d = jnp.where(k < m - 1, (sliced - s1) ** 2, 0.0)
    spec = _bluestein_dft(d, m - 1, N)
    half_len = (m - 1) // 2
    mag = jnp.where(k < half_len, jnp.abs(spec), -jnp.inf)
    # best-bin rule, reference src/wpcr.rs:217-239
    eligible = (k >= 2) & (k < half_len)
    thresh = jnp.max(jnp.where(eligible, mag, -jnp.inf)) * jnp.float32(0.8)
    nxt = jnp.concatenate([mag[1:], jnp.asarray([jnp.inf], mag.dtype)])
    ok = eligible & (mag > thresh) & (mag > nxt) & (k < half_len - 1)
    found = jnp.any(ok) & (m >= 4) & (half_len > 2)
    bin_ = jnp.argmax(ok)
    sps = bin_.astype(jnp.float32) / m.astype(jnp.float32)
    arg = jnp.arctan2(jnp.imag(spec[bin_]), jnp.real(spec[bin_]))
    t = jnp.float32(0.5) + arg / jnp.float32(2.0 * np.pi)
    clock_phase0 = jnp.where(t > 0.5, t, t + jnp.float32(1.0))
    kf = k.astype(jnp.float32)
    unwrapped = clock_phase0 + kf * sps
    fl = jnp.floor(unwrapped)
    mask = jnp.concatenate([(unwrapped[:1] >= 1.0), fl[1:] > fl[:-1]])
    mask = mask & found & valid
    return mask, sps, clock_phase0, found


@functools.lru_cache(maxsize=32)
def _wpcr_one_fn(n: int, midpoint_first: bool):
    """Jitted exact path for one burst length (one program + ONE
    readback per length)."""

    def f(v):
        ok = jnp.asarray(True)
        if midpoint_first:
            v, ok = midpoint(v)
        samples, mask, info = wpcr(v)
        return samples, mask & ok, info["sps"], info["phase"], info["found"] & ok

    return jax.jit(f)


def _wpcr_one_eager(b, midpoint_first: bool):
    """Exact per-burst path for bursts too long for the int32 chirp."""
    samples, mask, sps, phase, found = jax.tree.map(
        np.asarray,
        _wpcr_one_fn(len(b), midpoint_first)(jnp.asarray(b, jnp.float32)),
    )
    if not found:
        return (np.zeros(0, np.float32), dict(sps=0.0, phase=0.0, found=False))
    return (samples[mask], dict(sps=float(sps), phase=float(phase), found=True))


@functools.lru_cache(maxsize=None)
def _wpcr_bucket_fn(L: int, do_midpoint: bool):
    N = 2 * L

    def one(v, m):
        if do_midpoint:
            v, mid_ok = _midpoint_masked(v, m)
        else:
            mid_ok = jnp.asarray(True)
        mask, sps, phase, found = _wpcr_masked(v, m, N)
        return v, mask & mid_ok, sps, phase, found & mid_ok

    return jax.jit(jax.vmap(one))


import threading as _threading

_PREWARM_STOP = _threading.Event()


def prewarm_buckets(lengths=(2048, 4096, 8192, 16384, 32768),
                    batches=(1,), midpoint_first: bool = True,
                    background: bool = True):
    """Compile AND execute the WPCR bucket programs ahead of the first
    burst.

    The first execution of each bucket program pays its compilation, so
    a burst receiver that waits for its first packet before touching a
    bucket eats that cost on the packet.  This warms the (batch, length)
    grid in a daemon thread while the app starts up / waits for signal;
    results land in jax's dispatch + persistent caches.

    Returns the thread (``background=True``) or None after running
    inline.  Reference context: src/wpcr.rs:130-197 builds its FFT plan
    per burst; here the plan is a compiled XLA program per bucket.

    ``RR_NO_PREWARM=1`` disables it (the test suite sets this — a warm
    thread compiling during other measurements skews them, and a daemon
    thread killed inside an XLA call aborts interpreter shutdown).
    """
    import os

    if os.environ.get("RR_NO_PREWARM"):
        return None
    stop = _PREWARM_STOP

    def _warm():
        for L in lengths:
            for B in batches:
                if stop.is_set():
                    return
                try:
                    fn = _wpcr_bucket_fn(int(L), midpoint_first)
                    out = fn(jnp.zeros((int(B), int(L)), jnp.float32),
                             jnp.zeros((int(B),), jnp.int32))
                    np.asarray(out[2])  # readback forces remote AOT
                except Exception:  # noqa: BLE001 - warming must never kill the app
                    return

    if not background:
        _warm()
        return None
    import threading

    # NON-daemon + a stop flag raised before the interpreter joins
    # threads: a daemon thread killed inside an XLA call takes the whole
    # process down with "FATAL: exception not rethrown".  Exit waits at
    # most one bucket compile.
    t = threading.Thread(target=_warm, name="wpcr-prewarm", daemon=False)
    try:
        threading._register_atexit(stop.set)
    except Exception:  # pragma: no cover - private API fallback
        t.daemon = True
    t.start()
    return t


def wpcr_batch(bursts, midpoint_first: bool = True):
    """Batched device-side WPCR over many bursts.

    Buckets bursts into power-of-two padded lengths, runs ONE jitted
    vmapped program per bucket (midpoint + Bluestein-DFT WPCR + symbol
    mask), and reads everything back in one transfer per bucket — the
    amortized per-burst device cost is one dispatch instead of the eager
    path's per-op dispatches.

    Returns a list aligned with ``bursts``: each entry is
    ``(syms, info)`` with info dict (sps/phase/found) — ``found=False``
    entries have empty syms, mirroring the reference's process_one
    returning None (src/wpcr.rs:130-197).
    """
    results: list = [None] * len(bursts)
    buckets: dict[int, list[int]] = {}
    for i, b in enumerate(bursts):
        n = len(b)
        if n < 4:
            results[i] = (np.zeros(0, np.float32),
                          dict(sps=0.0, phase=0.0, found=False))
            continue
        L = 1 << max(6, (n - 1).bit_length())
        if L > 32768:
            # the chirp's t^2 must stay below 2^31 in int32 (t < L), so
            # very long bursts take the eager exact path instead
            results[i] = _wpcr_one_eager(b, midpoint_first)
            continue
        buckets.setdefault(L, []).append(i)
    for L, idxs in buckets.items():
        # batch dimension rounds up to a power of two (zero-length pad
        # rows, ignored on readback): bounds the compiled-program count
        # AND lets prewarm_buckets' (batch, length) grid hit real shapes
        B = 1 << (len(idxs) - 1).bit_length() if idxs else 1
        padded = np.zeros((B, L), np.float32)
        lens = np.zeros(B, np.int32)
        for row, i in enumerate(idxs):
            b = np.asarray(bursts[i], np.float32)
            padded[row, : len(b)] = b
            lens[row] = len(b)
        fn = _wpcr_bucket_fn(L, midpoint_first)
        v, mask, sps, phase, found = jax.tree.map(
            np.asarray, fn(jnp.asarray(padded), jnp.asarray(lens))
        )
        for row, i in enumerate(idxs):
            if found[row]:
                syms = v[row][mask[row]]
            else:
                syms = np.zeros(0, np.float32)
            results[i] = (
                syms,
                dict(sps=float(sps[row]), phase=float(phase[row]),
                     found=bool(found[row])),
            )
    return results


def midpoint_batch(bursts):
    """Batched Midpointer: returns list of (centered, ok) numpy pairs."""
    results: list = [None] * len(bursts)
    buckets: dict[int, list[int]] = {}
    for i, b in enumerate(bursts):
        n = len(b)
        if n == 0:
            results[i] = (np.zeros(0, np.float32), False)
            continue
        L = 1 << max(6, (n - 1).bit_length())
        buckets.setdefault(L, []).append(i)
    for L, idxs in buckets.items():
        B = len(idxs)
        padded = np.zeros((B, L), np.float32)
        lens = np.empty(B, np.int32)
        for row, i in enumerate(idxs):
            b = np.asarray(bursts[i], np.float32)
            padded[row, : len(b)] = b
            lens[row] = len(b)
        fn = _midpoint_bucket_fn(L)
        v, ok = jax.tree.map(np.asarray, fn(jnp.asarray(padded), jnp.asarray(lens)))
        for row, i in enumerate(idxs):
            results[i] = (v[row][: lens[row]], bool(ok[row]))
    return results


@functools.lru_cache(maxsize=None)
def _midpoint_bucket_fn(L: int):
    return jax.jit(jax.vmap(_midpoint_masked))


def wpcr_numpy(samples: np.ndarray, samp_rate=None):
    """Host golden model: literal port of reference process_one."""
    samples = np.asarray(samples, np.float32)
    if len(samples) < 4:
        return None
    sliced = (samples > 0).astype(np.float32)
    d = (sliced[:-1] - sliced[1:]) ** 2
    spec = np.fft.fft(d.astype(np.complex64))
    half = spec[: len(d) // 2]
    mag = np.abs(half)
    skip = 2
    if len(mag) <= skip:
        return None
    thresh = mag[skip:].max() * 0.8
    bin_ = None
    for i in range(skip, len(mag) - 1):
        if mag[i] > thresh and mag[i] > mag[i + 1]:
            bin_ = i
            break
    if bin_ is None:
        return None
    sps = np.float32(bin_) / np.float32(len(samples))
    arg = np.angle(half[bin_])
    t = 0.5 + arg / (2 * np.pi)
    clock_phase = t if t > 0.5 else t + 1.0
    syms = []
    for s in samples:
        if clock_phase >= 1.0:
            clock_phase -= 1.0
            syms.append(s)
        clock_phase += sps
    return np.asarray(syms, np.float32), float(sps), float(clock_phase)
