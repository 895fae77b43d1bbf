"""Clock recovery (symbol synchronization).

``symbol_sync`` is a faithful f32 port of the reference's SymbolSync block
(src/symbol_sync.rs:115-218): zero-crossing TED plus a clamped IIR clock
filter (src/iir_filter.rs:104-125), emitting the center sample of each
symbol.  It is an inherently sequential per-sample recurrence, so it runs
as a ``lax.scan`` — sequential within a stream, but vmap-able across
channels/bursts.  For burst traffic prefer :mod:`rustradio_tpu.ops.wpcr`,
which is batch-FFT based and parallel across the burst.

``zero_crossing_sync`` ports the simpler fixed-clock variant
(src/zero_crossing.rs).

Because output density is data-dependent, both return ``(values, mask)``
arrays of the input length; compact with ``mask`` (host-side or via
masked-stream downstream ops).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

F = jnp.float32


def symbol_sync(
    x,
    sps: float,
    max_deviation: float = 0.5,
    clock_taps=(0.5, 0.5),
    state=None,
    unroll: int = 1,
):
    """Returns ((values, mask, clocks), final_state).

    ``values[i]``/``clocks[i]`` are meaningful where ``mask[i]``;
    clocks carries the recovered clock (sps) at each emission, matching the
    reference's optional out_clock stream (src/symbol_sync.rs:100-113).

    ``unroll`` is forwarded to ``lax.scan`` — it unrolls the per-sample
    step body without changing its element-wise semantics (outputs stay
    bit-identical; asserted in tests/test_multichannel.py), trading
    program size for fewer sequential scan iterations.  On an accelerator
    the scan's per-step overhead dominates this tiny body, so the vmapped
    decode bank (models/multichannel.recover_symbols_batch) runs markedly
    faster unrolled.
    """
    if not sps > 1.0:
        raise ValueError("sps must be > 1")
    x = jnp.asarray(x, F)
    taps = np.asarray(clock_taps, np.float32)
    order = len(taps) - 1
    sps32 = F(np.float32(sps))
    mi = F(np.float32(sps) - np.float32(max_deviation))
    mx = F(np.float32(sps) + np.float32(max_deviation))

    if state is None:
        state = dict(
            clock=sps32,
            last_sign=jnp.asarray(False),
            stream_pos=F(0.0),
            last_sym_boundary_pos=F(0.0),
            next_sym_middle=F(np.float32(sps) / np.float32(2.0)),
            # clock filter history, newest first, pre-filled with sps
            # (SymbolSync::new calls clock_filter.fill(sps),
            #  src/symbol_sync.rs:78)
            fbuf=jnp.full((max(order, 1),), sps32, F),
        )

    tap0 = F(taps[0])
    fb = jnp.asarray(taps[1:], F)  # multiplies history newest-first

    def clock_filter_clamped(fbuf, sample, lo, hi):
        # reference src/iir_filter.rs:113-124.  Sequential sum (not
        # jnp.dot) so the f32 association matches the native C++ port
        # exactly for any tap count.
        ret = tap0 * sample
        for j in range(order):
            ret = ret + fb[j] * fbuf[j]
        ret = jnp.clip(ret, lo, hi)
        if order > 0:
            fbuf = jnp.concatenate([ret[None], fbuf[:-1]])
        return fbuf, ret

    def step(s, sample):
        emit = s["stream_pos"] >= s["next_sym_middle"]
        next_mid = jnp.where(emit, s["next_sym_middle"] + s["clock"], s["next_sym_middle"])
        out_val = sample
        out_clk = s["clock"]

        sign = sample > F(0.0)
        changed = sign != s["last_sign"]
        do_adjust = changed & (s["stream_pos"] > F(0.0)) & (
            s["last_sym_boundary_pos"] > F(0.0)
        )

        # while t > mx { t2 = t - clock; if |t-clock| < |t2-clock| break; t=t2 }
        def wcond(t):
            t2 = t - s["clock"]
            keep = jnp.abs(t - s["clock"]) >= jnp.abs(t2 - s["clock"])
            return (t > mx) & keep

        t0 = s["stream_pos"] - s["last_sym_boundary_pos"]
        t = jax.lax.while_loop(wcond, lambda t: t - s["clock"], t0)
        in_range = (t > mi * F(0.8)) & (t < mx * F(1.2))
        apply = do_adjust & in_range

        fbuf2, filt = clock_filter_clamped(
            s["fbuf"], t - sps32, mi - sps32, mx - sps32
        )
        new_clock = filt + sps32
        # next_sym_middle = last_boundary + clock/2, bumped above stream_pos
        nm0 = s["last_sym_boundary_pos"] + new_clock / F(2.0)
        nm = jax.lax.while_loop(
            lambda v: v < s["stream_pos"], lambda v: v + new_clock, nm0
        )

        clock = jnp.where(apply, new_clock, s["clock"])
        next_mid = jnp.where(apply, nm, next_mid)
        fbuf = jnp.where(apply, fbuf2, s["fbuf"])

        last_boundary = jnp.where(changed, s["stream_pos"], s["last_sym_boundary_pos"])
        last_sign = jnp.where(changed, sign, s["last_sign"])

        pos = s["stream_pos"] + F(1.0)
        # Stay near zero for float precision (src/symbol_sync.rs:200-209)
        step_back = F(10.0) * clock
        do_sb = (pos > step_back) & (last_boundary > step_back) & (next_mid > step_back)
        pos = jnp.where(do_sb, pos - step_back, pos)
        last_boundary = jnp.where(do_sb, last_boundary - step_back, last_boundary)
        next_mid = jnp.where(do_sb, next_mid - step_back, next_mid)

        s = dict(
            clock=clock,
            last_sign=last_sign,
            stream_pos=pos,
            last_sym_boundary_pos=last_boundary,
            next_sym_middle=next_mid,
            fbuf=fbuf,
        )
        return s, (out_val, emit, out_clk)

    final, (vals, mask, clks) = jax.lax.scan(step, state, x, unroll=unroll)
    return (vals, mask, clks), final


def _ted_reduce(t0_raw, clock, mx):
    """Reduce the time-since-boundary toward the clock period: the
    reference's ``while t > mx { t2 = t - clock; if |t-clock| < |t2-clock|
    break; t = t2 }`` (src/symbol_sync.rs:152-163), with a closed-form
    pre-reduction so the residual loop is bounded.

    The pre-reduction's f32 floor can be off by ~1-2 ULP-of-the-ratio for
    gaps up to 2^24, leaving the residual in (mx, mx + ~4*clock]; six
    predicated subtract steps therefore cover every real event exactly
    (identical f32 sequence to the while-loop — asserted against a
    while_loop reference in tests), without a vmapped while_loop inside
    the event scan."""
    k0 = jnp.maximum(F(0.0), jnp.floor((t0_raw - mx) / clock) - F(1.0))
    t = t0_raw - k0 * clock
    for _ in range(6):
        t2 = t - clock
        keep = jnp.abs(t - clock) >= jnp.abs(t2 - clock)
        t = jnp.where((t > mx) & keep, t2, t)
    return t


def symbol_sync_events(x, sps: float, max_deviation: float = 0.5,
                       clock_taps=(0.5, 0.5), max_events: int | None = None,
                       unroll: int = 8, state=None, return_state: bool = False):
    """Event-driven reformulation of :func:`symbol_sync` — the device
    decode-bank path.

    The reference recurrence (src/symbol_sync.rs:115-218) only mutates
    its clock state at zero CROSSINGS (sign(x[n]) != sign(x[n-1]) — a
    vectorized precompute), and between crossings emissions follow the
    catch-up race ``emit at n iff n >= mid + clock * e(n-1)`` whose
    closed form is ``e(n) = min(n - p_k, max(0, floor((n - mid)/clock)
    + 1))``.  So the per-sample scan collapses to (1) a scan over the
    ``max_events`` crossing slots — the only true sequential chain — and
    (2) a vectorized emission-mask pass (the same floor-difference trick
    as ops/wpcr.py).  All positions are kept event-relative so f32 stays
    exact without the reference's step-back renormalization.

    NOT bit-identical to the scan: the emit comparison and the
    ``next_sym_middle`` catch-up use closed forms instead of repeated
    f32 adds, so on heavily noise-chattered input an emission can land
    one sample off (measured: identical decoded bits up to noise sigma
    0.3 on a unit NRZ corpus; ~1 bit/400 differs at sigma 0.6, where the
    bit is genuinely ambiguous).  Use :func:`symbol_sync` when exact
    reference/native equivalence matters; this form when throughput
    does — the sequential chain shrinks by ~``n / max_events``.

    Returns ``((values, mask, clocks), valid)`` where ``valid`` is False
    if the input had more than ``max_events`` crossings (results are
    then untrustworthy; re-run with a bigger budget or fall back).
    ``max_events`` defaults to ~4x the expected crossing count for NRZ
    at ``sps`` (pow-2 bucketed so nearby lengths share compiles, capped
    at N//4); pass it explicitly for chattery input.

    Streaming (r5, the blocks.SymbolSync(method="events") path): pass
    the previous chunk's carried ``state`` and/or ``return_state=True``
    to get ``((values, mask, clocks), valid, new_state)``.  All carried
    positions are event-relative integers shifted per chunk, so chunked
    output is EXACTLY the whole-burst output (asserted in
    tests/test_multichannel.py) for gaps up to f32-exact 2^24 samples.
    """
    if not sps > 1.0:
        raise ValueError("sps must be > 1")
    x = jnp.asarray(x, F)
    n = int(x.shape[0])
    if max_events is None:
        want = max(64, int(4 * n / sps))
        max_events = min(1 << (want - 1).bit_length(), max(8, n // 4))
    taps = np.asarray(clock_taps, np.float32)
    order = len(taps) - 1
    sps32 = F(np.float32(sps))
    mi = F(np.float32(sps) - np.float32(max_deviation))
    mx = F(np.float32(sps) + np.float32(max_deviation))
    tap0 = F(taps[0])
    fb = jnp.asarray(taps[1:], F)

    if state is None:
        last_sign0 = jnp.asarray(False)
        started0 = jnp.asarray(False)
    else:
        last_sign0 = state["last_sign"]
        started0 = state["started"]

    sign = x > F(0.0)
    changed = jnp.concatenate([sign[:1] != last_sign0, sign[1:] != sign[:-1]])
    events = jnp.flatnonzero(changed, size=max_events, fill_value=n)
    valid = jnp.sum(changed) <= max_events

    def clock_filter(fbuf, sample):
        ret = tap0 * sample
        for j in range(order):
            ret = ret + fb[j] * fbuf[j]
        ret = jnp.clip(ret, mi - sps32, mx - sps32)
        if order > 0:
            fbuf = jnp.concatenate([ret[None], fbuf[:-1]])
        return fbuf, ret

    def event_step(s, p):
        is_pad = p >= n
        gap_i = p - s["p_prev"]
        gap = gap_i.astype(F)
        # emissions in (p_prev, p] bump mid BEFORE the crossing adjusts
        e_unc = jnp.floor((gap - s["mid_off"]) / s["clock"]).astype(jnp.int32) + 1
        e = jnp.clip(e_unc, 0, gap_i)
        mid_off_p = s["mid_off"] + e.astype(F) * s["clock"] - gap  # rel p

        # TED: t = time since last boundary, reduced toward clock (the
        # reference's sequential f32 while-loop in bounded predicated
        # form — see _ted_reduce).  The reduced t CAN land in_range for
        # long gaps (whole symbol runs during acquisition), so the raw
        # offset is kept for the next_sym_middle computation below —
        # only the TED residue uses the reduction.
        t0_raw = gap + s["bnd_off"]
        t = _ted_reduce(t0_raw, s["clock"], mx)
        in_range = (t > mi * F(0.8)) & (t < mx * F(1.2))
        # the reference's stream_pos > 0 guard: local index 0 is the
        # global stream start only on the first chunk
        do_adjust = (started0 | (p > 0)) & s["have_boundary"]
        apply = do_adjust & in_range & ~is_pad

        fbuf2, filt = clock_filter(s["fbuf"], t - sps32)
        new_clock = filt + sps32
        # next_sym_middle = last_boundary + clock/2, bumped to >= p
        # (closed form of the reference's catch-up while-loop; the RAW
        # boundary offset, not the TED-reduced one — the reference bumps
        # from the true last_boundary).  The reference's repeated adds
        # end at v >= stream_pos, so clamp the f32 rounding to >= 0.
        nm0 = new_clock / F(2.0) - t0_raw  # rel p
        k = jnp.maximum(F(0.0), jnp.ceil(-nm0 / new_clock))
        nm = jnp.maximum(nm0 + k * new_clock, F(0.0))

        clock = jnp.where(apply, new_clock, s["clock"])
        mid_off = jnp.where(apply, nm, mid_off_p)
        fbuf = jnp.where(apply, fbuf2, s["fbuf"])
        s2 = dict(
            clock=clock,  # apply already excludes padding slots
            p_prev=jnp.where(is_pad, s["p_prev"], p),
            mid_off=jnp.where(is_pad, s["mid_off"], mid_off),
            bnd_off=jnp.where(is_pad, s["bnd_off"], F(0.0)),
            have_boundary=jnp.where(is_pad, s["have_boundary"],
                                    started0 | (p > 0)),
            fbuf=jnp.where(is_pad, s["fbuf"], fbuf),
        )
        return s2, (s2["mid_off"], s2["clock"])

    if state is None:
        state0 = dict(
            clock=sps32,
            p_prev=jnp.int32(-1),
            mid_off=sps32 / F(2.0) + F(1.0),  # mid = sps/2, rel p_prev = -1
            bnd_off=F(1.0),                   # last_boundary = 0, rel -1
            have_boundary=jnp.asarray(False),
            fbuf=jnp.full((max(order, 1),), sps32, F),
        )
    else:
        state0 = state["ev"]
    final, (ev_mid, ev_clock) = jax.lax.scan(
        event_step, state0, events.astype(jnp.int32), unroll=unroll
    )

    # ---- vectorized emission mask over all samples ------------------
    p_tab = jnp.concatenate([jnp.asarray(state0["p_prev"], jnp.int32)[None],
                             events.astype(jnp.int32)])
    mid_tab = jnp.concatenate([jnp.asarray(state0["mid_off"], F)[None],
                               ev_mid])
    clk_tab = jnp.concatenate([jnp.asarray(state0["clock"], F)[None],
                               ev_clock])
    eid = jnp.cumsum(changed.astype(jnp.int32)) - changed.astype(jnp.int32)
    p_k = jnp.take(p_tab, eid)
    mid_k = jnp.take(mid_tab, eid)
    clk_k = jnp.take(clk_tab, eid)
    ns = jnp.arange(n, dtype=jnp.int32)
    rel = (ns - p_k).astype(F)

    def e_of(r, ri):
        unc = jnp.floor((r - mid_k) / clk_k).astype(jnp.int32) + 1
        return jnp.clip(unc, 0, ri)

    e_n = e_of(rel, ns - p_k)
    e_nm1 = e_of(rel - F(1.0), ns - p_k - 1)
    mask = e_n > e_nm1
    if state is None and not return_state:
        return (x, mask, clk_k), valid
    new_state = dict(
        # event-scan carry, re-anchored to the next chunk's origin
        ev=dict(final, p_prev=final["p_prev"] - jnp.int32(n)),
        last_sign=sign[-1] if n else last_sign0,
        started=jnp.asarray(True) if n else started0,
    )
    return (x, mask, clk_k), valid, new_state


def zero_crossing_sync(x, sps: float, max_deviation: float = 0.5, state=None,
                       unroll: int = 1):
    """Fixed-clock zero-crossing recovery (src/zero_crossing.rs:26-150).

    Emits the sample at sps/2 past each zero crossing, then every sps.
    Returns ((values, mask), final_state).  ``unroll`` as in
    :func:`symbol_sync` (bit-identical, fewer scan steps).
    """
    if not sps > 1.0:
        raise ValueError("sps must be > 1")
    x = jnp.asarray(x, F)
    sps32 = F(np.float32(sps))
    if state is None:
        state = dict(
            last_sign=jnp.asarray(False),
            last_cross=F(0.0),
            counter=jnp.uint32(0),
        )

    def step(s, sample):
        # reference: if counter == (last_cross + clock/2) as u64 { emit }
        emit = s["counter"] == (s["last_cross"] + sps32 / F(2.0)).astype(jnp.uint32)
        last_cross = jnp.where(emit, s["last_cross"] + sps32, s["last_cross"])
        sign = sample > F(0.0)
        changed = sign != s["last_sign"]
        last_cross = jnp.where(changed, jnp.asarray(s["counter"], F), last_cross)
        counter = s["counter"] + jnp.uint32(1)
        # step-back to preserve float precision (src/zero_crossing.rs:133-137)
        step_back = (F(10.0) * sps32).astype(jnp.uint32)
        do_sb = (counter > step_back) & (last_cross.astype(jnp.uint32) > step_back)
        counter = jnp.where(do_sb, counter - step_back, counter)
        last_cross = jnp.where(do_sb, last_cross - jnp.asarray(step_back, F), last_cross)
        s = dict(last_sign=sign, last_cross=last_cross, counter=counter)
        return s, (sample, emit)

    final, (vals, mask) = jax.lax.scan(step, state, x, unroll=unroll)
    return (vals, mask), final


def compact(values, mask):
    """Host helper: gather emitted symbols from a masked stream."""
    values = np.asarray(values)
    mask = np.asarray(mask)
    return values[mask]


def recover_symbols(x, sps: float, max_deviation: float = 0.5, clock_taps=(0.5, 0.5)):
    """Symbol sync returning the compacted symbol array.

    Dispatches the sequential low-rate recurrence to the native C++
    runtime when available (an exact f32 replication — rr_symbol_sync in
    native/rr_native.cpp, ~100x the lax.scan); falls back to the scan.
    """
    from .. import native

    xh = np.asarray(x, np.float32)
    out = native.symbol_sync_f32(xh, sps, max_deviation, np.asarray(clock_taps))
    if out is not None:
        return out[0]
    (vals, mask, _), _ = symbol_sync(xh, sps, max_deviation, clock_taps)
    return compact(vals, mask)
