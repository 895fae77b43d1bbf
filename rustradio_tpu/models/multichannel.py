"""Wideband multi-channel AX.25 decoding — the channel-parallel receiver.

No reference equivalent (its graphs are single-chain; SURVEY §2.6 item 6
names channel parallelism as the dimension the declarative model adds):
one wideband capture is polyphase-channelized on the device, the per-channel
FM + AFSK demod bank runs as one batched program, and clock recovery for
ALL channels advances in a single vmapped ``lax.scan`` — C sequential
recurrences ride parallel lanes for the wall-clock price of one.  Only the
final per-channel HDLC byte assembly runs on host (native C++ when
built).

This is what "scan the band and decode every APRS channel at once" looks
like on an accelerator.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import ops
from .. import taps as tapgen
from ..parallel.channelizer import channelizer_taps, pfb_channelize
from .ax25 import Ax25Packet


@functools.partial(
    jax.jit,
    static_argnames=("sps", "max_deviation", "clock_taps", "unroll", "method",
                     "max_events", "return_valid"),
)
def recover_symbols_batch(xs, sps: float, max_deviation: float = 0.5,
                          clock_taps=(0.5, 0.5), unroll: int = 16,
                          method: str = "scan", max_events: int | None = None,
                          return_valid: bool = False):
    """Vmapped SymbolSync over a (C, N) batch of NRZ streams.

    Returns (values, mask, clocks), each (C, N) — all C sequential
    clock-recovery recurrences advance in lockstep in ONE scan.

    ``unroll`` unrolls the scan body (bit-identical outputs — lax.scan's
    mechanical unroll); the per-step dispatch overhead dominates this
    tiny body on an accelerator, so unrolled banks run several times faster.

    ``method="events"`` switches to :func:`ops.symbol_sync.
    symbol_sync_events`: the sequential chain shrinks from N samples to
    ``max_events`` zero-crossing slots (default N//4; for clean NRZ a
    budget of ~4x the expected crossing count, N/sps * 2, is ample and
    much faster).  Decode-equivalent, not bit-identical — see its
    docstring.  Channels whose crossing count exceeds the slot budget
    produce untrustworthy symbols: pass ``return_valid=True`` to also
    get the per-channel overflow flags (a 4th output, all-True for the
    scan method) and fall back per channel.
    """
    from ..ops.symbol_sync import symbol_sync, symbol_sync_events

    if method == "events":
        f = jax.vmap(
            lambda x: symbol_sync_events(x, sps, max_deviation, clock_taps,
                                         max_events=max_events,
                                         unroll=unroll)
        )
        (vals, mask, clks), valid = f(jnp.asarray(xs, jnp.float32))
    elif method == "scan":
        f = jax.vmap(
            lambda x: symbol_sync(x, sps, max_deviation, clock_taps,
                                  unroll=unroll)[0]
        )
        vals, mask, clks = f(jnp.asarray(xs, jnp.float32))
        valid = jnp.ones(vals.shape[0], bool)
    else:
        raise ValueError(f"unknown method {method!r}; use 'scan' or 'events'")
    if return_valid:
        return vals, mask, clks, valid
    return vals, mask, clks


@functools.partial(jax.jit, static_argnames=("chan_rate",))
def _afsk_bank(channels, chan_rate: float):
    """(C, N) complex channel streams -> (C, N-1) Bell-202 NRZ floats.

    FM discriminator + vmapped Hilbert/audio filters per channel — one
    compiled program for the whole bank.
    """
    from .ax25 import bell202_demod

    d = jnp.conj(channels[:, :-1]) * channels[:, 1:]
    fm = jnp.arctan2(
        jnp.imag(d).astype(jnp.float32), jnp.real(d).astype(jnp.float32)
    )
    return jax.vmap(lambda a: bell202_demod(a, chan_rate))(fm)


@functools.partial(jax.jit, static_argnames=("rate",))
def _bank_demod(ch, idx, rate):
    """Channel selection + demod bank under ONE jit (module-level so the
    compiled program is reused across decode_band_ax25 calls)."""
    return _afsk_bank(jnp.transpose(ch[:, idx]), rate)


@dataclasses.dataclass
class ChannelDecode:
    channel: int
    freq: float  # channel center relative to capture center, Hz
    packets: list


def decode_band_ax25(
    iq,
    samp_rate: float,
    n_channels: int = 64,
    baud: float = 1200.0,
    max_active: int = 8,
    power_floor_db: float = -40.0,
    fix_bits: bool = False,
    sync_method: str = "scan",
) -> list[ChannelDecode]:
    """Channelize a wideband capture and decode AX.25 on every active
    channel concurrently.

    ``max_active`` bounds the decode bank (static shapes); channels are
    picked by power above ``power_floor_db`` relative to the strongest.
    The per-channel rate samp_rate/n_channels must give > 2 samples per
    symbol at ``baud``.  ``sync_method="events"`` uses the event-driven
    clock recovery (~sps-times shorter sequential chain per channel —
    see :func:`ops.symbol_sync.symbol_sync_events`); ``"scan"`` is the
    bit-exact reference recurrence.
    """
    M = int(n_channels)
    fs = float(samp_rate)
    chan_rate = fs / M
    sps = chan_rate / float(baud)
    if sps <= 2.0:
        raise ValueError(
            f"{chan_rate:.0f} Hz per channel gives only {sps:.1f} samples/"
            f"symbol at {baud:.0f} bd; use fewer channels"
        )

    taps = channelizer_taps(M, 8)

    @jax.jit
    def split(x):
        ch = pfb_channelize(x, taps, M)  # (frames, M)
        power = jnp.mean(jnp.real(ch) ** 2 + jnp.imag(ch) ** 2, axis=0)
        return ch, power

    ch, power = split(jnp.asarray(iq))
    power = np.asarray(power)
    order = np.argsort(power)[::-1]
    floor = power[order[0]] * 10.0 ** (power_floor_db / 10.0)
    active = [int(k) for k in order[:max_active] if power[k] > floor]
    if not active:
        return []

    nrz = _bank_demod(ch, jnp.asarray(active), chan_rate)
    nrz_np = np.asarray(nrz)
    if sync_method == "events":
        # budget ~4x the expected crossing count (power-of-2 bucketed so
        # repeat calls share compiles), never below the N//4 safety net's
        # own sequential win
        want = max(1024, int(4 * nrz_np.shape[1] / sps))
        budget = 1 << (want - 1).bit_length()
        vals, mask, _, valid = recover_symbols_batch(
            nrz_np, sps, method="events", max_events=budget,
            return_valid=True)
        vals, mask = np.array(vals), np.array(mask)
        bad = ~np.asarray(valid)
        if bad.any():
            # chatter beyond the budget: those channels re-run bit-exact
            vs, ms, _ = recover_symbols_batch(nrz_np, sps)
            vals[bad] = np.asarray(vs)[bad]
            mask[bad] = np.asarray(ms)[bad]
    else:
        vals, mask, _ = recover_symbols_batch(nrz_np, sps,
                                              method=sync_method)
        vals, mask = np.asarray(vals), np.asarray(mask)

    out: list[ChannelDecode] = []
    for row, k in enumerate(active):
        syms = vals[row][mask[row]]
        bits = np.asarray(ops.nrzi_decode(ops.binary_slicer(jnp.asarray(syms))))
        pkts, _ = ops.hdlc_deframe(bits, 10, 1500, fix_bits=fix_bits)
        if not pkts:
            continue
        f = (k if k < M / 2 else k - M) * fs / M
        out.append(
            ChannelDecode(
                channel=k,
                freq=f,
                packets=[Ax25Packet(np.asarray(d), int(p)) for d, p in pkts],
            )
        )
    return out
