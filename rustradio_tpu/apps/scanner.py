"""Wideband channel scanner: polyphase-channelize a capture, report the
strongest channels and optionally FM-demodulate one to audio.

A showcase of the channel-parallel dimension (SURVEY §2.6 item 6 — the
256-channel PFB + per-channel demod bank, no reference equivalent).

Usage:
    python -m rustradio_tpu.apps.scanner -r wideband.c32 --sample_rate 2.56m
    python -m rustradio_tpu.apps.scanner -r wideband.c32 --sample_rate 2.56m \
        --demod 37 --out ch37.f32
"""

from __future__ import annotations

import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np

from ..dtypes import parse_frequency
from ..io import rawfile
from ..parallel.channelizer import channelizer_taps, pfb_channelize


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-r", "--read", required=True,
                   help="complex64 IQ capture, or 'sim' for the loopback driver")
    p.add_argument("--sample_rate", type=parse_frequency, required=True)
    p.add_argument("-n", "--channels", type=int, default=256)
    p.add_argument("--top", type=int, default=10, help="channels to report")
    p.add_argument("--demod", type=int, help="FM-demod this channel index")
    p.add_argument("--decode", action="store_true",
                   help="decode AX.25 on every active channel concurrently "
                        "(one vmapped clock-recovery scan for the whole band)")
    p.add_argument("--max_active", type=int, default=8,
                   help="--decode: channel bank size")
    p.add_argument("--sync", choices=["scan", "events"], default="scan",
                   help="--decode clock recovery: 'scan' = bit-exact "
                        "per-sample recurrence, 'events' = event-driven "
                        "(~sps-times shorter sequential chain)")
    p.add_argument("-o", "--out", help="write demodulated channel audio (.f32)")
    p.add_argument("--frequency", type=parse_frequency, default=100_000_000.0,
                   help="sim mode: tuner center frequency")
    p.add_argument("--sim_tone", action="append", default=[],
                   help="sim mode: FREQ:AMP[:AUDIO:DEV] RF tone (repeatable)")
    p.add_argument("--seconds", type=float, default=0.5,
                   help="sim mode: capture length")
    opt = p.parse_args(argv)
    if opt.demod is not None:
        if not 0 <= opt.demod < opt.channels:
            p.error(f"--demod must be in [0, {opt.channels})")
        if not opt.out:
            p.error("--demod requires --out")

    if opt.read == "sim":
        from ..hw import SdrSource, SimDriver
        from ..hw.driver import parse_sim_tone

        tones = [parse_sim_tone(s) for s in opt.sim_tone] or [
            (opt.frequency + 0.2e6, 0.5),
            (opt.frequency - 0.35e6, 0.3),
        ]
        drv = SimDriver(
            frequency=float(opt.frequency),
            sample_rate=float(opt.sample_rate),
            gain=1.0,
            tones=[t for t in tones if len(t) == 2],
            fm_tones=[t for t in tones if len(t) == 4],
        )
        src = SdrSource(drv)
        iq = np.asarray(src.emit(0, int(opt.seconds * opt.sample_rate)))
    else:
        iq = rawfile.read_samples(opt.read, "c32")

    if opt.decode:
        from ..models.multichannel import decode_band_ax25

        results = decode_band_ax25(
            iq, float(opt.sample_rate), n_channels=opt.channels,
            max_active=opt.max_active, sync_method=opt.sync,
        )
        for r in results:
            for pkt in r.packets:
                route = ">".join(pkt.addresses[:2][::-1]) if pkt.addresses else "?"
                print(f"ch{r.channel:4d} {r.freq/1e3:+9.1f}k  {route}: "
                      f"{pkt.info[:80]!r}")
        total = sum(len(r.packets) for r in results)
        print(f"decoded {total} packets on {len(results)} channels",
              file=sys.stderr)
        return 0

    M = opt.channels
    taps = channelizer_taps(M, 8)
    fs = float(opt.sample_rate)

    @jax.jit
    def scan(x):
        ch = pfb_channelize(x, taps, M)  # (frames, M)
        power = jnp.mean(jnp.real(ch) ** 2 + jnp.imag(ch) ** 2, axis=0)
        return power, ch

    power, ch = scan(jnp.asarray(iq))
    power = np.asarray(power)
    order = np.argsort(power)[::-1][: opt.top]
    print(f"{'chan':>5} {'freq':>12} {'power dB':>9}")
    for k in order:
        # channel k center: k*fs/M, wrapping to negative above M/2
        f = (k if k < M / 2 else k - M) * fs / M
        print(f"{k:5d} {f/1e3:10.1f}k {10*np.log10(power[k]+1e-20):9.1f}")

    if opt.demod is not None:
        # demodulate just the requested channel column
        @jax.jit
        def one(chh):
            col = chh[:, opt.demod]
            d = jnp.conj(col[:-1]) * col[1:]
            return jnp.arctan2(
                jnp.imag(d).astype(jnp.float32), jnp.real(d).astype(jnp.float32)
            )

        audio = np.asarray(one(ch))
        rawfile.write_samples(opt.out, audio, "f32")
        print(f"wrote {len(audio)} samples (channel {opt.demod}, "
              f"{fs/M/1e3:.1f} ksps) to {opt.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
