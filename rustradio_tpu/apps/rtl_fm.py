"""Narrow-band FM receiver from an IQ capture (reference examples/rtl_fm.rs,
file path: capture -> channel filter -> FM demod -> audio resample -> .au).

Usage:
    python -m rustradio_tpu.apps.rtl_fm -r capture.c32 --sample_rate 1.024m \
        --out audio.au
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import taps as tapgen
from ..dtypes import parse_frequency
from ..io import au, rawfile
from .. import ops


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-r", "--read", required=True,
                   help="IQ capture file, 'sim' for the loopback SDR driver, "
                        "or 'rtl[:index]' for a live RTL-SDR via pyrtlsdr")
    p.add_argument("--sample_rate", type=parse_frequency, default=1_024_000.0)
    p.add_argument("--audio_rate", type=parse_frequency, default=48_000.0)
    p.add_argument("--cutoff", type=parse_frequency, default=100_000.0)
    p.add_argument("--deviation", type=parse_frequency, default=75_000.0)
    p.add_argument("--volume", type=float, default=1.0)
    p.add_argument("--out", required=True, help=".au output file")
    p.add_argument("--rtl_u8", action="store_true", help="input is RTL-SDR u8 IQ")
    p.add_argument("--precision", choices=["w3", "i8"], default="w3",
                   help="--rtl_u8 FM chain precision (ops.fm_chain): 'w3' "
                        "bf16 planes (the fused kernel on the GPU), 'i8' "
                        "the s8 wire grid (plain XLA form)")
    p.add_argument("--frequency", type=parse_frequency, default=100_000_000.0,
                   help="sim/rtl mode: tuner center frequency")
    p.add_argument("--sim_tone", action="append", default=[],
                   help="sim mode: FREQ:AMP[:AUDIO:DEV] RF tone (repeatable)")
    p.add_argument("--seconds", type=float, default=1.0,
                   help="sim/rtl mode: capture length")
    opt = p.parse_args(argv)

    iq = None
    u8_planes = None
    is_live = opt.read == "sim" or opt.read == "rtl" or opt.read.startswith("rtl:")
    if is_live and opt.rtl_u8:
        p.error("--rtl_u8 applies to capture files, not sim/rtl live input")
    if opt.read == "rtl" or opt.read.startswith("rtl:"):
        from ..hw import RtlDriver, SdrSource

        idx_s = opt.read.split(":", 1)[1] if ":" in opt.read else ""
        try:
            idx = int(idx_s) if idx_s else 0
        except ValueError:
            p.error(f"bad rtl device spec {opt.read!r}: want rtl or rtl:<index>")
        drv = RtlDriver(
            frequency=float(opt.frequency),
            sample_rate=float(opt.sample_rate),
            gain=1.0,
            device_index=idx,
        )
        src = SdrSource(drv)
        iq = np.asarray(src.emit(0, int(opt.seconds * opt.sample_rate)))
        for t in src.emit_tags(0, len(iq)):
            print(f"tag {t.key} = {t.val}", file=sys.stderr)
        drv.close()
    elif opt.read == "sim":
        from ..hw import SdrSource, SimDriver
        from ..hw.driver import parse_sim_tone

        tones = [parse_sim_tone(s) for s in opt.sim_tone] or [
            (opt.frequency, 0.8, 1_000.0, opt.deviation / 2)
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
        for t in src.emit_tags(0, len(iq)):
            print(f"tag {t.key} = {t.val}", file=sys.stderr)
    if not is_live and opt.rtl_u8:
        raw = np.fromfile(opt.read, np.uint8)
        # keep the raw planes too, on the (u8 - 127)/128 wire grid: exact
        # in bf16 (w3) AND on the s8 grid (i8); the demod
        # is scale-invariant so the normalization is free
        pairs = raw[: len(raw) // 2 * 2].reshape(-1, 2).astype(np.float32)
        u8_planes = ((pairs[:, 0] - 127.0) / 128.0,
                     (pairs[:, 1] - 127.0) / 128.0)
        iq = rawfile.rtlsdr_decode(raw)
    elif not is_live:
        # any other value of --read is a c32 capture file path
        iq = rawfile.read_samples(opt.read, "c32")

    import functools

    import jax
    import jax.numpy as jnp

    fs = float(opt.sample_rate)

    # the whole chain under one jit
    @functools.partial(jax.jit, static_argnames=("sr", "ar", "cutoff", "dev"))
    def chain(x, sr, ar, cutoff, dev):
        lp = tapgen.low_pass_complex(sr, cutoff, cutoff / 2, "hamming")
        y = ops.filter_complex(x, lp)
        demod = ops.quadrature_demod(y, sr / (2 * np.pi * dev))
        return ops.rational_resampler(demod, int(ar), int(sr))

    @functools.partial(jax.jit,
                       static_argnames=("sr", "ar", "cutoff", "dev", "prec"))
    def chain_u8(i_pl, q_pl, sr, ar, cutoff, dev, prec):
        # 8-bit wire format: filter + demod as ONE fused kernel pass on
        # the GPU with exact planes (ops.fm_chain)
        from ..models.fm import fm_demod_chain_planar

        demod = fm_demod_chain_planar(
            i_pl, q_pl, sr, cutoff, cutoff / 2, deci=1,
            gain=sr / (2 * np.pi * dev), precision=prec,
        )
        return ops.rational_resampler(demod, int(ar), int(sr))

    if u8_planes is not None:
        audio = chain_u8(u8_planes[0], u8_planes[1], fs, float(opt.audio_rate),
                         float(opt.cutoff), float(opt.deviation),
                         opt.precision)
    else:
        audio = chain(jnp.asarray(iq), fs, float(opt.audio_rate),
                      float(opt.cutoff), float(opt.deviation))
    audio = np.asarray(audio) * opt.volume
    with open(opt.out, "wb") as f:
        f.write(au.au_encode(np.clip(audio, -1, 1), int(opt.audio_rate)))
    print(f"wrote {len(audio)} audio samples to {opt.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
