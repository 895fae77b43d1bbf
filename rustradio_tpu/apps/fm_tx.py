"""FM transmitter: audio file -> FM-modulated IQ (reference examples/fm_tx.rs).

Usage:
    python -m rustradio_tpu.apps.fm_tx -r audio.au --deviation 5k \
        --sample_rate 240k --out fm.c32
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import ops
from ..dtypes import parse_frequency
from ..io import au, rawfile


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-r", "--read", required=True, help=".au audio in")
    p.add_argument("--sample_rate", type=parse_frequency, default=240_000.0)
    p.add_argument("--deviation", type=parse_frequency, default=75_000.0)
    p.add_argument("--out", required=True, help=".c32 IQ out")
    opt = p.parse_args(argv)

    import functools

    import jax
    audio, rate = au.au_read(opt.read)

    # upsample audio to the IQ rate, then FM modulate with a VCO, under
    # one jit
    @functools.partial(jax.jit, static_argnames=("sr", "ar", "dev"))
    def modulate(a, sr, ar, dev):
        up = ops.rational_resampler(a, int(sr), int(ar))
        iq, _ = ops.vco(up, k=2 * np.pi * dev / sr)
        return iq

    iq = modulate(audio.astype(np.float32), float(opt.sample_rate), float(rate),
                  float(opt.deviation))
    rawfile.write_samples(opt.out, np.asarray(iq))
    print(f"wrote {iq.shape[0]} IQ samples to {opt.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
