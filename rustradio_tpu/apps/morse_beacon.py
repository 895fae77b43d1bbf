"""Morse beacon: keyed CW carrier to IQ or audio (reference
examples/morse_beacon.rs).

Usage:
    python -m rustradio_tpu.apps.morse_beacon --msg "CQ CQ DE N0CALL" \
        --wpm 20 --sample_rate 48k --out beacon.c32
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import ops
from ..blocks.packets import morse_encode_bits
from ..dtypes import parse_frequency
from ..io import au, rawfile


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--msg", required=True)
    p.add_argument("--wpm", type=float, default=20.0)
    p.add_argument("--sample_rate", type=parse_frequency, default=48000.0)
    p.add_argument("--tone", type=parse_frequency, default=600.0)
    p.add_argument("--out", required=True, help=".c32 IQ or .au audio")
    opt = p.parse_args(argv)

    import jax
    bits = morse_encode_bits(opt.msg)
    dit_s = 1.2 / opt.wpm  # standard PARIS timing
    sps = int(opt.sample_rate * dit_s)
    key = np.repeat(bits.astype(np.float32), sps)
    n = len(key)

    # keyed tone under jit
    @jax.jit
    def keyed(k):
        return ops.signal_source_c(n, opt.sample_rate, opt.tone, 1.0) * k

    iq = np.asarray(keyed(key))
    if opt.out.endswith(".au"):
        with open(opt.out, "wb") as f:
            f.write(au.au_encode(iq.real * 0.8, int(opt.sample_rate)))
    else:
        rawfile.write_samples(opt.out, iq)
    print(f"wrote {n} samples ({n/opt.sample_rate:.1f}s) to {opt.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
