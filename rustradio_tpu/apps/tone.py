"""Generate a test tone to a raw sample file (reference examples/tone.rs /
simple_graph.rs).

Usage:
    python -m rustradio_tpu.apps.tone --freq 1k --sample_rate 48k \
        --seconds 1 --out tone.c32
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import ops
from ..dtypes import parse_frequency
from ..io import rawfile


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--freq", type=parse_frequency, default=1000.0)
    p.add_argument("--sample_rate", type=parse_frequency, default=48000.0)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--amplitude", type=float, default=0.5)
    p.add_argument("--real", action="store_true", help="write f32 instead of c32")
    p.add_argument("--out", required=True)
    opt = p.parse_args(argv)

    import functools

    import jax
    n = int(opt.sample_rate * opt.seconds)
    if opt.real:
        f = functools.partial(ops.signal_source_f, n, opt.sample_rate, opt.freq, opt.amplitude)
        y = np.asarray(jax.jit(f)())
    else:
        f = functools.partial(ops.signal_source_c, n, opt.sample_rate, opt.freq, opt.amplitude)
        y = np.asarray(jax.jit(f)())
    rawfile.write_samples(opt.out, y)
    print(f"wrote {n} samples to {opt.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
