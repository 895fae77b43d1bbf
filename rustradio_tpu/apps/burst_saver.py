"""Burst saver: listen for power bursts, save each as a separate IQ file
(reference examples/burst_saver.rs).

Usage:
    python -m rustradio_tpu.apps.burst_saver -r capture.c32 \
        --sample_rate 300k -o bursts/
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import ops
from .. import taps as tapgen
from ..dtypes import parse_frequency
from ..io import rawfile


@functools.partial(
    jax.jit, static_argnames=("samp_rate", "new_rate", "iir_alpha", "delay_n")
)
def _front(iq, samp_rate, new_rate, iir_alpha, delay_n):
    lp = tapgen.low_pass_complex(samp_rate, 20_000.0, 100.0, "hamming")
    x = ops.filter_complex(iq, lp)
    x = ops.rational_resampler(x, int(new_rate), int(samp_rate))
    power = ops.single_pole_iir(ops.complex_to_mag2(x), iir_alpha)
    # The reference delays the data path so the burst start isn't clipped.
    return power, ops.delay(x, delay_n)


def extract_bursts(
    iq,
    samp_rate: float,
    new_rate: float = 50_000.0,
    iir_alpha: float = 0.01,
    threshold: float = 0.0001,
    delay: int = 3000,
    tail: int = 5000,
) -> list[np.ndarray]:
    """Channel filter -> resample -> power-gate with pre-trigger delay ->
    segment extraction (reference examples/burst_saver.rs:90-126)."""
    power, data_dev = _front(
        jnp.asarray(iq), float(samp_rate), float(new_rate), float(iir_alpha), int(delay)
    )
    data = np.asarray(data_dev)
    n = min(len(data), int(power.shape[0]))
    start, end = ops.burst_tagger(power[:n], threshold)
    return ops.stream_to_pdu(
        data[:n], np.asarray(start), np.asarray(end), int(new_rate), tail
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-r", "--read", required=True, help="complex64 IQ file")
    p.add_argument("-o", "--out", required=True, help="output directory")
    p.add_argument("--sample_rate", type=parse_frequency, default=300_000.0)
    p.add_argument("--threshold", type=float, default=0.0001)
    p.add_argument("--iir_alpha", type=float, default=0.01)
    p.add_argument("--delay", type=int, default=3000)
    p.add_argument("--tail", type=int, default=5000)
    opt = p.parse_args(argv)

    iq = rawfile.read_samples(opt.read, "c32")
    t0 = time.time()
    bursts = extract_bursts(
        iq, float(opt.sample_rate),
        iir_alpha=opt.iir_alpha, threshold=opt.threshold,
        delay=opt.delay, tail=opt.tail,
    )
    dt = time.time() - t0
    os.makedirs(opt.out, exist_ok=True)
    stamp = time.strftime("%Y-%m-%dT%H:%M:%S")
    for i, burst in enumerate(bursts):
        rawfile.write_samples(
            os.path.join(opt.out, f"{stamp}.{i:06d}.c32"), burst, "c32"
        )
    print(f"saved {len(bursts)} bursts in {dt:.2f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
