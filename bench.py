#!/usr/bin/env python3
"""Headline benchmark: FM-demod chain throughput on the GPU.

Chain: 100 kHz channel low-pass (low_pass(1.024 MHz, 100 kHz, 50 kHz) —
the reference's own micro-benchmark filter, benches/bench_rustradio.rs:
72-125) + decimate-by-4 + quadrature demod, on 2^24 samples.  On the GPU
it runs as ONE fused Pallas kernel (ops.fm_chain, Triton route): FIR on
both I/Q planes + polynomial-atan2 discriminator per block, so device
memory traffic is the two input planes once and the f32 audio once.

The input is 8-bit-grid I/Q ((u8-127)/128 levels, the rtl-sdr wire format,
reference src/rtlsdr_decode.rs), made on the device and held as bf16
planes — exact for that grid — which the kernel reads at
``precision="w3"``.  ``bytes_per_sample`` is what that form reads and
writes per input sample: two bf16 plane reads (4 B) + the f32 audio write
at 1/deci (1 B).

Extra cells ride the same line: ``fm_chain_i8_msps`` (the s8-grid contract,
plain XLA form), ``graph_fm_chain_msps`` (the chain built from blocks,
VectorSource planes -> FloatToComplex -> FirFilter -> QuadratureDemod ->
DeviceFoldSink, through Graph.compile_device_loop, lowered to the kernel),
``channelizer_256ch_msps`` and ``decode_bank_events_msps``.  A cell that
cannot run is listed under ``absent`` with its reason.

Timing: back-to-back calls with one ``block_until_ready`` per run, median
of 5 runs (benches/bench_kernels.time_call).

Baseline: the reference publishes one full-chain wall-time figure —
ax25-1200-rx over WA8LMF CD track 1 (44.1 kHz * ~30 min = 79.4 Msamples) in
0.929 s multithreaded with 40 MB buffers (reference src/stream.rs:100-104),
i.e. ~85.4 Msamples/s for its full receive chain on the author's x86 box.
``vs_baseline`` is measured Msamples/s divided by that 85.4.

Without a GPU the script fails.  Prints exactly one JSON line.
"""

import json
import os
import subprocess
import sys
import traceback

import jax
import jax.numpy as jnp
import numpy as np

from benches.bench_kernels import (decode_bank_input, msps, require_gpu,
                                   time_call, wire_planes)
from rustradio_tpu.models.fm import chain_taps

BASELINE_MSPS = 85.4  # reference ax25-1200-rx: 79.4 Msamples / 0.929 s
N = 1 << 24
DECI = 4


def cell_i8(n):
    from rustradio_tpu.models.fm import fm_demod_chain_planar

    a, b = wire_planes(n)
    return msps(n, time_call(lambda x, y: fm_demod_chain_planar(x, y, precision="i8"), a, b))


def cell_graph(n, iters=16):
    from rustradio_tpu import blocks
    from rustradio_tpu.graph import Graph

    a, b = (np.asarray(p) for p in wire_planes(n))
    taps = chain_taps()
    g = Graph()
    f2c = g.add(blocks.FloatToComplex(), g.add(blocks.VectorSource(a, repeat=iters + 1)),
                g.add(blocks.VectorSource(b, repeat=iters + 1)))
    fir = g.add(blocks.FirFilter(taps, deci=DECI, precision="w3"), f2c)
    g.add(blocks.DeviceFoldSink(), g.add(blocks.QuadratureDemod(1.0), fir))
    loop = g.compile_device_loop(n, iters)
    return msps(n * iters, time_call(lambda: loop(0), calls=1))


def cell_channelizer(n=1 << 22, nch=256):
    from rustradio_tpu.parallel.channelizer import channelizer_taps, pfb_channelize

    taps = channelizer_taps(nch)
    a, b = wire_planes(n)
    x = jax.lax.complex(a, b)
    return msps(n, time_call(jax.jit(lambda v: pfb_channelize(v, taps, nch)), x))


def cell_events(nch=64, per=1 << 16, sps=36.75):
    from rustradio_tpu.models.multichannel import recover_symbols_batch

    nrz = decode_bank_input(nch, per, sps)
    budget = max(1024, 4 * per // int(round(sps)))
    f = jax.jit(lambda x: recover_symbols_batch(x, sps, 0.5, (0.5, 0.5), method="events",
                                                max_events=budget)[:2])
    return msps(nch * per, time_call(f, nrz, calls=4))


def main(argv) -> None:
    from rustradio_tpu.models.fm import fm_demod_chain_planar
    from rustradio_tpu.ops.fm import kernel_takes
    from rustradio_tpu.utils.stats import device_hbm_gbps

    rehearse = "--rehearse" in argv
    require_gpu(rehearse)
    dev = jax.devices()[0]
    n = 1 << 14 if rehearse else N
    taps = chain_taps()
    if not kernel_takes(taps, DECI, "w3"):
        raise SystemExit("the fused FM kernel is not taken for the headline chain")
    a, b = wire_planes(n, jnp.bfloat16)
    rate = msps(n, time_call(lambda x, y: fm_demod_chain_planar(x, y, precision="w3"), a, b))

    cells, absent = {}, {}
    for name, fn in (("fm_chain_i8_msps", lambda: cell_i8(n)),
                     ("graph_fm_chain_msps", lambda: cell_graph(n, 2 if rehearse else 16)),
                     ("channelizer_256ch_msps", lambda: cell_channelizer(1 << 14 if rehearse else 1 << 22)),
                     ("decode_bank_events_msps", lambda: cell_events(4, 1 << 10) if rehearse else cell_events())):
        try:
            cells[name] = round(fn(), 2)
        except Exception as e:  # reported by name, never dropped
            traceback.print_exc()
            absent[name] = f"{type(e).__name__}: {e}"[:300]
    if rehearse:
        print(json.dumps({"rehearsal": "ok", "absent": absent}))
        return

    bytes_per_sample = 2 * 2 + 4.0 / DECI
    gbps = rate * 1e6 * bytes_per_sample / 1e9
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    row = {
        "metric": "fm_demod_chain_throughput",
        "value": round(rate, 1),
        "unit": "Msamples/s",
        "vs_baseline": round(rate / BASELINE_MSPS, 2),
        "bytes_per_sample": bytes_per_sample,
        "gbps": round(gbps, 1),
        "roofline_pct": round(100 * gbps / device_hbm_gbps(dev), 1),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "card": card.strip(),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        **cells,
    }
    if absent:
        row["absent"] = absent
    print(json.dumps(row))


if __name__ == "__main__":
    main(sys.argv[1:])
