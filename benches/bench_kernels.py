#!/usr/bin/env python3
"""Per-op microbenchmarks on the GPU (reference analog:
benches/bench_rustradio.rs:72-125 criterion benches).

Each bench prints one JSON line {"bench": ..., "msps": ..., "platform": ...}.
Run all with no args, or name benches:

    python benches/bench_kernels.py [fm_chain fm_dispatch fir channelizer decode_bank native]

Timing: ``time_call`` runs the jitted op ``calls`` times back to back, syncs
once with ``block_until_ready``, and takes the median per-call time of 5
such runs.  Without a GPU the script fails; ``--rehearse`` runs every bench
at tiny sizes on any platform (kernels interpreted) and prints no numbers.
"""
from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rustradio_tpu import backend  # noqa: E402
from rustradio_tpu.models.fm import chain_taps  # noqa: E402

REHEARSE = False


def require_gpu(rehearse: bool = False) -> None:
    """Fail without a GPU; under a rehearsal, interpret the kernels
    instead and shrink every size."""
    global REHEARSE
    dev = jax.devices()[0]
    if rehearse:
        REHEARSE = True
        backend.INTERPRET = dev.platform != "gpu"
    elif dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {dev.platform} ({dev.device_kind})")


def size(full: int, small: int) -> int:
    return small if REHEARSE else full


def time_call(f, *args, calls: int = 20, reps: int = 5) -> float:
    """Median seconds per call of ``f(*args)``: ``calls`` back-to-back
    dispatches, one ``block_until_ready``, over ``reps`` runs."""
    jax.block_until_ready(f(*args))
    if REHEARSE:
        calls, reps = 1, 1
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            out = f(*args)
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / calls)
    return float(np.median(ts))


def msps(n: int, seconds: float) -> float:
    return n / seconds / 1e6


def emit(**kw):
    dev = jax.devices()[0]
    if REHEARSE:
        kw = {"bench": kw["bench"], "rehearsal": "ok"}
    else:
        kw.setdefault("platform", dev.platform)
        kw.setdefault("device_kind", dev.device_kind)
    print(json.dumps(kw), flush=True)


def wire_planes(n: int, dtype=jnp.float32):
    """Two I/Q planes on the (u8 - 127)/128 wire grid, made on device."""
    @jax.jit
    def make(key):
        u = jax.random.randint(key, (2, n), 0, 256).astype(jnp.float32)
        p = (u - 127.0) / 128.0
        return p[0].astype(dtype), p[1].astype(dtype)

    return make(jax.random.key(0))


# ---------------------------------------------------------------- benches

def bench_fm_chain():
    """The FM chain at the bench shape (2^24 samples, 49 taps, deci 4):
    the fused kernel against XLA's plain forms of the same chain."""
    from rustradio_tpu.ops.fft_filter import fft_filter_decimate
    from rustradio_tpu.ops.fir import _conv1d
    from rustradio_tpu.ops.fm import fm_chain_kernel, fm_chain_plain
    from rustradio_tpu.ops import quadrature_demod

    n = size(1 << 24, 1 << 14)
    deci = 4
    lp = chain_taps()
    a16, b16 = wire_planes(n, jnp.bfloat16)
    a, b = wire_planes(n)
    cases = {
        "kernel/w3_bf16_planes": (lambda x, y: fm_chain_kernel(x, y, lp, deci, 1.0, "w3"), a16, b16),
        "kernel/w3_f32_planes": (lambda x, y: fm_chain_kernel(x, y, lp, deci, 1.0, "w3"), a, b),
        "kernel/highest": (lambda x, y: fm_chain_kernel(x, y, lp, deci, 1.0, "highest"), a, b),
        "plain/w3": (lambda x, y: fm_chain_plain(x, y, lp, deci, 1.0, "w3"), a, b),
        "plain/i8": (lambda x, y: fm_chain_plain(x, y, lp, deci, 1.0, "i8"), a, b),
        "plain/fft_overlap_save": (lambda x, y: quadrature_demod(
            fft_filter_decimate(jax.lax.complex(x, y), lp, deci), 1.0), a, b),
        "plain/conv_highest": (lambda x, y: quadrature_demod(jax.lax.complex(
            _conv1d(x, lp, deci, len(lp) - 1), _conv1d(y, lp, deci, len(lp) - 1)), 1.0), a, b),
    }
    for name, (f, x, y) in cases.items():
        t = time_call(jax.jit(f), x, y)
        emit(bench=f"fm_chain/{name}", msps=round(msps(n, t), 1),
             us_per_call=round(t * 1e6, 1), n=n, deci=deci, ntaps=len(lp))


def bench_fm_dispatch():
    """Where ops.fm_chain should take the kernel: the kernel against the
    plain form it would otherwise run (fm_chain_plain), both at w3 on f32
    planes as rtl_fm and the models hand them over, at the longest
    filter of each tile span (128, 256 and, at deci 4, 512 samples) and
    the 49-tap chain.  deci 1 is rtl_fm --rtl_u8's chain, deci 4 the bench chain."""
    from rustradio_tpu.ops.fm import fm_chain_kernel, fm_chain_plain

    n = size(1 << 24, 1 << 12)
    a, b = wire_planes(n)
    grid = {1: (9, 49, 112, 240), 4: (49, 64, 192, 448)}
    for deci, ntap_list in grid.items():
        for ntaps in ntap_list:
            taps = (np.hamming(ntaps) * np.sinc(0.2 * (np.arange(ntaps) - ntaps // 2))
                    ).astype(np.float32)
            for form, f in (("kernel", fm_chain_kernel), ("plain", fm_chain_plain)):
                t = time_call(jax.jit(lambda x, y, f=f, t=taps, d=deci: f(x, y, t, d, 1.0, "w3")),
                              a, b)
                emit(bench=f"fm_dispatch/{form}/deci{deci}_taps{ntaps}",
                     msps=round(msps(n, t), 1), us_per_call=round(t * 1e6, 1), n=n)


def bench_fir():
    """Decimating FIR alone: direct conv at HIGHEST vs overlap-save FFT
    (the two plain forms ops.fir_filter_full chooses between)."""
    from rustradio_tpu.ops.fft_filter import fft_filter_decimate
    from rustradio_tpu.ops.fir import _conv1d

    n = size(1 << 22, 1 << 13)
    a, b = wire_planes(n)
    for deci in (1, 4):
        for ntaps in (5, 9, 17, 49, 129, 1025):
            taps = (np.hamming(ntaps) * np.sinc(0.2 * (np.arange(ntaps) - ntaps // 2))
                    ).astype(np.float32)
            conv = jax.jit(lambda x, y, t=taps, d=deci: (
                _conv1d(x, t, d, len(t) - 1), _conv1d(y, t, d, len(t) - 1)))
            fft = jax.jit(lambda x, y, t=taps, d=deci: fft_filter_decimate(
                jax.lax.complex(x, y), t, d))
            for form, f in (("conv_highest", conv), ("fft", fft)):
                t = time_call(f, a, b)
                emit(bench=f"fir/{form}/deci{deci}_taps{ntaps}",
                     msps=round(msps(n, t), 1), us_per_call=round(t * 1e6, 1), n=n)


def bench_channelizer():
    from rustradio_tpu.parallel.channelizer import channelizer_fm_bank, channelizer_taps

    nch = 256
    n = size(1 << 22, 1 << 14)
    taps = channelizer_taps(nch)
    a, b = wire_planes(n)
    x = jax.lax.complex(a, b)
    t = time_call(jax.jit(lambda v: channelizer_fm_bank(v, taps, nch)), x)
    emit(bench=f"channelizer_fm_bank/{nch}ch", msps=round(msps(n, t), 1),
         us_per_call=round(t * 1e6, 1), n=n)


def decode_bank_input(nch: int, per: int, sps: float):
    rep = int(round(sps))
    nbits = per // rep + 1

    @jax.jit
    def make(key):
        kb, kn = jax.random.split(key)
        bits = jax.random.rademacher(kb, (nch, nbits), jnp.float32)
        nrz = jnp.repeat(bits, rep, axis=1)[:, :per]
        return nrz + 0.1 * jax.random.normal(kn, (nch, per), jnp.float32)

    return make(jax.random.key(0))


def bench_decode_bank():
    """Channel-parallel clock recovery: vmapped symbol_sync over a bank of
    channels — the per-sample scan vs the event-driven form (sequential
    chain ~n/sps instead of n)."""
    from rustradio_tpu.models.multichannel import recover_symbols_batch

    nch = size(64, 4)
    per = size(1 << 16, 1 << 10)
    sps = 36.75
    nrz = decode_bank_input(nch, per, sps)
    budget = max(1024, 4 * per // int(round(sps)))
    for method, kw in (("scan", {}), ("events", {"max_events": budget})):
        f = jax.jit(lambda x, m=method, k=kw: recover_symbols_batch(
            x, sps, 0.5, (0.5, 0.5), method=m, **k)[:2])
        t = time_call(f, nrz, calls=4)
        emit(bench=f"decode_bank_{method}/{nch}ch", msps=round(msps(nch * per, t), 2),
             nch=nch, per_channel_msps=round(msps(per, t), 3))


def bench_native():
    """Host-native sequential tail (native/rr_native.cpp): symbol sync
    and HDLC deframe rates.  Host timing only."""
    from rustradio_tpu import native, ops

    if not native.available():
        emit(bench="native", absent="librr_native unavailable (no C++ compiler)")
        return
    rng = np.random.RandomState(0)
    sps = 36.75
    n = size(1 << 22, 1 << 14)
    bits = rng.randint(0, 2, int(n / sps) + 2) * 2.0 - 1.0
    x = np.repeat(bits, int(round(sps)))[:n].astype(np.float32)
    x += rng.randn(n).astype(np.float32) * 0.1
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        native.symbol_sync_f32(x, sps, 0.5, np.asarray([0.5, 0.5]))
        ts.append(time.perf_counter() - t0)
    emit(bench="native_symbol_sync", msps=round(msps(n, float(np.median(ts))), 1), n=n)

    frames = []
    for _ in range(64):
        payload = rng.randint(0, 256, 256).astype(np.uint8)
        frames.append(np.asarray(ops.hdlc_frame(ops.fcs_add(payload))))
    stream = np.concatenate(frames * 8).astype(np.uint8)
    ts = []
    for _ in range(5):
        sm = native.HdlcDeframer(1, 1500, False, False)
        t0 = time.perf_counter()
        sm.feed(stream)
        ts.append(time.perf_counter() - t0)
    emit(bench="native_hdlc_deframe",
         mbps=round(len(stream) / float(np.median(ts)) / 1e6, 1), bits=len(stream))


BENCHES = {
    "fm_chain": bench_fm_chain,
    "fm_dispatch": bench_fm_dispatch,
    "fir": bench_fir,
    "channelizer": bench_channelizer,
    "decode_bank": bench_decode_bank,
    "native": bench_native,
}


def main(argv):
    rehearse = "--rehearse" in argv
    names = [a for a in argv if a != "--rehearse"] or list(BENCHES)
    require_gpu(rehearse)
    for name in names:
        BENCHES[name]()


if __name__ == "__main__":
    main(sys.argv[1:])
