#!/usr/bin/env python3
"""Chip smoke test: the FM and AX.25 receive paths, once, on the GPU.

Usage:
    python3 chip_smoke.py [--seed N]              # one GPU: fm, ax25, channelizer
    python3 chip_smoke.py --four-cards [--seed N] # the multi-device paths, 4 GPUs
    python3 chip_smoke.py --rehearse              # tiny sizes on any platform,
                                                  # kernels interpreted; no result

Each phase makes its data from ``--seed``, runs it through the entry points a
user calls, and compares the output with a plain reference under the
tolerance printed beside it.  Any failure raises, so the script exits
non-zero.  Without a GPU it exits non-zero before printing a result.  The
last line of standard output is the result:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

FM_RATE = 1_024_000.0
FM_DECI = 4
FM_TONES = ((1_000.0, 0.6), (2_500.0, 0.4))  # (Hz, amplitude) of the message
FM_DEV = 25_000.0


def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def __call__(self) -> float:
        return time.perf_counter() - self.t0


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------- data


def fm_capture(seed: int, n: int):
    """(u8 interleaved I/Q, message): FM-modulated tones plus noise at
    FM_RATE, quantised like an RTL-SDR (u8, read as (u8 - 127)/128)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FM_RATE
    msg = sum(a * np.sin(2 * np.pi * f * t) for f, a in FM_TONES)
    phase = 2 * np.pi * FM_DEV * np.cumsum(msg) / FM_RATE
    x = 0.7 * np.exp(1j * phase)
    x = x + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    iq = np.stack([x.real, x.imag], axis=1).ravel()
    return np.clip(np.round(127.0 + 128.0 * iq), 0, 255).astype(np.uint8), msg


def fm_reference(i, q, taps, deci):
    """Float64 chain: full zero-history convolution, decimation, then
    angle(conj(y[n]) y[n+1])."""
    x = i.astype(np.float64) + 1j * q.astype(np.float64)
    y = np.convolve(x, np.asarray(taps, np.float64))[: len(x)][::deci]
    return np.angle(np.conj(y[:-1]) * y[1:])


def planes(u8):
    i = ((u8[0::2].astype(np.float32) - 127.0) / 128.0)
    q = ((u8[1::2].astype(np.float32) - 127.0) / 128.0)
    return i, q


def fm_graph(i, q, taps):
    from rustradio_tpu import blocks
    from rustradio_tpu.graph import Graph

    g = Graph()
    sink = blocks.VectorSink()
    f2c = g.add(blocks.FloatToComplex(), g.add(blocks.VectorSource(i)),
                g.add(blocks.VectorSource(q)))
    qd = g.add(blocks.QuadratureDemod(1.0),
               g.add(blocks.FirFilter(taps, deci=FM_DECI), f2c))
    g.add(sink, qd)
    return g, sink


# ---------------------------------------------------------------- phases


def phase_fm(seed: int, n: int) -> None:
    import jax
    import jax.numpy as jnp

    from rustradio_tpu import backend
    from rustradio_tpu.lowering import find_fm_pairs
    from rustradio_tpu.models.fm import chain_taps, fm_demod_chain_planar
    from rustradio_tpu.ops.fm import fm_chain_plain, kernel_takes

    taps = chain_taps(FM_RATE)
    u8, msg = fm_capture(seed, n)
    i, q = planes(u8)
    clk = Timer()
    ref = fm_reference(i, q, taps, FM_DECI)
    log(f"fm: {n} u8 I/Q samples at {FM_RATE:.0f} sps, {len(taps)} taps, "
        f"deci {FM_DECI}; float64 reference {ref.shape} in {clk():.1f} s")
    check(backend.use_kernels(), "kernels are not in use")

    # (a) the planar chain, both precisions, through the fused kernel
    ip, qp = jnp.asarray(i), jnp.asarray(q)
    for precision in ("w3", "highest"):
        check(kernel_takes(taps, FM_DECI, precision), f"kernel not taken for {precision}")
        clk = Timer()
        out = jax.block_until_ready(fm_demod_chain_planar(ip, qp, precision=precision))
        first = clk()
        clk = Timer()
        out = np.asarray(jax.block_until_ready(
            fm_demod_chain_planar(ip, qp, precision=precision)))
        again = clk()
        check(out.shape == ref.shape, f"(a) {precision} shape {out.shape} != {ref.shape}")
        err = float(np.max(np.abs(out - ref)))
        plain = np.asarray(fm_chain_plain(ip, qp, taps, FM_DECI, 1.0, precision))
        vs_plain = float(np.max(np.abs(out - plain)))
        log(f"fm (a) fm_demod_chain_planar {precision}: out {out.shape} "
            f"max|err| {err:.3e} rad (limit 3e-4), vs plain XLA form "
            f"{vs_plain:.3e}; first call {first:.2f} s, again {again * 1e3:.1f} ms")
        check(err <= 3e-4, f"(a) {precision} error {err} > 3e-4")
        check(vs_plain <= 3e-4, f"(a) {precision} kernel vs plain {vs_plain} > 3e-4")

    # (b) the same chain built from blocks, Graph.run (lowered to the kernel)
    ntaps = len(taps)
    d0 = (ntaps - 1) // FM_DECI  # valid-conv alignment: (ntaps-1) % deci == 0
    want = ref[d0 : d0 + (n - ntaps) // FM_DECI]
    g, sink = fm_graph(i, q, taps)
    seg = list(g._segments().values())[0]
    plans, _ = find_fm_pairs(seg, set())
    check(len(plans) == 1, "the graph's FM run was not lowered to the kernel")
    clk = Timer()
    g.run()
    out_b = np.asarray(sink.data())
    t_b = clk()
    check(out_b.shape == want.shape, f"(b) shape {out_b.shape} != {want.shape}")
    err = float(np.max(np.abs(out_b - want)))
    log(f"fm (b) Graph.run: out {out_b.shape} max|err| {err:.3e} rad "
        f"(limit 3e-4); {t_b:.2f} s")
    check(err <= 3e-4, f"(b) error {err} > 3e-4")

    # (c) the same graph streamed in 2^18-sample chunks equals (b)
    chunk = min(1 << 18, n // 4)
    g, sink = fm_graph(i, q, taps)
    clk = Timer()
    g.run_stream(chunk_size=chunk)
    out_c = np.asarray(sink.data())
    t_c = clk()
    check(out_c.shape == out_b.shape, f"(c) shape {out_c.shape} != {out_b.shape}")
    diff = float(np.max(np.abs(out_c - out_b)))
    log(f"fm (c) Graph.run_stream(chunk_size={chunk}): out {out_c.shape} "
        f"max|diff| vs (b) {diff:.3e} (limit 1e-5); {t_c:.2f} s")
    check(diff <= 1e-5, f"(c) differs from (b) by {diff}")

    # (d) the rtl_fm app on the capture file
    from rustradio_tpu.apps import rtl_fm
    from rustradio_tpu.io import au

    form = "kernel" if kernel_takes(chain_taps(FM_RATE), 1, "w3") else "plain XLA form"
    with tempfile.TemporaryDirectory() as tmp:
        cap = os.path.join(tmp, "capture.u8")
        out_au = os.path.join(tmp, "audio.au")
        u8.tofile(cap)
        clk = Timer()
        rc = rtl_fm.main(["-r", cap, "--rtl_u8", "--sample_rate", str(FM_RATE),
                          "--deviation", str(FM_DEV), "--out", out_au])
        t_d = clk()
        check(rc == 0, f"rtl_fm exit {rc}")
        audio, rate = au.au_read(out_au)
    audio = np.asarray(audio, np.float64)
    # output k is the demod of input floor(k*fs/rate); the 49-tap low-pass
    # delays the message by (ntaps-1)/2 samples
    src = (np.arange(len(audio)) * FM_RATE // rate).astype(np.int64)
    lag = (ntaps - 1) // 2
    ok = (src - lag >= 0) & (src - lag < len(msg))
    corr = float(np.corrcoef(audio[ok], msg[src[ok] - lag])[0, 1])
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
    freqs = np.fft.rfftfreq(len(audio), 1.0 / rate)
    peak = float(freqs[np.argmax(spec)])
    log(f"fm (d) rtl_fm --rtl_u8 ({form}): {len(audio)} samples at {rate} Hz, "
        f"correlation with the sent message {corr:.4f} (limit 0.95), "
        f"spectral peak {peak:.1f} Hz (want {FM_TONES[0][0]:.0f} +- 2 Hz); "
        f"{t_d:.2f} s")
    check(corr >= 0.95, f"(d) correlation {corr} < 0.95")
    check(abs(peak - FM_TONES[0][0]) <= 2.0, f"(d) spectral peak {peak} Hz")


def phase_ax25(seed: int, n_frames: int) -> None:
    from rustradio_tpu.models.ax25 import ax25_1200_rx, ax25_1200_rx_graph
    from rustradio_tpu.models.ax25_corpus import FS, corpus

    audio, payloads = corpus(n_frames, seed)
    sent = set(payloads)
    gate = int(np.ceil(0.98 * n_frames))  # the CPU suite's 980/1000
    log(f"ax25: {n_frames}-frame corpus, {len(audio)} samples at {FS:.0f} Hz")
    for name, rx in (("ax25_1200_rx", lambda a: [bytes(p) for p in ax25_1200_rx(a, FS)]),
                     ("ax25_1200_rx_graph", lambda a: ax25_1200_rx_graph(a, FS))):
        clk = Timer()
        got = rx(audio)
        t = clk()
        strays = [p for p in got if p not in sent]
        n_ok = len(sent.intersection(got))
        log(f"ax25 {name}: {len(got)} packets, {n_ok}/{n_frames} sent payloads "
            f"decoded (gate {gate}), {len(strays)} not sent; {t:.2f} s")
        check(not strays, f"{name} decoded payloads that were not sent: {strays[:3]}")
        check(n_ok >= gate, f"{name} decoded {n_ok} < {gate}")


def channelizer_reference(x, taps, M):
    """Float64 polyphase channelizer: branch FIR on the reversed frame
    matrix, then an IDFT over the branches."""
    nframes = len(x) // M
    xp = np.concatenate([np.zeros(M - 1), x.astype(np.complex128)])[: nframes * M]
    f = xp.reshape(nframes, M)[:, ::-1]
    h = np.asarray(taps, np.float64).reshape(-1, M)
    v = np.zeros_like(f)
    for l in range(h.shape[0]):
        v[l:] += h[l] * f[: nframes - l]
    return np.fft.ifft(v, axis=1) * M


def phase_channelizer(seed: int, n: int, M: int = 256) -> None:
    import jax
    import jax.numpy as jnp

    from rustradio_tpu.parallel.channelizer import (
        channelizer_fm_bank, channelizer_taps, pfb_channelize)

    rng = np.random.default_rng(seed + 1)
    x = (0.3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    taps = channelizer_taps(M)
    ref_ch = channelizer_reference(x, taps, M)
    xd = jnp.asarray(x)
    clk = Timer()
    bank = np.asarray(jax.block_until_ready(channelizer_fm_bank(xd, taps, M)))
    t = clk()
    ch = np.asarray(pfb_channelize(xd, taps, M))
    rel = float(np.max(np.abs(ch - ref_ch)) / np.max(np.abs(ref_ch)))
    ref_bank = np.angle(np.conj(ref_ch[:-1]) * ref_ch[1:])
    mag = np.abs(ref_ch)
    strong = (mag[:-1] >= 0.05 * np.sqrt(np.mean(mag ** 2, axis=0))) & (
        mag[1:] >= 0.05 * np.sqrt(np.mean(mag ** 2, axis=0)))
    d = np.abs(np.angle(np.exp(1j * (bank - ref_bank))))[strong]
    err = float(np.max(d))
    log(f"channelizer: {M} channels, {n} samples, {len(taps)} taps -> bank "
        f"{bank.shape}; channel outputs max|err|/max|ref| {rel:.3e} (limit 1e-5); "
        f"demod max|err| {err:.3e} rad (limit 2e-4) on the {strong.mean():.4f} "
        f"of samples above 5% of channel RMS; {t:.2f} s")
    check(bank.shape == (n // M - 1, M), f"bank shape {bank.shape}")
    check(rel <= 1e-5, f"channelizer error {rel}")
    check(err <= 2e-4, f"channelizer demod error {err}")


# ------------------------------------------------------------- four cards


def _iq_front_end(iq, fs_iq, new_rate, mesh):
    from rustradio_tpu import blocks
    from rustradio_tpu import taps as tapgen
    from rustradio_tpu.graph import Graph

    g = Graph()
    s = blocks.VectorSink()
    g.chain(
        blocks.VectorSource(iq),
        blocks.FftFilter(tapgen.low_pass_complex(fs_iq, 8_000.0, 2_000.0, "hamming")),
        blocks.RationalResampler(int(new_rate), int(fs_iq)),
        blocks.QuadratureDemod(float(fs_iq / (2 * np.pi * 3000.0))),
        s,
    )
    if mesh is not None:
        _, _, plans = g._segments_mesh(mesh, "time")
        check(len(plans) == 1, "IQ front-end did not shard as one segment")
    g.run(mesh=mesh)
    return np.asarray(s.data())


def phase_four_cards(seed: int, n_fm: int, n_frames: int, n_chan: int) -> None:
    """The multi-device paths users depend on, each against its run on
    one card: time-sharded FM chain, Graph.run(mesh=) offline and
    streaming (AX.25 receiver, IQ front-end), channel-sharded channelizer,
    symbol-sync banks (scan and events)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from rustradio_tpu import ops
    from rustradio_tpu.models.ax25 import ax25_1200_rx, ax25_1200_rx_graph
    from rustradio_tpu.models.fm import chain_taps
    from rustradio_tpu.models.ax25_corpus import FS, corpus
    from rustradio_tpu.models.multichannel import recover_symbols_batch
    from rustradio_tpu.parallel import make_mesh, sharded_fm_demod, sharded_symbol_sync_bank
    from rustradio_tpu.parallel.channelizer import (
        channelizer_fm_bank, channelizer_taps, sharded_channelizer_fm)

    n_dev = 4
    check(len(jax.devices()) >= n_dev, f"need {n_dev} devices, have {len(jax.devices())}")
    mesh = make_mesh(n_dev)
    one = jax.devices()[0]

    # time-sharded FM chain vs the composed chain on one card
    taps = chain_taps(FM_RATE)
    u8, _ = fm_capture(seed, n_fm)
    i, q = planes(u8)
    x = (i + 1j * q).astype(np.complex64)
    clk = Timer()
    xs = jax.device_put(x, NamedSharding(mesh, PartitionSpec("time")))
    got = np.asarray(jax.jit(lambda v: sharded_fm_demod(v, taps, mesh, deci=FM_DECI))(xs))
    t = clk()
    single = np.asarray(jax.jit(lambda v: ops.quadrature_demod(
        ops.fir_filter(v, taps, FM_DECI), 1.0))(jax.device_put(x, one)))
    m = len(single)
    diff = float(np.max(np.abs(got[:m] - single)))
    log(f"four cards: sharded FM chain {x.shape} -> {got.shape}, max|diff| vs "
        f"one card {diff:.3e} (limit 1e-5); {t:.2f} s")
    check(got.shape[0] >= m, "sharded FM chain is short")
    check(diff <= 1e-5, f"sharded FM chain differs by {diff}")

    # Graph.run(mesh=) offline and streaming: the AX.25 receiver
    audio, payloads = corpus(n_frames, seed)
    audio = np.concatenate([audio, np.zeros((-len(audio)) % (n_dev * 256), np.float32)])
    want = ax25_1200_rx_graph(audio, FS)
    check(len(want) >= int(np.ceil(0.98 * n_frames)), f"one-card AX.25 decoded {len(want)}")
    for label, kw in (("offline", {}), ("streaming", {"chunk_size": len(audio) // 4})):
        clk = Timer()
        got_p = ax25_1200_rx_graph(audio, FS, mesh=mesh, **kw)
        log(f"four cards: Graph-built AX.25 receiver {label} on the mesh: "
            f"{len(got_p)} packets, one card {len(want)}; {clk():.2f} s")
        check(got_p == want, f"AX.25 graph on the mesh ({label}) != one card")

    # Graph.run(mesh=): the IQ front-end through a rate changer, one segment
    fs_iq, new_rate = 96_000.0, 48_000.0
    audio_iq, payloads_iq = corpus(max(n_frames // 10, 4), seed + 2)
    up = np.repeat(audio_iq, int(fs_iq / FS))
    phase = np.cumsum(2 * np.pi * 3000.0 * up / fs_iq)
    iq = (np.cos(phase) + 1j * np.sin(phase)).astype(np.complex64)
    n_sig = len(iq)
    iq = np.concatenate([iq, np.zeros((-len(iq)) % (n_dev * 1024), np.complex64)])
    clk = Timer()
    fm_mesh = _iq_front_end(iq, fs_iq, new_rate, mesh)
    t = clk()
    fm_single = _iq_front_end(iq, fs_iq, new_rate, None)
    check(fm_mesh.shape == fm_single.shape, "IQ front-end shapes differ")
    # values compared where the filtered carrier is: the filter's warm-up
    # (its partial tap sums cross zero) and the zero padding demodulate
    # rounding noise, whose angle is arbitrary
    sig = slice(256, int(n_sig * new_rate / fs_iq) - 256)
    diff = float(np.max(np.abs(fm_mesh[sig] - fm_single[sig])))
    pk_mesh = [bytes(p) for p in ax25_1200_rx(fm_mesh, new_rate)]
    pk_single = [bytes(p) for p in ax25_1200_rx(fm_single, new_rate)]
    log(f"four cards: IQ front-end on the mesh {iq.shape} -> {fm_mesh.shape}, "
        f"max|diff| vs one card {diff:.3e} (limit 1e-4, over the carrier), "
        f"packets {len(pk_mesh)} vs "
        f"{len(pk_single)} ({len(payloads_iq)} sent); {t:.2f} s")
    check(pk_mesh == pk_single, "IQ front-end packets on the mesh != one card")
    check(diff <= 1e-4, f"IQ front-end differs by {diff}")

    # channel-sharded channelizer
    M = 256
    rng = np.random.default_rng(seed + 1)
    xw = (0.3 * (rng.standard_normal(n_chan) + 1j * rng.standard_normal(n_chan))).astype(np.complex64)
    ctaps = channelizer_taps(M)
    cmesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("chan",))
    clk = Timer()
    bank = np.asarray(jax.jit(lambda v: sharded_channelizer_fm(v, ctaps, M, cmesh))(jnp.asarray(xw)))
    t = clk()
    bank1 = np.asarray(jax.jit(lambda v: channelizer_fm_bank(v, ctaps, M))(jax.device_put(xw, one)))
    diff = float(np.max(np.abs(bank - bank1)))
    log(f"four cards: channel-sharded channelizer {bank.shape}, max|diff| vs "
        f"one card {diff:.3e} (limit 1e-5); {t:.2f} s")
    check(bank.shape == bank1.shape and diff <= 1e-5, f"channelizer differs by {diff}")

    # channel-sharded symbol-sync banks, scan and events
    C, nbits, sps = 16 * n_dev, 2000, 10
    bits = rng.integers(0, 2, (C, nbits)) * 2.0 - 1.0
    xsb = np.repeat(bits, sps, axis=1).astype(np.float32)
    bank_mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("chan",))
    clk = Timer()
    vs, ms, _ = sharded_symbol_sync_bank(xsb, float(sps), bank_mesh)
    v1, m1, _ = recover_symbols_batch(xsb, float(sps))
    check(np.array_equal(np.asarray(ms), np.asarray(m1)), "scan bank masks differ")
    diff = float(np.max(np.abs(np.asarray(vs) - np.asarray(v1))))
    check(diff <= 1e-6, f"scan bank values differ by {diff}")
    ve, me, _, valid = sharded_symbol_sync_bank(xsb, float(sps), bank_mesh,
                                                method="events", return_valid=True)
    v2, m2, _ = recover_symbols_batch(xsb, float(sps), method="events")
    check(bool(np.all(np.asarray(valid))), "events bank overflowed its budget")
    check(np.array_equal(np.asarray(me), np.asarray(m2)), "events bank masks differ")
    diff_e = float(np.max(np.abs(np.asarray(ve) - np.asarray(v2))))
    check(diff_e <= 1e-6, f"events bank values differ by {diff_e}")
    log(f"four cards: symbol-sync banks {C} channels x {nbits * sps} samples, "
        f"scan max|diff| {diff:.3e}, events max|diff| {diff_e:.3e} vs one card "
        f"(limit 1e-6, masks equal); {clk():.2f} s")


# ------------------------------------------------------------------ main


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--four-cards", action="store_true",
                   help="run only the multi-device paths, on 4 GPUs")
    p.add_argument("--rehearse", action="store_true",
                   help="tiny sizes on any platform with interpreted kernels; "
                        "prints no result line")
    opt = p.parse_args(argv)

    import jax

    from rustradio_tpu import backend

    log(f"jax {jax.__version__}, XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    dev = jax.devices()[0]
    if opt.rehearse:
        backend.INTERPRET = dev.platform != "gpu"
    elif dev.platform != "gpu":
        log(f"no GPU: JAX found {dev.platform} ({dev.device_kind})")
        return 1
    else:
        for line in card_lines():  # as nvidia-smi prints it: name, power limit
            log(line)
    check(opt.rehearse or not backend.INTERPRET, "kernels interpreted outside a rehearsal")

    small = opt.rehearse
    clk = Timer()
    if opt.four_cards:
        phase_four_cards(opt.seed, n_fm=1 << (16 if small else 24),
                         n_frames=20 if small else 1000,
                         n_chan=1 << (14 if small else 22))
    else:
        phase_fm(opt.seed, 1 << (15 if small else 24))
        phase_ax25(opt.seed, 50 if small else 1000)
        phase_channelizer(opt.seed, 1 << (15 if small else 22))
    log(f"all phases passed in {clk():.1f} s")
    if opt.rehearse:
        log("rehearsal only: no result")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
