"""Serve a downsampled IQ byte stream over the DATA_STREAM protocol
(reference examples/rtl_data_stream.rs).

The transport is stdin/stdout: RequestData control packets arrive on stdin,
Data packets carrying the downsampled RTL-style u8 IQ stream leave on
stdout.  The source is a capture file (no RTL-SDR hardware here); with
``--repeat`` the file loops forever, matching a live source.

Usage:
    python -m rustradio_tpu.apps.rtl_data_stream -r capture.u8 \
        --sample_rate 250k --downsample_rate 50k < control.bin > data.bin
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import queue

import jax.numpy as jnp
import numpy as np

from .. import ops
from .. import taps as tapgen
from ..dtypes import parse_frequency
from ..io import data_stream, rawfile


def downsample_u8(raw_u8: np.ndarray, sample_rate: float, downsample_rate: float) -> bytes:
    """RTL u8 IQ -> low-pass -> resample -> re-encode as RTL u8 IQ.

    Mirrors the reference chain RtlSdrDecode -> FftFilter -> RationalResampler
    -> RtlSdrEncode (examples/rtl_data_stream.rs graph body), under one
    jit."""
    import functools

    import jax
    iq = rawfile.rtlsdr_decode(np.asarray(raw_u8, np.uint8))

    @functools.partial(jax.jit, static_argnames=("sr", "dr"))
    def chain(x, sr, dr):
        lp = tapgen.low_pass_complex(sr, dr / 2.0, dr / 10.0, "hamming")
        y = ops.filter_complex(x, lp)
        return ops.rational_resampler(y, int(dr), int(sr))

    x = chain(jnp.asarray(iq), float(sample_rate), float(downsample_rate))
    return rawfile.rtlsdr_encode(np.asarray(x)).tobytes()


def control_reader(stdin, requests: "queue.Queue"):
    """Background thread: parse RequestData packets from stdin; None marks
    end of control input (reference spawn_control_reader,
    examples/rtl_data_stream.rs:138-170)."""
    parser = data_stream.BytesReader()
    try:
        while True:
            chunk = stdin.read(4096)
            if not chunk:
                break
            for ev in parser.feed(chunk):
                if ev[0] == "request_data":
                    requests.put((ev[1], ev[2]))
                elif ev[0] != "version":
                    raise data_stream.ProtocolError(f"unexpected input: {ev[0]}")
    except (data_stream.ProtocolError, OSError) as e:
        print(f"protocol input error: {e}", file=sys.stderr)
    finally:
        requests.put(None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-r", "--read", required=True, help="RTL u8 IQ capture file")
    p.add_argument("-s", "--sample_rate", type=parse_frequency, default=250_000.0)
    p.add_argument("-d", "--downsample_rate", type=parse_frequency, default=50_000.0)
    p.add_argument("--stream-id", default="rtl-sdr")
    p.add_argument("--packet-bytes", type=int, default=16_384)
    p.add_argument("--repeat", action="store_true", help="loop the capture")
    p.add_argument("--tcp", type=int, metavar="PORT",
                   help="serve many concurrent clients over TCP instead of "
                        "stdin/stdout (nonblocking asyncio server)")
    opt = p.parse_args(argv)

    raw = np.fromfile(opt.read, np.uint8)
    payload = downsample_u8(raw, float(opt.sample_rate), float(opt.downsample_rate))

    if opt.tcp is not None:
        import asyncio

        def payload_at(pos: int, n: int) -> bytes:
            if opt.repeat:
                pos %= len(payload)
            elif pos >= len(payload):
                return b""
            return payload[pos : pos + n]

        async def amain():
            srv = data_stream.DataStreamServer(
                payload_at, opt.stream_id, opt.packet_bytes
            )
            host, port = await srv.serve("0.0.0.0", opt.tcp)
            print(f"serving DATA_STREAM on {host}:{port}", file=sys.stderr)
            await asyncio.Event().wait()  # until interrupted

        try:
            asyncio.run(amain())
        except KeyboardInterrupt:
            pass
        return 0

    stdin = os.fdopen(sys.stdin.fileno(), "rb", buffering=0)
    stdout = os.fdopen(sys.stdout.fileno(), "wb", buffering=0)
    writer = data_stream.SyncWriter(stdout.write)

    requests: "queue.Queue" = queue.Queue()
    threading.Thread(target=control_reader, args=(stdin, requests), daemon=True).start()

    pos = 0
    input_closed = False
    exhausted = False
    while not exhausted:
        win = writer.windows.get(opt.stream_id, 0)
        if win <= 0:
            # Idle: wait for a new grant; on control EOF drain and exit.
            if input_closed:
                break
            req = requests.get()
        else:
            # Between sends just drain the queue non-blockingly so a
            # replacing RequestData (including window=0: "stop") applies
            # immediately — the reference updates the window between every
            # send (examples/rtl_data_stream.rs:108).
            try:
                req = requests.get_nowait()
            except queue.Empty:
                req = ()
        if req is None:
            input_closed = True
            continue
        if req:
            sid, window = req
            if sid == opt.stream_id:
                writer.grant(sid, window)
            continue
        if pos >= len(payload):
            if not opt.repeat:
                exhausted = True
                continue
            pos = 0
        sent = writer.send(opt.stream_id, payload[pos : pos + opt.packet_bytes])
        pos += sent
        if sent == 0:
            break
    stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
