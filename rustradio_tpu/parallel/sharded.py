"""Time-sharded stream kernels: the multi-chip dense pipeline.

Each function is semantically identical to its offline counterpart in
:mod:`rustradio_tpu.ops` applied to the *global* stream, but executes with
the sample axis sharded over a mesh axis, exchanging filter halos between
neighbouring shards over the device interconnect instead of carrying
host-side state.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..ops.fir import _conv1d
from ..ops.fft_filter import fft_filter as _fft_filter
from .halo import halo_exchange_left, halo_exchange_right


def _shmap(mesh, axis, f, nout=1):
    return shard_map(
        f,
        mesh=mesh,
        in_specs=(P(axis),),
        out_specs=P(axis) if nout == 1 else tuple(P(axis) for _ in range(nout)),
        # pallas_call out_shapes carry no varying-mesh-axes info; skip the
        # vma check so Pallas kernels can run inside the shard body.
        check_vma=False,
    )


def sharded_fir_filter(x, taps, mesh, deci: int = 1, axis: str = "time"):
    """fir_filter_full semantics (y[m] = sum_j taps[j] x[m*deci-j]) with the
    time axis sharded.  Shard length must be divisible by deci."""
    taps = np.asarray(taps)
    ntaps = len(taps)
    n_sh = mesh.shape[axis]
    n = x.shape[0]
    if n % (n_sh * deci):
        raise ValueError(f"stream length {n} not divisible by shards*deci")

    def body(xs):
        ext = halo_exchange_left(xs, ntaps - 1, axis)
        # full conv grid: y[m] = sum taps[j] ext[(ntaps-1) + m*deci - j]
        y = _conv1d(ext, taps, stride=deci, pad_left=0)
        return y[: xs.shape[0] // deci]

    return _shmap(mesh, axis, body)(x)


def sharded_fft_filter(x, taps, mesh, axis: str = "time", fft_size: int | None = None):
    """Overlap-save FFT filter with the time axis sharded; halo via ppermute."""
    taps = np.asarray(taps)
    ntaps = len(taps)
    def body(xs):
        ext = halo_exchange_left(xs, ntaps - 1, axis)
        # Within the shard run overlap-save over `ext`, emitting outputs for
        # the local region only (drop the first ntaps-1 "halo" outputs).
        y = _fft_filter(ext, taps, fft_size)
        return jax.lax.dynamic_slice_in_dim(y, ntaps - 1, xs.shape[0])

    return _shmap(mesh, axis, body)(x)


def sharded_quadrature_demod(x, gain, mesh, axis: str = "time"):
    """Quadrature demod over a sharded stream: 1-sample right halo.

    Output has the same global length as the input; the final global sample
    is 0 (the offline op emits N-1 samples — callers drop the last one).
    """

    def body(xs):
        ext = halo_exchange_right(xs, 1, axis, fill=0)
        d = jnp.conj(ext[:-1]) * ext[1:]
        return jnp.float32(gain) * jnp.arctan2(
            jnp.imag(d).astype(jnp.float32), jnp.real(d).astype(jnp.float32)
        )

    return _shmap(mesh, axis, body)(x)


def sharded_bell202_demod(audio, samp_rate: float, mesh, axis: str = "time",
                          band: tuple | None = (400.0, 2700.0)):
    """The full AX.25 1200 bd AFSK front-end, time-sharded in ONE program.

    Band-pass -> Hilbert(65) -> quadrature demod -> 1100 Hz low-pass ->
    centre offset (models/ax25.py::bell202_demod; the input band-pass is
    the r3 decode-rate addition, the rest is the reference chain,
    examples/ax25-1200-rx.rs:229-247).

    Thin wrapper: the body is built from the blocks' own shard plans via
    :func:`..parallel.graph_mesh.shard_chain` — the SAME machinery
    ``Graph.run(mesh=...)`` compiles, so the halo widths are derived from
    what each block declares instead of being re-hardcoded here.  Output
    equals the offline chain exactly (length N-1).
    """
    from .. import taps as tapgen
    from ..blocks.demod import QuadratureDemod
    from ..blocks.elementwise import AddConst
    from ..blocks.filters import FftFilterFloat, Hilbert
    from .graph_mesh import shard_chain

    lp = np.asarray(tapgen.low_pass(
        samp_rate, 1100.0, 200.0 if band is not None else 100.0, "hamming"))
    chain = []
    if band is not None:
        chain.append(FftFilterFloat(
            tapgen.band_pass(samp_rate, band[0], band[1], 65, "hamming")))
    chain += [
        Hilbert(65),
        QuadratureDemod(1.0),
        FftFilterFloat(lp),
        AddConst(-np.float32(2.0 * np.pi * 1700.0 / samp_rate)),
    ]
    return shard_chain(chain, mesh, axis)(jnp.asarray(audio, jnp.float32))


def sharded_symbol_sync_bank(xs, sps: float, mesh, axis: str = "chan",
                             max_deviation: float = 0.5,
                             clock_taps=(0.5, 0.5), unroll: int = 16,
                             method: str = "scan",
                             max_events: int | None = None,
                             return_valid: bool = False):
    """Clock recovery for a (C, N) bank of NRZ streams with the CHANNEL
    axis sharded over the mesh.

    Each device runs one vmapped ``symbol_sync`` scan over its C/n_dev
    channels — the multi-chip form of the channel-parallel receiver
    (models/multichannel.py): channels never talk to each other, so the
    shard needs no halos at all.  Returns (values, mask, clocks), each
    (C, N), sharded like the input.  ``method="events"`` selects the
    event-driven form (see ops.symbol_sync.symbol_sync_events — decode-
    equivalent, ~sps-times shorter sequential chain per channel);
    ``return_valid=True`` appends the per-channel budget-overflow flags
    (all-True for the scan method) as a 4th output.
    """
    from ..ops.symbol_sync import symbol_sync, symbol_sync_events

    n_sh = mesh.shape[axis]
    if xs.shape[0] % n_sh:
        raise ValueError(
            f"channel count {xs.shape[0]} must be divisible by {n_sh} shards"
        )
    if method not in ("scan", "events"):
        raise ValueError(f"unknown method {method!r}; use 'scan' or 'events'")

    def body(xs_local):
        if method == "events":
            f = jax.vmap(
                lambda x: symbol_sync_events(x, sps, max_deviation,
                                             clock_taps,
                                             max_events=max_events,
                                             unroll=unroll)
            )
            (vals, mask, clks), valid = f(xs_local)
        else:
            f = jax.vmap(
                lambda x: symbol_sync(x, sps, max_deviation, clock_taps,
                                      unroll=unroll)[0]
            )
            vals, mask, clks = f(xs_local)
            valid = jnp.ones(vals.shape[0], bool)
        return vals, mask, clks, valid

    vals, mask, clks, valid = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis, None),),
        out_specs=(P(axis, None), P(axis, None), P(axis, None), P(axis)),
        check_vma=False,
    )(jnp.asarray(xs, jnp.float32))
    if return_valid:
        return vals, mask, clks, valid
    return vals, mask, clks


def sharded_fm_demod(
    iq,
    taps,
    mesh,
    deci: int = 1,
    gain: float = 1.0,
    axis: str = "time",
    fft_size: int | None = None,
):
    """The headline chain — channel low-pass + decimate + FM demod — fused
    into ONE shard_map (one jit program, halos exchanged once per stream).

    Thin wrapper over :func:`..parallel.graph_mesh.shard_chain`: the body
    is built from FirFilter's and QuadratureDemod's own shard plans — the
    SAME machinery ``Graph.run(mesh=...)`` compiles — so halo widths and
    decimation-grid alignment are derived, not hardcoded.  Output follows
    the blocks' valid-conv streaming alignment: it equals
    ``quadrature_demod(fir_filter(iq, taps, deci), gain)`` for every
    sample that chain defines (up to one trailing sample whose window
    touches the stream end may follow; slice to the offline length for
    exact comparison).  ``fft_size`` is accepted for API compatibility
    (the filter dispatcher picks the kernel).
    """
    from ..blocks.demod import QuadratureDemod
    from ..blocks.filters import FirFilter
    from .graph_mesh import shard_chain

    return shard_chain(
        [FirFilter(np.asarray(taps), deci), QuadratureDemod(gain)], mesh, axis
    )(iq)
