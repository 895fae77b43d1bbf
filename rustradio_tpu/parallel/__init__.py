"""Multi-chip execution: mesh construction, halo exchange, sharded chains.

The reference's only inter-worker transport is an mmap'd SPSC ring buffer
plus TCP (SURVEY §2.7).  Here the equivalents are XLA collectives over a
``jax.sharding.Mesh``: the *time axis* of a stream is sharded across chips,
and filter history ("sequence-dimension chunking" in the reference —
src/fft_filter.rs:336-348, src/fir.rs:493-505) becomes a left-halo exchange
via ``ppermute`` over the device interconnect (NVLink between the cards
of a host).
"""

from .mesh import init_distributed, make_mesh, make_mesh_2d, time_axis_spec
from .pipeline import pipeline_chain, pipeline_run, pipeline_run_rates
from .halo import halo_exchange_left, halo_exchange_right
from .sharded import (
    sharded_bell202_demod,
    sharded_fft_filter,
    sharded_fir_filter,
    sharded_fm_demod,
    sharded_quadrature_demod,
    sharded_symbol_sync_bank,
)
from .channelizer import (
    channelizer_fm_bank,
    channelizer_taps,
    pfb_channelize,
    sharded_channelizer_fm,
)

__all__ = [
    "channelizer_fm_bank",
    "channelizer_taps",
    "halo_exchange_left",
    "halo_exchange_right",
    "init_distributed",
    "make_mesh",
    "pipeline_chain",
    "pipeline_run",
    "pipeline_run_rates",
    "make_mesh_2d",
    "pfb_channelize",
    "sharded_channelizer_fm",
    "sharded_bell202_demod",
    "sharded_fft_filter",
    "sharded_fir_filter",
    "sharded_fm_demod",
    "sharded_quadrature_demod",
    "sharded_symbol_sync_bank",
    "time_axis_spec",
]
