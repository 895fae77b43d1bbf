"""Pure stream kernels — the DSP math of the framework.

Every op here is a pure function ``y = op(x, ...)`` (or ``(y, state') =
op(x, state, ...)``) over 1-D sample arrays, jit/vmap/shard_map-friendly:
static shapes, no data-dependent Python control flow.  The stateful block
wrappers in :mod:`rustradio_tpu.blocks` build on these.

Semantics are documented per-op against the reference implementation
(rustradio's src/); see each docstring for the file:line.
"""

from .elementwise import (
    add,
    add_const,
    binary_slicer,
    complex_to_float,
    complex_to_mag2,
    complex_to_real,
    float_to_complex,
    multiply,
    multiply_const,
    xor,
    xor_const,
)
from .fir import fir_filter, fir_filter_full, fir_filter_translating
from .fft_filter import fft_filter, fft_filter_float, filter_complex, filter_float
from .resampler import rational_resampler, resampler_indices
from .demod import fast_atan2, fast_fm, quadrature_demod
from .fm import fm_chain, fm_chain_plain
from .hilbert import hilbert_transform
from .iir import iir_filter, single_pole_iir
from .nrzi import nrzi_decode, nrzi_encode
from .scramble import descramble, scramble
from .delay import delay, head, skip
from .vco import vco
from .symbol_sync import (recover_symbols, symbol_sync,
                          symbol_sync_events, zero_crossing_sync)
from .hdlc import calc_crc, fcs_add, hdlc_deframe, hdlc_frame
from .wpcr import midpoint, midpoint_batch, prewarm_buckets, wpcr, wpcr_batch
from .burst import burst_tagger, pdu_average, stream_to_pdu
from .cma import cma_equalize
from .correlate import correlate_access_code
from .fft import fft_pdu, fft_stream
from .signal import signal_source_c, signal_source_f

__all__ = [k for k in dir() if not k.startswith("_")]
