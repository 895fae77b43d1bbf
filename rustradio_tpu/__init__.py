"""rustradio_tpu — a JAX software-defined-radio framework.

A from-scratch JAX/XLA/Pallas re-imagining of the capability set of
`rustradio <https://github.com/ThomasHabets/rustradio>`_.  Where the
reference runs a dynamic block scheduler over mmap'd circular buffers
(graph.rs, mtgraph.rs, circular_buffer.rs), this
framework compiles a whole flowgraph into jitted programs over fixed-size
sample chunks, carrying all per-block state (filter tails, oscillator phases,
LFSR registers, clock-recovery state) in a pytree scanned with ``lax.scan``.

Layout:

* :mod:`rustradio_tpu.dtypes` — sample types, parsing helpers
* :mod:`rustradio_tpu.windows`, :mod:`rustradio_tpu.taps` — filter design
* :mod:`rustradio_tpu.ops` — pure stream kernels (the DSP math)
* :mod:`rustradio_tpu.blocks` — stateful block wrappers for graphs
* :mod:`rustradio_tpu.graph` — flowgraph builder + compilers
* :mod:`rustradio_tpu.parallel` — mesh / time-shard / channel-shard layer
* :mod:`rustradio_tpu.io` — file formats and host I/O (au, SigMF, ...)
* :mod:`rustradio_tpu.models` — full receiver chains (AX.25, FM, ...)
"""

import os as _os


def _enable_compilation_cache() -> None:
    """Persist compiled programs across processes.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is
    left to JAX.  Otherwise the cache lives at a fixed path in the
    checkout (``.jax_cache``, listed in .gitignore).  Runs whose primary
    platform is the CPU get no cache from here: CPU executables are
    specific to the host's CPU features."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    plats = _os.environ.get("JAX_PLATFORMS", "").split(",")
    if plats[0].strip() == "cpu":
        return
    import jax

    root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    jax.config.update("jax_compilation_cache_dir", _os.path.join(root, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_enable_compilation_cache()

from . import dtypes, taps, windows
from .dtypes import Complex, Float, parse_frequency, parse_verbosity
from .graph import CancellationToken, Graph
from .streams import Pdu, StreamValue, Tag

__version__ = "0.1.0"

__all__ = [
    "CancellationToken",
    "Complex",
    "Float",
    "Graph",
    "Pdu",
    "StreamValue",
    "Tag",
    "dtypes",
    "parse_frequency",
    "parse_verbosity",
    "taps",
    "windows",
]
