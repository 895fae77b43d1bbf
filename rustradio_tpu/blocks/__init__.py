"""Block library: the reference's block inventory as graph nodes.

Each block wraps a pure op from :mod:`rustradio_tpu.ops` with (a) offline
whole-stream semantics (`apply`), (b) optional streaming chunk semantics
with carried state (`init_state` / `apply_chunk`), and (c) tag handling.
Blocks declare `domain`: "device" blocks are fused into jitted segments by
the graph compiler; "host" blocks run between segments (packet domain).
"""

from .base import Block, SourceBlock
from .sources import (
    ConstantSource,
    FileSource,
    NoiseSource,
    SignalSourceComplex,
    SignalSourceFloat,
    VectorSource,
)
from .sinks import (
    DebugFilter,
    DebugSink,
    DeviceFoldSink,
    FileSink,
    NullSink,
    PduFileSink,
    PduVectorSink,
    VectorSink,
)
from .elementwise import (
    Add,
    AddConst,
    BinarySlicer,
    ComplexToFloat,
    ComplexToMag2,
    ComplexToReal,
    FloatToComplex,
    Inspect,
    Map,
    MultiplyConst,
    PduMap,
    Tee,
    Xor,
    XorConst,
)
from .filters import (
    FftFilter,
    FftFilterFloat,
    FirFilter,
    Hilbert,
    IqBalance,
    SinglePoleIirFilter,
)
from .rate import Delay, Head, RationalResampler, Skip
from .demod import FastFM, QuadratureDemod, Vco
from .digital import (
    CorrelateAccessCode,
    CorrelateAccessCodeTag,
    Descrambler,
    NrziDecode,
    NrziEncode,
    Scrambler,
    SymbolSync,
    ZeroCrossing,
)
from .packets import (
    Il2pDeframer,
    BurstTagger,
    Canary,
    FcsAdder,
    Fft,
    FftStream,
    HdlcDeframer,
    HdlcFramer,
    Hasher,
    KissDecode,
    KissEncode,
    KissFrame,
    Midpointer,
    MorseEncode,
    PduToStream,
    PduWriter,
    StreamToPdu,
    ToText,
    Wpcr,
)

__all__ = [k for k in dir() if not k.startswith("_")]
from .io_blocks import (
    AuDecode,
    AuEncode,
    CmaEqualizer,
    ReaderSource,
    RtlSdrDecode,
    RtlSdrEncode,
    Strobe,
    TcpSource,
    WriterSink,
)
