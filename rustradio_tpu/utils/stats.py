"""Throughput / roofline accounting.

The reference prints a per-block wall+CPU time table after every run
(src/graph.rs:175-257).  Graph.generate_stats() covers that; this module
adds rate metering for streaming feeds and a simple per-op roofline
estimate (achieved GB/s vs the card's memory bandwidth).
"""

from __future__ import annotations

import dataclasses
import time

#: Published memory bandwidth, GB/s, keyed on JAX's ``device_kind``
#: (NVIDIA H100 data sheet: SXM5 3.35 TB/s HBM3, PCIe 2.0 TB/s HBM2e).
HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
    "NVIDIA H100 PCIe": 2000.0,
}


@dataclasses.dataclass
class RateMeter:
    """Track samples/s over a streaming run."""

    samples: int = 0
    t0: float = dataclasses.field(default_factory=time.perf_counter)

    def add(self, n: int):
        self.samples += n

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def msps(self) -> float:
        return self.samples / max(self.elapsed, 1e-12) / 1e6

    def report(self) -> str:
        return f"{self.samples} samples in {self.elapsed:.3f}s = {self.msps:.1f} Msps"


def device_hbm_gbps(device=None) -> float:
    """The device's published memory bandwidth; ValueError for a device
    not in HBM_GBPS (no default: a guessed peak gives a false roofline)."""
    import jax

    device = device or jax.devices()[0]
    kind = device.device_kind
    if kind not in HBM_GBPS:
        raise ValueError(f"no published memory bandwidth for {kind!r}")
    return HBM_GBPS[kind]


def roofline_report(bytes_moved: int, seconds: float, device=None) -> str:
    """Achieved bandwidth vs the device's memory roofline."""
    gbps = bytes_moved / max(seconds, 1e-12) / 1e9
    roof = device_hbm_gbps(device)
    return f"{gbps:.1f} GB/s ({100 * gbps / roof:.0f}% of ~{roof:.0f} GB/s HBM)"
