"""Concrete librtlsdr driver adapter (reference src/rtlsdr_source.rs:28-57).

Binds the pyrtlsdr python bindings (librtlsdr) to the framework's
:class:`~rustradio_tpu.hw.driver.SdrDriver` interface, completing the
RTL-SDR path: ``RtlDriver`` -> ``RtlSdrSource`` (u8 wire format) ->
``RtlSdrDecode`` -> the device receive chains.  Without pyrtlsdr installed,
construction raises ImportError with a pointer at the Sim/Soapy routes
(rtl_tcp and the SoapySDR adapter reach the same hardware).

The reference applies queued tuner commands between blocking reads
(src/rtlsdr_source.rs:124-148); here the same happens in
``SdrSource._drain_commands`` calling the ``set_*`` methods below.
"""

from __future__ import annotations

import numpy as np

from .driver import SdrDriver


class RtlDriver(SdrDriver):
    """Adapter over pyrtlsdr (librtlsdr).

    Gain follows the framework's normalized 0-1 convention
    (``RtlSdrControl.set_gain_db`` maps the reference's dB API onto it as
    dB/50); here 0-1 maps back onto the dongle's *supported* gain list —
    the reference's tenth-dB ``rtlsdr_set_tuner_gain`` quantization.
    librtlsdr has no hardware clock, so ``time_ns`` synthesizes stream
    time from the sample counter (the deterministic choice SimDriver
    makes too).
    """

    def __init__(self, frequency: float, sample_rate: float, gain: float = 0.5,
                 device_index: int = 0, epoch_ns: int = 0):
        try:
            from rtlsdr import RtlSdr
        except ImportError as e:
            raise ImportError(
                "pyrtlsdr not available; reach RTL hardware via rtl_tcp "
                "(blocks.TcpSource + RtlSdrDecode) or the SoapySDR adapter "
                "(hw.soapy.SoapyDriver('driver=rtlsdr', ...)), or use "
                "hw.SimDriver for loopback"
            ) from e
        super().__init__(frequency, sample_rate, gain)
        self._sdr = RtlSdr(device_index=device_index)
        self._index = device_index
        self._count = 0
        self._epoch_ns = epoch_ns
        self._leftover = np.zeros(0, np.complex64)
        self._sdr.sample_rate = sample_rate
        self._sdr.center_freq = frequency
        self._apply_gain(gain)

    # ---- identity / telemetry ----
    def info(self) -> dict:
        return {"driver": "rtlsdr", "hardware": f"rtl{self._index}"}

    def sensors(self) -> dict:
        return {}  # librtlsdr exposes no sensors

    def time_ns(self) -> int:
        return self._epoch_ns + int(self._count / self.sample_rate * 1e9)

    # ---- control plane ----
    def _apply_gain(self, gain: float) -> None:
        gains = list(getattr(self._sdr, "valid_gains_db", []) or [])
        if not gains:
            self._sdr.gain = "auto"
            return
        want_db = float(gain) * 50.0  # inverse of RtlSdrControl.set_gain_db
        self._sdr.gain = min(gains, key=lambda g: abs(g - want_db))

    def set_frequency(self, hz: float) -> None:
        super().set_frequency(hz)
        self._sdr.center_freq = float(hz)

    def set_sample_rate(self, sps: float) -> None:
        super().set_sample_rate(sps)
        self._sdr.sample_rate = float(sps)

    def set_gain(self, gain: float) -> None:
        super().set_gain(gain)
        self._apply_gain(gain)

    # ---- data plane ----
    def read(self, n: int) -> np.ndarray:
        # librtlsdr wants multiples of 512 samples; read_samples returns
        # (u8 - 127.5)/127.5 complex — the same decode RtlSdrSource's wire
        # format re-encodes, so round-tripping through u8 is lossless.
        # Samples past n are BUFFERED for the next read, never dropped —
        # discarding them would put a phase jump in the stream every chunk.
        need = n - len(self._leftover)
        if need > 0:
            want = max(512, -(-need // 512) * 512)
            fresh = np.asarray(self._sdr.read_samples(want), np.complex64)
            self._leftover = np.concatenate([self._leftover, fresh])
        data, self._leftover = self._leftover[:n], self._leftover[n:]
        self._count += len(data)
        return data

    def close(self) -> None:
        self._sdr.close()
