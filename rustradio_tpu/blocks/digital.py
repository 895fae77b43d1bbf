"""Bit-level digital blocks: NRZI, scrambling, correlation, clock recovery."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import ops
from ..streams import Tag
from .base import Block


class NrziDecode(Block):
    shard_halo = 1  # carried previous bit (0 at stream start)

    def state_from_tail(self, tail):
        return jnp.asarray(tail, jnp.uint8)[0]

    def apply(self, x):
        return ops.nrzi_decode(x)

    def init_state(self):
        return jnp.uint8(0)

    def apply_chunk(self, state, x):
        x = jnp.asarray(x, jnp.uint8)
        y = ops.nrzi_decode(x, last=state)
        # a data-dependent upstream (e.g. clock recovery) can emit an
        # empty chunk; keep the carried bit rather than index into it
        return (state if x.shape[0] == 0 else x[-1]), y


class NrziEncode(Block):
    def apply(self, x):
        return ops.nrzi_encode(x)

    def init_state(self):
        return jnp.uint8(0)

    def apply_chunk(self, state, x):
        y = ops.nrzi_encode(x, out0=state)
        return (state if y.shape[0] == 0 else y[-1]), y


class Descrambler(Block):
    """Feed-forward LFSR descramble (reference src/descrambler.rs)."""

    def __init__(self, mask: int = 0x21, seed: int = 0, length: int = 16):
        self.mask, self.length = mask, length
        # seed affects only the first length+1 outputs; reference notes seed
        # is irrelevant in practice (src/descrambler.rs:3-5); we honor 0.

    @property
    def shard_halo(self):
        return self.length + 1  # feed-forward: state == input tail

    def state_from_tail(self, tail):
        return jnp.asarray(tail, jnp.uint8)

    @classmethod
    def g3ruh(cls):
        return cls(0x21, 0, 16)

    def apply(self, x):
        return ops.descramble(x, self.mask, self.length)

    def init_state(self):
        return jnp.zeros(self.length + 1, jnp.uint8)

    def apply_chunk(self, state, x):
        x = jnp.asarray(x, jnp.uint8)
        y = ops.descramble(x, self.mask, self.length, history=state)
        ext = jnp.concatenate([state, x])
        return ext[-(self.length + 1) :], y


class Scrambler(Block):
    """LFSR scramble (reference src/descrambler.rs:39-45)."""

    def __init__(self, mask: int = 0x21, seed: int = 0, length: int = 16):
        self.mask, self.seed, self.length = mask, seed, length

    @classmethod
    def g3ruh(cls):
        return cls(0x21, 0, 16)

    def apply(self, x):
        y, _ = ops.scramble(x, self.mask, self.length, self.seed)
        return y

    def init_state(self):
        return jnp.asarray(
            [(self.seed >> j) & 1 for j in range(self.length + 1)], jnp.uint8
        )

    def apply_chunk(self, state, x):
        y, s = ops.scramble(x, self.mask, self.length, state=state)
        return s, y


class CorrelateAccessCode(Block):
    """1 on access-code match (reference src/correlate_access_code.rs)."""

    def __init__(self, code, allowed_diffs: int = 0):
        self.code = np.asarray(code, np.uint8)
        if self.code.size == 0:
            raise ValueError("access code must be nonempty")
        self.allowed_diffs = allowed_diffs

    @property
    def shard_halo(self):
        return len(self.code) - 1

    def state_from_tail(self, tail):
        return jnp.asarray(tail, jnp.uint8)

    def apply(self, x):
        return ops.correlate_access_code(x, self.code, self.allowed_diffs)

    def init_state(self):
        return jnp.zeros(len(self.code) - 1, jnp.uint8) if len(self.code) > 1 else None

    def apply_chunk(self, state, x):
        if state is None:
            return None, self.apply(x)
        x = jnp.asarray(x, jnp.uint8)
        ext = jnp.concatenate([state, x])
        y = ops.correlate_access_code(ext, self.code, self.allowed_diffs)
        return ext[-(len(self.code) - 1) :], y[len(self.code) - 1 :]


class CorrelateAccessCodeTag(CorrelateAccessCode):
    """Tags match positions instead of producing a bit stream; passes data
    through (reference CorrelateAccessCodeTag)."""

    domain = "host"

    def __init__(self, code, tag: str = "sync", allowed_diffs: int = 0):
        super().__init__(code, allowed_diffs)
        self.tag = tag

    def apply(self, x):
        self._match = np.asarray(super().apply(x))
        return x

    def process_tags(self, in_tags, out_lens):
        base = list(in_tags[0]) if in_tags else []
        for pos in np.flatnonzero(self._match):
            base.append(Tag(int(pos), self.tag, 0))
        return [sorted(base)]


class SymbolSync(Block):
    """Zero-crossing TED clock recovery (reference src/symbol_sync.rs).

    Output length is data-dependent: the device scan produces a masked
    stream that is compacted at the host boundary, so this is a host-domain
    block whose inner math runs jitted.

    ``method``:

    * ``"native"`` (default) — the sequential per-sample recurrence
      (native C++ port when available, else the device scan); bit-exact
      reference parity.
    * ``"events"`` — the event-driven device form
      (ops.symbol_sync.symbol_sync_events): the sequential chain scans
      zero CROSSINGS instead of samples (~sps-times shorter), the
      decode-bank headline path, now first-class in the block API.
      Decode-equivalent rather than bit-identical to the scan; chunked
      output is exactly the block's own whole-stream output.  The event
      budget auto-sizes from ``sps`` (pow-2 bucketed) and doubles on
      overflow up to the chunk length, so chattery input degrades to a
      bigger compile instead of wrong output.
    """

    domain = "host"

    def __init__(self, sps: float, max_deviation: float = 0.5,
                 clock_taps=(0.5, 0.5), method: str = "native",
                 max_events: int | None = None):
        if method not in ("native", "events"):
            raise ValueError(f"unknown method {method!r}; use 'native' or 'events'")
        self.sps = sps
        self.max_deviation = max_deviation
        self.clock_taps = tuple(clock_taps)
        self.method = method
        self.max_events = max_events

    def init_state(self):
        return {"sync": None}

    def _default_budget(self, n: int) -> int:
        want = max(64, int(4 * n / self.sps))
        return min(1 << (want - 1).bit_length(), max(8, n // 4))

    def _run_events(self, x, state):
        x = np.asarray(x, np.float32)
        n = len(x)
        if n == 0:
            return jnp.zeros(0, jnp.float32), state
        budget = self.max_events or self._default_budget(n)
        while True:
            (vals, mask, _), valid, new_state = ops.symbol_sync_events(
                x, self.sps, self.max_deviation, self.clock_taps,
                max_events=budget, state=state, return_state=True,
            )
            if bool(valid) or budget >= n:
                break
            budget = min(n, budget * 2)  # overflow: retry, state untouched
        return jnp.asarray(np.asarray(vals)[np.asarray(mask)]), new_state

    def _run(self, x, state):
        (vals, mask, _), new_state = ops.symbol_sync(
            x, self.sps, self.max_deviation, self.clock_taps, state=state
        )
        return jnp.asarray(np.asarray(vals)[np.asarray(mask)]), new_state

    def apply(self, x):
        if self.method == "events":
            syms, _ = self._run_events(x, None)
            return syms
        # The native sequential kernel when available (exact f32 match,
        # ~100x the scan).
        syms = ops.recover_symbols(
            np.asarray(x), self.sps, self.max_deviation, self.clock_taps
        )
        return jnp.asarray(syms)

    def apply_chunk(self, state, x):
        from .. import native

        prev = state["sync"] if state else None
        if self.method == "events":
            syms, new = self._run_events(x, prev)
            return {"sync": new}, syms
        if native.available():
            # Native with an explicit state dict (same keys as the scan's
            # carry, so checkpoints interoperate between backends).
            vals, _, new = native.symbol_sync_f32(
                np.asarray(x, np.float32), self.sps, self.max_deviation,
                np.asarray(self.clock_taps), state=prev,
            )
            return {"sync": new}, jnp.asarray(vals)
        syms, new = self._run(x, prev)
        return {"sync": new}, syms


class ZeroCrossing(Block):
    """Fixed-clock zero-crossing recovery (reference src/zero_crossing.rs)."""

    domain = "host"

    def __init__(self, sps: float, max_deviation: float = 0.5):
        if not sps > 1.0:
            raise ValueError("sps must be > 1")
        self.sps = sps
        self.max_deviation = max_deviation

    def init_state(self):
        return {"sync": None}

    def _run(self, x, state):
        from .. import native

        out = native.zero_crossing_f32(np.asarray(x, np.float32), self.sps, state=state)
        if out is not None:  # exact native port, ~100x the scan
            vals, new_state = out
            return jnp.asarray(vals), new_state
        (vals, mask), new_state = ops.zero_crossing_sync(
            x, self.sps, self.max_deviation, state=state
        )
        return jnp.asarray(np.asarray(vals)[np.asarray(mask)]), new_state

    def apply(self, x):
        return self._run(x, None)[0]

    def apply_chunk(self, state, x):
        syms, new = self._run(x, state["sync"] if state else None)
        return {"sync": new}, syms
