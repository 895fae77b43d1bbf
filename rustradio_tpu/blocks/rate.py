"""Rate-changing and position blocks."""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from .. import ops
from .base import Block

_take = jax.jit(lambda v, idx: jnp.take(v, idx, axis=0))


@functools.lru_cache(maxsize=None)
def _drop_first(n: int):
    return jax.jit(lambda v: v[n:])


@functools.lru_cache(maxsize=None)
def _keep_first(n: int):
    return jax.jit(lambda v: v[:n])


class RationalResampler(Block):
    """Gather resampler (reference src/rational_resampler.rs:154-206).

    Streaming: output position is a pure function of the global input
    offset (the reference's counter evolves linearly), so the chunk form
    just computes the global index window.
    """

    jit_chunk = False  # chunk logic depends on Python-int offsets

    def __init__(self, interp: int, deci: int):
        if interp <= 0 or deci <= 0:
            raise ValueError("RationalResampler interp/deci must be > 0")
        g = math.gcd(interp, deci)
        self.interp = interp // g
        self.deci = deci // g

    def shard_fn(self, di):
        """Mesh plan (closes the r4 verdict's mtgraph gap): the counter
        algorithm's output position is a pure function of the global
        input offset (reference src/rational_resampler.rs:183-198 — the
        counter evolves linearly), so a shard's outputs are one gather.

        With the local input length divisible by ``deci`` (div), the
        output count is exactly ``L*interp/deci`` regardless of offset.
        For TRUE-stream input offset a, output k maps to input
        floor(k*deci/interp); the shard's first output is
        k0 = ceil(a*interp/deci).  The ``di`` garbage samples upstream
        blocks prepend at stream start shift the mesh coordinates off
        the true stream, so the gather anchors at a = g_in - di (folded
        into a nonnegative mod-period offset) — otherwise the output
        grid PHASE is wrong whenever di*interp % deci != 0.  The
        leading floor(di*interp/deci) outputs read the garbage prefix
        and are masked by the runner.  All index math runs on offsets
        reduced mod interp*deci so the traced int32 products stay exact
        (a itself can be ~2^30)."""
        from .base import ShardFn

        interp, deci = self.interp, self.deci
        period = interp * deci
        off = (-di) % period  # g_in + off == g_in - di (mod period), >= 0

        def fn(ext, n_local, ctx):
            rem = jax.lax.rem(jnp.asarray(ctx.g_in, jnp.int32)
                              + jnp.int32(off),
                              jnp.int32(period))
            r0 = (rem * interp + (deci - 1)) // deci  # ceil(rem*I/D)
            n_out = n_local * interp // deci
            j = jnp.arange(n_out, dtype=jnp.int32)
            # (r0 + j)*deci // interp - rem, with j = q*interp + s so the
            # int32 products stay bounded by interp*period for any chunk
            q, s = j // interp, j % interp
            idx = q * deci + (r0 + s) * deci // interp - rem
            return jnp.take(ext, idx, axis=0)

        return ShardFn(
            halo=0, d_out=di * interp // deci, div=deci, fn=fn
        )

    def shard_total_out(self, n):
        return -(-n * self.interp // self.deci)

    def shard_state(self, tail, consumed):
        # position-dependent host state: rebuild the offsets from the
        # global consumed count (mesh demotion / EOF conversion)
        return {
            "in_off": int(consumed),
            "out_off": -(-int(consumed) * self.interp // self.deci),
        }

    def apply(self, x):
        return ops.rational_resampler(x, self.interp, self.deci)

    def init_state(self):
        return {"in_off": 0, "out_off": 0}

    def apply_chunk(self, state, x):
        n = x.shape[0]
        in_off, out_off = state["in_off"], state["out_off"]
        # outputs k with floor(k*deci/interp) in [in_off, in_off+n)
        out_end = -(-(in_off + n) * self.interp // self.deci)  # ceil
        k = np.arange(out_off, out_end)
        idx = (k * self.deci) // self.interp - in_off
        # jitted gather: one dispatch
        y = _take(jnp.asarray(x), jnp.asarray(idx))
        return {"in_off": in_off + n, "out_off": out_end}, y


class Delay(Block):
    """Zero-filled delay (reference src/delay.rs): ``delay`` zeros, then
    the input stream.

    Two modes:

    * static (default) — a device block that fuses into jit segments:
      per-chunk output keeps the chunk length (a carried tail), and the
      final ``delay`` samples drain at end-of-stream via the graph's
      flush pass, so the total stream is the reference's N + delay.
    * ``dynamic=True`` — supports runtime ``set_delay`` (e.g. from a
      control thread): increasing the delay inserts zeros before the
      next chunk; decreasing it skips input until caught up — the
      reference's ``current_delay``/``skip`` arithmetic
      (src/delay.rs:42-53, 58-105).  Output length varies per chunk, so
      this mode runs unfused on the host.
    """

    def __init__(self, n: int, dynamic: bool = False):
        if n < 0:
            raise ValueError("delay must be >= 0")
        self.delay = n
        self.dynamic = dynamic
        # Static Delay declares NO shard plan: its end-of-stream drain
        # (flush_with_state emits the carried ``delay``-sample tail, so
        # the total stream is N + delay) cannot be reproduced by the
        # sharded offline form, whose totals model rate-1 streaming —
        # the planner would reject the flush hook anyway, so a halo
        # declaration here would be dead and only suggest otherwise.
        self._pending: list[int] = []
        self._zeros_this = 0
        self._skip_this = 0
        self._carried_tags: list = []
        if dynamic:
            self.jit_chunk = False
            self.domain = "host"

    def set_delay(self, n: int) -> None:
        """Queue a delay change; takes effect at the next chunk."""
        if not self.dynamic:
            raise ValueError("runtime set_delay needs Delay(n, dynamic=True)")
        if n < 0:
            raise ValueError("delay must be >= 0")
        self._pending.append(n)

    def init_state(self):
        self._carried_tags = []
        if not self.dynamic:
            return None  # lazily-typed carried tail
        return {"current": self.delay, "skip": 0}

    def _drain_pending(self, current: int, skip: int):
        for d in self._pending:
            if d > self.delay:
                current += d - self.delay
            else:
                reduce = self.delay - d
                c = min(current, reduce)
                current -= c
                skip += reduce - c
            self.delay = d
        self._pending.clear()
        return current, skip

    def apply_chunk(self, state, x):
        if not self.dynamic:
            x = jnp.asarray(x)
            if state is None:
                state = jnp.zeros(self.delay, x.dtype)
            ext = jnp.concatenate([state, x])
            return ext[x.shape[0] :], ext[: x.shape[0]]
        current, skip = self._drain_pending(state["current"], state["skip"])
        x = np.asarray(x)
        k = min(skip, len(x))
        body = x[k:]
        self._zeros_this, self._skip_this = current, k
        out = np.concatenate([np.zeros(current, x.dtype), body])
        return {"current": 0, "skip": skip - k}, jnp.asarray(out)

    def flush_with_state(self, state):
        # static mode: the carried tail (the stream's last `delay`
        # samples) drains at end-of-stream, making the total N + delay
        if self.dynamic or state is None or self.delay == 0:
            return None
        return state

    # carried tags ride host-side (the state pytree is jitted); expose
    # them to checkpoints so tags in a chunk's last `delay` samples
    # survive a checkpoint/resume boundary
    def host_state(self):
        return list(self._carried_tags)

    def restore_host_state(self, hs):
        self._carried_tags = list(hs)

    def apply(self, x):
        if not self.dynamic:
            x = jnp.asarray(x)
            return jnp.concatenate([jnp.zeros(self.delay, x.dtype), x])
        _, out = self.apply_chunk(self.init_state(), x)
        return out

    def process_tags(self, in_tags, out_lens):
        # input tags ride their samples, shifted by the zeros emitted ahead
        # of them this chunk (the zero-fill region carries no tags,
        # src/delay.rs:96-101)
        from ..streams import Tag

        src = in_tags[0] if in_tags else []
        if not self.dynamic:
            # static streaming: a tag whose delayed position lands past
            # this chunk rides the carried tail and re-emits next chunk
            # (or in the flush drain) — without this, any tag in the last
            # `delay` samples of a chunk would vanish
            n = out_lens[0] if out_lens else 0
            allt = self._carried_tags + [
                Tag(t.pos + self.delay, t.key, t.val) for t in src
            ]
            keep = sorted(t for t in allt if t.pos < n)
            self._carried_tags = [
                Tag(t.pos - n, t.key, t.val) for t in allt if t.pos >= n
            ]
            return [list(keep) for _ in out_lens]
        shift, k = self._zeros_this, self._skip_this
        return [
            [
                Tag(t.pos - k + shift, t.key, t.val)
                for t in src
                if t.pos >= k and t.pos - k + shift < n
            ]
            for n in out_lens
        ]


class Skip(Block):
    """Drop first n samples (reference src/skip.rs)."""

    jit_chunk = False  # variable-length outputs per chunk

    def __init__(self, n: int):
        self.n = n

    def apply(self, x):
        return ops.skip(x, self.n)

    def init_state(self):
        return {"left": self.n}

    def apply_chunk(self, state, x):
        left = state["left"]
        take = min(left, x.shape[0])
        return {"left": left - take}, _drop_first(take)(jnp.asarray(x))


class Head(Block):
    """Pass first n samples then end (reference src/head.rs)."""

    jit_chunk = False  # variable-length outputs per chunk

    def __init__(self, n: int):
        self.n = n

    def apply(self, x):
        return ops.head(x, self.n)

    def init_state(self):
        return {"left": self.n}

    def apply_chunk(self, state, x):
        take = min(state["left"], x.shape[0])
        return {"left": state["left"] - take}, _keep_first(take)(jnp.asarray(x))
