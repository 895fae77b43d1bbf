"""Block protocol.

The reference's Block trait is ``work(&mut self) -> BlockRet`` driven by a
dynamic scheduler (src/block.rs:112-126).  Here a block is a *declarative*
node: a pure function over whole streams (offline mode) plus an optional
chunk form with carried state (streaming mode).  ``BlockRet`` disappears —
scheduling is static.
"""

from __future__ import annotations

import dataclasses

from ..streams import Tag


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Position context the mesh runner hands a block's shard fn.

    ``g_in``/``g_out`` — global input/output index of the local window's
    first sample (traced int32 scalars); ``k`` — shard index along the
    mesh axis (traced); ``aux`` — this chunk's host-computed scalar from
    ``ShardFn.prep`` (traced f32), None when the block declares no prep.
    """

    g_in: object
    g_out: object
    k: object
    aux: object = None


@dataclasses.dataclass(frozen=True)
class ShardFn:
    """One block's time-sharding contract (see Block.shard_fn).

    ``fn(ext, n_local, ctx)`` computes the block's outputs for a local
    window of the stream given ``ext = [halo history | local]``, where
    the history is the previous ``halo`` input samples (zeros at global
    stream start — every shardable block here has zero-history streaming
    semantics) and ``ctx`` is a :class:`ShardCtx`.

    ``prep(in0)`` — optional host hook, called once per chunk with the
    block's global mesh input offset (Python int): returns a float the
    runner passes in as ``ctx.aux``.  Use it for quantities that need
    float64 host math (e.g. a rotator phase reduced mod 2π — computing
    ``step * offset`` in traced f32 would lose ~1e-3 rad by mid-stream).
    """

    halo: int  # input history samples exchanged between shards
    d_out: int  # garbage outputs at global stream start (masked to 0)
    div: int  # the local input length must be divisible by this
    fn: object
    prep: object = None


class Block:
    """Base graph node.

    Class attributes:

    * ``n_in`` / ``n_out`` — port counts.
    * ``domain`` — "device" (fused into jit segments) or "host".
    * ``interp`` / ``deci`` — nominal rate ratio, used for tag rescaling.
    """

    n_in = 1
    n_out = 1
    domain = "device"
    interp = 1
    deci = 1
    # The runners wrap a device block's apply/apply_chunk in jax.jit.
    # Set jit_chunk = False when the block's logic is not jax-traceable
    # (Python-value-dependent control flow or host numpy inside) — the
    # block then runs eagerly and must jit any complex-dtype math itself.
    jit_chunk = True

    def name(self) -> str:
        return type(self).__name__

    # ---- offline ----
    def apply(self, *xs):
        """Whole-stream pure function. Returns one array or a tuple."""
        raise NotImplementedError

    # ---- streaming ----
    def init_state(self):
        """Carried state pytree; None for stateless blocks."""
        return None

    def apply_chunk(self, state, *xs):
        """Chunk form: (state', outputs). Default: stateless == offline.

        Must produce, over concatenated chunks, exactly the same stream as
        ``apply`` over the concatenated input.
        """
        return state, self.apply(*xs)

    # ---- time sharding (mesh execution) ----
    # The reference gets multi-core execution by swapping Graph for
    # MTGraph (src/mtgraph.rs:73-149).  Here Graph.run/run_stream take a
    # ``mesh=``: dense device segments execute as ONE shard_map program
    # with the sample axis sharded, and each block's filter history
    # crosses shard boundaries as a ppermute halo instead of carried
    # state (parallel/graph_mesh.py).  A block opts in by declaring
    # ``shard_halo`` — the same tail-of-input quantity its apply_chunk
    # already carries as streaming state.
    shard_halo: int | None = None  # None = not time-shardable
    shard_extra_drop = 0  # leading outputs streaming mode never emits

    def state_from_tail(self, tail):
        """Build this block's streaming state from the last ``shard_halo``
        input samples (used by the default apply_ext and by the mesh
        runner's EOF flush).  Default: the state IS the tail."""
        return tail

    def shard_state(self, tail, consumed: int):
        """Streaming state equivalent to having consumed ``consumed``
        samples whose last ``shard_halo`` are ``tail`` (mesh runner's
        fallback/EOF conversion).  For the tail-state family this is
        position-independent.  Halo-free blocks are called with
        ``tail=None``; position-dependent ones (e.g. a rate changer)
        override this to rebuild their offsets from ``consumed``."""
        if tail is None and not self.shard_halo:
            return self.init_state()
        return self.state_from_tail(tail)

    def apply_ext(self, ext, n_local, in0, out0):
        """Outputs for the local window given ``ext = [halo | local]``.

        Default: reuse the streaming chunk form with the halo as state —
        exact for every block whose state is its input tail."""
        if not self.shard_halo:
            return self.apply(ext)
        _, y = self.apply_chunk(
            self.state_from_tail(ext[: self.shard_halo]), ext[self.shard_halo :]
        )
        return y

    def shard_fn(self, di: int) -> ShardFn | None:
        """Time-sharding plan given ``di`` = garbage samples prepended to
        this block's input at global stream start (cumulative drops of
        upstream blocks in the same fused segment; the runner masks them
        to 0 so zero-history semantics compose).  None = not shardable.
        """
        if (
            self.shard_halo is None
            or self.n_in < 1
            or self.n_out < 1
            or self.deci != 1
            or self.interp != 1
        ):
            return None
        if self.n_in >= 2:
            # multi-input blocks shard only as pure elementwise combiners
            # (no halo, same rate): the planner verifies all inputs share
            # one rate and stream-start drop, and passes the exts tuple
            if self.shard_halo != 0:
                return None
            return ShardFn(
                halo=0,
                d_out=di + self.shard_extra_drop,
                div=1,
                fn=lambda exts, n, ctx: self.apply(*exts),
            )
        return ShardFn(
            halo=self.shard_halo,
            d_out=di + self.shard_extra_drop,
            div=1,
            fn=lambda ext, n, ctx: self.apply_ext(ext, n, ctx.g_in, ctx.g_out),
        )

    def shard_total_out(self, n: int) -> int:
        """Total outputs the streaming path emits for an n-sample stream
        (used to trim padding artifacts at end-of-stream)."""
        return max(0, n * self.interp // self.deci - self.shard_extra_drop)

    # ---- tags ----
    def process_tags(self, in_tags: list[list[Tag]], out_lens) -> list[list[Tag]]:
        """Map input-port tag lists to output-port tag lists.

        Default: pass port-0 tags to every output, positions rescaled by
        interp/deci and clipped to the output length.
        """
        src = in_tags[0] if in_tags else []
        out = []
        for n in out_lens:
            out.append(
                [
                    Tag(t.pos * self.interp // self.deci, t.key, t.val)
                    for t in src
                    if t.pos * self.interp // self.deci < n
                ]
            )
        return out


class SourceBlock(Block):
    """A block with no inputs; produces n samples from a stream offset."""

    n_in = 0

    def total_len(self):
        """Total stream length for offline mode, or None if unbounded."""
        return None

    def emit(self, offset: int, n: int):
        """Produce samples [offset, offset+n) of the stream."""
        raise NotImplementedError

    def emit_tags(self, offset: int, n: int) -> list[Tag]:
        return []

    # Optional batch protocol for the compiled streaming runner
    # (Graph.run_stream(scan_chunks=B)): a source may define
    #   emit_batch(offset, chunk_size, nb) -> stacked (nb, chunk) array
    # to produce a whole batch in ONE call (device-resident sources avoid
    # nb per-chunk dispatch round trips).  Symmetrically, an n_out == 0
    # device-domain block may define accept_batch(*stacked) to consume
    # stacked outputs in one call (it then owns any per-chunk handling).

    def apply(self):
        total = self.total_len()
        if total is None:
            raise ValueError(
                f"{self.name()} is unbounded; offline mode needs Head or a "
                "finite source"
            )
        return self.emit(0, total)
