"""Mesh execution of fused device segments — Graph.run/run_stream(mesh=).

The reference gets transparent multi-core execution by swapping ``Graph``
for ``MTGraph`` (one constructor flag; /root/reference/src/mtgraph.rs:73-149,
examples/ax25-1200-rx.rs:209-213).  Here the same swap is a ``mesh=``
argument on the runners: every fused device segment whose members declare
a shard plan (``Block.shard_fn``, blocks/base.py) compiles into ONE
``shard_map`` program with the sample axis sharded over the mesh.  Each
block's filter history crosses

* shard boundaries via a ``ppermute`` halo (one interconnect hop per block per
  chunk), and
* chunk boundaries via a carried global tail,

so the emitted streams are exactly what the single-device streaming
runner produces.  Blocks that cannot shard (sequential recurrences, rate
trackers, host machines) run unsharded around the sharded segments — the
SURVEY §5 long-context design (time axis sharded, halos via ppermute),
composed into the framework's user-facing API instead of hand-built
per-chain functions.

Exactness model: every shardable block has zero-history streaming
semantics, so a shard's left halo is literally its neighbour's input
tail.  Outputs the streaming path never emits (e.g. the quadrature
demod's arg(conj(0)·x₀), a valid-FIR window touching the zero prefix)
appear in the sharded stream as a *leading* region of length ``d_out``;
the program masks them to 0 so downstream zero-history blocks compose
exactly, and the runner trims them from external outputs at stream
start.  End-of-stream padding artifacts are strictly trailing and are
trimmed to the streaming totals (``Block.shard_total_out``).
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Any

import numpy as np


class NotShardable(Exception):
    """This segment cannot run on a mesh (runner falls back)."""


class _Port:
    def __init__(self, node, index=0):
        self.node, self.index = node, index


class _Node:
    def __init__(self, block, idx):
        self.block, self.idx = block, idx
        self.inputs: list[_Port] = []


def shard_chain(block_seq, mesh, axis: str = "time"):
    """A jittable sharded function from a linear chain of blocks.

    Thin functional form of the Graph mesh runner for in-jit use: builds
    the SAME shard_map body Graph.run(mesh=) compiles for a fused segment
    (each block's ``shard_fn`` halo/grid plan), zero stream history, one
    shot.  The returned ``f(x)`` expects the global stream length to
    divide ``mesh_axis * div`` and emits the streaming-aligned output
    with the leading start-drop trimmed — i.e. exactly what the offline
    block chain produces over the same input, save any trailing samples
    whose input windows extend past the stream.
    """
    nodes = []
    prev = _Node(None, -1)
    for i, b in enumerate(block_seq):
        n = _Node(b, i)
        n.inputs = [_Port(prev)]
        nodes.append(n)
        prev = n
    ms = MeshSegment(nodes, [(-1, 0)], [(len(block_seq) - 1, 0)], mesh, axis)
    aux = {
        i: np.float32(p.prep(0)) for i, p in ms.plans.items() if p.prep is not None
    }

    def f(x):
        n = x.shape[0]
        if n % (ms.n_sh * ms.div):
            raise ValueError(
                f"stream length {n} must divide mesh*div = {ms.n_sh * ms.div}"
            )
        if n < ms.min_chunk:
            raise ValueError(f"stream shorter than the halo ({ms.min_chunk})")
        carries = ms.init_carries(x)
        fn = ms._fn or ms._build()
        _, outs = fn(carries, aux, 0, x, True, None)
        return outs[0]

    return f


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


class MeshSegment:
    """A fused device segment planned onto a 1-D mesh axis.

    ``nodes`` — topo-ordered graph nodes; ``ext_in``/``ext_out`` — the
    segment's external ports as (node_idx, port) keys (from
    Graph._segment_io).  Raises NotShardable when the plan is impossible
    (multiple external inputs, a member without a shard plan, a flush
    hook whose end-of-stream drain the sharded form can't reproduce).
    """

    def __init__(self, nodes, ext_in, ext_out, mesh, axis: str):
        if len(ext_in) != 1:
            raise NotShardable("mesh segments take exactly one external input")
        self.nodes = list(nodes)
        self.ext_in = ext_in[0]
        self.ext_out = list(ext_out)
        self.mesh = mesh
        self.axis = axis
        self.n_sh = int(mesh.shape[axis])

        member = {n.idx for n in self.nodes}
        plans: dict[int, Any] = {}
        ratio: dict[tuple[int, int], Fraction] = {self.ext_in: Fraction(1)}
        drops: dict[tuple[int, int], int] = {self.ext_in: 0}
        totals: dict[tuple[int, int], Any] = {self.ext_in: lambda m: m}
        div = 1
        min_chunk = 1
        for n in self.nodes:
            b = n.block
            if b.n_in < 1 or hasattr(b, "flush") or hasattr(b, "flush_with_state"):
                raise NotShardable(f"{b.name()} not mesh-eligible")
            keys = [(p.node.idx, p.index) for p in n.inputs]
            for key in keys:
                if key != self.ext_in and key[0] not in member:
                    raise NotShardable(
                        "mesh segments take exactly one external input"
                    )
            if len(keys) > 1:
                # multi-input combiner: all inputs must share one rate and
                # one stream-start drop, or the elementwise combine would
                # misalign the streams
                if len({ratio[k] for k in keys}) != 1 or len(
                    {drops[k] for k in keys}
                ) != 1:
                    raise NotShardable(
                        f"{b.name()} inputs differ in rate or drop"
                    )
            key = keys[0]
            sf = b.shard_fn(drops[key])
            if sf is None:
                raise NotShardable(f"{b.name()} has no shard plan")
            plans[n.idx] = sf
            r_in = ratio[key]
            # the member's local input length is L0 * r_in; it must be an
            # integer divisible by sf.div and large enough for the halo
            dd = sf.div * r_in.denominator
            div = _lcm(div, dd // math.gcd(r_in.numerator, dd))
            if sf.halo:
                min_chunk = max(
                    min_chunk, -(-(sf.halo * r_in.denominator) // r_in.numerator)
                )
            r_out = r_in * Fraction(b.interp, b.deci)
            t_in = totals[key]
            t_out = lambda m, _b=b, _t=t_in: _b.shard_total_out(_t(m))
            for i in range(b.n_out):
                ratio[(n.idx, i)] = r_out
                drops[(n.idx, i)] = sf.d_out
                totals[(n.idx, i)] = t_out
        self.plans = plans
        self.ratio = ratio
        self.drops = drops
        self.totals = totals
        self.div = div
        # per-shard local input length must cover every member's halo
        self.min_chunk = min_chunk * self.n_sh
        self._carry_halos = {i: p.halo for i, p in plans.items() if p.halo}
        self._fn = None
        self._carry_dtypes = None

    # ---- carries ----
    def _input_dtypes(self, x_sds):
        """Dtype of every member's input stream (eval_shape walk)."""
        import jax

        vals = {self.ext_in: x_sds}
        dts = {}
        for n in self.nodes:
            ins = [vals[(p.node.idx, p.index)] for p in n.inputs]
            dts[n.idx] = ins[0].dtype
            out = jax.eval_shape(n.block.apply, *ins)
            outs = out if isinstance(out, tuple) else (out,)
            for i, o in enumerate(outs):
                vals[(n.idx, i)] = o
        return dts

    def init_carries(self, x):
        """Zero carries matching the stream dtypes (built under jit)."""
        import jax
        import jax.numpy as jnp

        sds = jax.ShapeDtypeStruct(np.shape(x), getattr(x, "dtype", None)
                                   or np.asarray(x).dtype)
        dts = self._input_dtypes(sds)
        self._carry_dtypes = dts
        halos = self._carry_halos
        if not halos:
            return {}
        return jax.jit(
            lambda: {i: jnp.zeros((halos[i],), dts[i]) for i in halos}
        )()

    def member_lens(self, consumed: int, n_true: int) -> dict[int, list[int]]:
        """Per-member output lens for this chunk (streaming totals),
        for the graph's tag bookkeeping."""
        out = {}
        for n in self.nodes:
            lens = []
            for i in range(n.block.n_out):
                t = self.totals[(n.idx, i)]
                lens.append(t(consumed + n_true) - t(consumed))
            out[n.idx] = lens
        return out

    def carries_to_states(self, carries, consumed: int) -> dict:
        """Convert carried tails into the members' streaming states (for
        the per-chunk fallback path and the EOF flush), given ``consumed``
        = true samples fed to the segment so far.

        Device-domain conversions run under ONE jit: shard_state/
        init_state implementations slice and build arrays, and one
        program beats a dispatch per op.  Host-state
        blocks (jit_chunk=False, e.g. RationalResampler's Python-int
        offsets) convert eagerly so their states stay host values.
        """
        import jax

        seen = {}  # (node_idx, kind) for the jitted builder
        eager = {}
        for n in self.nodes:
            key = (n.inputs[0].node.idx, n.inputs[0].index)
            # true samples the member has seen = the streaming totals of
            # its input port (NOT the full-rate mesh length: a valid-conv
            # upstream emits fewer samples than the mesh grid)
            c_m = self.totals[key](consumed)
            h = self.plans[n.idx].halo
            if not n.block.jit_chunk:
                eager[n.idx] = (
                    n.block.shard_state(carries.get(n.idx), c_m)
                    if h
                    else n.block.shard_state(None, c_m)
                )
            else:
                seen[n.idx] = (n.block, h, c_m)
        if not seen:
            return eager

        def build(car):
            return {
                i: (b.shard_state(car[i], c_m) if h else b.init_state())
                for i, (b, h, c_m) in seen.items()
            }

        states = dict(jax.jit(build)(carries))
        states.update(eager)
        return states

    # ---- the compiled program ----
    def _build(self):
        import jax
        import jax.numpy as jnp
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        nodes, plans = self.nodes, self.plans
        ext_in, ext_outs = self.ext_in, self.ext_out
        ratio, drops = self.ratio, self.drops
        axis, n_sh, div = self.axis, self.n_sh, self.div
        halos = self._carry_halos

        from ..blocks.base import ShardCtx

        def body(carries, aux, in0, x):
            k = jax.lax.axis_index(axis)
            vals = {ext_in: x}
            tails = {}
            for n in nodes:
                key = (n.inputs[0].node.idx, n.inputs[0].index)
                xin = vals[key]
                L = xin.shape[0]
                p = plans[n.idx]
                if n.block.n_in > 1:
                    # elementwise combiner: all inputs, no halo
                    ext = tuple(vals[(q.node.idx, q.index)] for q in n.inputs)
                elif p.halo:
                    tails[n.idx] = xin[-p.halo :]
                    recv = jax.lax.ppermute(
                        xin[-p.halo :], axis,
                        [(i, i + 1) for i in range(n_sh - 1)],
                    )
                    recv = jnp.where(k == 0, carries[n.idx].astype(recv.dtype), recv)
                    ext = jnp.concatenate([recv, xin])
                else:
                    ext = xin
                r_in, r_out = ratio[key], ratio[(n.idx, 0)]
                g_in = (in0 * r_in.numerator) // r_in.denominator + k * L
                L_out = L * n.block.interp // n.block.deci
                g_out = (in0 * r_out.numerator) // r_out.denominator + k * L_out
                ctx = ShardCtx(g_in=g_in, g_out=g_out, k=k, aux=aux.get(n.idx))
                y = p.fn(ext, L, ctx)
                ys = y if isinstance(y, tuple) else (y,)
                d = drops[(n.idx, 0)]
                if d > 0:
                    gidx = g_out + jnp.arange(L_out, dtype=jnp.int32)
                    ys = tuple(jnp.where(gidx < d, 0, yy).astype(yy.dtype)
                               for yy in ys)
                for i, yy in enumerate(ys):
                    vals[(n.idx, i)] = yy
            return tuple(vals[kk] for kk in ext_outs), tails

        def fn(carries, aux, in0, x, first, keeps):
            n = x.shape[0]
            pad = (-n) % (n_sh * div)
            if pad:
                x = jnp.pad(x, (0, pad))
            outs, tails = shard_map(
                body,
                mesh=self.mesh,
                in_specs=(P(), P(), P(), P(axis)),
                out_specs=(tuple(P(axis) for _ in ext_outs),
                           {i: P(axis) for i in halos}),
                check_vma=False,
            )(carries, aux, jnp.asarray(in0, jnp.int32), x)
            new_carries = {i: tails[i][-halos[i] :] for i in halos}
            trimmed = []
            for o, kk in zip(outs, ext_outs):
                if first and drops[kk]:
                    o = o[drops[kk] :]
                if keeps is not None:
                    o = o[: keeps[ext_outs.index(kk)]]
                trimmed.append(o)
            return new_carries, tuple(trimmed)

        self._fn = jax.jit(fn, static_argnums=(4, 5))
        return self._fn

    def _build_scan(self):
        import jax

        fn = self._fn or self._build()

        def scan_fn(carries, aux_s, in0s, xs):
            def body(c, per):
                aux_i, in0_i, x_i = per
                new_c, outs = fn(c, aux_i, in0_i, x_i, False, None)
                return new_c, outs

            return jax.lax.scan(body, carries, (aux_s, in0s, xs))

        self._scan_fn = jax.jit(scan_fn)
        return self._scan_fn

    def run_batch(self, carries, xs, consumed: int):
        """Advance the segment over a whole stack of full-size chunks in
        ONE compiled program (lax.scan over the shard_map body) — the
        scan-runner form of the mesh path.  ``xs``: (nb, chunk) stacked
        chunks; requires consumed > 0 (the stream's warm-up chunk ran
        through run_chunk, so no start trims apply here) and full
        divisible chunks.  Returns (new_carries, stacked outputs tuple,
        per-chunk lens list)."""
        import jax.numpy as jnp

        nb, n = int(xs.shape[0]), int(xs.shape[1])
        if consumed == 0 or n % (self.n_sh * self.div) or n < self.min_chunk:
            raise NotShardable("batch needs warm, full, divisible chunks")
        fn = getattr(self, "_scan_fn", None) or self._build_scan()
        in0s = jnp.asarray(
            np.minimum(consumed + np.arange(nb, dtype=np.int64) * n, 1 << 30),
            jnp.int32,
        )
        aux = {}
        for nd in self.nodes:
            p = self.plans[nd.idx]
            if p.prep is not None:
                key = (nd.inputs[0].node.idx, nd.inputs[0].index)
                r = self.ratio[key]
                aux[nd.idx] = jnp.asarray(
                    [
                        np.float32(p.prep((consumed + b * n) * r.numerator
                                          // r.denominator))
                        for b in range(nb)
                    ]
                )
        new_carries, outs = fn(carries, aux, in0s, xs)
        lens = []
        for kk in self.ext_out:
            r = self.ratio[kk]
            lens.append(n * r.numerator // r.denominator)
        return new_carries, outs, lens

    def run_chunk(self, carries, x, consumed: int, true_len: int | None = None):
        """Advance the segment by one chunk.

        ``x`` — the chunk (device array); mid-stream chunks must have
        ``len(x) % (n_sh * div) == 0`` and ``len(x) >= min_chunk`` (the
        caller falls back to unsharded execution otherwise).
        ``consumed`` — true samples fed before this chunk.  ``true_len``
        — unpadded length when this is the final (possibly ragged)
        chunk, enabling end trims; None for mid-stream chunks.

        Returns (new_carries, outputs tuple, output lens list).
        """
        fn = self._fn or self._build()
        n = int(x.shape[0])
        first = consumed == 0
        keeps = None
        if true_len is not None:
            keeps = []
            for kk in self.ext_out:
                expect = self.totals[kk](consumed + true_len)
                before = self.totals[kk](consumed) if not first else 0
                r = self.ratio[kk]
                full = ((n + ((-n) % (self.n_sh * self.div)))
                        * r.numerator // r.denominator)
                if first:
                    full -= self.drops[kk]
                keeps.append(min(full, max(0, expect - before)))
            keeps = tuple(keeps)
        # in0 clamps to keep int32 masks exact near stream start (the
        # masked region only matters while consumed < d_out)
        in0 = min(consumed, 1 << 30)
        # per-chunk host scalars (float64 phase reductions etc.)
        aux = {}
        for nd in self.nodes:
            p = self.plans[nd.idx]
            if p.prep is not None:
                key = (nd.inputs[0].node.idx, nd.inputs[0].index)
                r = self.ratio[key]
                aux[nd.idx] = np.float32(
                    p.prep(consumed * r.numerator // r.denominator)
                )
        new_carries, outs = fn(carries, aux, in0, x, first, keeps)
        lens = []
        for j, kk in enumerate(self.ext_out):
            r = self.ratio[kk]
            full = ((n + ((-n) % (self.n_sh * self.div)))
                    * r.numerator // r.denominator)
            if first:
                full -= self.drops[kk]
            lens.append(full if keeps is None else min(full, keeps[j]))
        return new_carries, outs, lens
