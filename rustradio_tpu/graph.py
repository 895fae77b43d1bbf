"""Flowgraph builder and runners.

The reference has three schedulers (single-thread round-robin graph.rs,
thread-per-block mtgraph.rs, tokio agraph.rs) whose dynamism exists to cope
with buffer occupancy.  Here scheduling is static: a graph is a DAG
evaluated in topological order, with

* ``run()``   — offline mode: whole streams in one pass (one compile per
  block signature; XLA fuses the device segments),
* ``run_stream(chunk_size)`` — streaming mode: fixed-size chunks with each
  block's carried state, semantically identical to offline,

plus per-block wall-time stats like the reference's post-run table
(src/graph.rs:175-257) and a cancellation token (src/graph.rs:270-319).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np

from .blocks.base import Block, SourceBlock
from .streams import Tag


@dataclasses.dataclass(frozen=True)
class Port:
    node: "Node"
    index: int


class Node:
    def __init__(self, graph: "Graph", block: Block, idx: int):
        self.graph = graph
        self.block = block
        self.idx = idx
        self.inputs: list[Port] = []

    def __getitem__(self, i: int) -> Port:
        if i >= self.block.n_out:
            raise IndexError(f"{self.block.name()} has {self.block.n_out} outputs")
        return Port(self, i)

    def out(self) -> Port:
        return Port(self, 0)


class CancellationToken:
    """Cooperative cancellation (reference src/graph.rs:295-319)."""

    def __init__(self):
        self._cancelled = False

    def cancel(self):
        self._cancelled = True

    def is_cancelled(self) -> bool:
        return self._cancelled


class Graph:
    def __init__(self):
        self.nodes: list[Node] = []
        self._token = CancellationToken()
        self._stats: dict[int, float] = {}
        self._jit_cache: dict[tuple[int, str], Any] = {}
        self._costs: dict[int, dict[str, float]] = {}
        # wall time matching each cost entry (segments: FULL program time,
        # not the per-member split used in the stats column)
        self._cost_time: dict[int, float] = {}
        self._cost_seen: dict = {}
        self._profiling = False

    # ---- profiling ----
    def _profile_ctx(self, profile_dir: str | None):
        """jax.profiler trace over the whole run (SURVEY §5 tracing row:
        the accelerator equivalent of the reference's per-block timing hooks
        is a profiler trace with one named region per block/segment)."""
        import contextlib

        if not profile_dir:
            return contextlib.nullcontext()
        import jax

        self._profiling = True
        return jax.profiler.trace(profile_dir)

    def _annotate(self, name: str):
        import contextlib

        if not self._profiling:
            return contextlib.nullcontext()
        import jax

        return jax.profiler.TraceAnnotation(f"rr::{name}")

    def _record_cost(self, idx: int, fn, args):
        """Note a jitted execution for the stats table's FLOPs/bytes.

        Recording is free at run time: only the abstract input signature
        is kept (as ShapeDtypeStructs) with a call count.  The XLA cost
        analysis itself is evaluated lazily in :meth:`costs` /
        :meth:`generate_stats` — an AOT ``lower().compile()`` does not
        reuse the jit dispatch cache, so querying it eagerly would pay a
        second trace+compile per program on every run.
        """
        import jax

        leaves = jax.tree_util.tree_leaves(args)
        sig = (
            idx,
            tuple(
                (np.shape(a), str(getattr(a, "dtype", type(a).__name__)))
                for a in leaves
            ),
        )
        rec = self._cost_seen.get(sig)
        if rec is not None:  # hot path: one dict lookup + counter bump
            rec["calls"] += 1
            return
        abstract = jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct(
                np.shape(a), getattr(a, "dtype", None) or np.asarray(a).dtype
            ),
            args,
        )
        self._cost_seen[sig] = {"idx": idx, "fn": fn, "abstract": abstract,
                                "calls": 1}

    def _evaluate_costs(self) -> dict[int, dict[str, float]]:
        """Resolve pending cost-analysis queries (compiles on demand)."""
        costs: dict[int, dict[str, float]] = {}
        for rec in self._cost_seen.values():
            per_call = rec.get("per_call")
            if per_call is None:
                try:
                    cost = rec["fn"].lower(*rec["abstract"]).compile().cost_analysis()
                    if isinstance(cost, (list, tuple)):
                        cost = cost[0] if cost else {}
                    per_call = (
                        float(cost.get("flops", 0.0) or 0.0),
                        float(cost.get("bytes accessed", 0.0) or 0.0),
                    )
                except Exception:
                    per_call = (0.0, 0.0)
                rec["per_call"] = per_call
            agg = costs.setdefault(rec["idx"], {"flops": 0.0, "bytes": 0.0})
            agg["flops"] += per_call[0] * rec["calls"]
            agg["bytes"] += per_call[1] * rec["calls"]
        self._costs = costs
        return costs

    # ---- construction ----
    def add(self, block: Block, *inputs) -> Node:
        node = Node(self, block, len(self.nodes))
        ins: list[Port] = []
        for i in inputs:
            if isinstance(i, Node):
                ins.append(i.out())
            elif isinstance(i, Port):
                ins.append(i)
            else:
                raise TypeError(f"cannot connect {i!r}")
        if len(ins) != block.n_in:
            raise ValueError(
                f"{block.name()} takes {block.n_in} inputs, got {len(ins)}"
            )
        node.inputs = ins
        self.nodes.append(node)
        return node

    def chain(self, *blocks) -> Node:
        """Convenience like the reference's blockchain! macro
        (src/lib.rs:404-413): connect blocks in sequence."""
        prev: Node | None = None
        for b in blocks:
            if isinstance(b, (Node, Port)):
                prev = b if isinstance(b, Node) else b.node
                continue
            prev = self.add(b, *( [prev] * b.n_in if prev is not None else [] ))
        return prev

    def cancel_token(self) -> CancellationToken:
        return self._token

    # ---- execution ----
    def _device_call(self, node: Node, fn_name: str):
        """Jitted wrapper for a device block's apply/apply_chunk.

        Device segments run under jit: eager op-by-op dispatch forgoes XLA
        fusion.  Cached per (block, fn); XLA caches per shape.
        """
        key = (node.idx, fn_name)
        f = self._jit_cache.get(key)
        if f is None:
            import jax

            f = jax.jit(getattr(node.block, fn_name))
            self._jit_cache[key] = f
        return f

    # ---- segment fusion ----
    def _fusable(self, n: Node) -> bool:
        return (
            n.block.domain == "device"
            and n.block.n_out > 0
            and n.block.jit_chunk
            and not isinstance(n.block, SourceBlock)
            and not hasattr(n.block, "set_tags")
        )

    def _mesh_eligible(self, n: Node) -> bool:
        """Can this block join a sharded (mesh) segment?  Requires a
        shard plan (Block.shard_fn) and no end-of-stream flush hook (the
        sharded form cannot reproduce a drain exactly through padding).

        Unlike plain fusion this does NOT require ``jit_chunk``: a block
        whose *streaming chunk* form needs host integers (e.g.
        RationalResampler's offset counters) can still shard — its
        shard_fn is pure traced math.  Demoted chunks then run the
        segment per-member (_run_members_chunk) instead of as one fused
        program."""
        b = n.block
        return (
            b.domain == "device"
            and b.n_out > 0
            and not isinstance(b, SourceBlock)
            and not hasattr(b, "set_tags")
            and not hasattr(b, "flush")
            and not hasattr(b, "flush_with_state")
            and b.shard_fn(0) is not None
        )

    def _segments_mesh(self, mesh, shard_axis: str):
        """Mesh-mode segmentation: like _segments, but runs additionally
        split at shardability boundaries; maximal runs of mesh-eligible
        nodes (len >= 1) become sharded segments with a MeshSegment plan,
        remaining fusable runs (len >= 2) stay ordinary fused segments.

        Returns (segs, seg_member, plans) where plans maps a sharded
        segment's first idx to its MeshSegment."""
        key = (id(mesh), shard_axis)
        cache = getattr(self, "_mesh_segcache", None)
        if cache is None:
            cache = self._mesh_segcache = {}
        if key in cache:
            return cache[key]
        from .parallel.graph_mesh import MeshSegment, NotShardable

        segs: dict[int, list[Node]] = {}
        plans: dict[int, Any] = {}

        def close(cur, cur_mesh):
            if cur_mesh:
                try:
                    ext_in, ext_out = self._segment_io(cur)
                    plan = MeshSegment(cur, ext_in, ext_out, mesh, shard_axis)
                except NotShardable:
                    plan = None
                if plan is not None:
                    segs[cur[0].idx] = list(cur)
                    plans[cur[0].idx] = plan
                    return
            # not sharded after all: fall back to plain fused runs of the
            # jit-capable members (a mesh-eligible-but-not-jit_chunk
            # member, e.g. RationalResampler, cannot join a fused
            # program — split around it)
            run: list[Node] = []
            for n in cur:
                if self._fusable(n):
                    run.append(n)
                else:
                    if len(run) > 1:
                        segs[run[0].idx] = list(run)
                    run = []
            if len(run) > 1:
                segs[run[0].idx] = list(run)

        cur: list[Node] = []
        cur_mesh = False
        for n in self._topo():
            m = self._mesh_eligible(n)
            if self._fusable(n) or m:
                if cur and m != cur_mesh:
                    close(cur, cur_mesh)
                    cur = []
                cur.append(n)
                cur_mesh = m
            else:
                if cur:
                    close(cur, cur_mesh)
                cur = []
        if cur:
            close(cur, cur_mesh)
        seg_member = {m.idx: seg[0].idx for seg in segs.values() for m in seg}
        cache[key] = (segs, seg_member, plans)
        return cache[key]

    def _segments(self) -> dict[int, list[Node]]:
        """Maximal contiguous runs of fusable device nodes, keyed by the
        first member's idx.  Each run compiles into ONE jit program —
        the SURVEY §7 architecture stance (the reference's thread-per-block
        pipeline becomes XLA fusion of the dense chain)."""
        if not hasattr(self, "_segs"):
            segs: dict[int, list[Node]] = {}
            cur: list[Node] = []
            for n in self._topo():
                if self._fusable(n):
                    cur.append(n)
                else:
                    if len(cur) > 1:
                        segs[cur[0].idx] = cur
                    cur = []
            if len(cur) > 1:
                segs[cur[0].idx] = cur
            self._segs = segs
            self._seg_member = {
                m.idx: seg[0].idx for seg in segs.values() for m in seg
            }
        return self._segs

    def _segment_io(self, seg: list[Node]):
        member = {n.idx for n in seg}
        ext_in: list[tuple[int, int]] = []
        for n in seg:
            for p in n.inputs:
                key = (p.node.idx, p.index)
                if p.node.idx not in member and key not in ext_in:
                    ext_in.append(key)
        ext_out: list[tuple[int, int]] = []
        for m in self.nodes:
            if m.idx in member:
                continue
            for p in m.inputs:
                key = (p.node.idx, p.index)
                if p.node.idx in member and key not in ext_out:
                    ext_out.append(key)
        return ext_in, ext_out

    def _segment_raw(self, seg: list[Node], streaming: bool):
        """Unjitted composite over the whole segment (cached): the single
        traceable function the jit/scan wrappers build on."""
        key = (tuple(n.idx for n in seg), "raw_chunk" if streaming else "raw_apply")
        cached = self._jit_cache.get(key)
        if cached is not None:
            return cached

        ext_in, ext_out = self._segment_io(seg)

        # FM-shaped runs ([FloatToComplex ->] FirFilter -> QuadratureDemod)
        # execute as ONE fused kernel (ops.fm_chain) instead of separate
        # ops with a device-memory round trip — the reference's flagship
        # numbers come from plain block composition
        # (examples/ax25-1200-rx.rs:191-336); so do ours.
        from . import backend

        fm_plans, fm_consumed = {}, set()
        if backend.use_kernels():
            from .lowering import find_fm_pairs

            fm_plans, fm_consumed = find_fm_pairs(seg, set(ext_out))

        def run_body(vals, states):
            new_states = {}
            for n in seg:
                if n.idx in fm_plans:
                    plan = fm_plans[n.idx]
                    lead = plan["f2c"] or plan["fir"]
                    xs = [vals[(p.node.idx, p.index)] for p in lead.inputs]
                    if streaming:
                        from .lowering import fused_fm_chunk

                        new_fir, new_quad, out = fused_fm_chunk(
                            plan, states[plan["fir"].idx],
                            states[plan["quad"].idx], *xs,
                        )
                        new_states[plan["fir"].idx] = new_fir
                        new_states[plan["quad"].idx] = new_quad
                        if plan["f2c"] is not None:
                            new_states[plan["f2c"].idx] = states[plan["f2c"].idx]
                    else:
                        from .lowering import fused_fm_apply

                        out = fused_fm_apply(plan, *xs)
                    vals[(n.idx, 0)] = out
                    continue
                if n.idx in fm_consumed:
                    continue  # executed by the fused node above
                xs = [vals[(p.node.idx, p.index)] for p in n.inputs]
                if streaming:
                    new_states[n.idx], out = n.block.apply_chunk(states[n.idx], *xs)
                else:
                    out = n.block.apply(*xs)
                outs = out if isinstance(out, tuple) else (out,)
                for i, o in enumerate(outs):
                    vals[(n.idx, i)] = o
            return vals, new_states

        if streaming:
            def fn(states, *args):
                vals, new_states = run_body(dict(zip(ext_in, args)), states)
                return new_states, tuple(vals[k] for k in ext_out)
        else:
            def fn(*args):
                vals, _ = run_body(dict(zip(ext_in, args)), None)
                return tuple(vals[k] for k in ext_out)

        cached = (ext_in, ext_out, fn)
        self._jit_cache[key] = cached
        return cached

    def _segment_fn(self, seg: list[Node], streaming: bool):
        """Jitted composite over the whole segment (cached)."""
        key = (tuple(n.idx for n in seg), "chunk" if streaming else "apply")
        cached = self._jit_cache.get(key)
        if cached is not None:
            return cached
        import jax

        ext_in, ext_out, raw = self._segment_raw(seg, streaming)
        cached = (ext_in, ext_out, jax.jit(raw))
        self._jit_cache[key] = cached
        return cached

    def _segment_scan_fn(self, seg: list[Node]):
        """ONE compiled program advancing a segment over a whole stack of
        chunks: ``lax.scan`` with the segment's state pytree as carry —
        the SURVEY §7 scan-over-blocks streaming form.  One dispatch per
        batch instead of per chunk (reference analog: the single hot
        ``Graph::run`` loop, src/graph.rs:99-173)."""
        key = (tuple(n.idx for n in seg), "scan")
        cached = self._jit_cache.get(key)
        if cached is not None:
            return cached
        import jax

        ext_in, ext_out, raw = self._segment_raw(seg, True)

        def fn(states, *stacked):
            def body(st, args):
                new_st, outs = raw(st, *args)
                return new_st, outs

            return jax.lax.scan(body, states, tuple(stacked))

        cached = (ext_in, ext_out, jax.jit(fn))
        self._jit_cache[key] = cached
        return cached

    def _node_scan_fn(self, node: Node):
        """Scan-over-chunks form of a single (unfused) device block."""
        key = (node.idx, "scan")
        f = self._jit_cache.get(key)
        if f is None:
            import jax

            step = node.block.apply_chunk

            def fn(state, *stacked):
                def body(st, args):
                    new_st, out = step(st, *args)
                    return new_st, out

                return jax.lax.scan(body, state, tuple(stacked))

            f = jax.jit(fn)
            self._jit_cache[key] = f
        return f

    def _segment_lens(self, seg, ext_in, args, states=None):
        """Static per-node output lengths (for tag rescaling) via
        eval_shape — no interior arrays are ever materialized."""
        import jax

        def _sig_shape(a):
            s = getattr(a, "shape", None)
            return tuple(s) if s is not None else tuple(np.shape(a))

        sig = tuple((_sig_shape(a), str(getattr(a, "dtype", type(a)))) for a in args)
        if states is not None:
            import jax

            sig = sig + tuple(
                (tuple(np.shape(leaf)), str(getattr(leaf, "dtype", type(leaf))))
                for leaf in jax.tree.leaves(states)
            )
        key = (tuple(n.idx for n in seg), "lens", sig, states is not None)
        cached = self._jit_cache.get(key)
        if cached is not None:
            return cached
        vals = dict(zip(ext_in, args))
        lens: dict[int, list[int]] = {}
        for n in seg:
            xs = [vals[(p.node.idx, p.index)] for p in n.inputs]
            if states is None:
                sds = jax.eval_shape(lambda *a, _n=n: _n.block.apply(*a), *xs)
            else:
                _, sds = jax.eval_shape(
                    lambda s, *a, _n=n: _n.block.apply_chunk(s, *a), states[n.idx], *xs
                )
            sds = sds if isinstance(sds, tuple) else (sds,)
            for i, sd in enumerate(sds):
                vals[(n.idx, i)] = sd
            lens[n.idx] = [sd.shape[0] if sd.shape else 0 for sd in sds]
        self._jit_cache[key] = lens
        return lens

    def _run_segment(self, seg, values, tags, states=None):
        """Execute a fused segment; fills values (external ports only) and
        tags (all member ports); returns new states for members."""
        ext_in, ext_out, fn = self._segment_fn(seg, streaming=states is not None)
        args = [values[k] for k in ext_in]
        seg_name = "+".join(n.block.name() for n in seg[:3]) + (
            f"+{len(seg)-3}" if len(seg) > 3 else ""
        )
        t0 = time.perf_counter()
        with self._annotate(f"segment:{seg_name}"):
            if states is None:
                outs = fn(*args)
                new_states = None
            else:
                seg_states = {n.idx: states[n.idx] for n in seg}
                new_states, outs = fn(seg_states, *args)
        elapsed = time.perf_counter() - t0
        dt = elapsed / len(seg)
        # the whole-program cost entry lives on the first member; record the
        # segment's FULL elapsed time with it so GB/s isn't inflated by the
        # per-member time split below
        self._cost_time[seg[0].idx] = self._cost_time.get(seg[0].idx, 0.0) + elapsed
        if states is None:
            self._record_cost(seg[0].idx, fn, tuple(args))
        else:
            self._record_cost(seg[0].idx, fn, (seg_states,) + tuple(args))
        for n in seg:
            self._stats[n.idx] = self._stats.get(n.idx, 0.0) + dt
        for k, o in zip(ext_out, outs):
            values[k] = o
        lens = self._segment_lens(
            seg, ext_in, args, states={n.idx: states[n.idx] for n in seg} if states else None
        )
        for n in seg:
            in_tags = [tags.get((p.node.idx, p.index), []) for p in n.inputs]
            for i, ot in enumerate(n.block.process_tags(in_tags, lens[n.idx])):
                tags[(n.idx, i)] = ot
        return new_states

    def _run_segment_mesh(self, ms, seg, values, tags, mesh_state=None,
                          true_len=None):
        """Execute a sharded segment (one shard_map program over the mesh).

        ``mesh_state`` — {"tails": carries, "consumed": int} carried
        across chunks in streaming mode; None for offline (zero history,
        whole stream as one chunk).  ``true_len`` — unpadded input length
        when this call ends the stream (enables end trims); None for
        mid-stream chunks.  Returns the updated mesh_state.
        """
        x = values[ms.ext_in]
        n = int(x.shape[0])
        if mesh_state is None:
            mesh_state = {"tails": ms.init_carries(x), "consumed": 0}
        elif mesh_state.get("tails") is None:
            mesh_state = {"tails": ms.init_carries(x), "consumed": 0}
        consumed = int(mesh_state["consumed"])
        seg_name = "+".join(nd.block.name() for nd in seg[:3]) + (
            f"+{len(seg)-3}" if len(seg) > 3 else ""
        )
        t0 = time.perf_counter()
        with self._annotate(f"mesh:{seg_name}"):
            new_tails, outs, lens = ms.run_chunk(
                mesh_state["tails"], x, consumed, true_len=true_len
            )
        elapsed = time.perf_counter() - t0
        self._cost_time[seg[0].idx] = (
            self._cost_time.get(seg[0].idx, 0.0) + elapsed
        )
        for nd in seg:
            self._stats[nd.idx] = self._stats.get(nd.idx, 0.0) + elapsed / len(seg)
        for k, o in zip(ms.ext_out, outs):
            values[k] = o
        mlens = ms.member_lens(consumed, true_len if true_len is not None else n)
        for nd in seg:
            in_tags = [tags.get((p.node.idx, p.index), []) for p in nd.inputs]
            for i, ot in enumerate(nd.block.process_tags(in_tags, mlens[nd.idx])):
                tags[(nd.idx, i)] = ot
        return {"tails": new_tails,
                "consumed": consumed + (true_len if true_len is not None else n)}

    def _run_members_chunk(self, seg, values, tags, states) -> None:
        """Streaming execution of a segment's members one block at a time
        (used when a demoted mesh segment contains a host-state member,
        e.g. RationalResampler, that cannot join one fused jit program).
        Fills values/tags for every member port and updates states."""
        for node in seg:
            b = node.block
            keys = [(p.node.idx, p.index) for p in node.inputs]
            xs = [values[k] for k in keys]
            in_tags = [tags.get(k, []) for k in keys]
            t0 = time.perf_counter()
            with self._annotate(b.name()):
                if b.jit_chunk:
                    fn = self._device_call(node, "apply_chunk")
                    st_in = states[node.idx]
                    states[node.idx], out = fn(st_in, *xs)
                    self._record_cost(node.idx, fn, (st_in, *xs))
                else:
                    states[node.idx], out = b.apply_chunk(states[node.idx], *xs)
            self._stats[node.idx] = self._stats.get(node.idx, 0.0) + (
                time.perf_counter() - t0
            )
            outs = out if isinstance(out, tuple) else (out,)
            out_lens = [len(o) if hasattr(o, "__len__") else 0 for o in outs]
            otags = b.process_tags(in_tags, out_lens)
            for i, (o, ot) in enumerate(zip(outs, otags)):
                values[(node.idx, i)] = o
                tags[(node.idx, i)] = ot

    @staticmethod
    def _cat_outputs(a, b):
        """Concatenate two outputs of the same port (flush drain)."""
        if a is None:
            return b
        if b is None:
            return a
        if isinstance(a, list) or isinstance(b, list):
            return list(a) + list(b)
        return np.concatenate([np.asarray(a), np.asarray(b)])

    def _flush_pass(self, states=None) -> None:
        """End-of-stream drain pass, run once after the main loop.

        Blocks exposing ``flush()`` emit their final outputs here — the
        static-schedule equivalent of reference blocks that push on EOF or
        in Drop (e.g. src/hasher.rs:41-49 finalizes the digest when the
        input closes).  Flush outputs propagate through downstream blocks
        (apply in offline mode, apply_chunk with the carried state in
        streaming mode) so sinks see them before ``finish()``.

        Only nodes that flushed, or whose inputs all produced drain values,
        run; multi-input nodes with partially-available inputs are skipped.
        """
        values: dict[tuple[int, int], Any] = {}
        tags: dict[tuple[int, int], list[Tag]] = {}
        for node in self._topo():
            b = node.block
            keys = [(p.node.idx, p.index) for p in node.inputs]
            in_tags = [tags.get(k, []) for k in keys]
            out = None
            if node.inputs and all(k in values for k in keys):
                xs = [values[k] for k in keys]
                if hasattr(b, "set_tags"):
                    b.set_tags(in_tags[0])
                # device blocks go through their jitted forms (fused,
                # one dispatch per block instead of one per op)
                jitted = b.domain == "device" and b.n_out > 0 and b.jit_chunk
                if states is None:
                    fn = self._device_call(node, "apply") if jitted else b.apply
                    out = fn(*xs)
                elif jitted:
                    states[node.idx], out = self._device_call(node, "apply_chunk")(
                        states[node.idx], *xs
                    )
                else:
                    states[node.idx], out = b.apply_chunk(states[node.idx], *xs)
                if b.n_out == 0:
                    if hasattr(b, "accept_tags"):
                        b.accept_tags(in_tags[0], 0)
                    out = None
            if states is not None and hasattr(b, "flush_with_state"):
                # blocks whose pending output lives in the carried state
                # (e.g. static Delay's tail, StreamToPdu's clipped burst) —
                # reading the passed state keeps flush correct across
                # checkpoint/resume, where instance attributes are fresh
                fout = b.flush_with_state(states.get(node.idx))
            else:
                fout = b.flush() if hasattr(b, "flush") else None
            if out is None and fout is None:
                continue
            outs = out if isinstance(out, tuple) else ((out,) if out is not None else (None,) * max(b.n_out, 1))
            fouts = fout if isinstance(fout, tuple) else ((fout,) if fout is not None else (None,) * max(b.n_out, 1))
            merged = tuple(self._cat_outputs(o, f) for o, f in zip(outs, fouts))
            if b.n_out == 0:
                continue
            out_lens = [len(o) if hasattr(o, "__len__") else 0 for o in merged]
            otags = b.process_tags(in_tags, out_lens)
            for i, (o, ot) in enumerate(zip(merged, otags)):
                if o is not None:
                    values[(node.idx, i)] = o
                    tags[(node.idx, i)] = ot

    def _topo(self) -> list[Node]:
        # nodes are appended after their inputs, so insertion order is topo
        # as long as users build forward; verify anyway.
        seen = set()
        for n in self.nodes:
            for p in n.inputs:
                if p.node.idx not in seen and p.node.idx > n.idx:
                    raise ValueError("graph has a cycle or backward edge")
            seen.add(n.idx)
        return self.nodes

    def run(self, profile_dir: str | None = None, mesh=None,
            shard_axis: str = "time") -> None:
        """Offline mode: evaluate every block once over whole streams.

        ``profile_dir``: write a jax.profiler (xprof) trace there, with one
        named ``rr::`` region per block/segment.

        ``mesh``: a 1-D ``jax.sharding.Mesh`` (see parallel.make_mesh) —
        dense device segments whose blocks declare shard plans execute as
        ONE shard_map program each, with the sample axis sharded over
        ``shard_axis`` and filter histories exchanged between shards via
        ppermute halos.  Outputs are exactly the single-device run's; the
        reference analog is swapping Graph for MTGraph
        (src/mtgraph.rs:73-149).
        """
        with self._profile_ctx(profile_dir):
            self._run_inner(mesh, shard_axis)
        self._profiling = False

    def _run_inner(self, mesh=None, shard_axis: str = "time") -> None:
        values: dict[tuple[int, int], Any] = {}
        tags: dict[tuple[int, int], list[Tag]] = {}
        if mesh is not None:
            segs, seg_member, mesh_plans = self._segments_mesh(mesh, shard_axis)
        else:
            segs = self._segments()
            seg_member, mesh_plans = self._seg_member, {}
        for node in self._topo():
            if self._token.is_cancelled():
                break
            seg_first = seg_member.get(node.idx)
            if seg_first is not None:
                if seg_first == node.idx:
                    ms = mesh_plans.get(seg_first)
                    if ms is not None:
                        n_in = len(values[ms.ext_in])
                        # a stream shorter than the per-shard halo cannot
                        # shard (the shard_map body would trace a shape
                        # mismatch); fall back to single-device execution
                        # like the streaming path's demotion
                        if n_in < ms.min_chunk:
                            ms = None
                    if ms is not None:
                        self._run_segment_mesh(
                            ms, segs[seg_first], values, tags, true_len=n_in
                        )
                    else:
                        self._run_segment(segs[seg_first], values, tags)
                continue
            b = node.block
            xs = [values[(p.node.idx, p.index)] for p in node.inputs]
            in_tags = [tags.get((p.node.idx, p.index), []) for p in node.inputs]
            if hasattr(b, "set_tags") and in_tags:
                b.set_tags(in_tags[0])
            t0 = time.perf_counter()
            with self._annotate(b.name()):
                if isinstance(b, SourceBlock):
                    out = b.apply()
                    total = b.total_len()
                    out_tags_src = b.emit_tags(0, total) if total is not None else []
                elif b.domain == "device" and b.n_out > 0 and b.jit_chunk:
                    fn = self._device_call(node, "apply")
                    out = fn(*xs)
                    self._record_cost(node.idx, fn, tuple(xs))
                    out_tags_src = None
                else:
                    out = b.apply(*xs)
                    out_tags_src = None
            self._stats[node.idx] = self._stats.get(node.idx, 0.0) + (
                time.perf_counter() - t0
            )
            outs = out if isinstance(out, tuple) else (out,)
            if b.n_out == 0:
                if hasattr(b, "accept_tags") and in_tags:
                    b.accept_tags(in_tags[0], 0)
                continue
            if b.n_out == 1 and not isinstance(out, tuple):
                outs = (out,)
            out_lens = [len(o) if hasattr(o, "__len__") else 0 for o in outs]
            if out_tags_src is not None:
                otags = [out_tags_src] * b.n_out
            else:
                otags = b.process_tags(in_tags, out_lens)
            for i, (o, ot) in enumerate(zip(outs, otags)):
                values[(node.idx, i)] = o
                tags[(node.idx, i)] = ot
        if not self._token.is_cancelled():
            self._flush_pass()
        # notify canaries / finishers
        for node in self.nodes:
            if hasattr(node.block, "finish"):
                node.block.finish()

    def run_stream(
        self,
        chunk_size: int = 1 << 18,
        max_chunks: int | None = None,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 0,
        resume_from: str | None = None,
        profile_dir: str | None = None,
        scan_chunks: int | None = None,
        mesh=None,
        shard_axis: str = "time",
    ):
        """Streaming mode: fixed-size chunks with carried block state.

        With ``checkpoint_path`` + ``checkpoint_every=k`` the per-block state
        pytrees and the stream offset are snapshotted every k chunks;
        ``resume_from`` restarts from such a snapshot.  ``profile_dir``
        writes a jax.profiler (xprof) trace with ``rr::`` regions.

        ``scan_chunks=B`` enables the compiled streaming runner: after one
        warm-up chunk (which fixes lazily-typed state shapes), device
        segments advance over batches of up to B chunks in ONE
        ``lax.scan`` program each — one dispatch per batch instead of per
        chunk (SURVEY §7's scan-over-blocks stance; the reference analog is
        the single hot ``Graph::run`` loop, src/graph.rs:99-173).  Host
        blocks still see chunks one at a time, in order, so semantics are
        identical; checkpoints land on batch boundaries.

        ``mesh=`` shards every eligible device segment's sample axis over
        a ``jax.sharding.Mesh`` (see :meth:`run`); chunks whose size
        doesn't divide the mesh (e.g. a ragged final chunk) demote the
        segment to single-device execution with its carried halos
        converted to block state, so outputs stay exact.
        """
        import contextlib

        _pstack = contextlib.ExitStack()
        _pstack.enter_context(self._profile_ctx(profile_dir))
        try:
            self._run_stream_inner(
                chunk_size, max_chunks, checkpoint_path, checkpoint_every,
                resume_from, scan_chunks, mesh, shard_axis,
            )
        finally:
            _pstack.close()
            self._profiling = False

    def _run_stream_inner(
        self,
        chunk_size: int,
        max_chunks: int | None,
        checkpoint_path: str | None,
        checkpoint_every: int,
        resume_from: str | None,
        scan_chunks: int | None = None,
        mesh=None,
        shard_axis: str = "time",
    ):
        self._mesh_mode = mesh is not None
        sources = [n for n in self.nodes if isinstance(n.block, SourceBlock)]
        if not sources:
            raise ValueError("graph has no sources")
        totals = [s.block.total_len() for s in sources]
        if any(t is None for t in totals):
            if max_chunks is None:
                raise ValueError("unbounded source needs max_chunks")
            total = max_chunks * chunk_size
        else:
            total = min(t for t in totals)
        # max_chunks also bounds how many chunks THIS call processes (used
        # for checkpoint-then-resume workflows on bounded sources).

        states = {}
        for n in self.nodes:
            b = n.block
            if b.domain == "device" and b.n_out > 0 and b.jit_chunk:
                # Create device-block state under jit, on the device.
                import jax

                states[n.idx] = jax.jit(b.init_state)()
            else:
                states[n.idx] = b.init_state()
        if mesh is not None:
            segs, seg_member, mesh_plans = self._segments_mesh(mesh, shard_axis)
        else:
            segs = self._segments()
            seg_member, mesh_plans = self._seg_member, {}
        offset = 0
        if resume_from is not None:
            from .utils.checkpoint import load_checkpoint

            states, offset, extra = load_checkpoint(resume_from, states)
            names = [n.block.name() for n in self.nodes]
            if extra.get("blocks") is not None and extra["blocks"] != names:
                raise ValueError(
                    f"checkpoint was taken on a different graph: "
                    f"{extra['blocks']} vs {names}"
                )
            if bool(extra.get("mesh", False)) != (mesh is not None):
                raise ValueError(
                    "checkpoint mesh mode differs from this run's: a mesh "
                    "checkpoint carries shard halos, not block state"
                )
            # restore host-side block state (e.g. Delay's carried tag
            # queue) that can't live in the jitted state pytree
            for n in self.nodes:
                hs = extra.get("host", {}).get(n.idx)
                if hs is not None and hasattr(n.block, "restore_host_state"):
                    n.block.restore_host_state(hs)
        chunk_count = 0
        out_offsets: dict[int, int] = {}
        ended = False  # true end-of-stream (vs a max_chunks/cancel pause)
        while True:
            if offset >= total:
                ended = True
                break
            if self._token.is_cancelled():
                break
            if max_chunks is not None and chunk_count >= max_chunks:
                break
            # live sources (TCP, readers, SDR drivers) may end before their
            # nominal bound; ``exhausted()`` ends the stream early
            if any(
                getattr(s.block, "exhausted", lambda: False)() for s in sources
            ):
                ended = True
                break
            # compiled scan batches: after the warm-up chunk fixed the state
            # shapes, advance whole batches of full-size chunks per dispatch
            nb = 0
            if scan_chunks and scan_chunks > 1 and chunk_count >= 1:
                nb = min(scan_chunks, (total - offset) // chunk_size)
                if max_chunks is not None:
                    nb = min(nb, max_chunks - chunk_count)
            if nb >= 2:
                self._run_batch(nb, chunk_size, offset, states, out_offsets,
                                segs, seg_member, mesh_plans)
                before = chunk_count
                offset += nb * chunk_size
                chunk_count += nb
                if (
                    checkpoint_path
                    and checkpoint_every
                    and before // checkpoint_every != chunk_count // checkpoint_every
                ):
                    self._save_checkpoint(checkpoint_path, states, offset)
                continue
            n_chunk = min(chunk_size, total - offset)
            values: dict[tuple[int, int], Any] = {}
            tags: dict[tuple[int, int], list[Tag]] = {}
            for node in self._topo():
                b = node.block
                seg_first = seg_member.get(node.idx)
                if seg_first is not None:
                    if seg_first == node.idx:
                        ms = mesh_plans.get(seg_first)
                        mkey = f"mesh:{seg_first}"
                        if ms is not None and not (
                            isinstance(states.get(mkey), dict)
                            and states[mkey].get("demoted")
                        ):
                            n_in = len(values[ms.ext_in])
                            if n_in % (ms.n_sh * ms.div) == 0 and n_in >= ms.min_chunk:
                                states[mkey] = self._run_segment_mesh(
                                    ms, segs[seg_first], values, tags,
                                    mesh_state=states.get(mkey),
                                )
                                continue
                            # chunk doesn't fit the mesh (e.g. ragged final
                            # chunk): one-way demotion — carried halos
                            # become the members' streaming states, then
                            # the plain per-chunk path continues exactly
                            mst = states.get(mkey)
                            if mst and mst.get("tails") is not None:
                                states.update(ms.carries_to_states(
                                    mst["tails"], int(mst["consumed"])))
                            states[mkey] = {"demoted": True}
                        if all(m.block.jit_chunk for m in segs[seg_first]):
                            states.update(
                                self._run_segment(
                                    segs[seg_first], values, tags, states=states
                                )
                            )
                        else:
                            # a host-state member cannot join one fused
                            # program: run the members one at a time
                            self._run_members_chunk(
                                segs[seg_first], values, tags, states
                            )
                    continue
                if isinstance(b, SourceBlock):
                    t0 = time.perf_counter()
                    out = b.emit(offset, n_chunk)
                    self._stats[node.idx] = self._stats.get(node.idx, 0.0) + (
                        time.perf_counter() - t0
                    )
                    values[(node.idx, 0)] = out
                    tags[(node.idx, 0)] = b.emit_tags(offset, n_chunk)
                    continue
                xs = [values[(p.node.idx, p.index)] for p in node.inputs]
                in_tags = [tags.get((p.node.idx, p.index), []) for p in node.inputs]
                if hasattr(b, "set_tags") and in_tags:
                    b.set_tags(in_tags[0])
                t0 = time.perf_counter()
                with self._annotate(b.name()):
                    if b.domain == "device" and b.n_out > 0 and b.jit_chunk:
                        fn = self._device_call(node, "apply_chunk")
                        # capture the INPUT state: recording with the output
                        # state would lower a different program for blocks
                        # whose state shape changes on the first chunk
                        st_in = states[node.idx]
                        states[node.idx], out = fn(st_in, *xs)
                        self._record_cost(node.idx, fn, (st_in, *xs))
                    else:
                        states[node.idx], out = b.apply_chunk(states[node.idx], *xs)
                self._stats[node.idx] = self._stats.get(node.idx, 0.0) + (
                    time.perf_counter() - t0
                )
                if b.n_out == 0:
                    if hasattr(b, "accept_tags") and in_tags:
                        b.accept_tags(in_tags[0], out_offsets.get(node.idx, 0))
                        out_offsets[node.idx] = out_offsets.get(node.idx, 0) + len(
                            xs[0]
                        )
                    continue
                outs = out if isinstance(out, tuple) else (out,)
                out_lens = [len(o) if hasattr(o, "__len__") else 0 for o in outs]
                otags = b.process_tags(in_tags, out_lens)
                for i, (o, ot) in enumerate(zip(outs, otags)):
                    values[(node.idx, i)] = o
                    tags[(node.idx, i)] = ot
            offset += n_chunk
            chunk_count += 1
            if (
                checkpoint_path
                and checkpoint_every
                and chunk_count % checkpoint_every == 0
            ):
                self._save_checkpoint(checkpoint_path, states, offset)
        # Drain end-of-stream outputs ONLY at a true EOF: a max_chunks or
        # cancellation pause keeps pending state (tails, open bursts) in
        # the carried pytrees for checkpoint/resume; flushing there would
        # emit it early AND again after the resume.
        if ended:
            # sharded segments: carried halos -> member streaming states,
            # so flush outputs propagate through them exactly
            for sf, ms in mesh_plans.items():
                mst = states.get(f"mesh:{sf}")
                if mst and mst.get("tails") is not None:
                    states.update(
                        ms.carries_to_states(mst["tails"], int(mst["consumed"]))
                    )
            self._flush_pass(states)
        for node in self.nodes:
            if hasattr(node.block, "finish"):
                node.block.finish()

    def _save_checkpoint(self, path: str, states: dict, offset: int) -> None:
        """Snapshot the stream condition: state pytrees + offset + the
        host-side block state (e.g. Delay's carried tag queue) that can't
        live in the jitted pytrees."""
        from .utils.checkpoint import save_checkpoint

        save_checkpoint(
            path, states, offset,
            extra={
                "blocks": [n.block.name() for n in self.nodes],
                "mesh": bool(getattr(self, "_mesh_mode", False)),
                "host": {
                    n.idx: n.block.host_state()
                    for n in self.nodes
                    if hasattr(n.block, "host_state")
                },
            },
        )

    def _node_lens(self, node: Node, st, xs) -> list[int]:
        """Output lengths of one apply_chunk call, via eval_shape — cached
        by the (state, inputs) abstract signature so long scan-fallback
        runs don't re-trace per chunk."""
        import jax

        def sig(a):
            s = getattr(a, "shape", None)
            return (tuple(s) if s is not None else tuple(np.shape(a)),
                    str(getattr(a, "dtype", type(a))))

        key = (node.idx, "nlens",
               tuple(sig(l) for l in jax.tree_util.tree_leaves(st)),
               tuple(sig(x) for x in xs))
        cached = self._jit_cache.get(key)
        if cached is None:
            _, sds = jax.eval_shape(node.block.apply_chunk, st, *xs)
            sds = sds if isinstance(sds, tuple) else (sds,)
            cached = [sd.shape[0] if sd.shape else 0 for sd in sds]
            self._jit_cache[key] = cached
        return cached

    def _scan_precheck(self, key, raw, states_in, sds_args) -> bool:
        """A segment/block can scan only if its state pytree is shape-
        invariant chunk-to-chunk (lax.scan carry contract).  Cheap cached
        eval_shape check; blocks with cyclic carry shapes (e.g. FirFilter
        with deci not dividing the chunk) fall back to per-chunk programs."""
        ck = (key, "scan_ok")
        cached = self._jit_cache.get(ck)
        if cached is None:
            import jax
            import jax.numpy as jnp

            try:
                new_sd = jax.eval_shape(raw, states_in, *sds_args)[0]
                tu = jax.tree_util
                # compare shapes AND (canonicalized) dtypes: a carry whose
                # leaf dtype changes (f32 -> c64 promotion, say) would pass
                # a shape-only check and then blow up inside lax.scan
                cached = tu.tree_structure(new_sd) == tu.tree_structure(states_in) and [
                    (tuple(l.shape), l.dtype) for l in tu.tree_leaves(new_sd)
                ] == [
                    (tuple(np.shape(l)), jnp.result_type(l))
                    for l in tu.tree_leaves(states_in)
                ]
            except Exception:
                cached = False
            self._jit_cache[ck] = cached
        return cached

    def _run_batch(self, nb: int, chunk_size: int, offset: int,
                   states: dict, out_offsets: dict,
                   segs=None, seg_member=None, mesh_plans=None) -> None:
        """Advance the whole graph by ``nb`` full chunks with ONE dispatch
        per device segment (lax.scan over the stacked chunks).  Host blocks
        see the chunks one at a time, in stream order, so every stateful
        host machine behaves exactly as in the per-chunk path.  Sharded
        (mesh) segments scan their shard_map program over the batch with
        the carried halos as the scan carry."""
        import jax

        if segs is None:
            segs = self._segments()
            seg_member, mesh_plans = self._seg_member, {}

        # values: stacked jax array (leading dim nb) for device producers,
        # or a per-chunk list for host/source producers
        values: dict[tuple[int, int], Any] = {}
        host_view: dict[tuple[int, int], Any] = {}  # lazy per-chunk host cache
        tags: dict[tuple[int, int], list[list[Tag]]] = {}

        def as_stacked(key):
            v = values[key]
            if isinstance(v, list):
                if v and isinstance(v[0], jax.Array):
                    # device chunks from a fallback path: stack on device
                    # (eager np.stack would read complex arrays back)
                    f = self._jit_cache.get(("stack", len(v)))
                    if f is None:
                        f = jax.jit(lambda *cs: jax.numpy.stack(cs))
                        self._jit_cache[("stack", len(v))] = f
                    return f(*v)
                return np.stack([np.asarray(c) for c in v])
            return v

        def chunk_of(key, bi, domain):
            v = values[key]
            if isinstance(v, list):
                return v[bi]
            if domain == "device":
                return v[bi]  # device-side slice of the stacked output
            hv = host_view.get(key)
            if hv is None:
                # one readback for the whole stack
                hv = host_view[key] = np.asarray(v)
            return hv[bi]

        def is_uniform(key):
            """True if the value can be stacked: every chunk has one shape."""
            v = values[key]
            if not isinstance(v, list):
                return True
            shapes = [getattr(c, "shape", None) for c in v]
            return shapes[0] is not None and all(s == shapes[0] for s in shapes)

        def in_tags_of(node, bi):
            return [
                tags.get((p.node.idx, p.index), [[] for _ in range(nb)])[bi]
                for p in node.inputs
            ]

        def chunk_sds(a):
            return jax.ShapeDtypeStruct(a.shape[1:], a.dtype)

        for node in self._topo():
            b = node.block
            seg_first = seg_member.get(node.idx)
            if seg_first is not None and seg_first != node.idx:
                continue
            if seg_first is not None and mesh_plans.get(seg_first) is not None:
                # sharded segment: scan the shard_map program over the
                # batch (carried halos as the scan carry); demoted
                # segments fall through to the plain path below
                ms = mesh_plans[seg_first]
                mkey = f"mesh:{seg_first}"
                mst = states.get(mkey)
                demoted = isinstance(mst, dict) and mst.get("demoted")
                if not demoted and mst is not None and mst.get("tails") is not None:
                    seg = segs[seg_first]
                    from .parallel.graph_mesh import NotShardable

                    xs = as_stacked(ms.ext_in)
                    t0 = time.perf_counter()
                    try:
                        new_tails, outs, lens = ms.run_batch(
                            mst["tails"], xs, int(mst["consumed"])
                        )
                    except NotShardable:
                        # convert halos to block state and demote; the
                        # plain path below finishes this batch
                        if mst.get("tails") is not None:
                            states.update(ms.carries_to_states(
                                mst["tails"], int(mst["consumed"])))
                        states[mkey] = {"demoted": True}
                    else:
                        states[mkey] = {
                            "tails": new_tails,
                            "consumed": int(mst["consumed"]) + nb * int(xs.shape[1]),
                        }
                        elapsed = time.perf_counter() - t0
                        self._cost_time[seg[0].idx] = (
                            self._cost_time.get(seg[0].idx, 0.0) + elapsed
                        )
                        for nd in seg:
                            self._stats[nd.idx] = self._stats.get(nd.idx, 0.0) + (
                                elapsed / len(seg)
                            )
                        for k, o in zip(ms.ext_out, outs):
                            values[k] = o  # stacked (nb, len)
                        mlens = ms.member_lens(
                            int(mst["consumed"]), int(xs.shape[1])
                        )
                        for nd in seg:
                            per_port = [[] for _ in range(max(nd.block.n_out, 1))]
                            for bi in range(nb):
                                ots = nd.block.process_tags(
                                    in_tags_of(nd, bi), mlens[nd.idx]
                                )
                                for i, ot in enumerate(ots):
                                    per_port[i].append(ot)
                            for i, pp in enumerate(per_port):
                                tags[(nd.idx, i)] = pp
                        continue
            if seg_first is not None and not all(
                m.block.jit_chunk for m in segs[seg_first]
            ):
                # demoted mesh segment with a host-state member: run the
                # members one block at a time, chunk by chunk (the fused
                # scan/per-chunk programs below would trace the host
                # chunk logic)
                seg = segs[seg_first]
                ext_in_m, _ = self._segment_io(seg)
                coll: dict[tuple[int, int], list] = {}
                coll_tags: dict[tuple[int, int], list] = {}
                for bi in range(nb):
                    vals_bi = {k: chunk_of(k, bi, "device") for k in ext_in_m}
                    tags_bi = {
                        k: tags.get(k, [[] for _ in range(nb)])[bi]
                        for k in ext_in_m
                    }
                    self._run_members_chunk(seg, vals_bi, tags_bi, states)
                    for m in seg:
                        for i in range(max(m.block.n_out, 1)):
                            key = (m.idx, i)
                            coll.setdefault(key, []).append(vals_bi.get(key))
                            coll_tags.setdefault(key, []).append(
                                tags_bi.get(key, [])
                            )
                for key in coll:
                    values[key] = coll[key]
                    tags[key] = coll_tags[key]
                continue
            if seg_first is not None:
                seg = segs[seg_first]
                _, _, raw = self._segment_raw(seg, True)
                ext_in, ext_out, fn = self._segment_scan_fn(seg)
                uniform = all(is_uniform(k) for k in ext_in)
                seg_states = {n.idx: states[n.idx] for n in seg}
                seg_name = "+".join(n.block.name() for n in seg[:3]) + (
                    f"+{len(seg)-3}" if len(seg) > 3 else ""
                )
                t0 = time.perf_counter()
                scannable = False
                if uniform:
                    args = [as_stacked(k) for k in ext_in]
                    sds_args = [chunk_sds(a) for a in args]
                    scannable = self._scan_precheck(
                        ("seg", seg[0].idx), raw, seg_states, sds_args
                    )
                if scannable:
                    lens_per_chunk = [
                        self._segment_lens(seg, ext_in, sds_args, states=seg_states)
                    ] * nb
                    try:
                        with self._annotate(f"scan:{seg_name}"):
                            new_states, outs = fn(seg_states, *args)
                    except Exception:
                        # precheck false positive (e.g. weak-type carry
                        # mismatch): remember and run per-chunk instead
                        self._jit_cache[(("seg", seg[0].idx), "scan_ok")] = False
                        scannable = False
                    else:
                        states.update(new_states)
                        for k, o in zip(ext_out, outs):
                            values[k] = o
                        self._record_cost(seg[0].idx, fn, (seg_states,) + tuple(args))
                if not scannable:
                    # carry or chunk shapes vary chunk-to-chunk: per-chunk
                    # programs inside the batch (correct, not one-dispatch)
                    _, _, fnc = self._segment_fn(seg, streaming=True)
                    collected = {k: [] for k in ext_out}
                    lens_per_chunk = []
                    for bi in range(nb):
                        xs = [chunk_of(k, bi, "device") for k in ext_in]
                        seg_states = {n.idx: states[n.idx] for n in seg}
                        lens_per_chunk.append(
                            self._segment_lens(seg, ext_in, xs, states=seg_states)
                        )
                        with self._annotate(f"segment:{seg_name}"):
                            new_states, outs = fnc(seg_states, *xs)
                        states.update(new_states)
                        for k, o in zip(ext_out, outs):
                            collected[k].append(o)
                        self._record_cost(seg[0].idx, fnc, (seg_states,) + tuple(xs))
                    for k in ext_out:
                        values[k] = collected[k]
                elapsed = time.perf_counter() - t0
                self._cost_time[seg[0].idx] = (
                    self._cost_time.get(seg[0].idx, 0.0) + elapsed
                )
                for n in seg:
                    self._stats[n.idx] = self._stats.get(n.idx, 0.0) + (
                        elapsed / len(seg)
                    )
                for n in seg:
                    per_port: list[list[list[Tag]]] = [
                        [] for _ in range(max(n.block.n_out, 1))
                    ]
                    for bi in range(nb):
                        ots = n.block.process_tags(
                            in_tags_of(n, bi), lens_per_chunk[bi][n.idx]
                        )
                        for i, ot in enumerate(ots):
                            per_port[i].append(ot)
                    for i, pp in enumerate(per_port):
                        tags[(n.idx, i)] = pp
                continue
            if isinstance(b, SourceBlock):
                t0 = time.perf_counter()
                if hasattr(b, "emit_batch"):
                    # batch-capable source: ONE call yields the stacked
                    # (nb, chunk) block — no per-chunk dispatches
                    values[(node.idx, 0)] = b.emit_batch(offset, chunk_size, nb)
                else:
                    values[(node.idx, 0)] = [
                        b.emit(offset + bi * chunk_size, chunk_size)
                        for bi in range(nb)
                    ]
                tags[(node.idx, 0)] = [
                    b.emit_tags(offset + bi * chunk_size, chunk_size)
                    for bi in range(nb)
                ]
                self._stats[node.idx] = self._stats.get(node.idx, 0.0) + (
                    time.perf_counter() - t0
                )
                continue
            if b.domain == "device" and b.n_out > 0 and b.jit_chunk:
                keys = [(p.node.idx, p.index) for p in node.inputs]
                uniform = all(is_uniform(k) for k in keys)
                st_in = states[node.idx]
                t0 = time.perf_counter()
                scannable = False
                if uniform:
                    args = [as_stacked(k) for k in keys]
                    sds_args = [chunk_sds(a) for a in args]
                    scannable = self._scan_precheck(
                        ("node", node.idx), b.apply_chunk, st_in, sds_args
                    )
                if scannable:
                    fn = self._node_scan_fn(node)
                    try:
                        with self._annotate(f"scan:{b.name()}"):
                            states[node.idx], out = fn(st_in, *args)
                    except Exception:
                        self._jit_cache[(("node", node.idx), "scan_ok")] = False
                        scannable = False
                    else:
                        self._record_cost(node.idx, fn, (st_in,) + tuple(args))
                        outs = out if isinstance(out, tuple) else (out,)
                        outs_per_port = list(outs)  # stacked
                        lens_pc = [self._node_lens(node, st_in, sds_args)] * nb
                if not scannable:
                    fnc = self._device_call(node, "apply_chunk")
                    collected = [[] for _ in range(b.n_out)]
                    lens_pc = []
                    for bi in range(nb):
                        xs = [chunk_of(k, bi, "device") for k in keys]
                        st_b = states[node.idx]
                        lens_pc.append(self._node_lens(node, st_b, xs))
                        with self._annotate(b.name()):
                            states[node.idx], out = fnc(st_b, *xs)
                        self._record_cost(node.idx, fnc, (st_b,) + tuple(xs))
                        outs = out if isinstance(out, tuple) else (out,)
                        for i, o in enumerate(outs):
                            collected[i].append(o)
                    outs_per_port = collected  # per-chunk lists
                elapsed = time.perf_counter() - t0
                self._stats[node.idx] = self._stats.get(node.idx, 0.0) + elapsed
                self._cost_time[node.idx] = (
                    self._cost_time.get(node.idx, 0.0) + elapsed
                )
                per_port = [[] for _ in range(max(b.n_out, 1))]
                for bi in range(nb):
                    ots = b.process_tags(in_tags_of(node, bi), lens_pc[bi])
                    for i, ot in enumerate(ots):
                        per_port[i].append(ot)
                for i, (o, pp) in enumerate(zip(outs_per_port, per_port)):
                    values[(node.idx, i)] = o
                    tags[(node.idx, i)] = pp
                continue
            # host block (incl. sinks): chunks one at a time, in order
            keys = [(p.node.idx, p.index) for p in node.inputs]
            if (
                b.n_out == 0
                and hasattr(b, "accept_batch")
                and not hasattr(b, "accept_tags")
                and all(not isinstance(values[k], list) for k in keys)
            ):
                # batch-capable sink on stacked device inputs: ONE call,
                # no per-chunk slicing dispatches
                t0 = time.perf_counter()
                b.accept_batch(*[values[k] for k in keys])
                self._stats[node.idx] = self._stats.get(node.idx, 0.0) + (
                    time.perf_counter() - t0
                )
                continue
            per_port = [[] for _ in range(max(b.n_out, 1))]
            per_port_tags = [[] for _ in range(max(b.n_out, 1))]
            t0 = time.perf_counter()
            for bi in range(nb):
                xs = [chunk_of(k, bi, b.domain) for k in keys]
                itags = in_tags_of(node, bi)
                if hasattr(b, "set_tags") and itags:
                    b.set_tags(itags[0])
                with self._annotate(b.name()):
                    states[node.idx], out = b.apply_chunk(states[node.idx], *xs)
                if b.n_out == 0:
                    if hasattr(b, "accept_tags") and itags:
                        b.accept_tags(itags[0], out_offsets.get(node.idx, 0))
                        out_offsets[node.idx] = out_offsets.get(node.idx, 0) + len(
                            xs[0]
                        )
                    continue
                outs = out if isinstance(out, tuple) else (out,)
                out_lens = [len(o) if hasattr(o, "__len__") else 0 for o in outs]
                ots = b.process_tags(itags, out_lens)
                for i, (o, ot) in enumerate(zip(outs, ots)):
                    per_port[i].append(o)
                    per_port_tags[i].append(ot)
            self._stats[node.idx] = self._stats.get(node.idx, 0.0) + (
                time.perf_counter() - t0
            )
            if b.n_out > 0:
                for i in range(b.n_out):
                    values[(node.idx, i)] = per_port[i]
                    tags[(node.idx, i)] = per_port_tags[i]

    # ---- device-resident streaming ----
    def compile_device_loop(self, chunk_size: int, n_chunks: int):
        """Compile the WHOLE streaming run into ONE jitted device program.

        The per-chunk runners dispatch each chunk (and each host block)
        from Python, paying dispatch latency per chunk.  This runner instead traces ``n_chunks`` iterations
        of {source emit -> fused segments -> sink fold} into a single
        ``lax.scan`` program: zero host round-trips inside the loop, so
        a Graph-BUILT chain runs at kernel rate (the r5 device-resident
        framework benchmark; reference analog is the single hot
        ``Graph::run`` loop, src/graph.rs:99-173, with no allocation or
        locking inside).

        Requirements (raises ValueError otherwise):

        * every source defines ``emit_traced(offset, n)`` — a
          jax-traceable emit (``offset`` is a traced int32 scalar);
        * every sink (n_out == 0) defines ``fold(carry, *chunks)`` and
          ``fold_init()`` — a device-side reduction (e.g. a power sum);
          per-sample sink output stays on device, in the fold;
        * every other block is device-domain with ``jit_chunk`` and a
          scan-invariant state after one warm-up chunk (pick
          ``chunk_size`` divisible by the chain's decimations);
        * tags are not processed (DSP-payload loops only).

        Returns ``fn(offset0) -> {sink node idx: fold carry}`` — jitted;
        call with different static ``n_chunks`` compiles separate
        programs (the benchmark's dual-length timing method).
        """
        import jax
        import jax.numpy as jnp

        if n_chunks < 2:
            raise ValueError("device loop needs n_chunks >= 2")
        segs = self._segments()
        seg_member = self._seg_member
        for node in self._topo():
            b = node.block
            if isinstance(b, SourceBlock):
                if not hasattr(b, "emit_traced"):
                    raise ValueError(f"{b.name()} has no emit_traced")
            elif b.n_out == 0:
                if not hasattr(b, "fold"):
                    raise ValueError(f"{b.name()} has no device fold")
            elif not (b.domain == "device" and b.jit_chunk):
                raise ValueError(f"{b.name()} cannot join the device loop")
        seg_raws = {first: self._segment_raw(segs[first], True) for first in segs}
        # eager device staging BEFORE the trace (a source caching a
        # traced constant would leak the tracer into later compiles),
        # and resident collection: big device arrays (vectors) enter the
        # program as ARGUMENTS, never as constants baked into the HLO
        residents: dict[int, Any] = {}
        for node in self.nodes:
            hook = getattr(node.block, "prepare_traced", None)
            if hook is not None:
                hook()
            res = getattr(node.block, "device_resident", None)
            if res is not None:
                residents[node.idx] = res()

        # per-source modular offsets: a raw offset0 + i*chunk overflows
        # int32 within ~2^31 samples (a few hundred 16M chunks).  A
        # source declaring emit_period() (its ring/vector length, which
        # must be a chunk multiple here) gets its offset reduced mod the
        # period with all intermediates < 2*period.
        periods: dict[int, int] = {}
        for node in self.nodes:
            per = getattr(node.block, "emit_period", None)
            if isinstance(node.block, SourceBlock) and per is not None:
                p = per()
                if p is not None:
                    if p % chunk_size:
                        raise ValueError(
                            f"{node.block.name()} period {p} must be a "
                            f"multiple of chunk_size for the device loop"
                        )
                    periods[node.idx] = p

        def step(states, carries, offset0, i, res):
            vals: dict[tuple[int, int], Any] = {}
            new_states = dict(states)
            new_carries = dict(carries)
            for node in self._topo():
                b = node.block
                sf = seg_member.get(node.idx)
                if sf is not None:
                    if sf == node.idx:
                        ext_in, ext_out, raw = seg_raws[sf]
                        seg_states = {m.idx: states[m.idx] for m in segs[sf]}
                        ns, outs = raw(seg_states, *[vals[k] for k in ext_in])
                        new_states.update(ns)
                        for k, o in zip(ext_out, outs):
                            vals[k] = o
                    continue
                if isinstance(b, SourceBlock):
                    p = periods.get(node.idx)
                    if p is not None:
                        offset = jax.lax.rem(offset0, p) + jax.lax.rem(
                            i, p // chunk_size) * chunk_size
                    else:
                        offset = offset0 + i * chunk_size
                    if node.idx in res:
                        out = b.emit_traced(offset, chunk_size,
                                            resident=res[node.idx])
                    else:
                        out = b.emit_traced(offset, chunk_size)
                    outs = out if isinstance(out, tuple) else (out,)
                    for i, o in enumerate(outs):
                        vals[(node.idx, i)] = o
                    continue
                xs = [vals[(p.node.idx, p.index)] for p in node.inputs]
                if b.n_out == 0:
                    new_carries[node.idx] = b.fold(carries[node.idx], *xs)
                    continue
                new_states[node.idx], out = b.apply_chunk(states[node.idx], *xs)
                outs = out if isinstance(out, tuple) else (out,)
                for i, o in enumerate(outs):
                    vals[(node.idx, i)] = o
            return new_states, new_carries

        def fn(offset0, res):
            states = {
                n.idx: n.block.init_state()
                for n in self.nodes
                if not isinstance(n.block, SourceBlock) and n.block.n_out > 0
            }
            carries = {
                n.idx: n.block.fold_init()
                for n in self.nodes
                if n.block.n_out == 0 and not isinstance(n.block, SourceBlock)
            }
            offset0 = jnp.asarray(offset0, jnp.int32)
            # chunk 0 unrolled: fixes lazily-typed state shapes (e.g.
            # QuadratureDemod's (0,) -> (1,) carried sample) so the scan
            # carry is shape-invariant
            states, carries = step(states, carries, offset0,
                                   jnp.int32(0), res)

            def body(sc, i):
                return step(sc[0], sc[1], offset0, i, res), None

            (states, carries), _ = jax.lax.scan(
                body, (states, carries),
                jnp.arange(1, n_chunks, dtype=jnp.int32),
            )
            return carries

        jfn = jax.jit(fn)
        return lambda offset0: jfn(offset0, residents)

    # ---- stats ----
    def generate_stats(self) -> str:
        """Per-block elapsed-time table (reference src/graph.rs:175-257),
        extended with XLA cost analysis per jitted block/segment: FLOPs,
        bytes accessed, and achieved GB/s vs the device's memory roofline
        (where utils.stats knows its peak).
        Fused segments report their whole program on the first member."""
        from .utils.stats import device_hbm_gbps

        total = sum(self._stats.values()) or 1e-12
        self._evaluate_costs()
        have_costs = bool(self._costs)
        hdr = "block                          seconds     %"
        if have_costs:
            hdr += "    GFLOP     GB   GB/s  roof%"
        lines = [hdr]
        roof = None
        if have_costs:
            import jax

            try:
                roof = device_hbm_gbps(jax.devices()[0])
            except ValueError:
                roof = None  # no published peak for this device: no roof%
        for node in self.nodes:
            t = self._stats.get(node.idx, 0.0)
            row = f"{node.block.name():<30} {t:>8.4f} {100.0 * t / total:>5.1f}"
            c = self._costs.get(node.idx)
            if c is not None:
                gbps = c["bytes"] / max(self._cost_time.get(node.idx, t), 1e-12) / 1e9
                pct = f"{100 * gbps / roof:>5.1f}" if roof else "    -"
                row += (
                    f" {c['flops']/1e9:>8.3f} {c['bytes']/1e9:>6.3f}"
                    f" {gbps:>6.1f} {pct}"
                )
            lines.append(row)
        lines.append(f"{'TOTAL':<30} {total:>8.4f} 100.0")
        return "\n".join(lines)

    def costs(self) -> dict[int, dict[str, float]]:
        """Per-node accumulated {'flops', 'bytes'} from XLA cost analysis
        (evaluated lazily — compiles the cost query on first request)."""
        return dict(self._evaluate_costs())
