"""Explicit pipeline parallelism: one stage per device.

The reference's MTGraph runs every block on its own OS thread with stream
buffers between them (src/mtgraph.rs:76-130).  Here the default is to
FUSE the dense chain into one XLA program (graph.py segments); this module
is the explicit alternative SURVEY §2.6 item 1 calls for when stages must
live on separate devices (e.g. each stage near its own memory working set):
device d applies stage d, and chunks hand off to the next device
with ``ppermute`` — classic software pipelining, one chunk in flight per
device.

Constraints: every stage must map a (chunk,) array to a (chunk,) array of
the same shape/dtype (insert rate changes inside a stage, not between).
Throughput approaches one chunk per round once the pipe fills; latency is
``n_stages`` rounds.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P


def pipeline_run(stage_fns, chunks, mesh: Mesh, axis: str = "stage"):
    """Run ``chunks`` through ``stage_fns`` with stage d pinned to device d.

    ``stage_fns``: list of D jax-traceable fns, each (chunk,) -> (chunk,).
    ``chunks``: array (n_chunks, chunk_len) — all the same dtype the
    stages preserve.  Returns (n_chunks, chunk_len) outputs, equal to
    applying the composed stages to each chunk.
    """
    d_stages = len(stage_fns)
    if mesh.shape[axis] != d_stages:
        raise ValueError(f"mesh axis {axis} must have {d_stages} devices")
    chunks = jnp.asarray(chunks)
    n_chunks, chunk_len = chunks.shape
    rounds = n_chunks + d_stages - 1
    # Feed schedule: device 0 takes chunk r at round r, zeros afterwards.
    feed = jnp.concatenate(
        [chunks, jnp.zeros((d_stages - 1, chunk_len), chunks.dtype)], axis=0
    )

    fwd = [(i, i + 1) for i in range(d_stages - 1)]

    def body(carry, inject):
        # carry: the chunk handed to this device last round
        d = jax.lax.axis_index(axis)
        cur = jnp.where(d == 0, inject, carry)
        y = jax.lax.switch(d, stage_fns, cur)
        handed = jax.lax.ppermute(y, axis, fwd) if fwd else y
        return handed, y  # y on the LAST device is this round's pipe output

    def shard_body(feed_shard, init):
        # feed_shard: (rounds, chunk_len) replicated; init: per-device state
        final, ys = jax.lax.scan(body, init[0], feed_shard)
        return ys[None]  # (1, rounds, chunk_len) per device

    f = shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    init = jnp.zeros((d_stages, chunk_len), chunks.dtype)
    ys = f(feed, init)  # (d_stages, rounds, chunk_len)
    # pipe output = last device's emissions, offset by the fill latency
    return ys[d_stages - 1, d_stages - 1 :, :]


def pipeline_run_rates(stages, chunks, mesh: Mesh, axis: str = "stage"):
    """Pipeline with static per-stage rate ratios (decimators welcome).

    ``stages``: list of ``(fn, in_len, out_len)`` — stage d maps an
    ``(in_len,)`` array to an ``(out_len,)`` array, with
    ``out_len[d] == in_len[d+1]``.  Internally every inter-stage chunk
    rides a fixed-width "wire" buffer (the max of all lens, padded with
    zeros) so ``lax.switch`` branches and ``ppermute`` handoffs keep one
    static shape; each stage slices its prefix.  This is what lets a
    decimating filter→demod chain run stage-per-device — the reference's
    thread-per-block MTGraph with rate-changing blocks
    (src/mtgraph.rs:73-149).

    ``chunks``: (n_chunks, in_len0) of the wire dtype (complex64
    recommended; real-valued stages can view/cast internally).
    Returns (n_chunks, out_len_last), equal to composing the stage fns
    chunk-by-chunk.
    """
    d_stages = len(stages)
    if mesh.shape[axis] != d_stages:
        raise ValueError(f"mesh axis {axis} must have {d_stages} devices")
    for d in range(d_stages - 1):
        if stages[d][2] != stages[d + 1][1]:
            raise ValueError(
                f"stage {d} emits {stages[d][2]} but stage {d+1} takes "
                f"{stages[d+1][1]}"
            )
    chunks = jnp.asarray(chunks)
    n_chunks = chunks.shape[0]
    if chunks.shape[1] != stages[0][1]:
        raise ValueError("chunks must be (n, in_len of stage 0)")
    W = max(max(i, o) for _, i, o in stages)
    out_last = stages[-1][2]

    def wrap(fn, in_len, out_len):
        def g(buf):
            y = jnp.asarray(fn(buf[:in_len]), buf.dtype)
            return jnp.pad(y, (0, W - out_len))

        return g

    branch_fns = [wrap(*s) for s in stages]
    # d_stages-1 zero rows drain the pipe after the last chunk enters
    feed = jnp.pad(chunks, ((0, d_stages - 1), (0, W - chunks.shape[1])))
    fwd = [(i, i + 1) for i in range(d_stages - 1)]

    def body(carry, inject):
        d = jax.lax.axis_index(axis)
        cur = jnp.where(d == 0, inject, carry)
        y = jax.lax.switch(d, branch_fns, cur)
        handed = jax.lax.ppermute(y, axis, fwd) if fwd else y
        return handed, y

    def shard_body(feed_shard, init):
        _, ys = jax.lax.scan(body, init[0], feed_shard)
        return ys[None]

    f = shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    init = jnp.zeros((d_stages, W), chunks.dtype)
    ys = f(feed, init)
    return ys[d_stages - 1, d_stages - 1 :, :out_last]


def pipeline_chain(stage_fns, x, mesh: Mesh, chunk_len: int, axis: str = "stage"):
    """Convenience: split a 1-D stream into chunks, pipeline, reassemble.
    The stream length must be a multiple of chunk_len and every stage must
    be chunk-local (elementwise or carried-state-free)."""
    x = jnp.asarray(x)
    n = x.shape[0]
    if n % chunk_len:
        raise ValueError("stream length must be a multiple of chunk_len")
    out = pipeline_run(stage_fns, x.reshape(-1, chunk_len), mesh, axis)
    return out.reshape(-1)
