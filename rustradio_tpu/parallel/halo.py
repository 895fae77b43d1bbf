"""Halo exchange between time-adjacent shards (inside shard_map).

The reference carries per-block overlap state across work() calls
(src/fft_filter.rs:336-348 tail, src/fir.rs:493-505 lookahead); with the
time axis sharded across chips, the same samples move between neighbours
via ``ppermute`` — a single interconnect hop per stream per filter.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def halo_exchange_left(x, halo: int, axis_name: str):
    """Prepend each shard with the last ``halo`` samples of its left
    neighbour (zeros on shard 0, matching zero-history stream start).

    Must be called inside shard_map over a 1-D mesh axis ``axis_name``.
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    tail = x[-halo:]
    # shift right: shard i receives shard i-1's tail
    recv = jax.lax.ppermute(tail, axis_name, [(i, (i + 1) % n) for i in range(n)])
    recv = jnp.where(idx == 0, jnp.zeros_like(recv), recv)
    return jnp.concatenate([recv, x])


def halo_exchange_right(x, halo: int, axis_name: str, fill=0):
    """Append each shard with the first ``halo`` samples of its right
    neighbour (``fill`` on the last shard)."""
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    head = x[:halo]
    recv = jax.lax.ppermute(head, axis_name, [(i, (i - 1) % n) for i in range(n)])
    recv = jnp.where(idx == n - 1, jnp.full_like(recv, fill), recv)
    return jnp.concatenate([x, recv])
