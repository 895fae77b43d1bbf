"""Mesh construction helpers."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize multi-host JAX (SURVEY §2.7: the reference's inter-process
    transport is TCP + the DATA_STREAM protocol; here hosts join one
    ``jax.distributed`` job and the mesh spans (host, chip) so collectives
    ride NVLink within a host and the network between hosts).

    MUST be the first JAX call in the process — touching devices (even
    ``jax.process_count()``) initializes the local backend and makes
    coordinated initialization impossible.  No-op without a coordinator
    (single-process runs, tests, the CPU dryrun).
    """
    if coordinator is None:
        return  # single-process
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(n_devices: int | None = None, axis: str = "time") -> Mesh:
    """A 1-D device mesh over the first ``n_devices`` devices.

    Streams shard their sample axis over ``axis``; for multi-host runs the
    same axis spans (host, chip) so halos ride NVLink between neighbouring
    shards and the network only between hosts.
    """
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"asked for {n_devices} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:n_devices]), (axis,))


def make_mesh_2d(n_time: int, n_chan: int) -> Mesh:
    """2-D mesh: channel-parallel x time-parallel (for the channelizer)."""
    devs = jax.devices()
    need = n_time * n_chan
    if need > len(devs):
        raise ValueError(f"asked for {need} devices, have {len(devs)}")
    arr = np.asarray(devs[:need]).reshape(n_chan, n_time)
    return Mesh(arr, ("chan", "time"))


def time_axis_spec(mesh: Mesh, axis: str = "time") -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec(axis))
