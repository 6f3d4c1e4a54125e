"""Multi-host (multi-process) execution helpers.

One process can drive every GPU of a host (its cards are joined all
to all by NVLink) with nothing beyond a Mesh.  Several hosts run one
process each, and global arrays are assembled from process-local
shards.  The reference has no counterpart (it is single-process,
SURVEY.md section 2.8) — this is the framework's multi-host layer:
`jax.distributed` for rendezvous, the collectives inside shard_map
over NVLink within a host and the network between hosts.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["initialize", "global_mesh", "stage_global_cube"]


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the multi-process runtime (no-op when single-process).

    GPU hosts detect nothing: pass the coordinator "host:port", the
    process count and this process's id explicitly.
    """
    if num_processes in (None, 1) and coordinator is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(space: int | None = None, time: int | None = None) -> Mesh:
    """(space, time) mesh over *all* devices across processes.

    The **time** axis is laid out across processes (each host owns a
    contiguous run of time indices): frame cubes stream host-by-host as
    time-contiguous slabs (:func:`stage_global_cube`), so the process
    boundary must fall on the slab axis.  Space-axis collectives then
    stay within a host (NVLink); time-axis all_to_alls cross hosts.
    """
    devs = np.array(jax.devices())
    n = devs.size
    if space is None and time is None:
        space, time = 1, n
    elif space is None:
        space = n // time
    elif time is None:
        time = n // space
    if space * time != n:
        raise ValueError(f"space*time ({space}*{time}) != n_devices ({n})")
    nproc = jax.process_count()
    if time % nproc:
        raise ValueError(
            f"time axis ({time}) must be a multiple of the process "
            f"count ({nproc}) so each host owns whole time slabs"
        )
    # jax.devices() orders by process; reshape (time, space) puts
    # consecutive processes on consecutive time rows
    return Mesh(devs.reshape(time, space), axis_names=("time", "space"))


def stage_global_cube(local_frames: np.ndarray, mesh: Mesh) -> jax.Array:
    """Assemble a global [T, H, W, C] frame cube from this process's
    time-contiguous slab (host->device staging for pod runs:
    jax.make_array_from_process_local_data handles the DCN exchange)."""
    sharding = NamedSharding(mesh, P("time", "space", None, None))
    return jax.make_array_from_process_local_data(sharding, local_frames)
