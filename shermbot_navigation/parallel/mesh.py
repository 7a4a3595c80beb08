"""Mesh construction + multi-host initialization.

Replaces the reference's process/topic topology (TCPROS between local
processes) with a ``jax.sharding.Mesh`` over axes:

- ``"data"``: independent SLAM sequences (DP; SURVEY section 2.5 row 1)
- ``"map"``:  landmark blocks of the covariance (the TP/"long-context"
  analog; SURVEY section 2.5 rows 2/6)

Collectives between map shards (psum / all_gather / pmin) compile to NCCL
transfers: NVLink between the cards of one host, all to all at one rate,
so the mesh follows the algorithm alone, and the network across hosts.
The data axis needs no communication except metric reductions.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(devices=None, data: int = 1, map_: int | None = None) -> Mesh:
    """Build a ('data', 'map') mesh. Defaults: all devices on the map axis."""
    devices = list(jax.devices()) if devices is None else list(devices)
    n = len(devices)
    if map_ is None:
        map_ = n // data
    if data * map_ != n:
        raise ValueError(f"data({data}) * map({map_}) != #devices({n})")
    arr = np.asarray(devices).reshape(data, map_)
    return Mesh(arr, axis_names=("data", "map"))


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Initialize the JAX distributed runtime for N >= 2 hosts.

    Pass the coordinator address, process count and process id
    explicitly: nothing in a plain CPU/GPU cluster announces them. Safe to
    call once per process before any jax computation. (Single-host runs
    skip this entirely.)
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def sharding(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))
