"""Device mesh helpers for data-parallel decoding.

A 1-D ``data`` mesh shards read batches across devices: reads never
communicate, so the mesh follows the algorithm (one axis), and one process
drives all of a host's GPUs.  Multi-host runs initialize the JAX
distributed runtime first; single-process multi-device works out of the
box.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_data_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over all (or the given) devices, axis name ``data``."""
    if devices is None:
        devices = jax.devices()
    return jax.make_mesh((len(devices),), (DATA_AXIS,), devices=devices)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (read) axis over the data mesh."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the multi-host runtime (no-op if already initialized).

    Pass the coordinator address, process count and process id
    explicitly: nothing in a plain GPU or CPU environment provides them.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise
