"""Device mesh construction for the batch-parallel signing service.

The reference is a single FPGA chip whose only interconnect is a 64-bit
valid/ready host bus (`combined_top.v:36-41`); its parallelism is spatial
pipelining inside the chip (SURVEY.md §2.7). Here the scaling story is
data parallelism over independent keygen/sign/verify operations: a 1-D
`jax.sharding.Mesh` over all chips, inputs sharded on the leading batch
axis, zero cross-chip traffic in the hot path, and a single `psum` for
throughput accounting. pk/sk either shard with the batch (distinct keys
per lane) or replicate (one key signing many messages).

Multi-host entry: `jax.distributed.initialize()` + per-host feeds via
`jax.make_array_from_process_local_data` (see `local_batch_to_global`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "batch"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1-D data-parallel mesh over the given (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (BATCH_AXIS,))


def batch_sharding(mesh: Mesh, ndim_extra: int = 1) -> NamedSharding:
    """Sharding for an array whose axis 0 is the operation batch."""
    return NamedSharding(mesh, P(BATCH_AXIS, *([None] * ndim_extra)))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def local_batch_to_global(mesh: Mesh, local: np.ndarray) -> jax.Array:
    """Assemble a global batch-sharded array from per-process local data.

    Each host contributes its local shard; the result is one logical array
    sharded over the full mesh (the analog of each FPGA host streaming its
    own vectors over its own bus).
    """
    sharding = batch_sharding(mesh, ndim_extra=local.ndim - 1)
    return jax.make_array_from_process_local_data(sharding, local)
