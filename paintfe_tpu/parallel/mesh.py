"""Device-mesh helpers.

The reference is a single-process desktop app (SURVEY §2.9): its parallelism
is rayon rows + wgpu workgroups.  The scaling axis here is the *batch of
images*: a 1-D `Mesh(('batch',))` over all devices, images sharded on the
leading axis, XLA SPMD partitioning every fused kernel.  Within-image tiling
(halo exchange for images that span cards) is parallel/spatial.py.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def batch_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over this process's devices, axis name 'batch'.

    Local (not global) devices on purpose: the CLI batch path shards the
    *file list* across hosts (parallel.distributed.shard_inputs), so each
    host computes its own images on its own chips.  For job-wide compute
    over every chip use parallel.distributed.global_batch_mesh()."""
    devices = list(devices if devices is not None else jax.local_devices())
    return Mesh(np.array(devices), ("batch",))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """[N, H, W, C] arrays sharded on the leading (batch) axis."""
    return NamedSharding(mesh, P("batch"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_batch(n: int, mesh: Mesh) -> int:
    """Round a batch size up to a multiple of the mesh size."""
    d = mesh.devices.size
    return ((n + d - 1) // d) * d
