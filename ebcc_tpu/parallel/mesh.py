"""Device-mesh helpers for multi-chip / multi-host scale-out.

Role parity: the reference has NO parallelism of any kind (SURVEY §2.9 — a
single-threaded per-chunk serial codec).  This package supplies the
first-class equivalents (BASELINE.json north-star):

  * frame/chunk data parallelism over a ``jax.sharding.Mesh`` — chunks are
    embarrassingly parallel (the reference's chunk loop shares zero state
    between iterations, ebcc_codec.c:1007-1019), so decomposition is
    halo-free;
  * multi-host: ``jax.distributed.initialize`` + a mesh whose outer axis maps
    to hosts (DCN) and inner axis to chips (ICI);
  * the only collective the codec semantics ever need: a global min/max
    all-reduce for the compat RELATIVE->MAX conversion (mirror of
    ebcc_codec.c:1078-1087) and metrics reductions.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "chunks"
HOST_AXIS = "hosts"


def make_mesh(devices: Optional[Sequence] = None,
              axis_names=(HOST_AXIS, BATCH_AXIS),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """A 2-D (hosts, chips) mesh over the given (default: all) devices.

    Both axes shard the chunk batch; keeping hosts as a distinct axis lets
    per-host stream gather/IO align with the outer axis (each host writes its
    own chunks — the ETPK layout's chunk independence supports this).
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        n_hosts = max(1, jax.process_count()) if devices else 1
        if n % n_hosts != 0:
            n_hosts = 1
        shape = (n_hosts, n // n_hosts)
    dev_array = np.array(devices).reshape(tuple(shape))
    return Mesh(dev_array, axis_names)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading chunk axis over every mesh axis."""
    return NamedSharding(mesh, P(mesh.axis_names))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_batch_to_mesh(n: int, mesh: Mesh) -> int:
    """Smallest multiple of the total mesh size >= n."""
    total = int(np.prod(mesh.devices.shape))
    return -(-n // total) * total
