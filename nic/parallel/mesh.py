"""Device-mesh parallelism helpers.

The reference is strictly single-device (SURVEY.md §2: no torch.distributed
/ NCCL / MPI anywhere); this module is a *new* component. The natural batch
axes of these workloads map onto a 2-D
logical mesh:

- ``data``  — crops (training, image_compression.py:233's NUM_CROPS axis),
  frames (movie family), or output tiles (decode);
- ``pixel`` — the flattened pixel/voxel coordinate axis inside a crop/tile
  (the coordinate-network analogue of sequence parallelism).

Grids + MLP params are tiny (≤ a few MB) and stay replicated; activations
are sharded with ``with_sharding_constraint`` and the SPMD partitioner
inserts the gradient psum. No halo exchange is needed: grid gathers are
local reads of the replicated pyramid. Every device reaches every other at
the same rate, so the mesh follows the algorithm alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_batch", "replicate", "data_pixel_spec"]


def make_mesh(n_devices: int | None = None, data_axis: int | None = None) -> Mesh:
    """Build a ('data', 'pixel') mesh over the available devices.

    ``data_axis`` fixes the size of the data axis (must divide n_devices);
    by default the mesh is (n_devices, 1) — pure data parallelism.
    """
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    d = data_axis if data_axis is not None else n
    if n % d:
        raise ValueError(f"data axis {d} does not divide device count {n}")
    arr = np.asarray(devices).reshape(d, n // d)
    return Mesh(arr, ("data", "pixel"))


def data_pixel_spec(ndim_tail: int = 1) -> P:
    """PartitionSpec for a [crops, pixels, ...] activation: crops over
    'data', pixels over 'pixel', feature dims replicated."""
    return P("data", "pixel", *([None] * ndim_tail))


def shard_batch(x, mesh: Mesh | None, spec: P):
    """Constrain ``x`` to ``spec`` on ``mesh`` (no-op without a mesh)."""
    if mesh is None:
        return x
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))


def replicate(tree, mesh: Mesh | None):
    """Pin a param pytree to fully-replicated sharding on ``mesh``."""
    if mesh is None:
        return tree
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda a: jax.device_put(a, sharding), tree)


def shard_map_nocheck(f, mesh: Mesh, in_specs, out_specs):
    """``jax.shard_map`` with replication checking off."""
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)
