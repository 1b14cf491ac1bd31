"""Multi-device decode: the single-device decode shard_mapped over a mesh.

The output's outermost axis (image rows in 2D, frames in 3D) splits into
one contiguous block per device, and each device decodes its block with
the unchanged single-device decode (:func:`nic.kernels.decode.decode`) at
a row/frame origin. The grids and MLP are replicated, every read is local,
and no collective runs; the only cross-device traffic is gathering the
output blocks.
"""

from __future__ import annotations

import math

import jax
from jax.sharding import PartitionSpec as P

from nic.kernels.decode import decode
from nic.parallel.mesh import shard_map_nocheck

__all__ = ["decode_sharded", "shardable"]


def shardable(ns, mesh) -> bool:
    """Whether the outermost axis of an ``ns`` decode splits evenly over
    ``mesh``'s devices."""
    return mesh is not None and ns[0] % math.prod(mesh.devices.shape) == 0


def decode_sharded(fp, mlp, mip_level: int, mesh, *, image_size: int,
                   ndim: int = 2, n=None, **kw):
    """Decode [n.., 3] with the outermost axis sharded over every axis of
    ``mesh``; ``kw`` as for :func:`nic.kernels.decode.decode`."""
    if n is None:
        n = image_size // (2**mip_level)
    ns = (n,) * ndim if isinstance(n, int) else tuple(n)
    if not shardable(ns, mesh):
        raise ValueError(f"{ns[0]} rows do not split over "
                         f"{math.prod(mesh.devices.shape)} devices")
    rows = ns[0] // math.prod(mesh.devices.shape)
    axes = tuple(mesh.axis_names)

    def local(fp, mlp):
        k = jax.lax.axis_index(axes)
        origin = (k * rows,) + (0,) * (ndim - 1)
        return decode(fp, mlp, mip_level, image_size=image_size, ndim=ndim,
                      n=(rows,) + ns[1:], origin=origin, full_n=ns, **kw)

    return shard_map_nocheck(local, mesh, in_specs=(P(), P()),
                             out_specs=P(axes))(fp, mlp)
