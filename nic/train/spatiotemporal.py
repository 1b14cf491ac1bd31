"""Shared batched spatiotemporal decode + sharding specs for the movie
family.

The reference's four movie entry points each carry their own decode call
(``Projects/movie_frame_comp.py:187``, ``movie_2d_comp.py:167-185``,
``movie_3d_comp.py:183-202`` of 21K1113/Neural_Image_Compression_V2, all
single-device whole-asset calls). Here they all decode through ONE entry:
a latent laid out as ``[B, *spatial, C]`` through a conv decoder, with the
natural batch axis data-parallel over the device mesh:

- movie_label: B = T frames (true frame batching — one decoder, one
  batched conv pass over all frames);
- movie_frame / movie_2d: B = 1, the √T·S sheet; the sheet's row axis
  shards over the mesh (frames are spatial tiles of the sheet, so sheet
  rows ARE groups of frames; XLA SPMD inserts the conv halo exchange);
- movie_3d: B = 1, spatial = (T, H, W); the time axis shards.

Training uses the same specs: the trainers place the asset and constrain
the latent with :func:`movie_spec`, the SPMD partitioner psums the
replicated encoder/decoder grads.
"""

from __future__ import annotations

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from nic.parallel.mesh import shard_batch

__all__ = ["movie_spec", "make_batched_decode", "put_sharded"]


def movie_spec(ndim: int, batched: bool) -> P:
    """PartitionSpec for a [B, *spatial, C] movie tensor: the frame axis B
    over 'data' when batched (movie_label), otherwise the leading spatial
    axis (sheet rows for movie_frame/2d, time for movie_3d)."""
    if batched:
        return P("data", *([None] * (ndim - 1)))
    return P(None, "data", *([None] * (ndim - 2)))


def put_sharded(x, mesh, batched: bool):
    """Place a movie/asset array on the mesh with its movie_spec sharding
    (identity without a mesh)."""
    if mesh is None:
        return x
    return jax.device_put(x, NamedSharding(mesh, movie_spec(x.ndim, batched)))


def make_batched_decode(apply_fn, *, mesh=None, batched: bool = False):
    """The one spatiotemporal decode entry: jitted ``(params, z) →
    decoder(z)`` with frame/spatial data-parallel sharding constraints.
    ``apply_fn(params, z)`` is the variant's decoder application (for
    movie_label it concatenates the per-frame embedding plane first)."""

    def decode(params, z):
        z = shard_batch(z, mesh, movie_spec(z.ndim, batched))
        out = apply_fn(params, z)
        return shard_batch(out, mesh, movie_spec(out.ndim, batched))

    return jax.jit(decode)
