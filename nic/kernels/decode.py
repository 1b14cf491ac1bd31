"""One entry for a full (or tile) NTC decode, whichever backend decodes.

Backends:

- ``"pallas"``: the fused Triton kernel (:mod:`nic.kernels.decode_triton`);
- ``"fast"``: the folded-first-layer XLA decode
  (:func:`nic.grids.fastdecode.fast_decode`);
- ``"xla"``: the unfused reference graph (``decoder_input`` + ``apply_mlp``);
  at ``dtype="fp32"`` this is the plain float32 reference the others are
  checked against.

``"auto"`` resolves to :data:`AUTO_BACKEND`, the backend that measured
fastest end to end on the GPU (PERF.md). There is no platform branch: a
kernel that cannot compile where it runs raises.

``dtype="fp32"`` decodes in float32: every XLA matrix product runs at
``"highest"`` precision (no TF32), and the kernel's W2 product runs in
three bfloat16 passes with float32 accumulation (relative error ~2⁻¹⁶,
:func:`nic.kernels.decode_triton._dot_bf16x3`). ``dtype="bf16"`` and
``gelu="tanh"`` select the kernel's faster modes and apply to the
``"pallas"`` backend only.
"""

from __future__ import annotations

import contextlib
import math

import jax
import jax.numpy as jnp

__all__ = ["BACKENDS", "AUTO_BACKEND", "resolve_backend", "decode"]

BACKENDS = ("pallas", "fast", "xla")
AUTO_BACKEND = "pallas"


def resolve_backend(backend: str) -> str:
    if backend == "auto":
        return AUTO_BACKEND
    if backend not in BACKENDS:
        raise ValueError(f"decode backend must be auto or one of {BACKENDS}, "
                         f"got {backend!r}")
    return backend


def decode(fp, mlp, mip_level: int, *, backend: str, image_size: int,
           mip_to_level: dict, pe_channels: int, use_tri_pe: bool = True,
           ndim: int = 2, sparse_g0: bool = False, g1_quirk: bool = True,
           n=None, origin=None, full_n=None, dtype: str = "fp32",
           gelu: str = "exact"):
    """Decode [n.., 3] in (0, 1) on one device. ``n``/``origin`` select a
    tile (``full_n``: the whole decode's extent, for a traced origin)."""
    backend = resolve_backend(backend)
    if backend != "pallas" and (dtype, gelu) != ("fp32", "exact"):
        raise ValueError(f"dtype={dtype!r} gelu={gelu!r} apply to the "
                         f"pallas backend only, not {backend!r}")
    kw = dict(image_size=image_size, mip_to_level=mip_to_level,
              pe_channels=pe_channels, use_tri_pe=use_tri_pe, ndim=ndim,
              sparse_g0=sparse_g0, g1_quirk=g1_quirk, n=n, origin=origin)
    ctx = (jax.default_matmul_precision("highest") if dtype == "fp32"
           else contextlib.nullcontext())
    with ctx:
        if backend == "pallas":
            from nic.kernels.decode_triton import decode_fused

            return decode_fused(fp, mlp, mip_level, full_n=full_n,
                                dtype=dtype, gelu=gelu, **kw)
        if backend == "fast":
            from nic.grids.fastdecode import fast_decode

            return fast_decode(fp, mlp, mip_level, **kw)
        return _decode_unfused(fp, mlp, mip_level, **kw)


def _decode_unfused(fp, mlp, mip_level, *, image_size, mip_to_level,
                    pe_channels, use_tri_pe, ndim, sparse_g0, g1_quirk, n,
                    origin):
    """decoder_input + apply_mlp over square blocks: one block for a
    square decode, a gcd-sized block lattice for a rectangular one."""
    from nic.grids.sample import decoder_input
    from nic.models.mlp import apply_mlp

    if n is None:
        n = image_size // (2**mip_level)
    ns = (n,) * ndim if isinstance(n, int) else tuple(n)
    if origin is None:
        origin = (0,) * ndim
    fl = mip_to_level[mip_level]
    step = 2.0 ** (mip_level - (fl + 1) * 2)
    blk = math.gcd(*ns)

    def block(offsets):
        o = jnp.stack([jnp.asarray(a, jnp.int32) + b
                       for a, b in zip(origin, offsets)])
        x = decoder_input(
            fp, fl, o, step, blk, pe_channels=pe_channels,
            mip_level=mip_level, ndim=ndim, use_tri_pe=use_tri_pe,
            sparse_g0=sparse_g0, dtype=fp[0].dtype, g1_quirk=g1_quirk,
        )
        return apply_mlp(mlp, x).reshape((blk,) * ndim + (3,))

    def assemble(prefix):
        d = len(prefix)
        if d == ndim:
            return block(prefix)
        parts = [assemble(prefix + (k * blk,)) for k in range(ns[d] // blk)]
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts, d)

    return assemble(())
