"""Multiresolution feature pyramid (the learned "LUT").

Structure parity with the reference (``Projects/fp_def.py:8-78`` of
21K1113/Neural_Image_Compression_V2): the pyramid is a list of
``2 * levels`` grids; pyramid level ``l`` owns the pair
(G0 = ``fp[2l]``, G1 = ``fp[2l+1]``) of shape ``[C, s+1, s+1(, s+1)]``
with ``s = base_size // 2^i`` for list index ``i`` — so G1 sits at half
the resolution of G0. ``levels = (log2(base_size) + 1) // 2``; ``no_mip``
forces a single level. Grids initialise uniformly in the quantizer range
``[q_min, q_max]`` (fp_def.py:48-55).

Represented as a tuple of jnp arrays — a pytree that flows through
jit/grad/optax directly (the JAX analog of the reference's list of
``requires_grad`` tensors, cf. its test04/test05 probes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from nic.core.quant import quant_range, quantize, quantize_clamp, pack_grid, unpack_grid

__all__ = [
    "log2_int",
    "pyramid_levels",
    "pyramid_mip_levels",
    "create_pyramid",
    "pyramid_clamp",
    "pyramid_quantize_all",
    "pyramid_pack",
    "pyramid_unpack",
    "pyramid_num_elements",
    "pyramid_bits",
]

Pyramid = tuple  # tuple of [C, s+1, s+1(, s+1)] arrays


def log2_int(size: int) -> int:
    """Floor log2 by repeated halving (fp_def.py:8-14 semantics)."""
    count = 0
    x = size
    while x != 1:
        x //= 2
        count += 1
    return count


def pyramid_levels(base_size: int) -> int:
    """(log2(base_size) + 1) // 2  (fp_def.py:18-20)."""
    return (log2_int(base_size) + 1) // 2


def pyramid_mip_levels(image_size: int, base_size: int, no_mip: bool = False) -> dict[int, int]:
    """mip level → pyramid level map: clamp(mip//2 - 1, 0, levels-1)
    (fp_def.py:24-34)."""
    levels = 1 if no_mip else pyramid_levels(base_size)
    out = {}
    for mip in range(log2_int(image_size) + 1):
        out[mip] = min(max(mip // 2 - 1, 0), levels - 1)
    return out


def create_pyramid(
    key,
    base_size,
    channels: int,
    num_bits: int,
    ndim: int = 2,
    dtype=jnp.float32,
    no_mip: bool = False,
) -> tuple[Pyramid, int]:
    """Uniform-init pyramid in [q_min, q_max]  (fp_def.py:37-78).

    Returns (pyramid, levels). ``ndim`` selects 2D ([C,s+1,s+1]) or 3D
    ([C,s+1,s+1,s+1]) grids. ``base_size`` may be a per-axis tuple for
    NATIVE rectangular geometry (no reference counterpart — it is
    square-only, var2.py:60): grid i then has shape
    [C, s0/2^i + 1, s1/2^i + 1].
    """
    sizes = ((base_size,) * ndim if isinstance(base_size, int)
             else tuple(base_size))
    assert len(sizes) == ndim
    levels = 1 if no_mip else pyramid_levels(min(sizes))
    q_min, q_max = quant_range(num_bits)
    grids = []
    keys = jax.random.split(key, levels * 2)
    for i in range(levels * 2):
        shape = (channels,) + tuple(s // (2**i) + 1 for s in sizes)
        g = jax.random.uniform(
            keys[i], shape, dtype=dtype, minval=q_min, maxval=q_max
        )
        grids.append(g)
    return tuple(grids), levels


def pyramid_clamp(fp: Pyramid, fl: int, num_bits: int) -> Pyramid:
    """Clamp the active level's (G0, G1) pair to the quantizer range
    (fp_def.py:227-232); other grids pass through unchanged."""
    out = list(fp)
    out[fl * 2] = quantize_clamp(fp[fl * 2], num_bits)
    out[fl * 2 + 1] = quantize_clamp(fp[fl * 2 + 1], num_bits)
    return tuple(out)


def pyramid_quantize_all(fp: Pyramid, num_bits: int) -> Pyramid:
    """Hard-quantize every grid (fp_def.py:242-247)."""
    return tuple(quantize(g, num_bits) for g in fp)


def pyramid_pack(fp: Pyramid, num_bits: int) -> tuple:
    """Grids → unsigned uint8 codes for storage (fp_def.py:250-255)."""
    return tuple(pack_grid(g, num_bits) for g in fp)


def pyramid_unpack(codes, num_bits: int, dtype=jnp.float32) -> Pyramid:
    """Inverse of :func:`pyramid_pack` (fp_def.py:258-263)."""
    return tuple(unpack_grid(c, num_bits, dtype) for c in codes)


def pyramid_num_elements(fp: Pyramid) -> int:
    return sum(int(g.size) for g in fp)


def pyramid_bits(fp: Pyramid, num_bits: int) -> int:
    """True payload bits of the packed pyramid (for bpp accounting)."""
    return pyramid_num_elements(fp) * num_bits
