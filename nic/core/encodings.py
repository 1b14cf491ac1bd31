"""Positional encodings (sinusoidal + NTC triangular-wave).

Semantics parity with the reference repo's live encoders
(``Projects/utils.py:198-227`` of 21K1113/Neural_Image_Compression_V2):

- both take a stack of coordinate vectors ``coords[dim, N]`` and return a
  feature matrix ``[num_channels * dim, N]`` (features-first, matching the
  reference's transposed layout that is later concatenated channel-wise
  into the decoder input);
- the triangular encoding fills, per dimension block of ``num_channels``
  rows and per octave ``o`` with offsets (0.5, 0.0), the row
  ``num_channels - (2o + i + 1)`` with ``tri(x / 2^o, offset)`` — and skips
  the (octave 0, offset 0.5) slot, leaving the top row of each block zero
  (utils.py:211-223). We reproduce that zero row exactly: it is part of the
  decoder-input function class the reference trains on.

Everything is pure jnp, shape-static, jit/vmap/grad-safe, and elementwise
(no gathers).
"""

from __future__ import annotations

import math

import jax.numpy as jnp

__all__ = ["sinusoidal_pe", "tri", "triangular_pe", "pe_dim"]


def pe_dim(num_channels: int, ndim: int) -> int:
    """Output feature count of either encoder for ``ndim`` coordinates."""
    return num_channels * ndim


def sinusoidal_pe(coords, num_channels: int):
    """Transformer-style sin/cos encoding (utils.py:198-208).

    coords: [dim, N] (float). Returns [num_channels * dim, N].
    Within each dimension block, row 2k = sin(x * w_k), row 2k+1 = cos(x * w_k)
    with w_k = exp(-2k * ln(10000)/num_channels).
    """
    coords = jnp.asarray(coords)
    dim, n = coords.shape
    dtype = coords.dtype
    half = (num_channels + 1) // 2
    k = jnp.arange(0, num_channels, 2, dtype=dtype)  # [half]
    div_term = jnp.exp(k * (-math.log(10000.0) / num_channels))  # [half]
    # [dim, half, N]
    phase = coords[:, None, :] * div_term[None, :, None]
    sin = jnp.sin(phase)
    cos = jnp.cos(phase)
    # interleave along a new axis → [dim, half, 2, N] → [dim, 2*half, N]
    inter = jnp.stack([sin, cos], axis=2).reshape(dim, 2 * half, n)
    inter = inter[:, :num_channels, :]  # drop the trailing cos for odd nc
    return inter.reshape(dim * num_channels, n)


def tri(x, offset: float = 0.5):
    """Triangle wave: 2*|((x - offset) mod 2) - 1| - 1  (utils.py:226-227)."""
    return 2.0 * jnp.abs((x - offset) % 2.0 - 1.0) - 1.0


def triangular_pe(coords, num_channels: int):
    """NTC-paper triangle-wave encoding (utils.py:211-223).

    coords: [dim, N] (float, in G1-grid units). Returns
    [num_channels * dim, N]. Per dimension block, reading rows top→bottom
    (r = 0 .. num_channels-1) with j = num_channels - 1 - r, octave = j // 2,
    offset = 0.5 if j even else 0.0:

        r = 0:      tri(x / 2^(nc/2 - 1), 0.0)   (coarsest octave)
        ...
        r = nc - 2: tri(x, 0.0)                  (octave 0, offset 0.0)
        r = nc - 1: 0                            (octave 0, offset 0.5 — the
                                                  slot the reference skips)
    """
    coords = jnp.asarray(coords)
    dim, n = coords.shape
    dtype = coords.dtype
    octaves = num_channels // 2
    rows = []
    for r in range(num_channels):
        j = num_channels - 1 - r
        # filled slots are j = 2*octave + i for octave < octaves, minus the
        # skipped (octave 0, i 0) slot; everything else stays zero
        if j == 0 or j >= 2 * octaves:
            rows.append(jnp.zeros((dim, n), dtype=dtype))
            continue
        octave = j // 2
        offset = 0.5 if j % 2 == 0 else 0.0
        rows.append(tri(coords / (2.0**octave), offset=offset).astype(dtype))
    # [nc, dim, N] → [dim, nc, N] → [dim*nc, N]
    pe = jnp.stack(rows, axis=0).transpose(1, 0, 2)
    return pe.reshape(dim * num_channels, n)


# ---------------------------------------------------------------------------
# gather-based triangular-PE variants (utils.py:230-284 of the reference,
# exercised only by its test14.py visualization probe): a periodic 1-D LUT
# of tri waves gathered at integer coordinates. Kept for full component
# parity; the closed-form triangular_pe above is the production encoder.
# ---------------------------------------------------------------------------


def triangular_pe_table(sequence_length: int = 8, octaves: int = 3,
                        include_constant: bool = True, dtype=jnp.float32):
    """[rows, sequence_length] LUT of tri waves (utils.py:230-243):
    per octave o the offsets (0.0, 0.5) — skipping (octave 0, 0.5) — of
    tri(x / 2^o, offset), plus an optional constant zero row."""
    x = jnp.arange(sequence_length, dtype=dtype)
    rows = []
    for octave in range(octaves):
        div = 2.0**octave
        for i, offset in enumerate((0.0, 0.5)):
            if octave == 0 and i == 1:
                continue
            rows.append(tri(x / div, offset=offset))
    if include_constant:
        rows.append(jnp.zeros((sequence_length,), dtype))
    return jnp.stack(rows)


def convert_coordinate_start(coordinate_start, h: int, w: int, stride: int = 1,
                             flatten_sequence: bool = True):
    """Per-batch window start [b, 2] → full integer coordinate grids
    (full_x, full_y), each [b, h*w] (utils.py:266-284 — including its
    meshgrid(x over w, y over h, 'ij').view(h, w) reshape, which the
    reference only ever uses with h == w)."""
    x_offset = jnp.arange(0, w * stride, stride)
    y_offset = jnp.arange(0, h * stride, stride)
    xx, yy = jnp.meshgrid(x_offset, y_offset, indexing="ij")
    xx = xx.reshape(h, w, 1)
    yy = yy.reshape(h, w, 1)
    b = coordinate_start.shape[0]
    x_start = coordinate_start[:, 0].reshape(b, 1, 1, 1)
    y_start = coordinate_start[:, 1].reshape(b, 1, 1, 1)
    full_x = x_start + xx[None]
    full_y = y_start + yy[None]
    if flatten_sequence:
        return full_x.reshape(b, -1), full_y.reshape(b, -1)
    return full_x, full_y


def triangular_pe_gather_2d(coordinates, h: int, w: int, *,
                            sequence_length: int = 8, octaves: int = 3,
                            stride: int = 1, include_constant: bool = True,
                            dtype=jnp.float32):
    """Gather-based 2-D triangular PE (utils.py:246-263): LUT rows gathered
    at (coord mod sequence_length) for the x and y grids of each batch
    window. coordinates: [b, 2] integer window starts → [b, 2*rows, h, w]."""
    table = triangular_pe_table(sequence_length, octaves, include_constant,
                                dtype)
    full_x, full_y = convert_coordinate_start(coordinates, h, w, stride)

    def gather(full_coord):  # [b, h*w] → [b, rows, h, w]
        idx = (full_coord % sequence_length).astype(jnp.int32)
        return jnp.take(table, idx, axis=1).transpose(1, 0, 2).reshape(
            full_coord.shape[0], table.shape[0], h, w
        )

    return jnp.concatenate([gather(full_x), gather(full_y)], axis=1)
