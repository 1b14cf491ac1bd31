"""Algebraically-fused decode: fold the MLP's first layer into the grid.

The decoder input is a CONCATENATION of gathered/interpolated grid
features, PE, and a lod constant (reference image_compression.py:94-95),
so the first Linear layer distributes over the parts — and, crucially,
**gather/interpolation commute with the per-part matmuls**:

    x(p)·W1 = Σ_corners G0[cell(p)+off]·W1_off            (G0 blocks)
            + Σ_c w_c(p) · G1[cell1(p)+off_c]·W1_g1       (G1 block)
            + PE_u(row)·W1_peu + PE_v(col)·W1_pev         (separable PE)
            + lod·W1_lod                                   (constant)

so we precompute ON THE GRID (tiny matmuls, done once per decode):

    P[i,j]  = Σ_off G0[:, i+off0, j+off1]·W1_off   [cells, cells, H]
    C1[i,j] = G1[:, i, j]·W1_g1                    [S1, S1, H]

and the per-pixel first layer becomes a nearest upsample of P plus a
bi/tri-linear sample of C1 plus broadcast row/col PE vectors — all in
H-wide (64) rows. Per-pixel matmul work
drops from 73·H + H·H + H·3 to H·H + H·3 (≈ 2×), and the [N, 73] feature
matrix never exists. Exact to float rounding (verified vs the reference
path in tests/test_fastdecode.py), including the G1 step==2 raw-sum quirk.

Applies to inference/decode (QAT noise is injected pre-layer-1 during
training, which doesn't commute; trainers keep the standard path).
"""

from __future__ import annotations

import itertools


import jax
import jax.numpy as jnp

from nic.core.encodings import sinusoidal_pe, triangular_pe
from nic.grids.sample import EVEN_PARITY_CORNERS_3D, _g1_weights_active

__all__ = ["precompute_first_layer", "first_layer_acc", "fast_decode"]


def _axis_take_up(plane, e: int, n: int, origin, axis: int):
    """plane sampled at floor((origin + arange(n)) * 2^e) along ``axis``.

    When the origin is a static 0 (the full-decode case) the sample pattern
    is a pure upsample/strided-slice — reshape/broadcast and lax.slice,
    which XLA lowers to layout ops instead of a gather."""
    if isinstance(origin, int) and origin == 0:
        if e < 0:
            f = 1 << (-e)
            up = jnp.repeat(plane, f, axis=axis)
            return jax.lax.slice_in_dim(up, 0, n, axis=axis)
        s = 1 << e
        return jax.lax.slice_in_dim(plane, 0, (n - 1) * s + 1, stride=s, axis=axis)
    idx = jnp.floor(
        (jnp.arange(n, dtype=jnp.float32) + origin) * (2.0**e)
    ).astype(jnp.int32)
    return jnp.take(plane, idx, axis=axis)


def precompute_first_layer(fp, fl: int, mlp, *, ndim: int, channels: int,
                           pe_channels: int, sparse_g0: bool = False):
    """Fold W1 into the grids. Returns (P, C1, w1_pe_blocks, w1_lod, b1)."""
    g0 = fp[fl * 2]   # [C, s+1, ...]
    g1 = fp[fl * 2 + 1]
    w1 = mlp["w1"]    # [F, H]
    c = channels
    if sparse_g0:
        g0_offsets = EVEN_PARITY_CORNERS_3D
    else:
        g0_offsets = tuple(itertools.product((0, 1), repeat=ndim))
    n_corners = len(g0_offsets)

    # P[cell] = Σ_off G0[:, cell+off] · W1_block(off); cell counts are
    # per-axis (rectangular grids differ by axis)
    cells = tuple(s - 1 for s in g0.shape[1:])
    p_plane = None
    for k, off in enumerate(g0_offsets):
        w_blk = w1[k * c : (k + 1) * c]  # [C, H]
        sl = g0
        for d, o in enumerate(off):
            sl = jax.lax.slice_in_dim(sl, o, o + cells[d], axis=1 + d)
        term = jnp.tensordot(sl, w_blk, axes=([0], [0]))  # [cells.., H]
        p_plane = term if p_plane is None else p_plane + term

    # C1[node] = G1[:, node] · W1_g1
    w_g1 = w1[n_corners * c : (n_corners + 1) * c]
    c1_plane = jnp.tensordot(g1, w_g1, axes=([0], [0]))  # [S1.., H]

    pe_blocks = []
    base = (n_corners + 1) * c
    for d in range(ndim):
        pe_blocks.append(w1[base + d * pe_channels : base + (d + 1) * pe_channels])
    w_lod = w1[base + ndim * pe_channels]
    return p_plane, c1_plane, pe_blocks, w_lod, mlp["b1"]


def first_layer_acc(
    fp, mlp, mip_level: int, *, image_size: int, mip_to_level: dict,
    pe_channels: int, use_tri_pe: bool = True, ndim: int = 2,
    sparse_g0: bool = False, origin=None, n: int | None = None,
    g1_quirk: bool = True, planes=None,
):
    """The pre-GELU first-layer accumulator [n.., H] of the folded decode
    (everything in :func:`fast_decode` before the MLP tail)."""
    fl = mip_to_level[mip_level]
    e = mip_level - (fl + 1) * 2
    channels = fp[fl * 2].shape[0]
    if n is None:
        n = image_size // (2**mip_level)
    # native rectangular geometry: per-axis sample counts (int = square)
    ns = (n,) * ndim if isinstance(n, int) else tuple(n)
    if origin is None:
        origin = (0,) * ndim

    p_plane, c1_plane, pe_blocks, w_lod, b1 = (
        planes if planes is not None else precompute_first_layer(
            fp, fl, mlp, ndim=ndim, channels=channels,
            pe_channels=pe_channels, sparse_g0=sparse_g0,
        )
    )

    # ---- G0 term: nearest sample of P at floor(t) per axis ----
    h = p_plane
    for d in range(ndim):
        h = _axis_take_up(h, e, ns[d], origin[d], axis=d)
    acc = h  # [n.., H]

    # ---- G1 term: multilinear sample of C1 (or the step==2 raw sum) ----
    step = 2.0**e
    t1s, i1s, f1s = [], [], []
    for d in range(ndim):
        t = (jnp.arange(ns[d], dtype=jnp.float32) + origin[d]) * (step / 2.0)
        i1 = jnp.floor(t).astype(jnp.int32)
        t1s.append(t)
        i1s.append(i1)
        f1s.append(t - i1.astype(jnp.float32))
    weights_on = _g1_weights_active(step, g1_quirk)
    for off in itertools.product((0, 1), repeat=ndim):
        g = c1_plane
        w = None
        for d, o in enumerate(off):
            g = jnp.take(g, i1s[d] + o, axis=d)
            if weights_on:
                fd = f1s[d] if o else (1.0 - f1s[d])
                shape = [1] * (ndim + 1)
                shape[d] = ns[d]
                fd = fd.reshape(shape)
                w = fd if w is None else w * fd
        acc = acc + (g * w if weights_on else g)

    # ---- separable PE terms + lod-folded bias ----
    pe_fn = triangular_pe if use_tri_pe else sinusoidal_pe
    for d in range(ndim):
        table = pe_fn(t1s[d][None, :], pe_channels).T  # [n, PE]
        vec = table @ pe_blocks[d]  # [n, H]
        shape = [1] * (ndim + 1)
        shape[d] = ns[d]
        shape[-1] = vec.shape[-1]
        acc = acc + vec.reshape(shape)
    acc = acc + b1 + float(mip_level) * w_lod
    return acc


def fast_decode(
    fp, mlp, mip_level: int, *, image_size: int, mip_to_level: dict,
    pe_channels: int, use_tri_pe: bool = True, ndim: int = 2,
    sparse_g0: bool = False, origin=None, n: int | None = None,
    g1_quirk: bool = True, planes=None,
):
    """Full (or tile) decode via the folded first layer. Returns
    [n, n(, n), 3]. ``origin``/``n`` select a tile; origins may be static
    python ints (origin 0 gets the pure layout-op sampling path) or traced
    scalars (tiled decode vmaps over a lattice of origins). ``planes`` lets
    a tiled caller pass the :func:`precompute_first_layer` result so the
    fold is done once, not per tile."""
    acc = first_layer_acc(
        fp, mlp, mip_level, image_size=image_size, mip_to_level=mip_to_level,
        pe_channels=pe_channels, use_tri_pe=use_tri_pe, ndim=ndim,
        sparse_g0=sparse_g0, origin=origin, n=n, g1_quirk=g1_quirk,
        planes=planes,
    )

    # ---- layers 2..3 ----
    h = jax.nn.gelu(acc, approximate=False)
    h = jax.nn.gelu(
        jnp.tensordot(h, mlp["w2"], axes=([ndim], [0])) + mlp["b2"],
        approximate=False,
    )
    out = jax.nn.sigmoid(
        jnp.tensordot(h, mlp["w3"], axes=([ndim], [0])) + mlp["b3"]
    )
    return out  # [n.., 3]
