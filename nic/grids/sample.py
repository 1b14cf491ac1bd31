"""Grid corner sampling + decoder-input assembly (the hot decode math).

Reimplements the reference's ``create_g0_g1{,_3d,_3d_v2}`` block assembly
(``Projects/fp_def.py:81-223`` + ``Projects/image_compression.py:71-211`` of
21K1113/Neural_Image_Compression_V2) the XLA way:

- instead of flat pointwise gathers over N = n^d coordinates, indices are
  **separable per axis** (every output block is an axis-aligned lattice
  ``floor((arange(n) + origin) * step)``), so each corner is two cheap 1-D
  ``take``s per axis instead of an N-point gather, which XLA lowers to
  strided reads;
- corner order is ``itertools.product((0,1), repeat=ndim)`` over
  (axis0, axis1[, axis2]) offsets, which under the coordinate→grid-axis
  convention below is element-for-element the reference's
  ``g_0..g_3``/``g_0..g_7`` order (fp_def.py:81-104);
- the reference's **G1 unweighted-sum quirk** is reproduced: bilinear /
  trilinear weights are skipped when ``int(1 // (step/2)) == 1`` (i.e.
  step == 2, when G1 coordinates land exactly on grid points — the 4/8
  corners are then summed raw, fp_def.py:136-144); see readme.md:7.

Convention: coordinate k indexes grid axis 1+k of a ``[C, s+1, ...]`` grid
(the reference gathers ``fp[:, y, x]`` with x = crop axis 0 — i.e. its
grids are stored transposed relative to the image; since grids are learned
from init the two conventions define identical function classes; parity
tests account for the transpose).

Decoder-input row layout (features axis), matching
image_compression.py:94-95/126-128/160-162:

    [ G0 corner 0 (C) | ... | G0 corner k (C) | Σ G1 corners (C)
      | PE (pe_channels * ndim) | lod (1) ]
"""

from __future__ import annotations

import functools
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from nic.core.encodings import sinusoidal_pe, triangular_pe

__all__ = [
    "axis_coords",
    "corner_features",
    "corner_features_lattice",
    "corner_features_dense_vjp",
    "interp_weights",
    "apply_g1_weights",
    "decoder_input",
    "effective_pe_flags",
    "EVEN_PARITY_CORNERS_3D",
]


def effective_pe_flags(compression_method: int, ndim: int,
                       tf_use_tri_pe: bool) -> tuple[bool, bool]:
    """The one place the (use_tri_pe, sparse_g0) decode-graph switches are
    derived from (COMPRESSION_METHOD, dimension, TF_USE_TRI_PE) — shared by
    the trainer and the decoder-only runtime so artifacts always decode
    with the graph they were trained with.

    Reference semantics: method 4 uses the sparse 4-corner G0 and hardcodes
    sinusoidal PE (fp_def.py:187-223, :208); 3D method 3 uses triangular PE
    (fp_def.py:148-184); otherwise TF_USE_TRI_PE decides (2D,
    fp_def.py:132-135).
    """
    sparse_g0 = compression_method == 4
    if sparse_g0:
        use_tri_pe = False
    elif ndim == 3:
        use_tri_pe = True
    else:
        use_tri_pe = bool(tf_use_tri_pe)
    return use_tri_pe, sparse_g0

# method-4 sparse G0: the four even-parity cube corners, in the reference's
# order (fp_def.py:107-112 under the coordinate convention above)
EVEN_PARITY_CORNERS_3D = ((0, 0, 0), (0, 1, 1), (1, 0, 1), (1, 1, 0))


def axis_coords(origin, step: float, n: int, dtype=jnp.float32):
    """Continuous G0 coords ``(arange(n) + origin) * step`` along one axis.

    ``origin`` may be traced (crop origins are sampled per step); ``step``
    and ``n`` are static. Returns (t, floor(t) as int32).
    """
    t = (jnp.arange(n, dtype=dtype) + jnp.asarray(origin, dtype=dtype)) * step
    return t, jnp.floor(t).astype(jnp.int32)


def corner_features(grid, idxs, offsets):
    """Gather lattice corners of ``grid`` per axis.

    grid: [C, s0, s1(, s2)]; idxs: per-axis int32 index vectors (len n_k);
    offsets: iterable of 0/1 tuples. Returns {offset: [C, n0, n1(, n2)]}.
    Takes are deduplicated across offsets sharing a prefix, so the 2D
    4-corner case costs 2 + 4 one-axis takes and 3D 8-corner 2 + 4 + 8.
    """
    offsets = [tuple(o) for o in offsets]
    partial_takes = {(): grid}
    ndim = len(idxs)
    for d in range(ndim):
        nxt = {}
        for key in sorted({off[: d + 1] for off in offsets}):
            src = partial_takes[key[:d]]
            nxt[key] = jnp.take(src, idxs[d] + key[d], axis=1 + d)
        partial_takes = nxt
    return {off: partial_takes[off] for off in offsets}


def _axis_take_lattice(src, origin, step: float, n: int, off: int, axis: int):
    """``take(src, floor((arange(n)+origin)·step) + off, axis)`` for an
    integer (traced) ``origin`` and power-of-two static ``step``, as dense
    slice/repeat layout ops.

    Why it exists: ``jnp.take`` with these repeating lattice indices
    differentiates to a scatter-add, which looked like the train step's
    gather bottleneck. It measured slower than take/scatter, forward and
    backward: repeat + dynamic_slice materializes far more bytes than the
    scatter costs. Kept opt-in (``lattice=True``); default off.

    step < 1 callers must pre-pad ``src`` by one trailing node along
    ``axis`` (the covering node window can overshoot the last used node
    by one; a clamped dynamic_slice would otherwise SHIFT the window).
    """
    if step >= 1:
        s = int(step)
        span = (n - 1) * s + 1
        start = [0] * src.ndim
        start[axis] = jnp.asarray(origin, jnp.int32) * s + off
        sl = lax.dynamic_slice_in_dim(src, start[axis], span, axis)
        if s == 1:
            return sl
        idx = [slice(None)] * src.ndim
        idx[axis] = slice(0, span, s)
        return sl[tuple(idx)]
    f = int(round(1.0 / step))
    m = (n - 1) // f + 2  # covering node count for ANY phase
    node_lo = jnp.asarray(origin, jnp.int32) // f
    phase = jnp.asarray(origin, jnp.int32) - node_lo * f
    sl = lax.dynamic_slice_in_dim(src, node_lo + off, m, axis)
    rep = jnp.repeat(sl, f, axis=axis)  # length m·f ≥ phase + n
    return lax.dynamic_slice_in_dim(rep, phase, n, axis)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4, 5, 6))
def _axis_take_dense_vjp(src, origin, m: int, step: float, n: int, off: int,
                         axis: int):
    """``take(src, floor((arange(n)+origin)·step) + off, axis)`` with a
    hand-written dense transpose.

    Forward is the plain take (bit-identical to :func:`corner_features`,
    0.15 ms on the flagship geometry). Backward replaces autodiff's
    scatter-add — ~2.6 ms of the train step — with a phase reshape-sum:
    the crop lattice maps ``f = 1/step`` consecutive pixels to one node,
    so the node cotangent is a dynamic left-shift by the crop phase, a
    ``[..., m_cov, f]`` reshape, and a sum over the phase axis. All ops
    are dense; the only dynamic values are the crop origin's node/phase
    split. (The earlier ``corner_features_lattice`` tried to get this
    VJP by rewriting the FORWARD as slice/repeat and letting XLA
    transpose it — measured 18×/3.8× slower; this keeps the take
    forward and writes the transpose directly.)

    ``m`` is ``src.shape[axis]`` (static, passed explicitly because the
    bwd needs it for shapes); ``origin`` is the traced integer crop
    origin in output-pixel units along this axis.
    """
    _, idx = axis_coords(origin, step, n)
    return jnp.take(src, idx + off, axis=axis)


def _axis_take_dense_fwd(src, origin, m, step, n, off, axis):
    return _axis_take_dense_vjp(src, origin, m, step, n, off, axis), origin


def _axis_take_dense_bwd(m, step, n, off, axis, origin, ybar):
    yb = jnp.moveaxis(ybar, axis, -1)  # [..., n]
    lead = yb.shape[:-1]
    o = jnp.asarray(origin, jnp.int32)
    if step >= 1:
        s = int(step)
        # pixels hit distinct nodes at stride s: interleave with zero
        # columns, then one dynamic placement at origin·s + off
        if s > 1:
            z = jnp.concatenate(
                [yb[..., None], jnp.zeros(lead + (n, s - 1), yb.dtype)], -1
            ).reshape(lead + (n * s,))
        else:
            z = yb
        buf = jnp.zeros(lead + (m + s,), yb.dtype)
        buf = lax.dynamic_update_slice_in_dim(buf, z, o * s + off, -1)
    else:
        f = int(round(1.0 / step))
        mcov = (n - 1) // f + 2  # covering node count for ANY phase
        node_lo = o // f
        phase = o - node_lo * f
        zp = jnp.zeros(lead + (mcov * f,), yb.dtype)
        zp = lax.dynamic_update_slice_in_dim(zp, yb, phase, -1)
        red = zp.reshape(lead + (mcov, f)).sum(-1)
        # +3 tail slots: the covering window may extend past the last
        # node; those slots only ever receive zeros (the zp tail beyond
        # phase+n is zero) and are sliced off below. Sized so the
        # dynamic start is never clamped (no silent shift).
        buf = jnp.zeros(lead + (m + 3,), yb.dtype)
        buf = lax.dynamic_update_slice_in_dim(buf, red, node_lo + off, -1)
    g = jnp.moveaxis(buf[..., :m], -1, axis)
    return g, np.zeros(np.shape(origin), jax.dtypes.float0)


_axis_take_dense_vjp.defvjp(_axis_take_dense_fwd, _axis_take_dense_bwd)


def corner_features_dense_vjp(grid, origins, step: float, n: int, offsets):
    """:func:`corner_features` with the scatter-free hand-written VJP
    (:func:`_axis_take_dense_vjp`) per axis take. Forward bit-identical
    to the take path; requires integer traced origins and a power-of-two
    static step (pass ``step/2`` for the G1 grid)."""
    offsets = [tuple(o) for o in offsets]
    ndim = len(offsets[0])
    partial = {(): grid}
    for d in range(ndim):
        nxt = {}
        for key in sorted({off[: d + 1] for off in offsets}):
            src = partial[key[:d]]
            nxt[key] = _axis_take_dense_vjp(
                src, origins[d], src.shape[1 + d], step, n, key[d], 1 + d)
        partial = nxt
    return {off: partial[off] for off in offsets}


def corner_features_lattice(grid, origins, step: float, n: int, offsets):
    """``corner_features`` specialized to the axis-aligned crop lattice
    (coords ``(arange(n)+origin)·step`` with integer traced origins and a
    power-of-two static step — pass ``step/2`` for the G1 grid): every
    per-axis take becomes a dense slice/repeat (:func:`_axis_take_lattice`)
    whose VJP is scatter-free. Bit-identical forward to the take path."""
    offsets = [tuple(o) for o in offsets]
    ndim = len(offsets[0])
    # one edge-replicated node per axis: for step < 1 the covering node
    # window may overshoot the last USED node by one (value never read);
    # for step ≥ 1 it reproduces take's index-clipping for a +1 overshoot
    # at the boundary. Valid crops never clip (see _axis_take_lattice).
    pad = [(0, 0)] + [(0, 1)] * ndim
    grid = jnp.pad(grid, pad, mode="edge")
    partial = {(): grid}
    for d in range(ndim):
        nxt = {}
        for key in sorted({off[: d + 1] for off in offsets}):
            src = partial[key[:d]]
            nxt[key] = _axis_take_lattice(src, origins[d], step, n, key[d],
                                          1 + d)
        partial = nxt
    return {off: partial[off] for off in offsets}


def interp_weights(fracs, offset):
    """Multilinear weight Π_k (frac_k if offset_k else 1-frac_k), broadcast
    over the lattice. fracs: per-axis [n_k] vectors; returns [n0, n1(, n2)]."""
    ndim = len(fracs)
    w = None
    for d, (f, o) in enumerate(zip(fracs, offset)):
        shape = [1] * ndim
        shape[d] = -1
        fd = (f if o else (1.0 - f)).reshape(shape)
        w = fd if w is None else w * fd
    return w


def _g1_weights_active(step: float, quirk: bool = True) -> bool:
    """The reference's weight gate (fp_def.py:136, :170, :209): weights are
    applied unless ``int(1 // (step/2)) == 1``, i.e. skipped exactly when
    G1 coords are integral with step == 2. ``quirk=False`` always applies
    weights — the likely-intended behavior the reference's readme flags as
    a suspected G0/G1 placement issue (readme.md:7); exposed as the
    TF_G1_QUIRK config flag (default True = reference parity)."""
    if not quirk:
        return True
    return int(1 // (step / 2)) != 1


def apply_g1_weights(corners: dict, fracs, step: float, quirk: bool = True):
    """Σ over G1 corners, multilinearly weighted unless the step==2 quirk
    disables weighting (then the corners are summed raw)."""
    if _g1_weights_active(step, quirk):
        total = None
        for off, g in corners.items():
            w = interp_weights(fracs, off)[None]  # [1, n0, n1(,n2)]
            term = g * w
            total = term if total is None else total + term
        return total
    return sum(corners.values())


def decoder_input(
    fp,
    fl: int,
    origin,
    step: float,
    n: int,
    *,
    pe_channels: int,
    mip_level: int,
    ndim: int = 2,
    use_tri_pe: bool = True,
    sparse_g0: bool = False,
    dtype=jnp.float32,
    g1_quirk: bool = True,
    lattice: bool = False,
    grid_vjp: str = "scatter",
):
    """Assemble decoder-input rows for one n^ndim coordinate block.

    fp: pyramid tuple; fl: static pyramid level; origin: length-ndim traced
    ints (block origin in output-pixel units); step/n static.

    Returns [n^ndim, F] with
    F = C*(num_g0_corners + 1) + pe_channels*ndim + 1.

    Parity: create_decoder_input_2d/3d/_3d_v2 + finally_decode_input_*
    (image_compression.py:71-211) for a single crop; PE uses triangular
    (tri-PE flag, 2D) / triangular (3D method 3) / sinusoidal (method 4 —
    the reference hardcodes sinusoidal there, fp_def.py:208).
    """
    g0_grid = fp[fl * 2]
    g1_grid = fp[fl * 2 + 1]
    c = g0_grid.shape[0]

    ts, i0s = [], []
    for d in range(ndim):
        t, i0 = axis_coords(origin[d], step, n, dtype)
        ts.append(t)
        i0s.append(i0)

    # G0 corners (raw features, fed to the MLP unweighted)
    if sparse_g0:
        g0_offsets = EVEN_PARITY_CORNERS_3D
    else:
        g0_offsets = tuple(itertools.product((0, 1), repeat=ndim))
    g1_offsets = tuple(itertools.product((0, 1), repeat=ndim))

    # crop-lattice specializations (integer origins + power-of-two step):
    # - lattice: dense slice/repeat FORWARD (scatter-free VJP by XLA
    #   transpose) — measured slower than take/scatter, opt-in (see
    #   _axis_take_lattice);
    # - grid_vjp="dense": take forward (bit-identical) + hand-written
    #   phase-reshape-sum backward (see _axis_take_dense_vjp)
    on_lattice = (
        math.log2(step) == int(math.log2(step))
        and jnp.issubdtype(jnp.asarray(origin).dtype, jnp.integer)
    )
    use_lattice = lattice and on_lattice
    use_dense_vjp = grid_vjp == "dense" and on_lattice and not use_lattice
    if use_lattice:
        g0_corners = corner_features_lattice(
            g0_grid, origin, step, n, g0_offsets)
        g1_corners = corner_features_lattice(
            g1_grid, origin, step * 0.5, n, g1_offsets)
    elif use_dense_vjp:
        g0_corners = corner_features_dense_vjp(
            g0_grid, origin, step, n, g0_offsets)
        g1_corners = corner_features_dense_vjp(
            g1_grid, origin, step * 0.5, n, g1_offsets)
    else:
        g0_corners = corner_features(g0_grid, i0s, g0_offsets)

    # G1 at half resolution: gather + (quirk-gated) multilinear combine
    t1s = [t / 2.0 for t in ts]
    i1s = [jnp.floor(t1).astype(jnp.int32) for t1 in t1s]
    f1s = [t1 - i1.astype(dtype) for t1, i1 in zip(t1s, i1s)]
    if not use_lattice and not use_dense_vjp:
        g1_corners = corner_features(g1_grid, i1s, g1_offsets)
    g1_sum = apply_g1_weights(g1_corners, f1s, step, g1_quirk)  # [C, n0.. ]

    # PE over the continuous G1-resolution coordinates, flattened axis0-major
    mesh = jnp.meshgrid(*t1s, indexing="ij")
    coords = jnp.stack([m.reshape(-1) for m in mesh])  # [ndim, n^ndim]
    if use_tri_pe:
        pe = triangular_pe(coords, pe_channels)
    else:
        pe = sinusoidal_pe(coords, pe_channels)
    pe = pe.astype(dtype)  # [pe_channels*ndim, N]

    npts = n**ndim
    lod_plane = jnp.full((1, npts), float(mip_level), dtype=dtype)

    feats = [g0_corners[off].reshape(c, npts) for off in g0_offsets]
    feats.append(g1_sum.reshape(c, npts))
    feats.append(pe)
    feats.append(lod_plane)
    return jnp.concatenate(feats, axis=0).T  # [N, F]
