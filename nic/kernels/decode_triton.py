"""Fused NTC decode: one Pallas kernel, compiled through Triton.

The decode runs the folded first layer of :mod:`nic.grids.fastdecode`:
XLA computes the node-resolution planes P = G0·W1 and C1 = G1·W1 and the
per-axis positional-encoding tables folded through W1 (all small). Each
Triton program then takes ``block`` consecutive output pixels (row-major)
and, in registers:

- gathers the pixel's P cell (nearest sample) and its 2^ndim C1 corners
  (multilinear weights, or the reference's step==2 raw sum);
- adds one PE row per axis and the folded bias + LOD term;
- runs GELU → W2 (``pl.dot``) → GELU → W3 → sigmoid;
- writes 3 values per pixel.

``fast_decode`` writes several full-resolution ``[N, H]`` float32 arrays to
device memory instead (accumulator, C1 takes, GELU outputs); the kernel's
only full-resolution traffic is its RGB output. The gathers read the node
planes, which are small enough to stay in L2.

The kernel is ndim-generic (2D images, 3D volumes, sparse or dense G0: the
sparse corner set only changes the P fold) and takes any decode geometry,
thumbnail mips included. A traced ``origin`` selects a tile or a row/frame
block, which is how the sharded decode (:mod:`nic.kernels.decode_sharded`)
splits the output over devices.

Numerics: ``dtype="fp32"`` keeps the planes and all elementwise math in
float32 and runs the W2 product in three bfloat16 tensor-core passes
(:func:`_dot_bf16x3`, relative error ~2⁻¹⁶, float32 accumulation);
``dtype="bf16"`` feeds W2 with plain bfloat16 operands. The XLA fold
around the kernel follows the caller's matmul precision.
GELU is ``"exact"`` (erf through a degree-16 polynomial, |Δerf| ≤ 1.6e-7:
Triton has no erf) or ``"tanh"`` (the tanh approximation).
"""

from __future__ import annotations

import functools
import itertools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from nic.core.encodings import sinusoidal_pe, triangular_pe
from nic.grids.fastdecode import precompute_first_layer
from nic.grids.sample import _g1_weights_active

__all__ = ["decode_fused", "GELUS", "DTYPES"]

# Tests set this to run the kernel in the Pallas interpreter on the CPU.
# Nothing else does: off the GPU a kernel call fails to compile and raises.
INTERPRET = False

DTYPES = ("fp32", "bf16")

# erf(z) ≈ z·p(v), v = 2z²/B² − 1, B = 3.9188 (erf(B) = 1 − 2⁻²⁶):
# degree-16 monomial form of a Chebyshev interpolant of erf(z)/z.
# Max |Δerf| 1.6e-7 in float32 Horner: the float32-exact class.
_ERF_COEFS_V = (
    0.36084712417350057, -0.18016249079808996, 0.1341197098397116,
    -0.1092031839839547, 0.09062792421675198, -0.0739776908469364,
    0.0581495074523071, -0.0435456971886969, 0.030547198182092263,
    -0.019592030398672442, 0.012233327075772783, -0.008136814407460185,
    0.004267563623966739, -0.001049107566569795, 0.0006108818677171472,
    -0.0009324910271702735, 0.0003764209620008347,
)
_ERF_B2 = 3.9188 * 3.9188


def _gelu_exact(x):
    v = x * x * (1.0 / _ERF_B2) - 1.0  # 2z²/B² − 1 with z = x/√2
    acc = jnp.full_like(x, _ERF_COEFS_V[-1])
    for co in _ERF_COEFS_V[-2::-1]:
        acc = acc * v + co
    y = 0.5 * x * (1.0 + (x * 0.7071067811865476) * acc)
    lim = 5.54212  # √2·B: gelu saturates beyond it
    return jnp.where(x > lim, x, jnp.where(x < -lim, 0.0, y))


def _gelu_tanh(x):
    c = 0.7978845608028654  # sqrt(2/pi)
    return 0.5 * x * (1.0 + jnp.tanh(c * (x + 0.044715 * x * x * x)))


GELUS = {"exact": _gelu_exact, "tanh": _gelu_tanh}


def _split_bf16(x):
    hi = x.astype(jnp.bfloat16)
    return hi, (x - hi.astype(jnp.float32)).astype(jnp.bfloat16)


def _dot_bf16x3(a, b):
    """float32 a·b on the tensor cores in three bfloat16 passes
    (hi·hi + hi·lo + lo·hi): 16 mantissa bits of each operand, relative
    error ~2⁻¹⁶ per product, float32 accumulation."""
    a_hi, a_lo = _split_bf16(a)
    b_hi, b_lo = _split_bf16(b)
    return pl.dot(a_lo, b_hi) + pl.dot(a_hi, b_lo) + pl.dot(a_hi, b_hi)


def _kernel(org_ref, p_ref, c1_ref, *rest, ns, p_cells, c1_nodes, e,
            weights_on, block, gelu, bf16):
    ndim = len(ns)
    pe_refs = rest[:ndim]
    const_ref, w2_ref, b2_ref, w3t_ref, b3_ref, out_ref = rest[ndim:]
    npix = math.prod(ns)

    slot = pl.program_id(0) * block + jnp.arange(block, dtype=jnp.int32)
    # the last block's spare lanes decode the last pixel again and write
    # to the output's padding
    p = jnp.minimum(slot, npix - 1)

    # absolute sample coordinate per axis (row-major local index + origin)
    coords = []
    stride = npix
    for d in range(ndim):
        stride //= ns[d]
        coords.append((p // stride) % ns[d] + org_ref[d])

    # G0 term: nearest sample of P at floor(x·2^e)
    p_idx = None
    for d in range(ndim):
        x = coords[d] // (1 << -e) if e <= 0 else coords[d] * (1 << e)
        x = jnp.minimum(x, p_cells[d] - 1)
        p_idx = x if p_idx is None else p_idx * p_cells[d] + x
    acc = p_ref[p_idx, :]

    # G1 term: multilinear sample of C1 at t = x·2^(e-1)
    i1s, frs = [], []
    for d in range(ndim):
        t = coords[d].astype(jnp.float32) * (2.0 ** (e - 1))
        i1 = jnp.floor(t).astype(jnp.int32)
        i1s.append(i1)
        frs.append(t - i1.astype(jnp.float32))
    for off in itertools.product((0, 1), repeat=ndim):
        idx = None
        w = None
        for d, o in enumerate(off):
            x = jnp.minimum(i1s[d] + o, c1_nodes[d] - 1)
            idx = x if idx is None else idx * c1_nodes[d] + x
            if weights_on:
                fd = frs[d] if o else (1.0 - frs[d])
                w = fd if w is None else w * fd
        g = c1_ref[idx, :]
        acc = acc + (g * w[:, None] if weights_on else g)

    # separable PE rows (folded through W1) + bias + LOD term
    for d in range(ndim):
        acc = acc + pe_refs[d][coords[d], :]
    acc = acc + const_ref[...][None, :]

    h = gelu(acc)
    w2 = w2_ref[...]
    if bf16:
        h = pl.dot(h.astype(jnp.bfloat16), w2.astype(jnp.bfloat16))
    else:
        h = _dot_bf16x3(h, w2)
    h = gelu(h + b2_ref[...][None, :])
    for k in range(3):
        v = jnp.sum(h * w3t_ref[k, :][None, :], axis=1) + b3_ref[k]
        out_ref[slot * 3 + k] = jax.nn.sigmoid(v)


def _pad_last(a, size: int):
    pad = size - a.shape[-1]
    if pad == 0:
        return a
    return jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])


def decode_fused(
    fp, mlp, mip_level: int, *, image_size: int, mip_to_level: dict,
    pe_channels: int, use_tri_pe: bool = True, ndim: int = 2,
    sparse_g0: bool = False, g1_quirk: bool = True, n=None, origin=None,
    full_n=None, dtype: str = "fp32", gelu: str = "exact",
    block: int = 128, num_warps: int = 8, num_stages: int = 1,
):
    """Decode [n.., 3] in (0, 1) with the fused kernel — the same
    arguments and result as :func:`nic.grids.fastdecode.fast_decode`.

    ``n`` (int or per-axis tuple) and ``origin`` (per-axis, python ints or
    traced scalars) select a tile; ``full_n`` is the whole decode's
    per-axis extent, which sizes the PE tables when the origin is traced
    (default: ``origin + n`` for static origins).

    The hidden width is zero-padded to a power of two ≥ 16, the shape the
    Triton dot takes; the padded channels stay exactly 0 through the MLP.
    """
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {DTYPES}, got {dtype!r}")
    fl = mip_to_level[mip_level]
    e = mip_level - (fl + 1) * 2
    step = 2.0**e
    if n is None:
        n = image_size // (2**mip_level)
    ns = (n,) * ndim if isinstance(n, int) else tuple(n)
    if origin is None:
        origin = (0,) * ndim
    if full_n is None:
        full_n = tuple(int(o) + s for o, s in zip(origin, ns))
    channels = fp[fl * 2].shape[0]

    p_plane, c1_plane, pe_blocks, w_lod, b1 = precompute_first_layer(
        fp, fl, mlp, ndim=ndim, channels=channels, pe_channels=pe_channels,
        sparse_g0=sparse_g0)
    hidden = p_plane.shape[-1]
    hp = max(16, 1 << (hidden - 1).bit_length())

    pe_fn = triangular_pe if use_tri_pe else sinusoidal_pe
    pe_tables = []
    for d in range(ndim):
        t = jnp.arange(full_n[d], dtype=jnp.float32) * (step / 2.0)
        pe_tables.append(_pad_last(pe_fn(t[None, :], pe_channels).T
                                   @ pe_blocks[d], hp))
    const = _pad_last(b1 + float(mip_level) * w_lod, hp)

    p_cells = tuple(p_plane.shape[:ndim])
    c1_nodes = tuple(c1_plane.shape[:ndim])
    p_flat = _pad_last(p_plane.reshape(-1, hidden), hp)
    c1_flat = _pad_last(c1_plane.reshape(-1, hidden), hp)
    w2 = jnp.pad(mlp["w2"], ((0, hp - hidden), (0, hp - hidden)))
    b2 = _pad_last(mlp["b2"], hp)
    w3t = _pad_last(mlp["w3"].T, hp)  # [3, hp]
    org = jnp.stack([jnp.asarray(o, jnp.int32) for o in origin])

    npix = math.prod(ns)
    grid = pl.cdiv(npix, block)
    kernel = functools.partial(
        _kernel, ns=ns, p_cells=p_cells, c1_nodes=c1_nodes, e=e,
        weights_on=_g1_weights_active(step, g1_quirk),
        block=block, gelu=GELUS[gelu],
        bf16=dtype == "bf16")
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((grid * block * 3,), jnp.float32),
        grid=(grid,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        interpret=INTERPRET,
        name="ntc_decode",
    )(org, p_flat, c1_flat, *pe_tables, const, w2, b2, w3t, mlp["b3"])
    return out[: npix * 3].reshape(ns + (3,))
