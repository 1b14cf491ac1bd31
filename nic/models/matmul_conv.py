"""Conv / transposed-conv implemented as explicit im2col + matmuls.

Motivation: on the accelerator this family was first built on, the
conv-AE trained to a far worse loss through the convolution primitive
than the same code on the CPU. These modules express the identical math
through pad/slice/concat + ``jnp.dot`` only (with well-defined
``preferred_element_type=float32`` accumulation), avoiding the
convolution primitive entirely. Whether ``lax.conv`` trains as well on
the GPU is an open ROADMAP item.

- :class:`MatmulConv`: k×k, stride s, torch-style symmetric padding —
  patches are gathered as k² strided slices and contracted in one dot.
- :class:`MatmulConvTranspose`: torch ConvTranspose(k, s, p, op) via
  zero-insertion upsampling followed by a stride-1 MatmulConv with the
  flipped kernel (the textbook equivalence), so shapes match
  nic.models.autoencoder exactly.
"""

from __future__ import annotations

import flax.linen as nn
import jax.numpy as jnp

__all__ = ["MatmulConv", "MatmulConvTranspose"]


import itertools
import os


def _im2col(x, k: int, stride: int, pad_lo: int, pad_hi: int):
    """[B, *spatial, C] → [B, *out_spatial, kⁿ·C] patches (torch conv
    geometry), for 2D or 3D spatial dims.

    stride == 1 gathers kⁿ contiguous slices. stride > 1 goes through a
    polyphase (space-to-depth) decomposition: the padded input is
    reshaped into sⁿ phase planes and every kernel tap becomes a
    CONTIGUOUS slice of one plane — no strided slices at all, the layout
    XLA tiles best. Bit-exact vs the slicing
    form (pure data movement, same concat order)."""
    ndim = x.ndim - 2
    s = stride
    dims = x.shape[1:-1]
    outs = [(d + pad_lo + pad_hi - k) // s + 1 for d in dims]
    if s == 1:
        pad = ((0, 0),) + ((pad_lo, pad_hi),) * ndim + ((0, 0),)
        x = jnp.pad(x, pad)
        parts = []
        for offs in itertools.product(range(k), repeat=ndim):
            sl = [slice(None)]
            for d, o in enumerate(offs):
                sl.append(slice(o, o + outs[d]))
            sl.append(slice(None))
            parts.append(x[tuple(sl)])
        return jnp.concatenate(parts, axis=-1)  # [B, *out, kⁿ·C]

    m = (k - 1) // s + 1  # tap window size over each phase plane
    P = []  # padded size per axis: multiple of s, planes cover out+m-1
    for o, d in zip(outs, dims):
        p = max((o + m - 1) * s, d + pad_lo + pad_hi)
        P.append(-(-p // s) * s)
    pad = ((0, 0),) + tuple(
        (pad_lo, Pd - d - pad_lo) for Pd, d in zip(P, dims)
    ) + ((0, 0),)
    x = jnp.pad(x, pad)
    B, C = x.shape[0], x.shape[-1]
    shape = [B]
    for Pd in P:
        shape += [Pd // s, s]
    shape.append(C)
    # [B, n1, s, n2, s(, n3, s), C] → [B, n1, n2(, n3), s, s(, s), C]
    perm = ([0] + [1 + 2 * d for d in range(ndim)]
            + [2 + 2 * d for d in range(ndim)] + [1 + 2 * ndim])
    ph = x.reshape(shape).transpose(perm)
    parts = []
    for offs in itertools.product(range(k), repeat=ndim):
        idx = [slice(None)]
        for d, a in enumerate(offs):
            idx.append(slice(a // s, a // s + outs[d]))
        for a in offs:
            idx.append(a % s)
        idx.append(slice(None))
        parts.append(ph[tuple(idx)])
    return jnp.concatenate(parts, axis=-1)  # [B, *out, kⁿ·C]


class MatmulConv(nn.Module):
    """n-D (2D/3D) conv as im2col + dot; torch-style symmetric padding."""

    features: int
    kernel: int = 3
    stride: int = 2
    padding: int = 1
    dtype: type = jnp.float32
    # feed the MXU dots in this dtype (fp32 accumulation stays) — the
    # conv analogue of the NTC trainer's MLP_NUM_DTYPE=16 split; params
    # and elementwise math keep ``dtype``. None = dots in ``dtype``.
    mxu_dtype: type | None = None

    @nn.compact
    def __call__(self, x):
        c_in = x.shape[-1]
        ndim = x.ndim - 2
        w = self.param(
            "kernel", nn.initializers.lecun_normal(),
            (self.kernel**ndim * c_in, self.features), self.dtype,
        )
        b = self.param("bias", nn.initializers.zeros, (self.features,), self.dtype)
        patches = _im2col(x.astype(self.dtype), self.kernel, self.stride,
                          self.padding, self.padding)
        if self.mxu_dtype is not None:
            patches = patches.astype(self.mxu_dtype)
            w = w.astype(self.mxu_dtype)
        return jnp.dot(patches, w, preferred_element_type=jnp.float32).astype(
            self.dtype
        ) + b


def _phase_taps(k: int, s: int, p: int, r: int):
    """1-D polyphase geometry for output phase ``r`` of a transposed conv:
    the kernel tap indices that land on real (non-inserted-zero) inputs,
    and the input offset ``d`` such that out[s·u + r] = Σ_a x[u + d + a] ·
    w[taps[a]]."""
    pad_lo = k - 1 - p
    j0 = (pad_lo - r) % s
    taps = list(range(j0, k, s))
    d = (r + j0 - pad_lo) // s
    return taps, d


def _conv_transpose_zero_insertion(x, w, k, s, p, op, features):
    """Reference lowering (zero-insert + stride-1 im2col conv): exact but
    materializes kⁿ·C patches at the UPSAMPLED resolution — kept for the
    parity test; the polyphase path below computes the identical function
    with s^n× less patch volume."""
    c_in = x.shape[-1]
    ndim = x.ndim - 2
    up_shape = (x.shape[0],) + tuple(
        (x.shape[1 + d] - 1) * s + 1 for d in range(ndim)
    ) + (c_in,)
    up = jnp.zeros(up_shape, x.dtype)
    idx = (slice(None),) + (slice(None, None, s),) * ndim + (slice(None),)
    up = up.at[idx].set(x)
    pad_lo = k - 1 - p
    pad_hi = pad_lo + op
    pad = ((0, 0),) + ((pad_lo, pad_hi),) * ndim + ((0, 0),)
    up = jnp.pad(up, pad)
    patches = _im2col(up, k, 1, 0, 0)
    return jnp.dot(patches, w, preferred_element_type=jnp.float32).astype(x.dtype)


def _conv_transpose_polyphase(x, w, k, s, p, op, features,
                              mxu_dtype=None, sumdot=None):
    """torch ConvTranspose(k, s, p, output_padding=op) via the exact
    polyphase (subpixel) decomposition: each of the s^n output phases is a
    stride-1 conv AT INPUT RESOLUTION over the ≤⌈k/s⌉^n kernel taps that
    hit real inputs; phases are then interleaved (depth-to-space). Bitwise
    the same function as zero-insertion + stride-1 conv, with none of the
    multiply-by-zero work or upsampled-resolution im2col traffic (s^n
    small dense dots instead of one sparse large one)."""
    c_in = x.shape[-1]
    ndim = x.ndim - 2
    ins = [x.shape[1 + d] for d in range(ndim)]
    outs = [(i - 1) * s - 2 * p + k + op for i in ins]
    u_cap = [-(-o // s) for o in outs]  # padded per-phase length

    # w rows are laid out offset-major (itertools.product order), blocks
    # of c_in rows per kernel offset — same layout as MatmulConv/_im2col
    strides_q = [k ** (ndim - 1 - d) for d in range(ndim)]

    phases = []
    for r in itertools.product(range(s), repeat=ndim):
        geo = [_phase_taps(k, s, p, r[d]) for d in range(ndim)]
        o_r = [max(0, -(-(outs[d] - r[d]) // s)) for d in range(ndim)]
        # pad x so every tap read u + d + a stays in bounds
        pad = [(0, 0)]
        srcs = []
        for d in range(ndim):
            taps, off = geo[d]
            lo = max(0, -off)
            hi = max(0, (o_r[d] - 1) + off + len(taps) - 1 - (ins[d] - 1))
            pad.append((lo, hi))
            srcs.append((taps, off + lo))
        pad.append((0, 0))
        xp = jnp.pad(x, pad)
        # gather the per-phase patches: one slice per tap combination
        parts = []
        rows = []
        for combo in itertools.product(*[range(len(t)) for t, _ in srcs]):
            sl = [slice(None)]
            q = 0
            for d, a in enumerate(combo):
                taps, start = srcs[d]
                sl.append(slice(start + a, start + a + o_r[d]))
                q += taps[a] * strides_q[d]
            sl.append(slice(None))
            parts.append(xp[tuple(sl)])
            rows.append(q)
        use_sumdot = (sumdot if sumdot is not None
                      else os.environ.get("NIC_CT_SUMDOT", "1") != "0")
        if use_sumdot:
            # tap-sum form: one dot PER TAP, accumulated — the [.., taps·C]
            # patch concat (taps× the activation volume, written then
            # re-read by the big dot) never materializes. Same FLOPs,
            # ~taps× less patch traffic; bitwise equal per-tap dots, sum
            # order differs from the single fused dot only in fp32
            # addition order (round-5; the hyperprior synthesis stage
            # measured dot-bound on traffic, not MXU throughput).
            # ``sumdot`` pins the path explicitly: numerics forks must not
            # sit under entropy-coding determinism boundaries (the
            # hyperprior σ→bin map pins sumdot=True; the env var remains
            # an A/B toggle for reconstruction-only stages).
            ph = None
            for part, q in zip(parts, rows):
                w_blk = w[q * c_in : (q + 1) * c_in]
                if mxu_dtype is not None:
                    part = part.astype(mxu_dtype)
                    w_blk = w_blk.astype(mxu_dtype)
                t = jnp.dot(part, w_blk, preferred_element_type=jnp.float32)
                ph = t if ph is None else ph + t
            ph = ph.astype(x.dtype)
        else:
            patches = jnp.concatenate(parts, axis=-1)
            w_rows = jnp.concatenate(
                [w[q * c_in : (q + 1) * c_in] for q in rows], axis=0
            )
            if mxu_dtype is not None:
                patches = patches.astype(mxu_dtype)
                w_rows = w_rows.astype(mxu_dtype)
            ph = jnp.dot(patches, w_rows,
                         preferred_element_type=jnp.float32).astype(x.dtype)
        # pad phase to the common per-phase grid for interleaving
        ppad = [(0, 0)] + [(0, u_cap[d] - o_r[d]) for d in range(ndim)] + [(0, 0)]
        phases.append(jnp.pad(ph, ppad))

    # interleave: [s^n, B, U..., F] → [B, U1, s, U2, s, ..., F] → crop
    st = jnp.stack(phases).reshape(
        (s,) * ndim + (x.shape[0],) + tuple(u_cap) + (features,)
    )
    perm = (ndim,) + tuple(
        a for d in range(ndim) for a in (ndim + 1 + d, d)
    ) + (2 * ndim + 1,)
    out = st.transpose(perm).reshape(
        (x.shape[0],) + tuple(s * u for u in u_cap) + (features,)
    )
    crop = (slice(None),) + tuple(slice(0, o) for o in outs) + (slice(None),)
    return out[crop]


class MatmulConvTranspose(nn.Module):
    """torch ConvTranspose(k, s, p, output_padding=op) ≡ insert (s−1) zeros
    between inputs, pad (k−1−p) [+op on the high side], stride-1 conv —
    computed via the exact polyphase decomposition (see
    :func:`_conv_transpose_polyphase`)."""

    features: int
    kernel: int = 3
    stride: int = 2
    padding: int = 1
    output_padding: int = 1
    dtype: type = jnp.float32
    mxu_dtype: type | None = None  # see MatmulConv.mxu_dtype
    # None = follow NIC_CT_SUMDOT (default on); True/False pin the
    # polyphase accumulation order regardless of the env toggle. Pin it
    # wherever the output feeds an entropy-coding decision (bin
    # selection) — stream compatibility must not depend on an env var.
    sumdot: bool | None = None

    @nn.compact
    def __call__(self, x):
        c_in = x.shape[-1]
        ndim = x.ndim - 2
        w = self.param(
            "kernel", nn.initializers.lecun_normal(),
            (self.kernel**ndim * c_in, self.features), self.dtype,
        )
        b = self.param("bias", nn.initializers.zeros, (self.features,), self.dtype)
        out = _conv_transpose_polyphase(
            x.astype(self.dtype), w, self.kernel, self.stride, self.padding,
            self.output_padding, self.features, mxu_dtype=self.mxu_dtype,
            sumdot=self.sumdot,
        )
        return out + b
