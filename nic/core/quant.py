"""Fixed-point quantization core.

Semantics parity with the reference repo's quantizer
(``Projects/models.py:5-71`` of 21K1113/Neural_Image_Compression_V2):

- the rounding rule is ``floor(x * (2^b - 1) + 0.5) / (2^b - 1)`` — i.e.
  round-half-up on the (2^b - 1)-level code book, NOT banker's rounding
  (``jnp.round`` would round half-to-even and disagree on exact .5 codes);
- grid ("feature pyramid") values live in the zero-centred range
  ``[-(2^b - 1)/2^(b+1), 1/2]`` and are stored as unsigned codes with offset
  ``2^(b-1) - 1`` (``models.py:61-71``);
- QAT uses additive uniform noise of amplitude ``±1/2^(b+1)``
  (``image_compression.py:248-254``).

All functions are pure jnp and safe under jit/vmap/grad. ``quantize`` has
zero gradient (floor), matching the reference; ``quantize_ste`` is the
straight-through variant (new, opt-in — the reference has no STE).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "scale_to_bit",
    "normalize_from_bit",
    "quantize",
    "quantize_ste",
    "quantize_to_bit",
    "quantize_from_bit_to_bit",
    "quant_range",
    "quantize_clamp",
    "qat_noise",
    "pack_grid",
    "unpack_grid",
    "pack_bits",
    "unpack_bits",
    "code_dtype",
]


def scale_to_bit(x, bits: int = 8):
    """[0,1] → [0, 2^b - 1]  (models.py:5-7)."""
    return x * (2.0**bits - 1.0)


def normalize_from_bit(x, bits: int = 8):
    """[0, 2^b - 1] → [0,1]  (models.py:11-13)."""
    return x / (2.0**bits - 1.0)


def quantize(x, bits: int):
    """Round-half-up onto the (2^b - 1)-level code book; in/out in [0,1].

    Parity: models.py:17-19 (``quantize_torch``) / :23-25 / :29-35 / :55-57.
    Gradient is zero (floor), as in the reference.
    """
    s = 2.0**bits - 1.0
    return jnp.floor(x * s + 0.5) / s


def quantize_ste(x, bits: int):
    """``quantize`` with a straight-through gradient (identity). New feature."""
    return x + jax.lax.stop_gradient(quantize(x, bits) - x)


def quantize_to_bit(x, bits: int = 8):
    """[0,1] → quantized codes scaled to [0, 2^b - 1]  (models.py:39-40)."""
    return scale_to_bit(quantize(x, bits), bits)


def quantize_from_bit_to_bit(x, bits: int):
    """[0, 2^b - 1] → re-quantized [0, 2^b - 1]  (models.py:44-45)."""
    return scale_to_bit(quantize(normalize_from_bit(x, bits), bits), bits)


def quant_range(bits: int) -> tuple[float, float]:
    """Zero-centred grid value range [q_min, q_max]  (models.py:48-51).

    q_min = -(2^b - 1)/2^(b+1), q_max = 1/2. The (2^b) representable codes
    step by 1/(2^b - 1) across this range.
    """
    q_min = -(2.0**bits - 1.0) / 2.0 ** (bits + 1)
    q_max = 0.5
    return q_min, q_max


def quantize_clamp(x, bits: int):
    """Clamp to the grid quantizer range  (models.py:48-51, fp_def.py:227-232)."""
    q_min, q_max = quant_range(bits)
    return jnp.clip(x, q_min, q_max)


def qat_noise(key, shape, bits: int, dtype=jnp.float32):
    """Uniform QAT noise in (−1/2^(b+1), +1/2^(b+1)).

    Parity: ``(torch.rand_like(x) - 0.5) / 2**bits``
    (image_compression.py:250, image_comp.py:90).
    """
    return (jax.random.uniform(key, shape, dtype=dtype) - 0.5) / (2.0**bits)


def pack_grid(x, bits: int):
    """Grid values → unsigned uint8 codes (``save4fp``, models.py:61-64).

    code = floor(x*(2^b - 1) + 0.5) + 2^(b-1) - 1, which maps the clamped
    range [q_min, q_max] onto [0, 2^b - 1].
    """
    s = 2.0**bits - 1.0
    code = jnp.floor(x * s + 0.5) + (2 ** (bits - 1) - 1)
    return code.astype(jnp.uint8)


def unpack_grid(code, bits: int, dtype=jnp.float32):
    """Inverse of :func:`pack_grid` (``load4fp``, models.py:68-71)."""
    x = code.astype(dtype) - (2 ** (bits - 1) - 1)
    return x / (2.0**bits - 1.0)


def code_dtype(bits: int):
    """Smallest numpy dtype for b-bit codes (utils.py:316-328 semantics)."""
    if bits <= 8:
        return np.uint8
    if bits <= 16:
        return np.uint16
    return np.uint32


# ---------------------------------------------------------------------------
# Sub-byte bit packing (framework extension — the reference always stores one
# uint8 per code regardless of FP_BITS, fp_def.py:250-255, wasting 8/b× space;
# the bpp accounting counts true bits, so we actually pack).
# Host-side numpy: artifact I/O stays off-device.
# ---------------------------------------------------------------------------


def pack_bits(codes: np.ndarray, bits: int) -> np.ndarray:
    """Pack an array of b-bit codes (any shape) into a flat uint8 byte stream.

    TRUE bit stream: code i occupies absolute bits [i·b, (i+1)·b),
    LSB-first, straddling byte boundaries when b ∤ 8 — the payload is
    exactly ``ceil(count·b / 8)`` bytes for every b ∈ [1, 8], so the bpp
    accounting counts real payload bytes at any bit width.
    Layout matches the native ``nic_pack_bits`` exactly (artifacts are
    interchangeable between builds), and for b | 8 (1, 2, 4, 8 — the
    reference's sweep grid) it coincides with the historical
    codes-per-byte layout, so old artifacts stay readable.
    """
    codes = np.asarray(codes).reshape(-1).astype(np.uint8)
    if bits >= 8:
        return codes
    # bit j of code i → stream bit i·bits + j
    bitmat = (codes[:, None] >> np.arange(bits, dtype=np.uint8)) & 1
    return np.packbits(bitmat.reshape(-1), bitorder="little")


def unpack_bits(packed: np.ndarray, bits: int, count: int) -> np.ndarray:
    """Inverse of :func:`pack_bits`; returns ``count`` codes as uint8."""
    packed = np.asarray(packed, dtype=np.uint8).reshape(-1)
    if bits >= 8:
        return packed[:count]
    stream = np.unpackbits(packed, bitorder="little")[: count * bits]
    bitmat = stream.reshape(count, bits).astype(np.uint8)
    return (bitmat * (1 << np.arange(bits, dtype=np.uint8))).sum(
        axis=1
    ).astype(np.uint8)
