"""Image/video quality metrics and tensor health audits.

Parity notes vs the reference (21K1113/Neural_Image_Compression_V2):

- ``psnr`` defaults to the reference's convention ``max = 2^bits`` (= 256
  for 8-bit, ``Projects/utils.py:117-130``), which inflates PSNR by
  ``20*log10(256/255) ≈ 0.034 dB`` vs the standard 255 convention the
  author later standardized on (memo.txt:17-24). Pass ``max_value=255.0``
  for the standard number.
- ``average_psnr`` is the per-frame mean (utils.py:134-145).
- ``safe_statistics`` mirrors utils.py:149-181 (max/min/mean/var over
  finite values + NaN/Inf flags) but returns a dict instead of printing.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = ["mse", "psnr", "average_psnr", "safe_statistics"]


def mse(a, b):
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    return jnp.mean((a - b) ** 2)


def psnr(original, reconstructed, num_bits: int = 8, max_value: float | None = None):
    """PSNR in dB. ``max_value=None`` → reference convention 2^num_bits."""
    if max_value is None:
        max_value = float(2**num_bits)
    m = mse(original, reconstructed)
    return jnp.where(
        m == 0,
        jnp.inf,
        10.0 * jnp.log10(max_value * max_value / jnp.maximum(m, 1e-30)),
    )


def average_psnr(original_video, reconstructed_video, num_bits: int = 8,
                 max_value: float | None = None):
    """Mean of per-frame PSNR over the leading (frame) axis (utils.py:134-145)."""
    original_video = jnp.asarray(original_video)
    reconstructed_video = jnp.asarray(reconstructed_video)
    n = original_video.shape[0]
    vals = [
        psnr(original_video[i], reconstructed_video[i], num_bits, max_value)
        for i in range(n)
    ]
    return jnp.mean(jnp.stack(vals))


def safe_statistics(x) -> dict:
    """Finite-value stats + NaN/Inf flags (utils.py:149-181 semantics)."""
    x = np.asarray(x)
    finite = x[np.isfinite(x)]
    stats: dict = {
        "has_nan": bool(np.isnan(x).any()),
        "has_inf": bool(np.isinf(x).any()),
        "num_valid": int(finite.size),
    }
    if finite.size:
        stats.update(
            max=float(finite.max()),
            min=float(finite.min()),
            mean=float(finite.mean()),
            var=float(finite.var(ddof=1)) if finite.size > 1 else 0.0,
        )
    return stats
