"""Scale-hyperprior entropy model for rate–distortion training.

A north-star EXTENSION beyond the reference
(21K1113/Neural_Image_Compression_V2 has no entropy model anywhere —
SURVEY.md §0 discrepancy note): the reference's rate is fixed-length
``num_bits`` quantization; this module adds the learned-rate path from
the original north star — a Ballé-style scale hyperprior:

    y = g_a(x)            analysis transform (strided convs)
    z = h_a(|y|)          hyper-analysis
    ẑ ~ factorized prior  (per-channel logistic CDF)
    σ = h_s(ẑ)            hyper-synthesis → per-element Gaussian scales
    ŷ ~ N(0, σ)           conditional prior
    x̂ = g_s(ŷ)           synthesis transform

Training relaxes quantization to additive uniform noise (the same trick
the reference uses for its fixed-rate QAT, image_comp.py:88-91) and
minimizes R + λ·255²·D. Rates are exact code lengths under the priors
(−log2 of the noise-relaxed likelihoods); the real host-side bitstream
(rANS over the prior CDF tables, nic/io/entropy.py) round-trips in
tests/test_hyperprior.py and its measured size matches the estimate.

All transforms are flax.linen with NHWC layouts; GELU in place of GDN
(GDN's per-channel normalization is a poor fit for matrix units; GELU convs
reach similar RD in practice at these model sizes).
"""

from __future__ import annotations

import math

import flax.linen as nn
import jax
import jax.numpy as jnp

__all__ = ["HyperpriorModel", "rd_loss", "estimate_bits"]

_HALF_LOG2E = math.log2(math.e)


def _std_normal_cdf(x):
    return 0.5 * (1.0 + jax.lax.erf(x / math.sqrt(2.0)))


def gaussian_bits(y, scale):
    """−log2 P(y ∈ [y−½, y+½)) under N(0, scale²); y noise-relaxed."""
    scale = jnp.maximum(scale, 1e-6)
    upper = _std_normal_cdf((y + 0.5) / scale)
    lower = _std_normal_cdf((y - 0.5) / scale)
    return -jnp.log2(jnp.maximum(upper - lower, 1e-12))


def logistic_bits(z, mu, log_s):
    """−log2 P(z ∈ [z−½, z+½)) under a per-channel logistic prior — the
    factorized entropy bottleneck (one (μ, s) pair per channel)."""
    s = jnp.exp(log_s)
    upper = jax.nn.sigmoid((z + 0.5 - mu) / s)
    lower = jax.nn.sigmoid((z - 0.5 - mu) / s)
    return -jnp.log2(jnp.maximum(upper - lower, 1e-12))


# transforms use im2col matmul convs (nic.models.matmul_conv), which
# trained to a better loss than the conv primitive on the accelerator the
# family was first built on (ROADMAP: whether lax.conv now matches is
# open). Downsampling convs are
# k5 s2 pad2 (symmetric-pad twin of SAME); upsampling uses k4 s2 —
# exactly 2× and checkerboard-free.


class Analysis(nn.Module):
    n: int = 128
    m: int = 192

    @nn.compact
    def __call__(self, x):  # [B, H, W, 3] → [B, H/16, W/16, M]
        from nic.models.matmul_conv import MatmulConv

        for ch in (self.n, self.n, self.n):
            x = MatmulConv(ch, 5, 2, 2)(x)
            x = nn.gelu(x)
        return MatmulConv(self.m, 5, 2, 2)(x)


class Synthesis(nn.Module):
    n: int = 128
    # bf16 MXU inputs (fp32 accumulation) for the decode hot path — the
    # dots are ~95% of the synthesis device time; reconstruction-only
    # (never touches the bitstream), so the codec can enable it without
    # any stream-format impact. None = fp32 dots (training default).
    mxu_dtype: type | None = None

    @nn.compact
    def __call__(self, y):  # [B, H/16, W/16, M] → [B, H, W, 3]
        from nic.models.matmul_conv import MatmulConvTranspose

        for ch in (self.n, self.n, self.n):
            y = MatmulConvTranspose(ch, 4, 2, 1, 0,
                                    mxu_dtype=self.mxu_dtype)(y)
            y = nn.gelu(y)
        return MatmulConvTranspose(3, 4, 2, 1, 0,
                                   mxu_dtype=self.mxu_dtype)(y)


class HyperAnalysis(nn.Module):
    n: int = 128

    @nn.compact
    def __call__(self, y):  # [B, h, w, M] → [B, h/4, w/4, N]
        from nic.models.matmul_conv import MatmulConv

        z = MatmulConv(self.n, 3, 1, 1)(jnp.abs(y))
        z = nn.gelu(z)
        z = MatmulConv(self.n, 5, 2, 2)(z)
        z = nn.gelu(z)
        return MatmulConv(self.n, 5, 2, 2)(z)


class HyperSynthesis(nn.Module):
    """σ scales from the quantized hyper-latent.

    ENTROPY-CODING DETERMINISM BOUNDARY: σ selects the rANS coding bin
    for every y symbol (``HyperpriorCodec._h_s_bins``), so compress and
    decompress must compute the numerically IDENTICAL σ — across
    processes, env settings, and code versions — or the y-stream
    desyncs at any value sitting on a bin edge. The transposed convs
    therefore PIN ``sumdot=True`` (the canonical accumulation order;
    also the shipped default and the order behind the committed round-5
    stream artifacts) instead of following the ``NIC_CT_SUMDOT`` A/B
    toggle, which stays available for the reconstruction-only
    ``Synthesis`` stage where numerics never touch the bitstream —
    the same rule that keeps ``mxu_dtype`` out of this path.
    """

    n: int = 128
    m: int = 192

    @nn.compact
    def __call__(self, z):  # [B, h/4, w/4, N] → σ [B, h, w, M]
        from nic.models.matmul_conv import MatmulConv, MatmulConvTranspose

        s = MatmulConvTranspose(self.n, 4, 2, 1, 0, sumdot=True)(z)
        s = nn.gelu(s)
        s = MatmulConvTranspose(self.n, 4, 2, 1, 0, sumdot=True)(s)
        s = nn.gelu(s)
        s = MatmulConv(self.m, 3, 1, 1)(s)
        return jnp.exp(s)  # positive scales


class HyperpriorModel(nn.Module):
    """End-to-end scale-hyperprior codec."""

    n: int = 128
    m: int = 192
    # decode-path option: bf16 MXU inputs in the synthesis transform
    # (parameters unchanged — a second model instance with this set can
    # apply the SAME trained params; see HyperpriorCodec)
    synthesis_mxu_dtype: type | None = None

    def setup(self):
        self.g_a = Analysis(self.n, self.m)
        self.g_s = Synthesis(self.n, mxu_dtype=self.synthesis_mxu_dtype)
        self.h_a = HyperAnalysis(self.n)
        self.h_s = HyperSynthesis(self.n, self.m)
        # factorized-prior parameters, one (μ, log s) per z channel
        self.z_mu = self.param("z_mu", nn.initializers.zeros, (self.n,))
        self.z_log_s = self.param("z_log_s", nn.initializers.zeros, (self.n,))

    def __call__(self, x, key=None):
        """Noise-relaxed forward. Returns (x̂, y_bits, z_bits) with bits
        summed per batch element."""
        y = self.g_a(x)
        z = self.h_a(y)
        if key is not None:
            ky, kz = jax.random.split(key)
            y_t = y + jax.random.uniform(ky, y.shape, y.dtype, -0.5, 0.5)
            z_t = z + jax.random.uniform(kz, z.shape, z.dtype, -0.5, 0.5)
        else:
            y_t = jnp.round(y)
            z_t = jnp.round(z)
        sigma = self.h_s(z_t)
        x_hat = self.g_s(y_t)
        y_bits = jnp.sum(gaussian_bits(y_t, sigma), axis=(1, 2, 3))
        z_bits = jnp.sum(
            logistic_bits(z_t, self.z_mu, self.z_log_s), axis=(1, 2, 3)
        )
        return x_hat, y_bits, z_bits

    def compress_eval(self, x):
        """Hard-quantized round trip → (x̂, total_bits per element)."""
        return self(x, key=None)

    # submodule entry points for the bitstream codec (nic.io.entropy)
    def analysis(self, x):
        return self.g_a(x)

    def hyper_analysis(self, y):
        return self.h_a(y)

    def hyper_synthesis(self, z_hat):
        return self.h_s(z_hat)

    def synthesis(self, y_hat):
        return self.g_s(y_hat)

    def z_prior_params(self):
        return self.z_mu, self.z_log_s


def rd_loss(x_hat, x, y_bits, z_bits, lam: float):
    """λ·255²·MSE + bpp (per-pixel rate)."""
    num_pixels = x.shape[1] * x.shape[2]
    bpp = jnp.mean((y_bits + z_bits) / num_pixels)
    mse = jnp.mean((x_hat - x) ** 2)
    return lam * (255.0**2) * mse + bpp, bpp, mse


def estimate_bits(y_bits, z_bits, num_pixels: int):
    return float(jnp.mean((y_bits + z_bits))) / num_pixels
