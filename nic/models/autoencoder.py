"""Conv autoencoders (2D / 3D) for the whole-asset compression family.

Function-class parity with the reference's inline ``ColorEncoder`` /
``ColorDecoder`` modules (21K1113/Neural_Image_Compression_V2):

- ``image_comp.py:32-59`` — Conv(3→16, k3 s2 p1) ReLU, Conv(16→8) Sigmoid;
  ConvT(8→16, k3 s2 p1 op1) ReLU, ConvT(16→3) Sigmoid;
- ``pixel_comp.py:35-47`` — same encoder but first conv pads 2, yielding a
  (S/4 + 1)² corner-lattice latent that the per-pixel MLP decoder slices
  2×2 patches from;
- ``movie_3d_comp.py:44-71`` — the Conv3d/ConvTranspose3d analogue
  (3→32→16, 16→32→3).

Implemented in flax.linen with **explicit torch-style padding** so latent
shapes match exactly (SAME padding would disagree on the pixel_comp 257→129
lattice). NHWC/NDHWC layouts; entry points convert from the
host CHW arrays once per run.
"""

from __future__ import annotations

from collections.abc import Sequence

import flax.linen as nn
import jax.numpy as jnp

__all__ = [
    "ConvEncoder2D",
    "ConvDecoder2D",
    "ConvEncoder3D",
    "ConvDecoder3D",
    "PixelLatentEncoder",
]


def _pad(ndim: int, p: int) -> Sequence[tuple[int, int]]:
    return tuple((p, p) for _ in range(ndim))


class ConvEncoder2D(nn.Module):
    """3 → hidden → latent, each k3 s2 p1; Sigmoid head keeps the latent in
    (0,1) for the fixed-point quantizer (image_comp.py:32-44)."""

    latent_channels: int = 8
    hidden_channels: int = 16
    dtype: type = jnp.float32

    @nn.compact
    def __call__(self, x):  # [B, H, W, 3]
        x = nn.Conv(self.hidden_channels, (3, 3), strides=2, padding=_pad(2, 1),
                    dtype=self.dtype)(x)
        x = nn.relu(x)
        x = nn.Conv(self.latent_channels, (3, 3), strides=2, padding=_pad(2, 1),
                    dtype=self.dtype)(x)
        return nn.sigmoid(x)  # [B, H/4, W/4, C]


class ConvDecoder2D(nn.Module):
    """Transposed-conv mirror (image_comp.py:47-59): k3 s2, torch p1 op1 ⇒
    jax explicit padding (1, 2) per spatial dim, doubling resolution."""

    hidden_channels: int = 16
    out_channels: int = 3
    dtype: type = jnp.float32

    @nn.compact
    def __call__(self, z):  # [B, H/4, W/4, C]
        z = nn.ConvTranspose(self.hidden_channels, (3, 3), strides=(2, 2),
                             padding=((1, 2), (1, 2)), transpose_kernel=True,
                             dtype=self.dtype)(z)
        z = nn.relu(z)
        z = nn.ConvTranspose(self.out_channels, (3, 3), strides=(2, 2),
                             padding=((1, 2), (1, 2)), transpose_kernel=True,
                             dtype=self.dtype)(z)
        return nn.sigmoid(z)  # [B, H, W, 3]


class ConvEncoder3D(nn.Module):
    """Conv3d stack over [B, T, H, W, 3] (movie_3d_comp.py:44-56)."""

    latent_channels: int = 16
    hidden_channels: int = 32
    dtype: type = jnp.float32

    @nn.compact
    def __call__(self, x):
        x = nn.Conv(self.hidden_channels, (3, 3, 3), strides=2, padding=_pad(3, 1),
                    dtype=self.dtype)(x)
        x = nn.relu(x)
        x = nn.Conv(self.latent_channels, (3, 3, 3), strides=2, padding=_pad(3, 1),
                    dtype=self.dtype)(x)
        return nn.sigmoid(x)  # [B, T/4, H/4, W/4, C]


class ConvDecoder3D(nn.Module):
    """ConvTranspose3d mirror (movie_3d_comp.py:58-71)."""

    hidden_channels: int = 32
    out_channels: int = 3
    dtype: type = jnp.float32

    @nn.compact
    def __call__(self, z):
        pad = ((1, 2),) * 3
        z = nn.ConvTranspose(self.hidden_channels, (3, 3, 3), strides=(2, 2, 2),
                             padding=pad, transpose_kernel=True, dtype=self.dtype)(z)
        z = nn.relu(z)
        z = nn.ConvTranspose(self.out_channels, (3, 3, 3), strides=(2, 2, 2),
                             padding=pad, transpose_kernel=True, dtype=self.dtype)(z)
        return nn.sigmoid(z)


class MatmulEncoder2D(nn.Module):
    """ConvEncoder2D expressed via im2col matmuls (nic.models.matmul_conv) —
    the conv-primitive-free path for backends whose conv lowering degrades
    training."""

    latent_channels: int = 8
    hidden_channels: int = 16
    dtype: type = jnp.float32

    @nn.compact
    def __call__(self, x):
        from nic.models.matmul_conv import MatmulConv

        x = MatmulConv(self.hidden_channels, 3, 2, 1, dtype=self.dtype)(x)
        x = nn.relu(x)
        x = MatmulConv(self.latent_channels, 3, 2, 1, dtype=self.dtype)(x)
        return nn.sigmoid(x)


class MatmulDecoder2D(nn.Module):
    hidden_channels: int = 16
    out_channels: int = 3
    dtype: type = jnp.float32

    @nn.compact
    def __call__(self, z):
        from nic.models.matmul_conv import MatmulConvTranspose

        z = MatmulConvTranspose(self.hidden_channels, 3, 2, 1, 1, dtype=self.dtype)(z)
        z = nn.relu(z)
        z = MatmulConvTranspose(self.out_channels, 3, 2, 1, 1, dtype=self.dtype)(z)
        return nn.sigmoid(z)


class MatmulEncoder3D(nn.Module):
    latent_channels: int = 16
    hidden_channels: int = 32
    dtype: type = jnp.float32

    @nn.compact
    def __call__(self, x):  # [B, T, H, W, 3]
        from nic.models.matmul_conv import MatmulConv

        x = MatmulConv(self.hidden_channels, 3, 2, 1, dtype=self.dtype)(x)
        x = nn.relu(x)
        x = MatmulConv(self.latent_channels, 3, 2, 1, dtype=self.dtype)(x)
        return nn.sigmoid(x)


class MatmulDecoder3D(nn.Module):
    hidden_channels: int = 32
    out_channels: int = 3
    dtype: type = jnp.float32

    @nn.compact
    def __call__(self, z):
        from nic.models.matmul_conv import MatmulConvTranspose

        z = MatmulConvTranspose(self.hidden_channels, 3, 2, 1, 1, dtype=self.dtype)(z)
        z = nn.relu(z)
        z = MatmulConvTranspose(self.out_channels, 3, 2, 1, 1, dtype=self.dtype)(z)
        return nn.sigmoid(z)


class MatmulPixelEncoder(nn.Module):
    """PixelLatentEncoder via im2col matmuls (first conv pads 2 → the
    (S/4 + 1)² corner lattice, pixel_comp.py:39). The odd 257/129
    lattice is safe here: ``_im2col`` uses the polyphase decomposition,
    whose contiguous slices avoid long strided slices (see
    matmul_conv._im2col)."""

    latent_channels: int = 8
    hidden_channels: int = 16
    dtype: type = jnp.float32

    @nn.compact
    def __call__(self, x):
        from nic.models.matmul_conv import MatmulConv

        x = MatmulConv(self.hidden_channels, 3, 2, 2, dtype=self.dtype)(x)
        x = nn.relu(x)
        x = MatmulConv(self.latent_channels, 3, 2, 1, dtype=self.dtype)(x)
        return nn.sigmoid(x)


class PixelLatentEncoder(nn.Module):
    """pixel_comp encoder variant: first conv pads 2, producing a
    (S/4 + 1)² latent lattice so every output pixel's 2×2 patch slice
    ``latent[ex:ex+2, ey:ey+2]`` with ex = x//4 stays in bounds
    (pixel_comp.py:35-47)."""

    latent_channels: int = 8
    hidden_channels: int = 16
    dtype: type = jnp.float32

    @nn.compact
    def __call__(self, x):  # [B, H, W, 3]
        x = nn.Conv(self.hidden_channels, (3, 3), strides=2, padding=_pad(2, 2),
                    dtype=self.dtype)(x)
        x = nn.relu(x)
        x = nn.Conv(self.latent_channels, (3, 3), strides=2, padding=_pad(2, 1),
                    dtype=self.dtype)(x)
        return nn.sigmoid(x)  # [B, H/4 + 1, W/4 + 1, C]
