"""Pixel-decode trainer: the pixel_comp / pixel_pos_comp workloads.

The reference trains a conv encoder + per-pixel MLP on ONE random pixel
per step and decodes with a 512×512 Python double loop — 262,144
single-row MLP launches (``Projects/pixel_comp.py:89-168``,
``pixel_pos_comp.py`` adds a sinusoidal PE of (x, y) —
21K1113/Neural_Image_Compression_V2). SURVEY.md §3.2 marks that loop as
the kernel-fusion target.

JAX redesign:
- training samples a whole BATCH of random pixels per step (the
  one-pixel-per-step reference loop is pure host latency; batching is the
  same estimator with lower variance) and runs as one jitted step;
- decode is fully vectorized: the per-pixel 2×2 latent patch gather is
  separable (``ex = x // 4`` row/col takes), so the whole image decodes as
  four axis takes + one [N, 32(+PE)] × MLP matmul batch — no Python loop;
  the Pallas fused kernel (nic.kernels) goes further and fuses gather+MLP.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax

from nic.core.encodings import sinusoidal_pe
from nic.core.quant import qat_noise, quantize, quantize_ste
from nic.models.autoencoder import PixelLatentEncoder
from nic.models.mlp import apply_mlp, init_mlp

__all__ = ["PixelTrainer", "pixel_patch_features"]


def pixel_patch_features(latent, image_size: int):
    """[Hl, Wl, C] latent lattice → [S, S, 4C] per-pixel 2×2 patch features.

    Feature order matches the reference's ``flatten(latent[:, :, ex:ex+2,
    ey:ey+2])`` channel-major layout (pixel_comp.py:98-99): for channel c,
    the 4 patch cells in (dx, dy) row-major order → index c*4 + dx*2 + dy.
    Separable takes: 2 row takes + 2 col takes replace 262k pointwise
    gathers.
    """
    c = latent.shape[-1]
    ex = jnp.arange(image_size) // 4
    rows0 = jnp.take(latent, ex, axis=0)
    rows1 = jnp.take(latent, ex + 1, axis=0)
    feats = []
    for dx, rows in ((0, rows0), (1, rows1)):
        for dy in (0, 1):
            feats.append(jnp.take(rows, ex + dy, axis=1))  # [S, S, C]
    # stack → [S, S, 4, C] → channel-major flatten [S, S, C, 4] → [S, S, 4C]
    patch = jnp.stack(feats, axis=2)  # [S, S, 4, C]
    return patch.transpose(0, 1, 3, 2).reshape(image_size, image_size, 4 * c)


class PixelTrainer:
    def __init__(
        self,
        image,  # [H, W, 3] float in [0, 1]
        *,
        num_bits: int = 8,
        latent_channels: int = 8,
        hidden: int = 64,
        num_epochs: int = 20000,
        batch_pixels: int = 256,
        use_pe: bool = False,
        pe_channels: int = 4,
        lr: float = 1e-3,
        seed: int = 0,
        qat_ste: bool = False,
        dtype=jnp.float32,
        conv_impl: str = "matmul",  # im2col matmuls by default
        # (nic.models.matmul_conv); _im2col's stride>1 path is a
        # polyphase decomposition with contiguous slices only
    ):
        self.num_bits = num_bits
        self.num_epochs = num_epochs
        self.batch_pixels = batch_pixels
        self.use_pe = use_pe
        self.pe_channels = pe_channels
        self.dtype = dtype
        self.qat_ste = qat_ste
        self.image = jnp.asarray(image, dtype)[None]  # [1, H, W, 3]
        self.image_size = self.image.shape[1]

        if conv_impl == "matmul":
            from nic.models.autoencoder import MatmulPixelEncoder

            self.encoder = MatmulPixelEncoder(latent_channels, 16, dtype=dtype)
        else:
            self.encoder = PixelLatentEncoder(latent_channels, 16, dtype=dtype)
        k1, k2, self._key = jax.random.split(jax.random.PRNGKey(seed), 3)
        enc_params = self.encoder.init(k1, self.image)
        # decoder input: 4·C latent patch (+ PE of (x, y) for pixel_pos —
        # pixel_pos_comp.py:20-23 uses pe_channels per axis)
        in_features = 4 * latent_channels + (pe_channels * 2 if use_pe else 0)
        mlp = init_mlp(k2, in_features, hidden, 3, dtype)
        self.params = {"enc": enc_params, "mlp": mlp}
        self._tx = optax.adam(lr)
        self.opt_state = self._tx.init(self.params)
        self.step = 0
        self._jit_step = {p: self._build_step(p) for p in ("noise", "quantize")}
        self._jit_encode = jax.jit(
            lambda p, x: quantize(self.encoder.apply(p["enc"], x), num_bits)
        )
        self._jit_decode = jax.jit(self._decode_impl)

    # ------------------------------------------------------------------

    def _pe_of(self, xs, ys):
        coords = jnp.stack([xs.astype(self.dtype), ys.astype(self.dtype)])
        return sinusoidal_pe(coords, self.pe_channels).T  # [N, 2*pe]

    def _build_step(self, phase: str, jit: bool = True):
        enc = self.encoder
        bits = self.num_bits
        s = self.image_size
        nb = self.batch_pixels
        tx = self._tx
        use_ste = self.qat_ste

        def loss_fn(params, image, key):
            k_xy, k_noise = jax.random.split(key)
            xy = jax.random.randint(k_xy, (2, nb), 0, s)
            xs, ys = xy[0], xy[1]
            latent = enc.apply(params["enc"], image)[0]  # [Hl, Wl, C]
            ex, ey = xs // 4, ys // 4
            # gather the 2×2 patch per sampled pixel, channel-major order
            cells = []
            for dx in (0, 1):
                for dy in (0, 1):
                    cells.append(latent[ex + dx, ey + dy])  # [nb, C]
            patch = jnp.stack(cells, axis=1)  # [nb, 4, C]
            feat = patch.transpose(0, 2, 1).reshape(nb, -1)  # [nb, 4C]
            if phase == "noise":
                feat = feat + qat_noise(k_noise, feat.shape, bits, feat.dtype)
            else:
                feat = quantize_ste(feat, bits) if use_ste else quantize(feat, bits)
            if self.use_pe:
                feat = jnp.concatenate([feat, self._pe_of(xs, ys)], axis=1)
            out = apply_mlp(params["mlp"], feat)
            tgt = image[0, xs, ys]  # [nb, 3]
            return jnp.mean((out - tgt) ** 2)

        def step(params, opt_state, image, key):
            loss, grads = jax.value_and_grad(loss_fn)(params, image, key)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        return jax.jit(step, donate_argnums=(0, 1)) if jit else step

    def train_step(self):
        phase = "noise" if self.step < self.num_epochs * 0.95 else "quantize"
        self._key, sub = jax.random.split(self._key)
        self.params, self.opt_state, loss = self._jit_step[phase](
            self.params, self.opt_state, self.image, sub
        )
        self.step += 1
        return loss

    def _scan_fn(self, phase: str, chunk: int):
        key = ("scan", phase, chunk)
        if key not in self._jit_step:
            step = self._build_step(phase, jit=False)

            def run(params, opt_state, image, key):
                def body(carry, subkey):
                    p, o = carry
                    p, o, loss = step(p, o, image, subkey)
                    return (p, o), loss

                keys = jax.random.split(key, chunk)
                return jax.lax.scan(body, (params, opt_state), keys)

            self._jit_step[key] = jax.jit(run, donate_argnums=(0, 1))
        return self._jit_step[key]

    def train_many(self, num_steps: int, chunk: int = 1000) -> np.ndarray:
        """Compiled lax.scan training (see ConvAETrainer.train_many)."""
        losses = []
        remaining = num_steps
        boundary_total = int(np.ceil(self.num_epochs * 0.95))
        while remaining > 0:
            if self.step < boundary_total:
                n = min(remaining, boundary_total - self.step, chunk)
                phase = "noise"
            else:
                n = min(remaining, chunk)
                phase = "quantize"
            self._key, sub = jax.random.split(self._key)
            run = self._scan_fn(phase, n)
            (self.params, self.opt_state), lh = run(
                self.params, self.opt_state, self.image, sub
            )
            self.step += n
            remaining -= n
            losses.append(np.asarray(lh))
        return np.concatenate(losses)

    # ------------------------------------------------------------------

    def encode(self) -> np.ndarray:
        """→ uint8 latent codes [Hl, Wl, C] (pixel_comp.py:138-146)."""
        z = self._jit_encode(self.params, self.image)[0]
        return np.asarray(z * (2.0**self.num_bits - 1.0)).astype(np.uint8)

    def _decode_impl(self, mlp_params, latent):
        """Folded-first-layer decode (same algebra as nic.grids.fastdecode):
        layer 1 commutes with the 2×2 patch gather, so fold W1 into the
        latent lattice once (P = Σ_cells shift(latent)·W1_cell, [*,*,H]) and
        per-pixel work is a ×4 nearest upsample in H-lane space (+ separable
        PE vectors for pixel_pos). Exact vs the unfolded path."""
        s = self.image_size
        w1, b1 = mlp_params["w1"], mlp_params["b1"]
        c = latent.shape[-1]
        cells = s // 4  # ex = x//4 ∈ [0, cells-1]; lattice is cells+1 wide
        p_plane = None
        for k, (dx, dy) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            # feature layout is channel-major: row index c*4 + (dx*2+dy)
            rows = w1[jnp.arange(c) * 4 + (dx * 2 + dy)]  # [C, H]
            sl = jax.lax.slice(latent, (dx, dy, 0), (dx + cells, dy + cells, c))
            term = jnp.tensordot(sl, rows, axes=([2], [0]))
            p_plane = term if p_plane is None else p_plane + term
        up = jnp.repeat(jnp.repeat(p_plane, 4, axis=0), 4, axis=1)  # [s, s, H]
        acc = up
        if self.use_pe:
            coords = jnp.arange(s, dtype=self.dtype)[None, :]
            table = sinusoidal_pe(coords, self.pe_channels).T  # [s, PE]
            base = 4 * c
            pe_u = table @ w1[base : base + self.pe_channels]
            pe_v = table @ w1[base + self.pe_channels : base + 2 * self.pe_channels]
            acc = acc + pe_u[:, None, :] + pe_v[None, :, :]
        h = jax.nn.gelu(acc + b1, approximate=False)
        h = jax.nn.gelu(
            jnp.tensordot(h, mlp_params["w2"], axes=([2], [0])) + mlp_params["b2"],
            approximate=False,
        )
        return jax.nn.sigmoid(
            jnp.tensordot(h, mlp_params["w3"], axes=([2], [0])) + mlp_params["b3"]
        )

    def decode(self, latent_codes: np.ndarray) -> np.ndarray:
        """uint8 latent codes → [S, S, 3] image in [0, 1]; the vectorized
        replacement for pixel_comp.py:155-168's per-pixel loop."""
        z = jnp.asarray(latent_codes, self.dtype) / (2.0**self.num_bits - 1.0)
        return np.asarray(self._jit_decode(self.params["mlp"], z))

    def reconstruct(self) -> np.ndarray:
        return self.decode(self.encode())
