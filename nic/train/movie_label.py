"""Per-frame label-embedding video compression.

The reference's ``movie_lavel_comp.py`` is a byte-identical copy of
``image_comp.py`` (SURVEY.md §2.4 item 9); the method it was *named* for
lives only in the sample08–11 lineage of 21K1113/Neural_Image_Compression_V2:
a 2D conv autoencoder over individual frames, with a learned per-frame
embedding injected into the decoder so one decoder serves all frames —
sample10.py:112-127 shapes the embedding as one extra (H/4)² channel plane
concatenated to the latent.

JAX redesign: frames are a batch axis (vmapped conv encode/decode — the
natural data-parallel axis), the embedding is a [T, h, w, 1] learnable
plane, and the whole train step (all frames per step) is one jitted
program. The latent gets the usual QAT treatment; embeddings stay float
(quantizing them is the reference's own unfinished wish, sample11.py:4-5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax

from nic.core.quant import qat_noise, quantize, quantize_ste
from nic.models.autoencoder import ConvDecoder2D, ConvEncoder2D

__all__ = ["MovieLabelTrainer"]


class MovieLabelTrainer:
    def __init__(
        self,
        movie,  # [T, H, W, 3] float in [0, 1]
        *,
        num_bits: int = 8,
        latent_channels: int = 8,
        hidden_channels: int = 16,
        num_epochs: int = 50000,
        lr: float = 1e-3,
        seed: int = 0,
        qat_ste: bool = False,
        dtype=jnp.float32,
        mesh=None,  # ('data', ...) mesh: frames data-parallel over devices
    ):
        self.num_bits = num_bits
        self.num_epochs = num_epochs
        self.qat_ste = qat_ste
        self.dtype = dtype
        self.mesh = mesh
        self.movie = jnp.asarray(movie, dtype)  # [T, H, W, 3]
        t, h, w, _ = self.movie.shape
        lh, lw = h // 4, w // 4

        self.encoder = ConvEncoder2D(latent_channels, hidden_channels, dtype=dtype)
        # decoder sees latent channels + the embedding plane
        self.decoder = ConvDecoder2D(hidden_channels, 3, dtype=dtype)

        k1, k2, k3, self._key = jax.random.split(jax.random.PRNGKey(seed), 4)
        enc_params = self.encoder.init(k1, self.movie[:1])
        dec_params = self.decoder.init(
            k2, jnp.zeros((1, lh, lw, latent_channels + 1), dtype)
        )
        emb = jax.random.normal(k3, (t, lh, lw, 1), dtype) * 0.1
        self.params = {"enc": enc_params, "dec": dec_params, "emb": emb}
        if mesh is not None:
            from nic.parallel.mesh import replicate
            from nic.train.spatiotemporal import put_sharded

            self.params = replicate(self.params, mesh)
            self.movie = put_sharded(self.movie, mesh, batched=True)
        self._tx = optax.adam(lr)
        self.opt_state = self._tx.init(self.params)
        self.step = 0
        self._jit_step = {p: self._build_step(p) for p in ("noise", "quantize")}
        self._jit_encode = jax.jit(
            lambda p, x: quantize(self.encoder.apply(p["enc"], x), num_bits)
        )
        # frames decode through the shared batched spatiotemporal entry
        # (one batched conv pass over all frames, sharded over 'data')
        from nic.train.spatiotemporal import make_batched_decode

        self._jit_decode = make_batched_decode(
            lambda p, z: self.decoder.apply(
                p["dec"], jnp.concatenate([z, p["emb"]], axis=-1)
            ),
            mesh=mesh, batched=True,
        )

    def _build_step(self, phase: str):
        enc, dec = self.encoder, self.decoder
        bits = self.num_bits
        tx = self._tx
        use_ste = self.qat_ste
        mesh = self.mesh

        def loss_fn(params, movie, key):
            z = enc.apply(params["enc"], movie)  # [T, lh, lw, C]
            if mesh is not None:
                from nic.parallel.mesh import shard_batch
                from nic.train.spatiotemporal import movie_spec

                z = shard_batch(z, mesh, movie_spec(z.ndim, batched=True))
            if phase == "noise":
                z = z + qat_noise(key, z.shape, bits, z.dtype)
            else:
                z = quantize_ste(z, bits) if use_ste else quantize(z, bits)
            zin = jnp.concatenate([z, params["emb"]], axis=-1)
            out = dec.apply(params["dec"], zin)
            return jnp.mean((out - movie) ** 2)

        def step(params, opt_state, movie, key):
            loss, grads = jax.value_and_grad(loss_fn)(params, movie, key)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        return jax.jit(step, donate_argnums=(0, 1))

    def train_step(self):
        phase = "noise" if self.step < self.num_epochs * 0.95 else "quantize"
        self._key, sub = jax.random.split(self._key)
        self.params, self.opt_state, loss = self._jit_step[phase](
            self.params, self.opt_state, self.movie, sub
        )
        self.step += 1
        return loss

    def train_many(self, num_steps: int, chunk: int = 1000) -> np.ndarray:
        losses = []
        remaining = num_steps
        boundary_total = int(np.ceil(self.num_epochs * 0.95))
        while remaining > 0:
            n = min(remaining, chunk)
            if self.step < boundary_total:
                n = min(n, boundary_total - self.step)
            for _ in range(n):  # small T ⇒ per-step dispatch is cheap enough
                losses.append(float(self.train_step()))
            remaining -= n
        return np.asarray(losses)

    def encode(self) -> np.ndarray:
        """→ uint8 per-frame latent codes [T, lh, lw, C]; the embedding
        plane rides in the decoder params (one decoder for all frames)."""
        z = self._jit_encode(self.params, self.movie)
        return np.asarray(z * (2.0**self.num_bits - 1.0)).astype(np.uint8)

    def decode(self, latent_codes: np.ndarray) -> np.ndarray:
        z = jnp.asarray(latent_codes, self.dtype) / (2.0**self.num_bits - 1.0)
        return np.asarray(self._jit_decode(self.params, z))

    def reconstruct(self) -> np.ndarray:
        return self.decode(self.encode())
