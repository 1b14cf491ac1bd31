"""Conv-autoencoder trainer: the image_comp / movie_frame / movie_2d /
movie_3d workload family.

Re-architects the reference's whole-asset batch=1 loop
(``Projects/image_comp.py:82-158``, ``movie_2d_comp.py:69-123``,
``movie_3d_comp.py:75-202`` of 21K1113/Neural_Image_Compression_V2) as one
jitted step:

- encoder fwd → QAT (noise for the first 95% of steps, hard quantize
  after — with the reference's zero-gradient-through-floor semantics, or
  STE when ``qat_ste`` is on) → decoder fwd → MSE → Adam(1e-3);
- by construction fixes the reference's ``quantize_norm`` NameError (its
  final-5%/encode phase calls an undefined function, movie_2d_comp.py:81,
  movie_3d_comp.py:87 — SURVEY.md §2.4) — here the quantizer is
  nic.core.quant.quantize;
- encode/decode produce/consume the uint8 latent artifact
  (image_comp.py:124-152 semantics);
- checkpoint/resume replaces the ``encode_from_middle`` flags
  (movie_3d_comp.py:29-35).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import optax

from nic.core.quant import qat_noise, quantize, quantize_ste
from nic.models.autoencoder import (
    ConvDecoder2D,
    ConvDecoder3D,
    ConvEncoder2D,
    ConvEncoder3D,
)

__all__ = ["ConvAETrainer"]


@dataclass
class _ModelPair:
    encoder: object
    decoder: object


class ConvAETrainer:
    def __init__(
        self,
        image,  # [H, W, 3] or [T, H, W, 3] float in [0, 1]
        *,
        num_bits: int = 4,
        latent_channels: int = 8,
        hidden_channels: int = 16,
        num_epochs: int = 1000,
        lr: float = 1e-3,
        seed: int = 0,
        qat_ste: bool = False,
        dtype=jnp.float32,
        conv_impl: str = "matmul",  # im2col matmuls by default
        # (nic.models.matmul_conv); "xla" selects the plain lax-conv
        # modules
        mesh=None,  # ('data', ...) mesh: shard the sheet-row/time axis
        # (movie frames) data-parallel; params replicated, grads psum'd
    ):
        self.num_bits = num_bits
        self.num_epochs = num_epochs
        self.qat_ste = qat_ste
        self.dtype = dtype
        self.mesh = mesh
        image = jnp.asarray(image, dtype)
        self.is_3d = image.ndim == 4
        self.image = image[None]  # batch dim

        if self.is_3d and conv_impl == "matmul":
            from nic.models.autoencoder import MatmulDecoder3D, MatmulEncoder3D

            enc = MatmulEncoder3D(latent_channels, hidden_channels, dtype=dtype)
            dec = MatmulDecoder3D(hidden_channels, 3, dtype=dtype)
        elif self.is_3d:
            enc = ConvEncoder3D(latent_channels, hidden_channels, dtype=dtype)
            dec = ConvDecoder3D(hidden_channels, 3, dtype=dtype)
        elif conv_impl == "matmul":
            from nic.models.autoencoder import MatmulDecoder2D, MatmulEncoder2D

            enc = MatmulEncoder2D(latent_channels, hidden_channels, dtype=dtype)
            dec = MatmulDecoder2D(hidden_channels, 3, dtype=dtype)
        else:
            enc = ConvEncoder2D(latent_channels, hidden_channels, dtype=dtype)
            dec = ConvDecoder2D(hidden_channels, 3, dtype=dtype)
        self.model = _ModelPair(enc, dec)

        k1, k2, self._key = jax.random.split(jax.random.PRNGKey(seed), 3)
        enc_params = enc.init(k1, self.image)
        latent_shape = jax.eval_shape(lambda p, x: enc.apply(p, x), enc_params, self.image)
        dec_params = dec.init(k2, jnp.zeros(latent_shape.shape, dtype))
        self.params = {"enc": enc_params, "dec": dec_params}

        if mesh is not None:
            from nic.parallel.mesh import replicate
            from nic.train.spatiotemporal import put_sharded

            self.params = replicate(self.params, mesh)
            self.image = put_sharded(self.image, mesh, batched=False)

        self._tx = optax.adam(lr)
        self.opt_state = self._tx.init(self.params)
        self.step = 0
        self._jit_step = {p: self._build_step(p) for p in ("noise", "quantize")}
        self._jit_encode = jax.jit(
            lambda p, x: quantize(self.model.encoder.apply(p["enc"], x), num_bits)
        )
        # all movie variants (frame/2d sheet, 3d volume) decode through the
        # one batched spatiotemporal entry (nic.train.spatiotemporal)
        from nic.train.spatiotemporal import make_batched_decode

        self._jit_decode = make_batched_decode(
            lambda p, z: self.model.decoder.apply(p["dec"], z), mesh=mesh
        )

    # ------------------------------------------------------------------

    def _build_step(self, phase: str, jit: bool = True):
        enc, dec = self.model.encoder, self.model.decoder
        bits = self.num_bits
        tx = self._tx
        use_ste = self.qat_ste
        mesh = self.mesh

        def loss_fn(params, image, key):
            z = enc.apply(params["enc"], image)
            if mesh is not None:
                # frames/sheet-rows data-parallel: keep the latent on the
                # same spatial sharding as the asset (the partitioner
                # handles conv halos and psums the replicated-param grads)
                from nic.parallel.mesh import shard_batch
                from nic.train.spatiotemporal import movie_spec

                z = shard_batch(z, mesh, movie_spec(z.ndim, batched=False))
            if phase == "noise":
                z = z + qat_noise(key, z.shape, bits, z.dtype)
            else:
                z = quantize_ste(z, bits) if use_ste else quantize(z, bits)
            out = dec.apply(params["dec"], z)
            return jnp.mean((out - image) ** 2)

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
        """Compiled lax.scan training — one dispatch per chunk instead of
        the reference's per-epoch Python loop; phase boundary respected."""
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
        """Image → quantized latent codes as uint8 [0, 2^b - 1]
        (image_comp.py:124-139)."""
        z = self._jit_encode(self.params, self.image)
        return np.asarray(z * (2.0**self.num_bits - 1.0)).astype(np.uint8)

    def decode(self, latent_codes: np.ndarray) -> np.ndarray:
        """uint8 latent codes → reconstructed asset in [0, 1]
        (image_comp.py:141-153)."""
        z = jnp.asarray(latent_codes, self.dtype) / (2.0**self.num_bits - 1.0)
        out = self._jit_decode(self.params, z)
        return np.asarray(out[0])

    def reconstruct(self) -> np.ndarray:
        """encode → decode round trip through the quantized latent."""
        return self.decode(self.encode())
