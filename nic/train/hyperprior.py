"""Rate–distortion trainer for the scale-hyperprior codec + image-set eval
harness (Kodak-style: PSNR/bpp over a directory of images).

North-star extension — no reference counterpart (SURVEY.md §0): the
reference's conv-AE rate is fixed num_bits; this trains R + λD end to end
and evaluates estimated bpp (code lengths under the learned priors).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import PartitionSpec as P

from nic.models.hyperprior import HyperpriorModel, rd_loss
from nic.parallel.mesh import replicate, shard_batch

__all__ = ["HyperpriorTrainer", "eval_image_set"]

# [B, H, W, C] patch batches: the batch axis is the natural 'data' axis
_BATCH_SPEC = P("data", None, None, None)


class HyperpriorTrainer:
    def __init__(
        self,
        *,
        n: int = 96,
        m: int = 128,
        lam: float = 0.01,
        lr: float = 1e-4,
        patch: int = 256,
        batch: int = 8,
        seed: int = 0,
        mesh=None,
        clip_grad_norm: float = 1.0,
    ):
        """``mesh``: optional ('data', 'pixel') device mesh — the patch
        batch shards over 'data', transform params replicate, and the SPMD
        partitioner psums grads (same pattern as NTCTrainer;
        ``batch`` must be divisible by the data-axis size)."""
        self.model = HyperpriorModel(n, m)
        self.lam = lam
        self.patch = patch
        self.batch = batch
        self.mesh = mesh
        k_init, self._key = jax.random.split(jax.random.PRNGKey(seed))
        dummy = jnp.zeros((1, patch, patch, 3), jnp.float32)
        self.params = replicate(
            self.model.init({"params": k_init}, dummy, None), mesh
        )
        # Global-norm clipping guards the entropy/transform params against
        # rare rate-loss spikes: a 50k-step lam=0.018 run measured healthy
        # (loss 2.67, kernels |max| ~1.2) at 48k and exploded (loss 8.6,
        # kernels 7e4, eval -5.3 dB) by 50k without it — one bad minibatch
        # is unrecoverable under plain Adam. clip_grad_norm=0 disables.
        self._tx = (
            optax.chain(optax.clip_by_global_norm(clip_grad_norm),
                        optax.adam(lr))
            if clip_grad_norm else optax.adam(lr)
        )
        self.opt_state = self._tx.init(self.params)
        self.step = 0
        self._jit_step = self._build_step()
        self._jit_eval = jax.jit(
            lambda p, x: self.model.apply(p, x, None)
        )

    def _build_step(self):
        model, lam, tx, mesh = self.model, self.lam, self._tx, self.mesh

        def loss_fn(params, batch, key):
            x_hat, y_bits, z_bits = model.apply(params, batch, key)
            loss, bpp, mse = rd_loss(x_hat, batch, y_bits, z_bits, lam)
            return loss, (bpp, mse)

        def step(params, opt_state, batch, key):
            batch = shard_batch(batch, mesh, _BATCH_SPEC)
            (loss, (bpp, mse)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, batch, key
            )
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss, bpp, mse

        return jax.jit(step, donate_argnums=(0, 1))

    def sample_patches(self, images: list[np.ndarray], rng: np.random.Generator):
        """Random [batch, patch, patch, 3] crops from a list of HWC images."""
        out = np.empty((self.batch, self.patch, self.patch, 3), np.float32)
        for i in range(self.batch):
            img = images[rng.integers(len(images))]
            h, w = img.shape[:2]
            r = rng.integers(0, max(1, h - self.patch + 1))
            c = rng.integers(0, max(1, w - self.patch + 1))
            out[i] = img[r : r + self.patch, c : c + self.patch]
        return out

    def train_step(self, batch: np.ndarray):
        self._key, sub = jax.random.split(self._key)
        self.params, self.opt_state, loss, bpp, mse = self._jit_step(
            self.params, self.opt_state, jnp.asarray(batch), sub
        )
        self.step += 1
        return loss, bpp, mse

    # ------------------------------------------------------------------
    # compiled multi-step training: crops drawn ON DEVICE inside a
    # lax.scan — one dispatch (and zero batch uploads) per chunk. The
    # per-step path moves ~6 MB host→device and syncs three scalars per
    # step.
    # ------------------------------------------------------------------

    def _scan_fn(self, chunk: int, num_images: int, img_hw):
        key = ("scan", chunk, num_images, img_hw)
        if not hasattr(self, "_scan_cache"):
            self._scan_cache = {}
        if key not in self._scan_cache:
            model, lam, tx = self.model, self.lam, self._tx
            batch, patch, mesh = self.batch, self.patch, self.mesh
            h, w = img_hw

            def loss_fn(params, xb, key):
                x_hat, y_bits, z_bits = model.apply(params, xb, key)
                loss, bpp, mse = rd_loss(x_hat, xb, y_bits, z_bits, lam)
                return loss, (bpp, mse)

            def run(params, opt_state, images, key):
                keys = jax.random.split(key, chunk)

                def body(carry, subkey):
                    prm, opt = carry
                    k_i, k_r, k_c, k_n = jax.random.split(subkey, 4)
                    idx = jax.random.randint(k_i, (batch,), 0, num_images)
                    rr = jax.random.randint(k_r, (batch,), 0, h - patch + 1)
                    cc = jax.random.randint(k_c, (batch,), 0, w - patch + 1)
                    xb = jax.vmap(
                        lambda i, r, c: jax.lax.dynamic_slice(
                            images, (i, r, c, 0), (1, patch, patch, 3)
                        )[0]
                    )(idx, rr, cc)
                    xb = shard_batch(xb, mesh, _BATCH_SPEC)
                    (loss, (bpp, mse)), grads = jax.value_and_grad(
                        loss_fn, has_aux=True
                    )(prm, xb, k_n)
                    updates, opt = tx.update(grads, opt, prm)
                    prm = optax.apply_updates(prm, updates)
                    return (prm, opt), (loss, bpp, mse)

                (params, opt_state), hist = jax.lax.scan(
                    body, (params, opt_state), keys
                )
                return params, opt_state, hist

            self._scan_cache[key] = jax.jit(run, donate_argnums=(0, 1))
        return self._scan_cache[key]

    def stage_images(self, images: list[np.ndarray]):
        """Upload the training set once as one [N, H, W, 3] device array
        (images smaller than the largest are tiled by edge-padding so crop
        origins stay valid)."""
        hs = [i.shape[0] for i in images]
        ws = [i.shape[1] for i in images]
        h, w = max(hs), max(ws)
        stack = np.stack([
            np.pad(im, ((0, h - im.shape[0]), (0, w - im.shape[1]), (0, 0)),
                   mode="edge")
            if im.shape[:2] != (h, w) else im
            for im in images
        ]).astype(np.float32)
        # replicated on the mesh: crops are local dynamic_slices per device
        return replicate(jnp.asarray(stack), self.mesh)

    def train_chunk(self, staged_images, num_steps: int):
        """Run ``num_steps`` compiled steps; returns (loss, bpp, mse)
        history arrays of length ``num_steps``."""
        n, h, w = staged_images.shape[0], staged_images.shape[1], staged_images.shape[2]
        run = self._scan_fn(num_steps, n, (h, w))
        self._key, sub = jax.random.split(self._key)
        self.params, self.opt_state, hist = run(
            self.params, self.opt_state, staged_images, sub
        )
        self.step += num_steps
        return tuple(np.asarray(x) for x in hist)

    def save_checkpoint(self, path: str) -> None:
        """Atomic params+opt snapshot for segmented (resumable) runs."""
        from nic.io.artifacts import save_checkpoint

        save_checkpoint(path, self.step, self.params, self.opt_state,
                        extra={"lam": self.lam})

    def load_checkpoint(self, path: str) -> None:
        from nic.io.artifacts import load_checkpoint

        try:
            self.step, self.params, self.opt_state = load_checkpoint(
                path, self.params, self.opt_state
            )
        except KeyError:
            # optimizer-state layout mismatch (e.g. a checkpoint written
            # before clip_grad_norm wrapped the Adam chain): restore the
            # params and resume with a fresh optimizer state rather than
            # refusing — params-shape mismatches still fail loudly above
            self.step, self.params = load_checkpoint(path, self.params)
            self.opt_state = self._tx.init(self.params)

    def evaluate(self, image: np.ndarray):
        """Hard-quantized PSNR/bpp on one HWC image in [0,1] (padded to a
        multiple of 64 as strided transforms require)."""
        h, w = image.shape[:2]
        ph = (-h) % 64
        pw = (-w) % 64
        x = np.pad(image, ((0, ph), (0, pw), (0, 0)), mode="edge")[None]
        x_hat, y_bits, z_bits = (
            np.asarray(a) for a in self._jit_eval(self.params, jnp.asarray(x)))
        x_hat = np.clip(np.asarray(x_hat)[0, :h, :w], 0, 1)
        mse = float(np.mean((x_hat - image) ** 2))
        psnr = 10 * np.log10(1.0 / max(mse, 1e-12))
        bpp = float(y_bits[0] + z_bits[0]) / (h * w)
        return psnr, bpp, x_hat


def _pad64(image: np.ndarray):
    h, w = image.shape[:2]
    ph, pw = (-h) % 64, (-w) % 64
    return np.pad(image, ((0, ph), (0, pw), (0, 0)), mode="edge")[None], (h, w)


class HyperpriorCodec:
    """Real bitstream compress/decompress around a trained HyperpriorTrainer
    (rANS over the learned priors — nic.io.entropy + nic/native/rans.cpp).

    Lossless w.r.t. the quantized latents: decompress reproduces exactly
    the trainer's hard-quantized evaluation output."""

    def __init__(self, trainer: HyperpriorTrainer,
                 synthesis_mxu_dtype=None):
        """``synthesis_mxu_dtype``: run the synthesis transform's MXU
        dots with inputs in this dtype (fp32 accumulation) — the decode
        hot path's dominant stage. Reconstruction-only (σ→bin and both
        rANS streams stay fp32-exact), so streams are byte-identical
        either way."""
        import math

        import jax

        from nic.io.entropy import NUM_SCALE_BINS, SCALE_MAX, SCALE_MIN

        self.t = trainer
        m, p = trainer.model, trainer.params
        self._g_a = jax.jit(lambda x: m.apply(p, x, method=m.analysis))
        self._h_a = jax.jit(lambda y: m.apply(p, y, method=m.hyper_analysis))
        self._h_s = jax.jit(lambda z: m.apply(p, z, method=m.hyper_synthesis))
        ms = m
        if synthesis_mxu_dtype is not None:
            from nic.models.hyperprior import HyperpriorModel

            ms = HyperpriorModel(m.n, m.m,
                                 synthesis_mxu_dtype=synthesis_mxu_dtype)
        self._g_s_body = lambda y: ms.apply(p, y, method=ms.synthesis)
        self._g_s = jax.jit(self._g_s_body)

        # σ → scale-bin mapping fused into the jitted hyper-synthesis:
        # the host used to fetch σ (524 KB f32) and redo the log in f64
        # numpy (~1 ms — entropy.scale_bin_indices); the decoder only
        # ever needs the BIN INDICES, which are one device elementwise
        # chain and a 4× smaller fetch. Both compress and decompress use
        # this mapping, so streams stay self-consistent (NICX\x02).
        ln_min = math.log(SCALE_MIN)
        inv_step = (NUM_SCALE_BINS - 1) / (math.log(SCALE_MAX) - ln_min)

        def h_s_bins(z):
            s = m.apply(p, z, method=m.hyper_synthesis)
            idx = jnp.ceil((jnp.log(s) - ln_min) * inv_step)
            return jnp.clip(idx, 0, NUM_SCALE_BINS - 1).astype(jnp.int32)

        self._h_s_bins_body = h_s_bins  # unjitted (bench fori-loop slope)
        self._h_s_bins = jax.jit(h_s_bins)
        self._z_mu, self._z_log_s = m.apply(p, method=m.z_prior_params)
        self._cdf_z_cache: dict[int, np.ndarray] = {}

    def _cdf_z(self, max_abs: int) -> np.ndarray:
        """Per-instance cache: the z prior's (μ, s) are fixed for a trained
        codec, so the logistic CDF table only varies with the alphabet."""
        hit = self._cdf_z_cache.get(max_abs)
        if hit is None:
            from nic.io import entropy as ec

            hit = ec.logistic_cdf_table(
                np.asarray(self._z_mu), np.asarray(self._z_log_s), max_abs
            )
            self._cdf_z_cache[max_abs] = hit
        return hit

    def compress(self, image: np.ndarray) -> dict:
        """HWC image in [0,1] → {'y': bytes, 'z': bytes, header...}."""
        from nic.io import entropy as ec
        from nic.native import rans_encode

        x, (h, w) = _pad64(image)
        y = np.asarray(self._g_a(jnp.asarray(x)))
        z = np.asarray(self._h_a(jnp.asarray(y)))
        z_hat = np.round(z).astype(np.int32)
        y_hat = np.round(y).astype(np.int32)
        bins_y = np.asarray(
            self._h_s_bins(jnp.asarray(z_hat, np.float32))).reshape(-1)

        a_y = max(1, int(np.abs(y_hat).max()))
        a_z = max(1, int(np.abs(z_hat).max()))
        cdf_y = ec.gaussian_cdf_table(a_y)
        bytes_y = rans_encode(y_hat.reshape(-1) + a_y, bins_y, cdf_y)

        cdf_z = self._cdf_z(a_z)
        n_ch = z_hat.shape[-1]
        bins_z = np.tile(np.arange(n_ch, dtype=np.int32),
                         z_hat.size // n_ch)
        bytes_z = rans_encode(z_hat.reshape(-1) + a_z, bins_z, cdf_z)
        return {
            "y": bytes_y, "z": bytes_z, "a_y": a_y, "a_z": a_z,
            "y_shape": y.shape, "z_shape": z.shape, "hw": (h, w),
        }

    def num_bits(self, blob: dict) -> int:
        return (len(blob["y"]) + len(blob["z"])) * 8

    def decompress(self, blob: dict) -> np.ndarray:
        from nic.io import entropy as ec
        from nic.native import rans_decode

        n_ch = blob["z_shape"][-1]
        cdf_z = self._cdf_z(blob["a_z"])
        count_z = int(np.prod(blob["z_shape"]))
        bins_z = np.tile(np.arange(n_ch, dtype=np.int32), count_z // n_ch)
        z_hat = (rans_decode(blob["z"], bins_z, cdf_z) - blob["a_z"]).reshape(
            blob["z_shape"]
        )
        bins_y = np.asarray(
            self._h_s_bins(jnp.asarray(z_hat, np.float32))).reshape(-1)
        cdf_y = ec.gaussian_cdf_table(blob["a_y"])
        y_hat = (rans_decode(blob["y"], bins_y, cdf_y) - blob["a_y"]).reshape(
            blob["y_shape"]
        )
        x_hat = np.asarray(self._g_s(jnp.asarray(y_hat, np.float32)))
        h, w = blob["hw"]
        return np.clip(x_hat[0, :h, :w], 0, 1)


def eval_image_set(trainer: HyperpriorTrainer, paths: list[str]):
    """Kodak-style harness: mean PSNR (255-domain equivalent) and bpp over
    a directory/list of images."""
    from PIL import Image

    rows = []
    for p in paths:
        img = np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
        psnr, bpp, _ = trainer.evaluate(img)
        rows.append({"image": os.path.basename(p), "psnr": psnr, "bpp": bpp})
    mean_psnr = float(np.mean([r["psnr"] for r in rows]))
    mean_bpp = float(np.mean([r["bpp"] for r in rows]))
    return {"images": rows, "mean_psnr": mean_psnr, "mean_bpp": mean_bpp}
