"""Smoke + parity-shape tests for the conv-AE and pixel trainers."""

import numpy as np
import jax
import jax.numpy as jnp

from nic.core.metrics import psnr
from nic.train.conv_ae import ConvAETrainer
from nic.train.pixel import PixelTrainer, pixel_patch_features


def _toy_image(size):
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    return np.clip(
        np.stack([np.sin(8 * x) * 0.5 + 0.5, y, (x * y) ** 0.5], axis=-1), 0, 1
    )


def test_conv_ae_2d_latent_shape_and_overfit():
    img = _toy_image(32)
    tr = ConvAETrainer(img, num_bits=4, num_epochs=200, seed=0)
    z = tr.encode()
    assert z.shape == (1, 8, 8, 8)  # [B, H/4, W/4, C]
    assert z.dtype == np.uint8 and z.max() <= 15  # 4-bit codes
    l0 = float(tr.train_step())
    for _ in range(199):
        loss = tr.train_step()
    assert float(loss) < l0
    rec = tr.reconstruct()
    assert rec.shape == (32, 32, 3)
    assert float(psnr(rec * 255, img * 255, max_value=255.0)) > 12.0


def test_conv_ae_3d_shapes():
    rng = np.random.default_rng(0)
    vol = rng.uniform(0, 1, (8, 16, 16, 3)).astype(np.float32)
    tr = ConvAETrainer(vol, num_bits=8, latent_channels=16,
                       hidden_channels=32, num_epochs=50, seed=1)
    z = tr.encode()
    assert z.shape == (1, 2, 4, 4, 16)  # [B, T/4, H/4, W/4, C]
    for _ in range(10):
        tr.train_step()
    rec = tr.reconstruct()
    assert rec.shape == (8, 16, 16, 3)


def test_qat_phase_switch():
    img = _toy_image(16)
    tr = ConvAETrainer(img, num_bits=4, num_epochs=20, seed=0)
    for _ in range(20):
        tr.train_step()
    assert tr.step == 20  # 19 ≥ 0.95*20 → last step ran the quantize phase


def test_pixel_latent_lattice_shape():
    """pixel_comp's padding=2 first conv yields an (S/4 + 1)² corner
    lattice (pixel_comp.py:39 → latent 129² at S=512; here 9² at S=32)."""
    img = _toy_image(32)
    tr = PixelTrainer(img, num_epochs=100, batch_pixels=64, seed=0)
    z = tr.encode()
    assert z.shape == (9, 9, 8)


def test_pixel_patch_features_matches_loop():
    rng = np.random.default_rng(0)
    latent = jnp.asarray(rng.uniform(0, 1, (9, 9, 4)).astype(np.float32))
    s = 32
    feats = np.asarray(pixel_patch_features(latent, s))
    assert feats.shape == (s, s, 16)
    # reference loop semantics: flatten(latent[:, ex:ex+2, ey:ey+2])
    # channel-major (pixel_comp.py:163-164)
    lat = np.asarray(latent)
    for x, y in [(0, 0), (5, 17), (31, 31), (13, 2)]:
        ex, ey = x // 4, y // 4
        want = lat[ex : ex + 2, ey : ey + 2, :].transpose(2, 0, 1).reshape(-1)
        np.testing.assert_allclose(feats[x, y], want, atol=1e-6)


def test_pixel_overfit_and_vectorized_decode():
    img = _toy_image(32)
    tr = PixelTrainer(img, num_epochs=300, batch_pixels=256, seed=0)
    l0 = float(tr.train_step())
    for _ in range(299):
        loss = tr.train_step()
    assert float(loss) < l0
    rec = tr.reconstruct()
    assert rec.shape == (32, 32, 3)
    assert float(psnr(rec * 255, img * 255, max_value=255.0)) > 10.0


def test_pixel_pos_pe_variant():
    img = _toy_image(32)
    tr = PixelTrainer(img, num_epochs=50, batch_pixels=64, use_pe=True,
                      pe_channels=4, seed=0)
    for _ in range(10):
        tr.train_step()
    rec = tr.reconstruct()
    assert rec.shape == (32, 32, 3)
    assert np.all(np.isfinite(rec))


def test_pixel_folded_decode_matches_unfolded():
    """PixelTrainer.decode folds W1 into the latent lattice; must equal the
    explicit patch-gather + MLP path exactly."""
    import jax.numpy as jnp
    from nic.models.mlp import apply_mlp

    img = _toy_image(32)
    for use_pe in (False, True):
        tr = PixelTrainer(img, num_epochs=40, batch_pixels=64, seed=0,
                          use_pe=use_pe, pe_channels=4)
        for _ in range(10):
            tr.train_step()
        latent_codes = tr.encode()
        z = jnp.asarray(latent_codes, jnp.float32) / 255.0
        s = 32
        feats = pixel_patch_features(z, s).reshape(s * s, -1)
        if use_pe:
            xs = jnp.repeat(jnp.arange(s), s)
            ys = jnp.tile(jnp.arange(s), s)
            coords = jnp.stack([xs.astype(jnp.float32), ys.astype(jnp.float32)])
            from nic.core.encodings import sinusoidal_pe
            feats = jnp.concatenate([feats, sinusoidal_pe(coords, 4).T], axis=1)
        want = np.asarray(apply_mlp(tr.params["mlp"], feats)).reshape(s, s, 3)
        got = tr.decode(latent_codes)
        np.testing.assert_allclose(got, want, atol=3e-6)


def test_matmul_conv_matches_xla_conv_shapes_and_function():
    """MatmulConv/MatmulConvTranspose reproduce lax-conv outputs exactly
    given the same weights (reshaped to im2col layout)."""
    import jax
    import jax.numpy as jnp
    import flax.linen as nn
    from nic.models.matmul_conv import MatmulConv, MatmulConvTranspose

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(0, 1, (2, 16, 16, 3)).astype(np.float32))

    # conv: compare against nn.Conv with the same kernel values
    mc = MatmulConv(5, 3, 2, 1)
    pm = mc.init(jax.random.PRNGKey(0), x)
    k_flat = pm["params"]["kernel"]  # [9*3, 5]
    k_hwio = k_flat.reshape(3, 3, 3, 5)
    conv = nn.Conv(5, (3, 3), strides=2, padding=((1, 1), (1, 1)))
    pc = {"params": {"kernel": k_hwio, "bias": pm["params"]["bias"]}}
    np.testing.assert_allclose(
        np.asarray(mc.apply(pm, x)), np.asarray(conv.apply(pc, x)), atol=2e-5
    )

    # transpose: shape parity with the torch-geometry ConvTranspose path
    z = jnp.asarray(rng.normal(0, 1, (2, 8, 8, 4)).astype(np.float32))
    mt = MatmulConvTranspose(6, 3, 2, 1, 1)
    pt = mt.init(jax.random.PRNGKey(1), z)
    out = mt.apply(pt, z)
    assert out.shape == (2, 16, 16, 6)


def test_conv_ae_matmul_impl_trains():
    img = _toy_image(32)
    tr = ConvAETrainer(img, num_bits=4, num_epochs=120, seed=0,
                       conv_impl="matmul")
    losses = tr.train_many(120)
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    rec = tr.reconstruct()
    assert rec.shape == (32, 32, 3)


def test_conv_transpose_polyphase_matches_zero_insertion():
    """The polyphase (subpixel) transposed-conv lowering must compute the
    exact same function as the textbook zero-insertion lowering for every
    geometry the models use (2D/3D, the conv-AE k3s2p1op1, the hyperprior
    k4s2p1op0, odd strides/output_padding)."""
    import jax.numpy as jnp

    from nic.models.matmul_conv import (_conv_transpose_polyphase,
                                        _conv_transpose_zero_insertion)

    rng = np.random.default_rng(0)
    for ndim in (2, 3):
        for (k, s, p, op) in [(4, 2, 1, 0), (3, 2, 1, 1), (5, 2, 2, 1),
                              (3, 1, 1, 0), (4, 3, 1, 2), (2, 2, 0, 0)]:
            c_in, f = 3, 4
            x = jnp.asarray(
                rng.standard_normal((2,) + (5,) * ndim + (c_in,)), jnp.float32)
            w = jnp.asarray(
                rng.standard_normal((k**ndim * c_in, f)), jnp.float32)
            a = _conv_transpose_polyphase(x, w, k, s, p, op, f)
            b = _conv_transpose_zero_insertion(x, w, k, s, p, op, f)
            assert a.shape == b.shape, (ndim, k, s, p, op)
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=1e-4, rtol=1e-4)


def test_polyphase_im2col_matches_strided_slicing():
    """stride>1 _im2col is a polyphase (space-to-depth) decomposition —
    contiguous slices only. Must be bit-exact vs the naive
    strided-slicing form across 2D/3D geometries incl. odd sizes."""
    import jax.numpy as jnp

    from nic.models.matmul_conv import _im2col

    def naive(x, k, s, pad_lo, pad_hi):
        import itertools
        ndim = x.ndim - 2
        pad = ((0, 0),) + ((pad_lo, pad_hi),) * ndim + ((0, 0),)
        xp = jnp.pad(x, pad)
        outs = [(xp.shape[1 + d] - k) // s + 1 for d in range(ndim)]
        parts = []
        for offs in itertools.product(range(k), repeat=ndim):
            sl = [slice(None)]
            for d, o in enumerate(offs):
                sl.append(slice(o, o + (outs[d] - 1) * s + 1, s))
            sl.append(slice(None))
            parts.append(xp[tuple(sl)])
        return jnp.concatenate(parts, axis=-1)

    rng = np.random.default_rng(3)
    for shape, k, s, p in [
        ((1, 33, 33, 3), 3, 2, 2),   # pixel-encoder pad-2 lattice (odd)
        ((1, 32, 32, 3), 3, 2, 1),   # conv-AE geometry
        ((2, 17, 21, 4), 3, 2, 2),   # non-square, odd
        ((1, 16, 16, 3), 2, 2, 0),   # k == s
        ((1, 9, 9, 9, 2), 3, 2, 1),  # 3D
    ]:
        x = jnp.asarray(rng.uniform(-1, 1, shape).astype(np.float32))
        a = np.asarray(_im2col(x, k, s, p, p))
        b = np.asarray(naive(x, k, s, p, p))
        assert a.shape == b.shape, (shape, k, s, p, a.shape, b.shape)
        assert np.array_equal(a, b), (shape, k, s, p)


def test_matmul_pixel_encoder_matches_lax_encoder():
    """MatmulPixelEncoder must reproduce the lax-conv PixelLatentEncoder
    (same weights) on the (S/4+1)² corner lattice."""
    import jax
    import jax.numpy as jnp

    from nic.models.autoencoder import MatmulPixelEncoder, PixelLatentEncoder

    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32))
    me = MatmulPixelEncoder(8, 16)
    pm = me.init(jax.random.PRNGKey(0), x)
    out_m = me.apply(pm, x)
    lat = 32 // 4 + 1
    assert out_m.shape == (1, lat, lat, 8)

    # same weights into the lax-conv encoder (im2col rows → HWIO)
    le = PixelLatentEncoder(8, 16)
    p = pm["params"]
    pc = {"params": {
        "Conv_0": {"kernel": p["MatmulConv_0"]["kernel"].reshape(3, 3, 3, 16),
                   "bias": p["MatmulConv_0"]["bias"]},
        "Conv_1": {"kernel": p["MatmulConv_1"]["kernel"].reshape(3, 3, 16, 8),
                   "bias": p["MatmulConv_1"]["bias"]},
    }}
    out_l = le.apply(pc, x)  # [1, 9, 9, 8]
    np.testing.assert_allclose(np.asarray(out_m), np.asarray(out_l), atol=2e-5)
