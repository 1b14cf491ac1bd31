"""End-to-end overfit smoke tests for the NTC trainer (CPU-runnable).

The reference has no automated tests; these encode its expected training
behaviour: a few hundred QAT steps on a tiny synthetic image must raise
PSNR well above the random-init level, the freeze/quantize transition must
keep grids on the code book, and decode must round-trip through the packed
artifact."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from nic.config import CompressionConfig
from nic.core.metrics import psnr
from nic.core.quant import quantize
from nic.grids import pyramid as fp_lib
from nic.train.ntc import NTCTrainer, UniformLodSchedule, sample_lod


def _tiny_cfg(**kw):
    base = dict(
        image_size=32,
        crop_mip_level=4,  # 16² crops
        num_crops=4,
        num_epochs=300,
        fp_bits=4,
        feature_pyramid_channels=4,
        pe_channels=4,
        hidden_layer_channels=16,
        max_mip_level=5,
        tf_no_mip=True,
        seed=0,
    )
    base.update(kw)
    return CompressionConfig(**base)


def _toy_image(size):
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.stack(
        [np.sin(6 * x) * 0.5 + 0.5, y, ((x + y) % 0.25) * 4.0], axis=0
    )
    return np.clip(img, 0, 1)


def test_overfit_smoke_2d():
    cfg = _tiny_cfg()
    img = _toy_image(32)
    tr = NTCTrainer(cfg, [img])
    p0 = float(psnr(np.asarray(tr.decode(0)) * 255, img.transpose(1, 2, 0) * 255,
                    max_value=255.0))
    for _ in range(cfg.num_epochs):
        loss, step_psnr, lod = tr.train_step()
        assert lod == 0
    assert tr.state.frozen  # passed the 95% boundary
    rec = np.asarray(tr.decode(0))
    assert rec.shape == (32, 32, 3)
    p1 = float(psnr(rec * 255, img.transpose(1, 2, 0) * 255, max_value=255.0))
    assert p1 > p0 + 4, f"PSNR did not improve enough: {p0:.2f} → {p1:.2f}"
    assert p1 > 14.0
    # frozen grids sit exactly on the code book
    for g in tr.state.fp:
        q = quantize(g, cfg.fp_bits)
        np.testing.assert_allclose(np.asarray(q), np.asarray(g), atol=1e-6)


def test_overfit_smoke_3d_method3():
    cfg = _tiny_cfg(
        image_size=16,
        image_dimension=3,
        compression_method=3,
        crop_mip_level=3,
        num_crops=2,
        num_epochs=60,
        max_mip_level=4,
    )
    rng = np.random.default_rng(0)
    vol = rng.uniform(0, 1, (3, 16, 16, 16)).astype(np.float32)
    vol = (vol + np.roll(vol, 1, axis=1)) / 2  # mild smoothness
    tr = NTCTrainer(cfg, [vol])
    l0 = None
    for _ in range(cfg.num_epochs):
        loss, _, _ = tr.train_step()
        if l0 is None:
            l0 = float(loss)
    assert float(loss) < l0
    rec = np.asarray(tr.decode(0))
    assert rec.shape == (16, 16, 16, 3)


def test_method4_sparse_g0_shapes():
    cfg = _tiny_cfg(
        image_size=16,
        image_dimension=3,
        compression_method=4,
        crop_mip_level=3,
        num_crops=2,
        num_epochs=20,
        max_mip_level=4,
    )
    assert cfg.decoder_input_channels == 4 * 5 + 4 * 3 + 1
    vol = np.random.default_rng(1).uniform(0, 1, (3, 16, 16, 16)).astype(np.float32)
    tr = NTCTrainer(cfg, [vol])
    for _ in range(5):
        tr.train_step()
    assert np.asarray(tr.decode(0)).shape == (16, 16, 16, 3)


def test_mip_training_and_decode():
    cfg = _tiny_cfg(tf_no_mip=False, max_mip_level=5, num_epochs=40)
    from nic.data.assets import load_image_mips  # noqa: F401  (API exists)

    img = _toy_image(32)
    mips = [img[:, :: 2**i, :: 2**i] for i in range(6)]
    tr = NTCTrainer(cfg, mips)
    seen = set()
    for _ in range(40):
        _, _, lod = tr.train_step()
        seen.add(lod)
    assert max(seen) <= 5
    # decode at several mips, tiled and untiled agree
    for mip in (0, 1, 3):
        s = 32 // 2**mip
        rec = np.asarray(tr.decode(mip))
        assert rec.shape == (s, s, 3)
    rec_tiled = np.asarray(tr.decode(0, div_size=3))  # force 2^(5-3)=4 slices
    rec_whole = np.asarray(tr.decode(0))
    np.testing.assert_allclose(rec_tiled, rec_whole, atol=2e-5)


def test_lod_schedule():
    gate = UniformLodSchedule(0.25)
    fires = [gate() for _ in range(8)]
    assert fires == [False, False, False, True] * 2
    rng = np.random.default_rng(0)
    draws = [sample_lod(rng, False, 9) for _ in range(2000)]
    assert min(draws) == 0 and max(draws) <= 9
    # exponential: P(lod=0) = 1 - 2^-2 = 0.75
    assert abs(np.mean([d == 0 for d in draws]) - 0.75) < 0.05
    uni = [sample_lod(rng, True, 3) for _ in range(2000)]
    assert set(uni) == {0, 1, 2, 3}


def test_artifact_roundtrip_decode():
    from nic.io.artifacts import save_compressed, load_compressed
    import tempfile, os

    cfg = _tiny_cfg(num_epochs=30)
    img = _toy_image(32)
    tr = NTCTrainer(cfg, [img])
    for _ in range(30):
        tr.train_step()
    tr.freeze_and_quantize()
    rec0 = np.asarray(tr.decode(0))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "art.npz")
        bits = save_compressed(path, tr.state.mlp, tr.state.fp, cfg.fp_bits,
                               {"cfg": "tiny"})
        mlp, fp, meta = load_compressed(path)
        # grids survive bit-packing exactly
        for a, b in zip(fp, tr.state.fp):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
        tr2 = NTCTrainer(cfg, [img])
        tr2.state = dataclasses.replace(tr2.state, fp=fp, mlp=mlp, frozen=True)
        rec1 = np.asarray(tr2.decode(0))
        np.testing.assert_allclose(rec0, rec1, atol=1e-5)
        # bpp accounting: grids at fp_bits + fp32 MLP
        grid_bits = fp_lib.pyramid_bits(tr.state.fp, cfg.fp_bits)
        assert bits > grid_bits


def _tiled_vs_whole(method, backend, tf_no_mip=False, max_mip=4):
    cfg = CompressionConfig(
        image_size=32, image_dimension=3, compression_method=method,
        crop_mip_level=3, num_crops=2, num_epochs=20, fp_bits=4,
        feature_pyramid_channels=4, pe_channels=4, hidden_layer_channels=16,
        tf_no_mip=tf_no_mip, max_mip_level=max_mip, seed=0,
        decode_backend=backend,
    )
    vol = np.random.default_rng(2).uniform(0, 1, (3, 32, 32, 32)).astype(np.float32)
    tr = NTCTrainer(cfg, [vol] * (cfg.effective_max_mip_level + 1))
    for _ in range(5):
        tr.train_step()
    whole = np.asarray(tr.decode(0))
    # force 2^(4-1)=8 tiles per axis → 512 tiles would be huge; use
    # div_size=2 → 4 tiles/axis = 64 tiles of 8³
    tiled = np.asarray(tr.decode(0, div_size=2))
    assert whole.shape == (32, 32, 32, 3)
    np.testing.assert_allclose(tiled, whole, atol=2e-5)


def test_3d_tiled_decode_method3_fast():
    """The reference's div_size tiling applies to 3D too
    (image_compression.py:335-340); tiled must equal single-tile."""
    _tiled_vs_whole(3, "fast")


def test_3d_tiled_decode_method3_xla():
    _tiled_vs_whole(3, "xla")


def test_3d_tiled_decode_method4_fast():
    _tiled_vs_whole(4, "fast")


def test_2d_tiled_decode_fast_backend():
    """The fast backend now also covers the tiled path (folded planes
    hoisted out of the tile vmap)."""
    cfg = _tiny_cfg(tf_no_mip=False, max_mip_level=5, num_epochs=40,
                    decode_backend="fast")
    img = _toy_image(32)
    mips = [img[:, :: 2**i, :: 2**i] for i in range(6)]
    tr = NTCTrainer(cfg, mips)
    for _ in range(5):
        tr.train_step()
    tiled = np.asarray(tr.decode(0, div_size=3))
    whole = np.asarray(tr.decode(0))
    np.testing.assert_allclose(tiled, whole, atol=2e-5)


# ----------------------------------------------------------------------
# TRAIN_FORWARD=folded: the fastdecode fold algebra differentiated
# through in training. (x+ε)·W1 = x·W1 + ε·W1, so a single step from an
# identical init must match the gather path to float-reassociation
# tolerance — for BOTH QAT phases and all grid geometries.
# ----------------------------------------------------------------------

import jax


def _one_step(cfg, images, lod, frozen):
    tr = NTCTrainer(cfg, images)
    fn = tr._build_step(lod, frozen, jit=False)
    s = tr.state
    key = jax.random.PRNGKey(7)
    fp, mlp, _, _, loss, _ = fn(s.fp, s.mlp, s.opt_fp, s.opt_mlp, key)
    return fp, mlp, float(loss)


def _assert_folded_equiv(cfg, images, lod=0):
    # algebraic-equivalence check: pin fp32 so bf16 rounding (the round-4
    # MLP_NUM_DTYPE=16 default) doesn't sit inside the tight tolerances
    cfg = dataclasses.replace(cfg, mlp_num_dtype=32)
    cfg_f = dataclasses.replace(cfg, train_forward="folded")
    for frozen in (False, True):
        fp_g, mlp_g, loss_g = _one_step(cfg, images, lod, frozen)
        fp_f, mlp_f, loss_f = _one_step(cfg_f, images, lod, frozen)
        np.testing.assert_allclose(loss_g, loss_f, rtol=1e-4, atol=1e-7)
        for a, b in zip(fp_g, fp_f):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=5e-4, atol=1e-5
            )
        for k in mlp_g:
            np.testing.assert_allclose(
                np.asarray(mlp_g[k]), np.asarray(mlp_f[k]),
                rtol=5e-4, atol=1e-5,
            )


def test_folded_training_forward_2d():
    _assert_folded_equiv(_tiny_cfg(), [_toy_image(32)])


def test_folded_training_forward_2d_mip():
    cfg = _tiny_cfg(tf_no_mip=False, max_mip_level=5)
    img = _toy_image(32)
    mips = [img[:, :: 2**i, :: 2**i] for i in range(6)]
    _assert_folded_equiv(cfg, mips, lod=1)


def _tiny_3d_cfg(method):
    return _tiny_cfg(
        image_size=16, image_dimension=3, compression_method=method,
        crop_mip_level=3, num_crops=2, num_epochs=60, max_mip_level=4,
    )


def _toy_volume():
    rng = np.random.default_rng(0)
    vol = rng.uniform(0, 1, (3, 16, 16, 16)).astype(np.float32)
    return (vol + np.roll(vol, 1, axis=1)) / 2


def test_folded_training_forward_3d_method3():
    _assert_folded_equiv(_tiny_3d_cfg(3), [_toy_volume()])


def test_folded_training_forward_3d_method4_sparse_g0():
    _assert_folded_equiv(_tiny_3d_cfg(4), [_toy_volume()])


def test_folded_training_forward_bf16_runs():
    cfg = _tiny_cfg(mlp_num_dtype=16, train_forward="folded")
    tr = NTCTrainer(cfg, [_toy_image(32)])
    for _ in range(3):
        loss, _, _ = tr.train_step()
    assert np.isfinite(float(loss))


# ----------------------------------------------------------------------
# QAT_NOISE_WHERE=node: noise the active grids' nodes instead of every
# [N, F] decoder-input channel. Different regularizer semantics (the
# interpolated-quantization-error model), so the contract is training
# health, not numeric parity with the reference schedule.
# ----------------------------------------------------------------------


def test_node_noise_overfit_smoke():
    for fwd in ("gather", "folded"):
        cfg = _tiny_cfg(qat_noise_where="node", train_forward=fwd)
        img = _toy_image(32)
        tr = NTCTrainer(cfg, [img])
        for _ in range(cfg.num_epochs):
            loss, _, _ = tr.train_step()
        assert tr.state.frozen
        rec = np.asarray(tr.decode(0))
        p1 = float(psnr(rec * 255, img.transpose(1, 2, 0) * 255,
                        max_value=255.0))
        assert p1 > 14.0, f"{fwd}: node-noise training unhealthy ({p1:.2f} dB)"


def test_node_noise_matches_feature_when_frozen():
    # after the freeze boundary no noise is drawn at all, so the two
    # noise placements must be numerically identical
    cfg_a = _tiny_cfg(qat_noise_where="node")
    cfg_b = _tiny_cfg()
    fp_a, mlp_a, loss_a = _one_step(cfg_a, [_toy_image(32)], 0, True)
    fp_b, mlp_b, loss_b = _one_step(cfg_b, [_toy_image(32)], 0, True)
    np.testing.assert_allclose(loss_a, loss_b, rtol=0, atol=0)
    for a, b in zip(fp_a, fp_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_gate_visibility_log_lines():
    """The trainer logs which forward and decode backend ``auto`` resolved
    to, once per step/decode build; an unknown forward is refused."""
    lines = []
    cfg = _tiny_cfg()
    tr = NTCTrainer(cfg, [_toy_image(32)], log=lines.append)
    tr.train_step()
    tr.decode(0)
    text = "\n".join(str(x) for x in lines)
    assert ("train forward (lod=0, frozen=False): folded "
            "[TRAIN_FORWARD=auto]") in text
    assert "decode backend (mip=0): pallas [DECODE_BACKEND=auto]" in text
    tr2 = NTCTrainer(_tiny_cfg(train_forward="kernel3"), [_toy_image(32)])
    with pytest.raises(ValueError, match="TRAIN_FORWARD must be"):
        tr2._step_fn(0, False)
