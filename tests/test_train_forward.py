"""TRAIN_FORWARD=folded against gather: the same loss and gradients.

The folded forward folds W1 into the grids at node resolution (the
fastdecode algebra, differentiated through); the gather forward builds the
reference-shaped [N, F] decoder input. One train step's loss and raw
gradients (``NTCTrainer.loss_and_grads``) must agree over every geometry
the trainer takes, and whole runs must track each other step for step.
"""

import dataclasses

import jax
import numpy as np
import pytest

from nic.config import AUTO_TRAIN_FORWARD, CompressionConfig
from nic.train.ntc import NTCTrainer

FP32_TOL = (1e-5, 1e-4)   # (loss rel, worst-leaf grad rel): summation order
BF16_TOL = (1e-2, 5e-2)   # bf16 dot operands keep 8 mantissa bits


def _toy_image(h, w=None):
    w = w or h
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    y, x = y / h, x / w
    return np.clip(np.stack([x, y, 0.5 + 0.5 * np.sin(6 * x * y)]), 0, 1)


def _toy_volume(s=16):
    t, y, x = np.mgrid[0:s, 0:s, 0:s].astype(np.float32) / s
    return np.clip(np.stack([x, y, (t + x * y) / 2]), 0, 1)


def _cfg(**kw):
    base = dict(image_size=32, crop_mip_level=4, num_crops=2, num_epochs=40,
                fp_bits=8, feature_pyramid_channels=4, pe_channels=4,
                hidden_layer_channels=16, tf_no_mip=True, seed=0,
                mlp_num_dtype=32)
    base.update(kw)
    return CompressionConfig(**base)


def _images(cfg):
    if cfg.image_dimension == 3:
        return [_toy_volume(cfg.image_size)] * (cfg.effective_max_mip_level + 1)
    h, w = cfg.image_hw
    return [_toy_image(h >> i, w >> i)
            for i in range(cfg.effective_max_mip_level + 1)]


def _rel(a, b):
    worst = 0.0
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        worst = max(worst, float(np.abs(x - y).max()
                                 / (np.abs(y).max() + 1e-30)))
    return worst


def _compare(cfg, lod=0, tol=FP32_TOL, seed=3):
    key = jax.random.key(seed, impl=cfg.rng_impl)
    out = {}
    for fwd in ("gather", "folded"):
        tr = NTCTrainer(dataclasses.replace(cfg, train_forward=fwd),
                        _images(cfg))
        with jax.default_matmul_precision("highest"):
            loss, grads = tr.loss_and_grads(key, lod=lod)
        assert tr._forward_mode == fwd
        out[fwd] = (float(loss), grads)
    (l_g, g_g), (l_f, g_f) = out["gather"], out["folded"]
    assert np.isfinite(l_g) and l_g > 0
    assert abs(l_f - l_g) / l_g <= tol[0], (l_f, l_g)
    assert _rel(g_f, g_g) <= tol[1]
    return out


@pytest.mark.parametrize("noise", ["feature", "node"])
@pytest.mark.parametrize("crop_mip", [3, 4, 5])
def test_folded_matches_gather_2d(crop_mip, noise):
    _compare(_cfg(crop_mip_level=crop_mip, qat_noise_where=noise,
                  image_size=64 if crop_mip == 5 else 32))


@pytest.mark.parametrize("lod", [0, 1, 2, 3])
def test_folded_matches_gather_mip_lods(lod):
    """Each LOD branch of mip training: its own crop size, grid level and
    G1 step (lod 1 is the step==2 raw-sum quirk at this size)."""
    _compare(_cfg(tf_no_mip=False, max_mip_level=3), lod=lod)


def test_folded_matches_gather_g1_quirk_off():
    _compare(_cfg(tf_no_mip=False, max_mip_level=3, tf_g1_quirk=False),
             lod=1)


@pytest.mark.parametrize("hw", [(32, 64), (64, 32)])
@pytest.mark.parametrize("noise", ["feature", "node"])
def test_folded_matches_gather_rect(hw, noise):
    _compare(_cfg(image_size=hw[0], image_size_w=hw[1],
                  qat_noise_where=noise))


@pytest.mark.parametrize("noise", ["feature", "node"])
@pytest.mark.parametrize("method", [3, 4])
def test_folded_matches_gather_3d(method, noise):
    """Methods 3 (dense 8-corner G0, tri-PE) and 4 (sparse G0, sin PE)."""
    _compare(_cfg(image_size=16, image_dimension=3, compression_method=method,
                  crop_mip_level=3, max_mip_level=4, qat_noise_where=noise))


@pytest.mark.parametrize("lod", [0, 1])
def test_folded_matches_gather_rect_mip(lod):
    """Rectangular geometry in mip/LOD mode: per-axis crops at each LOD."""
    _compare(_cfg(image_size=32, image_size_w=64, tf_no_mip=False,
                  max_mip_level=2), lod=lod)


@pytest.mark.parametrize("num_crops", [1, 4])
def test_folded_matches_gather_num_crops(num_crops):
    _compare(_cfg(num_crops=num_crops))


@pytest.mark.parametrize("use_tri_pe", [True, False])
def test_folded_matches_gather_pe_family(use_tri_pe):
    _compare(_cfg(tf_use_tri_pe=use_tri_pe))


@pytest.mark.parametrize("noise", ["feature", "node"])
def test_folded_matches_gather_bf16(noise):
    """MLP_NUM_DTYPE=16 (bf16 dot operands, the default): same algebra,
    bf16 rounding in different places."""
    _compare(_cfg(mlp_num_dtype=16, qat_noise_where=noise), tol=BF16_TOL)


@pytest.mark.parametrize("fp_bits", [2, 4])
def test_folded_matches_gather_fp_bits(fp_bits):
    """The QAT noise amplitude follows FP_BITS; both forms draw the same
    noise from the same key."""
    _compare(_cfg(fp_bits=fp_bits))


def _losses(cfg, steps, chunk):
    tr = NTCTrainer(cfg, _images(cfg))
    losses, _ = tr.train_many(steps, chunk=chunk)
    return np.asarray(losses), tr


@pytest.mark.parametrize("tf_no_mip", [True, False])
def test_folded_tracks_gather_across_freeze(tf_no_mip):
    """Whole runs across the 95% freeze boundary (the frozen phase
    differentiates only the MLP), no-mip and mip/LOD."""
    res = {}
    for fwd in ("gather", "folded"):
        cfg = _cfg(num_epochs=24, train_forward=fwd, tf_no_mip=tf_no_mip,
                   max_mip_level=3)
        with jax.default_matmul_precision("highest"):
            res[fwd], tr = _losses(cfg, 24, 8)
        assert tr.state.frozen
    np.testing.assert_allclose(res["folded"], res["gather"], rtol=1e-4)


def test_folded_under_mesh_matches_single_device():
    """The folded forward under a data-parallel 8-device mesh: the same
    losses as on one device."""
    from nic.parallel.mesh import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    cfg = _cfg(num_crops=8, train_forward="folded")
    one, _ = _losses(cfg, 4, 4)
    mesh = make_mesh(8, data_axis=8)
    with mesh:
        tr = NTCTrainer(cfg, _images(cfg), mesh=mesh)
        many = np.asarray(tr.train_many(4, chunk=4)[0])
    np.testing.assert_allclose(many, one, rtol=1e-5)


def test_auto_resolves_to_folded():
    assert AUTO_TRAIN_FORWARD == "folded"
    assert _cfg().resolved_train_forward == "folded"
    assert _cfg(train_forward="gather").resolved_train_forward == "gather"
    with pytest.raises(ValueError, match="TRAIN_FORWARD"):
        _ = _cfg(train_forward="kernel3").resolved_train_forward


def test_train_many_one_program_per_phase():
    """Chunks of any size, boundary chunks included, reuse one compiled
    loop per (phase, chunk): nothing recompiles mid-run, and every step
    that runs records a loss."""
    cfg = _cfg(num_epochs=100)
    tr = NTCTrainer(cfg, _images(cfg))
    for n in (25, 30, 7, 38):
        losses, _ = tr.train_many(n, chunk=32)
        assert losses.shape == (n,) and np.isfinite(losses).all()
    loops = [k for k in tr._step_fns if k[0] == "loop"]
    assert sorted(loops) == [("loop", False, 32), ("loop", True, 32)]
    assert tr.state.step == 100 and tr.state.frozen
