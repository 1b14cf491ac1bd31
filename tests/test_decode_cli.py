"""Decoder-only runtime CLI: train → save artifact → decode standalone."""

import dataclasses
import os

import numpy as np

from nic.config import CompressionConfig
from nic.io.artifacts import save_compressed
from nic.train.ntc import NTCTrainer


def test_decode_cli_roundtrip(tmp_path):
    from nic.cli.decode import run as decode_run

    cfg = CompressionConfig(
        image_size=32, crop_mip_level=4, num_crops=2, num_epochs=40,
        fp_bits=4, feature_pyramid_channels=4, pe_channels=4,
        hidden_layer_channels=16, tf_no_mip=True, seed=0,
    )
    y, x = np.mgrid[0:32, 0:32].astype(np.float32) / 32
    img = np.clip(np.stack([x, y, x * y], axis=0), 0, 1)
    tr = NTCTrainer(cfg, [img])
    tr.train_many(40)
    tr.freeze_and_quantize()
    art = str(tmp_path / "a.npz")
    save_compressed(art, tr.state.mlp, tr.state.fp, cfg.fp_bits, {
        "config": {
            "image_size": 32, "pe_channels": 4, "tf_use_tri_pe": True,
            "tf_no_mip": True,
        },
    })
    out_png = str(tmp_path / "o.png")
    rec = decode_run([art, "--mip", "0", "--out", out_png])
    assert rec.shape == (32, 32, 3)
    assert os.path.exists(out_png)
    # standalone decode equals the trainer's decode
    np.testing.assert_allclose(
        rec, np.clip(np.asarray(tr.decode(0)), 0, 1), atol=1e-5
    )

def _train_3d(method: int, tf_use_tri_pe: bool = True):
    cfg = CompressionConfig(
        image_size=16, image_dimension=3, compression_method=method,
        crop_mip_level=3, num_crops=2, num_epochs=30, fp_bits=4,
        feature_pyramid_channels=4, pe_channels=4, hidden_layer_channels=16,
        tf_no_mip=True, tf_use_tri_pe=tf_use_tri_pe, seed=0,
    )
    rng = np.random.default_rng(0)
    vol = rng.uniform(0, 1, (3, 16, 16, 16)).astype(np.float32)
    tr = NTCTrainer(cfg, [vol])
    tr.train_many(30)
    tr.freeze_and_quantize()
    return cfg, tr


def _save_art(tmp_path, cfg, tr, name):
    art = str(tmp_path / name)
    save_compressed(art, tr.state.mlp, tr.state.fp, cfg.fp_bits, {
        "config": {
            "image_size": cfg.image_size, "pe_channels": cfg.pe_channels,
            "tf_use_tri_pe": cfg.tf_use_tri_pe, "tf_no_mip": cfg.tf_no_mip,
            "compression_method": cfg.compression_method,
            "image_dimension": cfg.image_dimension,
        },
    })
    return art


def test_decode_cli_method4_sparse_g0(tmp_path):
    """Method-4 artifacts decode standalone: sparse_g0 + sinusoidal PE must
    be derived from the stored compression_method (ADVICE r1: previously a
    shape error)."""
    from nic.cli.decode import run as decode_run

    cfg, tr = _train_3d(4)
    art = _save_art(tmp_path, cfg, tr, "m4.npz")
    for backend in ("fast", "xla"):
        rec = decode_run([art, "--backend", backend])
        np.testing.assert_allclose(
            rec, np.clip(np.asarray(tr.decode(0)), 0, 1), atol=2e-5
        )


def test_decode_cli_method3_ignores_raw_tri_pe_flag(tmp_path):
    """A 3D method-3 artifact trained with TF_USE_TRI_PE=False still uses
    triangular PE (the trainer forces it); the runtime must apply the same
    rule instead of trusting the raw flag (ADVICE r1: silent garbage)."""
    from nic.cli.decode import run as decode_run

    cfg, tr = _train_3d(3, tf_use_tri_pe=False)
    art = _save_art(tmp_path, cfg, tr, "m3.npz")
    rec = decode_run([art, "--backend", "fast"])
    np.testing.assert_allclose(
        rec, np.clip(np.asarray(tr.decode(0)), 0, 1), atol=2e-5
    )


def test_decode_cli_pallas_handles_sparse_g0(tmp_path):
    """A method-4 (sparse-G0) 3D artifact decodes through the Triton
    kernel (the sparse corner set only changes the XLA fold) and matches
    the XLA fast path."""
    import numpy as np

    from nic.cli.decode import run as decode_run

    cfg, tr = _train_3d(4)
    art = _save_art(tmp_path, cfg, tr, "m4b.npz")
    got = np.asarray(decode_run([art, "--backend", "pallas"]))
    want = np.asarray(decode_run([art, "--backend", "fast"]))
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_decode_cli_rejects_kernel_modes_elsewhere(tmp_path, capsys):
    """--dtype/--gelu select kernel modes: asking for them on another
    backend is an error, not a silently ignored flag; on the kernel a
    thumbnail mip (e = 2) decodes like the fast path, with no fallback."""
    import pytest

    from nic.cli.decode import run as decode_run

    cfg = CompressionConfig(
        image_size=32, crop_mip_level=4, num_crops=2, num_epochs=10,
        fp_bits=4, feature_pyramid_channels=4, pe_channels=4,
        hidden_layer_channels=16, tf_no_mip=True, seed=0,
    )
    y, x = np.mgrid[0:32, 0:32].astype(np.float32) / 32
    img = np.clip(np.stack([x, y, x * y], axis=0), 0, 1)
    tr = NTCTrainer(cfg, [img])
    tr.train_many(10)
    tr.freeze_and_quantize()
    art = str(tmp_path / "a.npz")
    save_compressed(art, tr.state.mlp, tr.state.fp, cfg.fp_bits, {
        "config": {
            "image_size": 32, "pe_channels": 4, "tf_use_tri_pe": True,
            "tf_no_mip": True,
        },
    })

    with pytest.raises(SystemExit):
        decode_run([art, "--backend", "fast", "--dtype", "bf16"])
    assert "apply to the pallas backend" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        decode_run([art, "--backend", "xla", "--gelu", "tanh"])

    # mip 4 on the 32² no-mip map is e = 2
    got = decode_run([art, "--backend", "pallas", "--mip", "4"])
    want = decode_run([art, "--backend", "fast", "--mip", "4"])
    assert got.shape == (2, 2, 3)
    np.testing.assert_allclose(got, want, atol=2e-5)
    out = capsys.readouterr().out
    assert "backend=pallas" in out and "backend=fast" in out
