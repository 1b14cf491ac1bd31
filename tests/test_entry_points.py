"""Contracts of the GPU entry points and the configuration around them:
chip_smoke.py and bench.py refuse to run without a GPU, the compile cache
follows JAX_COMPILATION_CACHE_DIR, the decode and train modes resolve
without a platform branch, and the CLIs report what they measured."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from nic.config import CompressionConfig, parse_overrides

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=ROOT, **env):
    full = dict(os.environ, JAX_PLATFORMS="cpu", NIC_COMPILE_CACHE="0")
    full.update(env)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=full,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script,args", [("chip_smoke.py", []),
                                         ("chip_smoke.py", ["--multi"]),
                                         ("bench.py", [])])
def test_gpu_scripts_fail_without_gpu(script, args):
    out = _run([script] + args)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and out.stdout.strip() == ""
    assert "needs a GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied away from the repo, the script cannot import nic."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run([str(tmp_path / "chip_smoke.py")], cwd=str(tmp_path),
               PYTHONPATH="")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_dir(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the fixed
    .jax_cache at the repo root."""
    code = "import nic, jax; print(jax.config.jax_compilation_cache_dir)"
    env = {"NIC_COMPILE_CACHE": "1"}
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    else:
        env["JAX_COMPILATION_CACHE_DIR"] = ""
    out = _run(["-c", code], **env)
    assert out.returncode == 0, out.stderr[-2000:]
    want = str(tmp_path) if env_dir else os.path.join(ROOT, ".jax_cache")
    assert out.stdout.strip() == want


@pytest.mark.parametrize("value,want", [("auto", "pallas"),
                                        ("pallas", "pallas"),
                                        ("fast", "fast"), ("xla", "xla")])
def test_decode_backend_resolves(value, want):
    cfg = parse_overrides([f"DECODE_BACKEND={value}"])
    assert cfg.resolved_decode_backend == want


def test_decode_backend_rejects_unknown():
    with pytest.raises(ValueError, match="decode backend"):
        _ = parse_overrides(["DECODE_BACKEND=i16"]).resolved_decode_backend


def test_guards_are_opt_in():
    cfg = CompressionConfig()
    assert not cfg.sdc_guard_train and not cfg.sdc_guard_decode
    cfg = parse_overrides(["SDC_GUARD_DECODE=True", "SDC_GUARD_TRAIN=1"])
    assert cfg.sdc_guard_decode and cfg.sdc_guard_train
    with pytest.raises(ValueError, match="unknown config key"):
        parse_overrides(["TRAIN_GELU=poly"])


def test_save_name_names_no_device():
    assert CompressionConfig().save_name.startswith(
        "image_compression_jax_sancho_512.png_16_")


def _small_cli_args(tmp_path, *extra):
    return ["IMAGE_PATH=data/sancho_512.png", "IMAGE_SIZE=32",
            "MAX_MIP_LEVEL=5", "CROP_MIP_LEVEL=4", "NUM_EPOCHS=24",
            "INTERVAL_PRINT=8", "FEATURE_PYRAMID_CHANNELS=4",
            "PE_CHANNELS=4", "HIDDEN_LAYER_CHANNELS=16",
            f"OUTPUT_ROOT={tmp_path}", "TF_WRITE_TIME=False", *extra]


@pytest.mark.parametrize("guard", [False, True])
def test_image_compression_reports_chunks(tmp_path, guard, monkeypatch):
    """run() returns per-chunk (steps, seconds, last loss, mean loss);
    with SDC_GUARD_DECODE every scored decode runs twice."""
    from nic.cli import image_compression
    import nic.obs.integrity as integrity

    calls = []
    real = integrity.verified_result

    def spy(fn, **kw):
        calls.append(1)
        return real(fn, **kw)

    monkeypatch.setattr(integrity, "verified_result", spy)
    monkeypatch.chdir(ROOT)
    res = image_compression.run(_small_cli_args(
        tmp_path, f"SDC_GUARD_DECODE={guard}"))
    chunks = res["train_chunks"]
    assert [c[0] for c in chunks] == [8, 8, 8]
    assert all(c[1] > 0 and np.isfinite(c[2]) and np.isfinite(c[3])
               for c in chunks)
    assert bool(calls) == guard
    assert res["bpp"] > 0 and np.isfinite(res["psnr"][0])


@pytest.mark.parametrize("args", [[], ["--verify"], ["--devices", "4"],
                                  ["--devices", "4", "--backend", "fast"]])
def test_decode_cli_modes(tmp_path, args, capsys, monkeypatch):
    """The decode CLI on one device, verified, and row-sharded over the
    virtual devices all give the same image."""
    from nic.cli import decode, image_compression

    monkeypatch.chdir(ROOT)
    image_compression.run(_small_cli_args(tmp_path, "TF_PRINT_PSNR=False"))
    art = os.path.join(tmp_path, "artifacts", parse_overrides(
        _small_cli_args(tmp_path)[:-2]).save_name + ".npz")
    want = decode.run([art, "--backend", "fast"])
    got = decode.run([art] + args)
    assert got.shape == (32, 32, 3)
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert "GPix/s" in capsys.readouterr().out
