"""Host I/O without PIL or OpenCV: the PNG codec, the bilinear mip resize
(against Pillow, which this test environment has), the raw-DIB AVI writer,
and the main path's imports."""

import os
import subprocess
import sys

import numpy as np
import pytest

from nic.data import assets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PNGS = ["data/sancho_512.png", "data/mandrill.png"]


@pytest.mark.parametrize("path", PNGS)
def test_read_png_matches_pillow(path):
    Image = pytest.importorskip("PIL.Image")
    got = assets.read_png(os.path.join(ROOT, path))
    want = np.asarray(Image.open(os.path.join(ROOT, path)))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_round_trip(tmp_path, channels):
    rng = np.random.default_rng(channels)
    shape = (17, 23) if channels == 1 else (17, 23, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    assets.write_png(img, path)
    if channels == 1:
        pytest.importorskip("PIL")
    if channels in (3, 4):
        np.testing.assert_array_equal(assets.read_png(path), img)
    Image = pytest.importorskip("PIL.Image")
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def test_read_png_rejects_unsupported(tmp_path):
    path = str(tmp_path / "g.png")
    assets.write_png(np.zeros((4, 4), np.uint8), path)  # greyscale
    with pytest.raises(ValueError, match="only 8-bit"):
        assets.read_png(path)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        assets.read_png(str(bad))


@pytest.mark.parametrize("hw", [(256, 256), (128, 128), (64, 64), (1, 1),
                                (300, 200), (96, 64), (512, 768), (2, 3)])
@pytest.mark.parametrize("path", PNGS)
def test_resize_matches_pillow_bilinear(path, hw):
    """The mip chain's resize: Pillow's BILINEAR (antialiased triangle on
    downscale) to within one u8 step — here exactly."""
    Image = pytest.importorskip("PIL.Image")
    src = Image.open(os.path.join(ROOT, path)).convert("RGB")
    want = np.asarray(src.resize((hw[1], hw[0]), Image.BILINEAR), np.int32)
    got = assets.resize_bilinear(np.asarray(src), *hw).astype(np.int32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1


def test_load_image_mips_without_pillow(monkeypatch):
    """The mip chain loads with PIL unimportable, and equals the
    Pillow-built chain."""
    Image = pytest.importorskip("PIL.Image")
    path = os.path.join(ROOT, "data/sancho_512.png")
    src = Image.open(path).convert("RGB")
    want = [np.asarray(src.resize((512 >> i, 512 >> i), Image.BILINEAR),
                       np.float32) / 255.0 for i in range(1, 4)]
    monkeypatch.setitem(sys.modules, "PIL", None)
    mips = assets.load_image_mips(path, 512, 3)
    assert [m.shape for m in mips] == [(3, 512 >> i, 512 >> i)
                                       for i in range(4)]
    for got, w in zip(mips[1:], want):
        assert np.abs(got.transpose(1, 2, 0) - w).max() <= 1 / 255 + 1e-6


@pytest.mark.parametrize("shape", [(5, 64, 64, 3), (3, 7, 5, 3),
                                   (1, 16, 48, 3)])
def test_avi_writer_round_trip(tmp_path, shape):
    """write_timelaps writes raw-DIB AVI (rows padded to 4 bytes, stored
    bottom-up) that read_clip reads back bit-exact."""
    rng = np.random.default_rng(sum(shape))
    movie = rng.integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "m.avi")
    assets.write_timelaps(movie, path)
    np.testing.assert_array_equal(assets.read_clip(path), movie)


def test_bundled_clip_round_trips(tmp_path):
    clip = assets.read_clip(os.path.join(ROOT, "data/misty_64_64.avi"))
    assert clip.shape == (64, 64, 64, 3) and clip.dtype == np.uint8
    path = str(tmp_path / "misty.avi")
    assets.write_timelaps(clip, path)
    np.testing.assert_array_equal(assets.read_clip(path), clip)


def test_main_path_imports_no_optional_packages():
    """The 2D/3D train and decode CLIs import nothing beyond numpy, scipy,
    optax, chex, einops and JAX: no flax, PIL, OpenCV or torch."""
    code = (
        "import sys\n"
        "import nic.cli.image_compression, nic.cli.decode, nic.train.ntc\n"
        "import nic.kernels.decode, nic.kernels.decode_sharded\n"
        "bad = [m for m in ('flax', 'PIL', 'cv2', 'torch', 'tensorboardX')\n"
        "       if m in sys.modules]\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", NIC_COMPILE_CACHE="0")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == ""
