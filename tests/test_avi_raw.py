"""Pure-python raw-DIB AVI reader (cv2 heap-corrupts on these files)."""

import os
import struct

import numpy as np
import pytest

from nic.data.assets import _read_avi_raw_dib, read_clip


def _write_raw_avi(path, frames):
    """Minimal RIFF/AVI with BI_RGB 24-bit '00db' chunks (bottom-up rows)."""
    t, h, w, _ = frames.shape
    row_bytes = (w * 3 + 3) & ~3

    def chunk(fourcc, payload):
        pad = b"\x00" if len(payload) % 2 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    def lst(kind, payload):
        return chunk(b"LIST", kind + payload)

    bih = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, row_bytes * h,
                      0, 0, 0, 0)
    strh = chunk(b"strh", b"vids" + b"\x00" * 52)
    strf = chunk(b"strf", bih)
    avih = chunk(b"avih", struct.pack("<14I", 33333, 0, 0, 0, t, 0, 1, 0,
                                      w, h, 0, 0, 0, 0))
    hdrl = lst(b"hdrl", avih + lst(b"strl", strh + strf))
    movi_payload = b"movi"
    for i in range(t):
        dib = frames[i][::-1]  # bottom-up
        rows = b"".join(
            dib[r].tobytes() + b"\x00" * (row_bytes - w * 3) for r in range(h)
        )
        movi_payload += chunk(b"00db", rows)
    riff = b"AVI " + hdrl + b"LIST" + struct.pack("<I", len(movi_payload)) + movi_payload
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff)) + riff)


def test_raw_dib_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (5, 6, 10, 3)).astype(np.uint8)  # padded rows
    p = str(tmp_path / "raw.avi")
    _write_raw_avi(p, frames)
    got = _read_avi_raw_dib(p)
    assert got is not None
    np.testing.assert_array_equal(got, frames)
    # read_clip routes through the raw reader
    np.testing.assert_array_equal(read_clip(p), frames)


@pytest.mark.skipif(not os.path.exists("data/misty_64_64.avi"),
                    reason="bundled asset absent")
def test_misty_reads_without_cv2():
    v = _read_avi_raw_dib("data/misty_64_64.avi")
    assert v is not None and v.shape == (64, 64, 64, 3)
    assert v.std() > 10  # real image content, not zeros


def test_compressed_avi_falls_back_to_cv2(tmp_path):
    import cv2

    movie = (np.random.default_rng(1).uniform(0, 255, (4, 16, 16, 3))).astype(np.uint8)
    p = str(tmp_path / "mp4v.avi")
    out = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 30, (16, 16))
    for frame in movie:
        out.write(frame)
    out.release()
    # mp4v-coded → the raw reader returns None and read_clip uses cv2
    assert _read_avi_raw_dib(p) is None
    assert read_clip(p).shape == (4, 16, 16, 3)
