"""Host-side asset I/O: images, AVI video, npy LUTs, mip chains.

Everything here stays on the host and out of jit (the reference keeps
OpenCV/PIL on the CPU too — utils.py:67-94, image_compression.py:429-477 of
21K1113/Neural_Image_Compression_V2). PNG, the bilinear mip resize and raw
DIB AVI are read and written with numpy and the standard library; OpenCV
is needed only to read compressed clips. Arrays are float32 CHW (/CTHW) in
[0, 1], the layout the trainers upload to device once per run.
"""

from __future__ import annotations

import math
import os
import zlib

import numpy as np

__all__ = [
    "asset_kind",
    "load_image_mips",
    "read_clip",
    "write_timelaps",
    "load_volume",
    "flatten_3d_to_2d",
    "unflatten_2d_to_3d",
    "save_png",
    "read_png",
    "write_png",
    "resize_bilinear",
    "save_lut_csv",
]


def asset_kind(path: str) -> str:
    """File extension → data kind (utils.py:330-336 semantics)."""
    ext = os.path.splitext(path)[1][1:].lower()
    if ext in ("npy", "npz"):
        return "ndarray"
    if ext in ("avi", "mp4"):
        return "movie"
    if ext in ("png", "jpg", "jpeg"):
        return "image"
    raise ValueError(f"unsupported asset extension: {ext!r}")


def load_image_mips(path: str, image_size: int, max_mip_level: int,
                    image_size_w: int = 0) -> list[np.ndarray]:
    """RGB image → list of [3, H/2^i, W/2^i] float32 mips in [0,1].

    Parity with the reference's PIL Resize + ToTensor mip chain
    (image_compression.py:429-442): bilinear resize of the *original* per
    mip (not successive halving), through :func:`resize_bilinear`.
    ``image_size_w`` (0 = square) selects native rectangular geometry —
    with H, W matching the file, no resampling happens at mip 0."""
    img = read_png(path)[..., :3]
    w0 = image_size_w or image_size
    mips = []
    for i in range(max_mip_level + 1):
        h = image_size // (2**i)
        w = w0 // (2**i)
        arr = resize_bilinear(img, h, w).astype(np.float32) / 255.0
        mips.append(arr.transpose(2, 0, 1))  # [3, H, W]
    return mips


_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def read_png(path: str) -> np.ndarray:
    """8-bit non-interlaced PNG (colour type 2 RGB or 6 RGBA) → [H, W, C]
    uint8, with stdlib ``zlib`` and numpy."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        size = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + size]
        pos += 12 + size
        if kind == b"IHDR":
            hdr = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None or len(hdr) < 13:
        raise ValueError(f"{path}: PNG has no valid IHDR chunk")
    width = int.from_bytes(hdr[0:4], "big")
    height = int.from_bytes(hdr[4:8], "big")
    depth, ctype, interlace = hdr[8], hdr[9], hdr[12]
    if depth != 8 or ctype not in (2, 6) or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced RGB/RGBA PNG "
                         f"is supported (depth={depth}, colour type={ctype}, "
                         f"interlace={interlace})")
    bpp = 3 if ctype == 2 else 4
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        ftype, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype == 1:  # Sub: running sum per channel
            line = np.cumsum(line.reshape(width, bpp), axis=0).reshape(-1)
        elif ftype == 2:  # Up
            line = line + prev
        elif ftype in (3, 4):  # Average / Paeth: sequential along the row
            line = _unfilter_seq(line.tolist(), prev.tolist(), bpp, ftype)
        elif ftype != 0:
            raise ValueError(f"{path}: bad PNG filter type {ftype}")
        cur = np.asarray(line, np.int32) & 0xFF
        out[y] = cur
        prev = cur
    return out.reshape(height, width, bpp)


def _unfilter_seq(line: list, prev: list, bpp: int, ftype: int) -> list:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        if ftype == 3:
            line[i] = (line[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF
    return line


def write_png(image_u8: np.ndarray, path: str) -> None:
    """[H, W, 3|4] (or [H, W] grey) uint8 → 8-bit PNG, filter 0 rows."""
    img = np.ascontiguousarray(image_u8, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return (len(body).to_bytes(4, "big") + kind + body
                + crc.to_bytes(4, "big"))

    ihdr = (w.to_bytes(4, "big") + h.to_bytes(4, "big")
            + bytes([8, ctype, 0, 0, 0]))
    with open(path, "wb") as f:
        f.write(_PNG_SIG + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


_PREC = 22  # fixed-point bits of an 8-bit resample coefficient


def _resample_taps(in_size: int, out_size: int):
    """Per-output (first input index, fixed-point triangle weights) of a
    bilinear resample, antialiased on downscale (support grows with the
    scale), with the coefficients rounded to 22 fractional bits."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = fscale
    taps = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, taps), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        x = np.arange(xmin, xmax, dtype=np.float64)
        w = np.maximum(0.0, 1.0 - np.abs((x - center + 0.5) / fscale))
        if w.sum():
            w = w / w.sum()
        k = w * (1 << _PREC)
        first[xx] = xmin
        weights[xx, :len(k)] = np.where(k < 0, k - 0.5, k + 0.5).astype(
            np.int64)
    return first, weights


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    in_size = img.shape[axis]
    first, weights = _resample_taps(in_size, out_size)
    x = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + x.shape[1:], 1 << (_PREC - 1), np.int64)
    for t in range(weights.shape[1]):
        idx = np.minimum(first + t, in_size - 1)
        w = weights[:, t].reshape((-1,) + (1,) * (x.ndim - 1))
        acc += x[idx] * w
    out = np.clip(acc >> _PREC, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """[H, W, C] uint8 → [h, w, C] uint8 with Pillow's ``BILINEAR``
    semantics: a separable triangle filter whose support widens with the
    downscale factor, fixed-point coefficients, columns first, an 8-bit
    rounding between the passes."""
    if img.shape[1] != w:
        img = _resample_axis(img, w, axis=1)
    if img.shape[0] != h:
        img = _resample_axis(img, h, axis=0)
    return img


def _riff_chunks(data: bytes, start: int, end: int):
    """Iterate (fourcc, payload_start, payload_size) over a RIFF chunk run."""
    pos = start
    while pos + 8 <= end:
        fourcc = data[pos : pos + 4]
        size = int.from_bytes(data[pos + 4 : pos + 8], "little")
        yield fourcc, pos + 8, size
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def _read_avi_raw_dib(path: str) -> np.ndarray | None:
    """Pure-python reader for AVIs carrying uncompressed DIB video
    ('00db' chunks, BI_RGB 24-bit) — the format of the reference's bundled
    misty_*.avi assets. Returns [T, H, W, 3] uint8 in BGR top-down order
    (what cv2 would produce), or None if the file is not raw-DIB."""
    data = open(path, "rb").read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        return None
    strf = data.find(b"strf")
    if strf < 0:
        return None
    bih = data[strf + 8 : strf + 8 + 40]  # BITMAPINFOHEADER
    width = int.from_bytes(bih[4:8], "little", signed=True)
    height = int.from_bytes(bih[8:12], "little", signed=True)
    bit_count = int.from_bytes(bih[14:16], "little")
    compression = int.from_bytes(bih[16:20], "little")
    if compression != 0 or bit_count != 24:  # BI_RGB only
        return None
    bottom_up = height > 0
    height = abs(height)
    row_bytes = (width * 3 + 3) & ~3  # rows padded to 4 bytes
    frames = []
    pos = data.find(b"movi")
    if pos < 0:
        return None
    for fourcc, payload, size in _riff_chunks(data, pos + 4, len(data)):
        if fourcc[2:4] in (b"db", b"dc") and size >= row_bytes * height:
            raw = np.frombuffer(data, np.uint8, count=row_bytes * height,
                                offset=payload)
            frame = raw.reshape(height, row_bytes)[:, : width * 3]
            frame = frame.reshape(height, width, 3)
            frames.append(frame[::-1] if bottom_up else frame)
    if not frames:
        return None
    return np.stack(frames)


def read_clip(path: str) -> np.ndarray:
    """AVI/MP4 → [T, H, W, 3] uint8 (BGR, as the reference reads it —
    utils.py:67-80 uses raw cv2 frames; colour order round-trips through
    the matching writer).

    Raw-DIB AVIs decode through the pure-python RIFF reader (this image's
    OpenCV corrupts the heap demuxing them); everything else via cv2."""
    if path.lower().endswith(".avi"):
        raw = _read_avi_raw_dib(path)
        if raw is not None:
            return raw.astype(np.uint8)
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    frames = []
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        frames.append(frame)
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames).astype(np.uint8)


def write_timelaps(movie: np.ndarray, path: str, frame_rate: int = 32) -> None:
    """[T, H, W, 3] uint8 (BGR, as :func:`read_clip` returns it) → an
    uncompressed DIB AVI (BI_RGB, 24-bit, bottom-up rows), the format
    :func:`read_clip` reads natively (utils.py:85-94 semantics; frame
    count and size come from the array)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    t, h, w, _ = movie.shape
    row_bytes = (w * 3 + 3) & ~3
    frame_bytes = row_bytes * h
    u32 = lambda v: int(v).to_bytes(4, "little")

    def chunk(fourcc: bytes, body: bytes) -> bytes:
        return fourcc + u32(len(body)) + body + (b"\0" if len(body) & 1
                                                 else b"")

    def lst(kind: bytes, body: bytes) -> bytes:
        return chunk(b"LIST", kind + body)

    avih = b"".join(u32(v) for v in (
        1_000_000 // frame_rate, frame_bytes * frame_rate, 0, 0x10, t, 0, 1,
        frame_bytes, w, h, 0, 0, 0, 0))
    strh = (b"vids" + b"DIB " + u32(0) + u32(0) + u32(0) + u32(1)
            + u32(frame_rate) + u32(0) + u32(t) + u32(frame_bytes)
            + u32(0xFFFFFFFF) + u32(0)
            + b"".join(v.to_bytes(2, "little") for v in (0, 0, w, h)))
    strf = b"".join(u32(v) for v in (40, w, h)) + (1).to_bytes(2, "little") \
        + (24).to_bytes(2, "little") + b"".join(
            u32(v) for v in (0, frame_bytes, 0, 0, 0, 0))
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(
        b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    pad = np.zeros((h, row_bytes - w * 3), np.uint8)
    frames, index, offset = [], [], 4
    for i in range(t):
        rows = np.ascontiguousarray(movie[i, ::-1], np.uint8).reshape(h, -1)
        body = np.concatenate([rows, pad], axis=1).tobytes()
        frames.append(chunk(b"00db", body))
        index.append(b"00db" + u32(0x10) + u32(offset) + u32(len(body)))
        offset += len(frames[-1])
    movi = lst(b"movi", b"".join(frames))
    riff = chunk(b"RIFF", b"AVI " + hdrl + movi
                 + chunk(b"idx1", b"".join(index)))
    with open(path, "wb") as f:
        f.write(riff)


def load_volume(path: str, image_bits: int = 8) -> np.ndarray:
    """Movie/ndarray asset → [T, H, W, 3] float array of b-bit code values
    (0..2^b-1), re-quantized like image_compression.py:443-449."""
    from nic.core.quant import quantize, normalize_from_bit, scale_to_bit

    if asset_kind(path) == "movie":
        vol = read_clip(path).astype(np.float64)
    else:
        vol = np.load(path).astype(np.float64)
    # quantize_from_bit_to_bit parity (models.py:44-45)
    return np.asarray(scale_to_bit(quantize(normalize_from_bit(vol, image_bits), image_bits), image_bits))


def flatten_3d_to_2d(volume: np.ndarray, image_size: int) -> np.ndarray:
    """[T, S, S, 3] → one [R, R, 3] tile sheet (method 2,
    image_compression.py:453-459): frame i goes to tile
    (i // (R/S), i % (R/S))."""
    t, s = volume.shape[0], volume.shape[1]
    per_row = image_size // s
    sheet = np.zeros((image_size, image_size, volume.shape[3]), dtype=volume.dtype)
    for i in range(t):
        r, c = divmod(i, per_row)
        sheet[r * s : (r + 1) * s, c * s : (c + 1) * s] = volume[i]
    return sheet


def unflatten_2d_to_3d(sheet: np.ndarray, frame_size: int, num_frames: int) -> np.ndarray:
    """Inverse of :func:`flatten_3d_to_2d` (image_compression.py:414-421)."""
    per_row = sheet.shape[0] // frame_size
    frames = []
    for i in range(num_frames):
        r, c = divmod(i, per_row)
        frames.append(
            sheet[r * frame_size : (r + 1) * frame_size, c * frame_size : (c + 1) * frame_size]
        )
    return np.stack(frames)


def save_png(image_u8: np.ndarray, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(image_u8, path)


def save_lut_csv(lut: np.ndarray, path: str) -> None:
    """[S, S, S, 3] LUT → CSV rows over (diag_angle, angle) with refangle·3
    values per row (utils.py:97-113 layout, sample22-x export)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    s = lut.shape[0]
    with open(path, "w") as f:
        for a in range(s):
            for b in range(s):
                row = ",".join(
                    str(float(lut[a, b, r, c])) for r in range(s) for c in range(3)
                )
                f.write(row + ",\n")
