"""Dependency-free PNG read/write (zlib + numpy).

Plays the role of stb_image / the swapchain present for this framework:
texture loading (reference ``TextureCache.cpp:50-106`` via stb) and frame
output. Supports non-interlaced 8/16-bit grayscale, RGB, RGBA and palette
images — the formats that matter for game textures.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x89PNG\r\n\x1a\n"


def encode_png(image: np.ndarray) -> bytes:
    """Encode uint8 [H,W], [H,W,3] or [H,W,4] to PNG bytes."""
    img = np.asarray(image)
    assert img.dtype == np.uint8, "write_png expects uint8"
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    data = zlib.compress(raw, 6)

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return _MAGIC + chunk(b"IHDR", ihdr) + chunk(b"IDAT", data) + chunk(b"IEND", b"")


def write_png(path: str, image: np.ndarray) -> None:
    """Write uint8 [H,W], [H,W,3] or [H,W,4] to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_png(image))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG per-row filters. Uses the native helper when available
    (the per-byte Sub/Average/Paeth recurrences are ~1000x faster in C++);
    falls back to a Python row loop."""
    from ..native import unfilter_png

    native = unfilter_png(raw.tobytes(), h, stride, bpp)
    if native is not None:
        return native
    return _unfilter_py(raw, h, stride, bpp)


def _unfilter_py(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Pure-Python fallback (host asset parsing, not a device path)."""
    out = np.zeros((h, stride), np.uint8)
    pos = 0
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = raw[pos]
        row = raw[pos + 1 : pos + 1 + stride].astype(np.int32)
        pos += 1 + stride
        if ftype == 0:
            cur = row
        elif ftype == 1:  # Sub
            cur = row.copy()
            for i in range(bpp, stride):
                cur[i] = (cur[i] + cur[i - bpp]) & 0xFF
        elif ftype == 2:  # Up
            cur = (row + prev) & 0xFF
        elif ftype == 3:  # Average
            cur = row.copy()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            cur = row.copy()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {ftype}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Read to uint8 [H,W,C] (16-bit sources are scaled down to 8)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _MAGIC:
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    idat = b""
    ihdr = None
    palette = None
    trns = None
    while pos < len(buf):
        (length,) = struct.unpack(">I", buf[pos : pos + 4])
        tag = buf[pos + 4 : pos + 8]
        payload = buf[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(payload, np.uint8)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    assert ihdr is not None
    w, h, bit_depth, color_type, _, _, interlace = ihdr
    if interlace:
        raise ValueError(f"{path}: interlaced PNG unsupported")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    bytes_per_sample = bit_depth // 8 if bit_depth >= 8 else 1
    if bit_depth not in (8, 16):
        raise ValueError(f"{path}: bit depth {bit_depth} unsupported")
    bpp = channels * bytes_per_sample
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    data = _unfilter(raw, h, stride, bpp)
    if bit_depth == 16:
        # full 16-bit (big-endian) — the reference loads via stbi_load_16
        # and keeps R16G16B16A16Unorm textures (TextureCache.h:59)
        d = data.reshape(h, w, channels, 2).astype(np.uint16)
        img = (d[..., 0] << 8) | d[..., 1]
    else:
        img = data.reshape(h, w, channels)
    if color_type == 3:  # palette
        assert palette is not None
        rgb = palette[img[..., 0]]
        if trns is not None:
            a = np.full((h, w, 1), 255, np.uint8)
            a[..., 0] = np.where(img[..., 0] < len(trns), trns[np.minimum(img[..., 0], len(trns) - 1)], 255)
            return np.concatenate([rgb, a], axis=-1)
        return rgb
    return img.copy()
