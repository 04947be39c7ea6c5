"""Minimal OpenEXR reader — the tinyexr role (reference
``TextureCache::LoadHdri``, ``TextureCache.cpp:109-165``: RGBA32F HDRIs).

Supports single-part scanline images, NONE/ZIP/ZIPS compression, HALF and
FLOAT channels. Returns float32 [H,W,C]. Dependency-free (zlib only).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}  # UINT, HALF, FLOAT


def _read_cstr(buf, pos):
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _unpredict_deinterleave(data: bytes) -> bytes:
    """EXR ZIP post-processing: undo delta predictor, then de-interleave
    the two halves."""
    d = np.frombuffer(data, np.uint8).astype(np.int32).copy()
    # predictor: d[i] += d[i-1] - 128
    d = (np.cumsum(d - 128) + 128) % 256
    d = d.astype(np.uint8)
    # interleave: first half -> even positions, second half -> odd
    out = np.empty_like(d)
    half = (len(d) + 1) // 2
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out.tobytes()


def read_exr(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack("<ii", buf[:8])
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR")
    if version & 0x200:
        raise ValueError("multi-part EXR unsupported")
    pos = 8

    channels = []  # (name, pixel_type)
    compression = 0
    data_window = None
    while True:
        name, pos = _read_cstr(buf, pos)
        if not name:
            break
        atype, pos = _read_cstr(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        payload = buf[pos : pos + size]
        pos += size
        if name == "channels":
            cpos = 0
            while payload[cpos] != 0:
                cname, cpos = _read_cstr(payload, cpos)
                ptype, _pl, _x, _y = struct.unpack_from("<iiii", payload, cpos)
                cpos += 16
                channels.append((cname, ptype))
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", payload)
    if compression not in (0, 2, 3):
        raise ValueError(f"EXR compression {compression} unsupported (NONE/ZIP/ZIPS only)")
    x0, y0, x1, y1 = data_window
    width = x1 - x0 + 1
    height = y1 - y0 + 1
    lines_per_block = 1 if compression in (0, 2) else 16

    n_blocks = -(-height // lines_per_block)
    offsets = struct.unpack_from(f"<{n_blocks}q", buf, pos)

    # channel order in the file is alphabetical
    chans = sorted(channels)
    bytes_per_line = sum(np.dtype(_PIXEL_DTYPES[t]).itemsize for _, t in chans) * width
    out = {c: np.zeros((height, width), np.float32) for c, _ in chans}

    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        raw = buf[off + 8 : off + 8 + size]
        n_lines = min(lines_per_block, y1 - y + 1)
        expect = bytes_per_line * n_lines
        if compression == 0:
            data = raw
        else:
            data = zlib.decompress(raw)
            if len(data) == expect:
                data = _unpredict_deinterleave(data)
            else:
                data = _unpredict_deinterleave(data)
        data = data[:expect]
        lpos = 0
        for ly in range(n_lines):
            for cname, ptype in chans:
                dt = np.dtype(_PIXEL_DTYPES[ptype])
                n = width * dt.itemsize
                arr = np.frombuffer(data, dt, width, lpos)
                out[cname][y - y0 + ly] = arr.astype(np.float32)
                lpos += n
    order = [c for c in ("R", "G", "B", "A") if c in out] or [c for c, _ in chans]
    return np.stack([out[c] for c in order], axis=-1)


def write_exr(path: str, img: np.ndarray) -> None:
    """Write float32 [H,W,3/4] as uncompressed FLOAT scanline EXR (for
    tests and asset generation)."""
    img = np.asarray(img, np.float32)
    h, w, c = img.shape
    names = ["R", "G", "B", "A"][:c]
    chans = sorted(names)

    def attr(name, atype, payload):
        return (name.encode() + b"\x00" + atype.encode() + b"\x00"
                + struct.pack("<i", len(payload)) + payload)

    chan_payload = b""
    for n in chans:
        chan_payload += n.encode() + b"\x00" + struct.pack("<iiii", 2, 0, 1, 1)
    chan_payload += b"\x00"
    header = b""
    header += attr("channels", "chlist", chan_payload)
    header += attr("compression", "compression", b"\x00")
    header += attr("dataWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += attr("displayWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    head = struct.pack("<ii", _MAGIC, 2) + header
    table_pos = len(head)
    data_start = table_pos + 8 * h
    blocks = []
    offsets = []
    pos = data_start
    ci = {n: i for i, n in enumerate(names)}
    for y in range(h):
        line = b"".join(img[y, :, ci[n]].tobytes() for n in chans)
        block = struct.pack("<ii", y, len(line)) + line
        offsets.append(pos)
        blocks.append(block)
        pos += len(block)
    with open(path, "wb") as f:
        f.write(head)
        f.write(struct.pack(f"<{h}q", *offsets))
        for b in blocks:
            f.write(b)
