"""Unified host image loading — the stb_image seam.

The reference loads every material/skybox texture through stb_image
(``TextureCache.cpp:67``, the skybox's six ``.jpg`` faces at
``Skybox.cpp:71-79``). The package's in-repo codecs: PNG (utils.png),
baseline JPEG (native C++ decoder), EXR (utils.exr, for HDRIs), plus
``.npy`` for tests.
"""

from __future__ import annotations

import numpy as np

from . import png


def read_image(path: str) -> np.ndarray:
    """Decode ``path`` by extension. Returns uint8 [H,W,3|4] (PNG/JPEG)
    or float32 (EXR via read_exr left to callers that want HDR)."""
    lower = str(path).lower()
    if lower.endswith(".npy"):
        return np.load(path)
    if lower.endswith((".jpg", ".jpeg", ".jfif")):
        from ..native import decode_jpeg

        with open(path, "rb") as f:
            data = f.read()
        img = decode_jpeg(data)
        if img is None:
            raise ValueError(
                f"cannot decode JPEG {path!r}: native decoder unavailable "
                "or unsupported stream (arithmetic-coded / 12-bit JPEGs "
                "must be transcoded)")
        return img
    if lower.endswith(".png"):
        return png.read_png(path)
    raise ValueError(f"unsupported image format: {path!r} "
                     "(PNG, baseline JPEG, NPY)")
