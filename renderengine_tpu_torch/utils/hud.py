"""Host-side stats HUD — the ImGui-overlay role (reference
``ImGuiVulkan.{h,cpp}``: a UI pass drawn after the scene). Renders text
into presented numpy frames with a built-in 5x7 bitmap font; like ImGui,
it composites after the 3D scene, on the host side of the present seam.
"""

from __future__ import annotations

import numpy as np

# 5x7 font for the HUD character set, rows as 5-bit patterns (MSB left)
_GLYPHS = {
    "0": "0E 11 13 15 19 11 0E", "1": "04 0C 04 04 04 04 0E",
    "2": "0E 11 01 02 04 08 1F", "3": "1F 02 04 02 01 11 0E",
    "4": "02 06 0A 12 1F 02 02", "5": "1F 10 1E 01 01 11 0E",
    "6": "06 08 10 1E 11 11 0E", "7": "1F 01 02 04 08 08 08",
    "8": "0E 11 11 0E 11 11 0E", "9": "0E 11 11 0F 01 02 0C",
    ".": "00 00 00 00 00 0C 0C", " ": "00 00 00 00 00 00 00",
    ":": "00 0C 0C 00 0C 0C 00", "/": "01 01 02 04 08 10 10",
    "-": "00 00 00 1F 00 00 00", "%": "19 19 02 04 08 13 13",
    "F": "1F 10 10 1E 10 10 10", "P": "1E 11 11 1E 10 10 10",
    "S": "0F 10 10 0E 01 01 1E", "M": "11 1B 15 15 11 11 11",
    "T": "1F 04 04 04 04 04 04", "R": "1E 11 11 1E 14 12 11",
    "I": "0E 04 04 04 04 04 0E", "X": "11 11 0A 04 0A 11 11",
    "E": "1F 10 10 1E 10 10 1F", "A": "0E 11 11 1F 11 11 11",
    "G": "0E 11 10 17 11 11 0F", "V": "11 11 11 11 11 0A 04",
    "W": "11 11 11 15 15 1B 11", "D": "1E 11 11 11 11 11 1E",
    "H": "11 11 11 1F 11 11 11", "L": "10 10 10 10 10 10 1F",
    "U": "11 11 11 11 11 11 0E", "B": "1E 11 11 1E 11 11 1E",
    "C": "0E 11 10 10 10 11 0E", "N": "11 19 15 13 11 11 11",
    "O": "0E 11 11 11 11 11 0E",
}


def _glyph(ch: str) -> np.ndarray:
    rows = _GLYPHS.get(ch.upper(), _GLYPHS[" "]).split()
    bits = np.array([[int(r, 16) >> (4 - c) & 1 for c in range(5)] for r in rows],
                    np.uint8)
    return bits


def draw_text(frame: np.ndarray, text: str, x: int = 4, y: int = 4,
              scale: int = 2, color=(255, 255, 64)) -> np.ndarray:
    """Draw text (in place) onto a uint8 [H,W,3/4] frame. Returns frame."""
    h, w = frame.shape[:2]
    cx = x
    for ch in text:
        g = np.repeat(np.repeat(_glyph(ch), scale, 0), scale, 1)
        gh, gw = g.shape
        if cx + gw >= w or y + gh >= h:
            break
        region = frame[y : y + gh, cx : cx + gw, :3]
        mask = g.astype(bool)
        region[mask] = np.asarray(color, np.uint8)
        cx += gw + scale
    return frame


def draw_stats(frame: np.ndarray, fps: float, frame_ms: float,
               n_tris: int | None = None) -> np.ndarray:
    """The reference ImGui panel's stats line, burned into the frame."""
    text = f"FPS {fps:5.1f}  MS {frame_ms:6.1f}"
    if n_tris is not None:
        text += f"  TRIS {n_tris}"
    return draw_text(frame, text)
