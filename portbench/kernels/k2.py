"""K2, the merged raster kernel (``merged_tile_kernel<N_ATTRS_B>`` in the
port's ``csrc/raster_tile.cu``): one launch rasters the opaque list (4
attributes: chart uv, texture uv) and the two nearest translucent layers
in front of it (``N_ATTRS_B`` attributes). Its work is K1's single walk
over the opaque pass plus K1's dual walk over the translucent pass, and a
fold of two compares and two selects per pixel; its output is the 7
opaque planes and (3 + N_ATTRS_B) per translucent layer. Counted from the
passes, as ``k1.py`` counts."""

from __future__ import annotations

import re

from . import k1

_NAME = re.compile(r"merged_tile_kernel<\s*(\d+)\s*>")
N_ATTRS_A = 4


def variant(kernel_name: str):
    """(n_attrs_b,) of a profiler kernel name, or None."""
    m = _NAME.search(kernel_name)
    return (int(m.group(1)),) if m else None


def work(n_attrs_b: int, opaque: dict, blend: dict,
         pixels: int) -> tuple[float, float]:
    """(operations, bytes) of one launch from the opaque and translucent
    passes' counts (``fragments``, ``wins``, ``triangles``)."""
    ops_a, _ = k1.work(N_ATTRS_A, False, False, opaque["fragments"],
                       opaque["wins"], 0, pixels)
    ops_b, _ = k1.work(n_attrs_b, True, True, blend["fragments"],
                       blend["wins"], 0, pixels)
    ops = ops_a + ops_b + 4 * pixels
    nbytes = ((opaque["triangles"] * (15 + 3 * N_ATTRS_A + 2)
               + blend["triangles"] * (15 + 3 * n_attrs_b + 2)) * 4
              + (7 + 2 * (3 + n_attrs_b)) * 4 * pixels)
    return float(ops), float(nbytes)
