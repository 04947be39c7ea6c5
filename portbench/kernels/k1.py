"""K1, the tile raster kernel (``raster_tile_kernel<N_ATTRS, PEEL, DUAL>``
in the port's ``csrc/raster_tile.cu``): the work one launch needs.

Counted from the pass itself, not from the port's pair tables: the
covered (triangle, pixel) fragments of the pass's valid triangles, its
covered pixels per layer, its valid triangles and its extent, all from
the benchmark's own raster (``reference/raster/binned_raster.py``), so
the count does not move when the port's binning or budgets do.

Operations: each fragment 5 planes (2 mul + 2 add each), 3 tie adds, the
depth divide and 7 compares (31; 2 more with peel bounds, 2 more for a
second layer); each layer's winner per covered pixel its attribute
planes (4 operations each; without attributes the 2 barycentric
numerators), the edge sum's 2 adds and its carried values (4 + the
numerators); each pixel, per layer, a compare, a select, the reciprocal
and a multiply per numerator. Bytes: each valid triangle's row (15 plane
coefficients, 3 per attribute, its id and material) read once, the peel
bounds (2 planes) read once, every output plane (depth, id, material and
one per numerator, per layer) written once.
"""

from __future__ import annotations

import re

_NAME = re.compile(r"raster_tile_kernel<\s*(\d+)\s*,\s*(true|false)\s*,"
                   r"\s*(true|false)\s*>")


def variant(kernel_name: str):
    """(n_attrs, peel, dual) of a profiler kernel name, or None."""
    m = _NAME.search(kernel_name)
    if not m:
        return None
    return int(m.group(1)), m.group(2) == "true", m.group(3) == "true"


def work(n_attrs: int, peel: bool, dual: bool, fragments: int,
         wins: int, triangles: int, pixels: int) -> tuple[float, float]:
    """(operations, bytes) of one launch. ``wins``: covered pixels summed
    over the launch's layers."""
    n_num = n_attrs if n_attrs else 2
    layers = 2 if dual else 1
    per_frag = 4 * 5 + 3 + 1 + 7 + (2 if peel else 0) + (2 if dual else 0)
    per_win = 4 * n_attrs + 2 + 4 + n_num
    ops = (fragments * per_frag + wins * per_win
           + pixels * layers * (3 + n_num))
    nbytes = (triangles * (15 + 3 * n_attrs + 2) * 4
              + (2 * 4 * pixels if peel else 0)
              + layers * (3 + n_num) * 4 * pixels)
    return float(ops), float(nbytes)
