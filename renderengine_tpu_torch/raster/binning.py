"""Triangle -> tile binning (device-side, per frame): torch port of the
JAX package's ``raster/binning.py``.

Instead of scan-converting triangles one at a time, build (tile, triangle)
pairs with a sort:

1. per-triangle covered tile span from its screen bbox
2. exclusive-scan the span sizes -> pair slots
3. each slot finds its triangle (searchsorted over the inclusive scan)
4. sort the combined ``tile << tri_bits | tri`` keys: ascending triangle
   ids within a tile come from the key order
5. per-tile segments from the sorted keys

The combined keys are int64: torch has no ``<<``/``>>`` for uint32 on the
CPU, and 64 bits always hold (tile, tri), so the JAX package's variadic
(key, payload) fallback sort is never needed. Outputs equal the JAX
package's element for element, invalid slots included.

Pair-table capacity is a static budget; overflow is counted and reported
(``n_overflow``) rather than silently dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .setup import TriSetup

_BIG_TRI_CAP = 65536      # compacted span>k triangle list (sorted prefix)


class TileBins(NamedTuple):
    pair_tri: torch.Tensor    # [MAX_PAIRS] i32 triangle id (sorted by tile)
    pair_valid: torch.Tensor  # [MAX_PAIRS] bool
    starts: torch.Tensor      # [n_tiles] i32 first pair index per tile
    counts: torch.Tensor      # [n_tiles] i32 pairs per tile
    n_overflow: torch.Tensor  # scalar: pairs that didn't fit the budget
    # pairs of span>dense_k triangles beyond the big-list compaction cap
    # (_BIG_TRI_CAP); always 0 on the fill path
    n_tail: torch.Tensor | int = 0


def _tile_spans(setup: TriSetup, tile_h: int, tile_w: int):
    """(tx0, ty0, nx, ny, span) per triangle, int64."""
    bbox = setup.bbox.long()
    tx0 = bbox[:, 0] // tile_w
    ty0 = bbox[:, 1] // tile_h
    nx = bbox[:, 2] // tile_w - tx0 + 1
    ny = bbox[:, 3] // tile_h - ty0 + 1
    span = torch.where(setup.valid, nx * ny, 0)
    return tx0, ty0, nx, ny, span


def _corner_cull_planes(setup: TriSetup, tx0, ty0, tile_h: int, tile_w: int,
                        width: int, height: int, y0: int = 0):
    """Edge values at each triangle's first tile centre, per-tile steps and
    the conservative tile margin (see ``_bin_dense``). The tile grid starts
    at row ``y0`` of a viewport ``height`` rows tall (a row band's grid
    sits ``y0`` rows down the full frame)."""
    a_ = setup.coef[:, 0:3, 0]                # [T,3]
    b_ = setup.coef[:, 0:3, 1]
    c_ = setup.coef[:, 0:3, 2]
    cpx0 = (tx0 * tile_w + (tile_w - 1) * 0.5 + 0.5
            - width * 0.5).to(torch.float32)[:, None]      # [T,1]
    cpy0 = (ty0 * tile_h + y0 + (tile_h - 1) * 0.5 + 0.5
            - height * 0.5).to(torch.float32)[:, None]
    e0 = a_ * cpx0 + b_ * cpy0 + c_                         # [T,3]
    sx = a_ * float(tile_w)
    sy = b_ * float(tile_h)
    margin = (a_.abs() * ((tile_w - 1) * 0.5)
              + b_.abs() * ((tile_h - 1) * 0.5))
    margin = margin + 1e-5 * (e0.abs() + sx.abs() + sy.abs() + margin)
    return e0, sx, sy, margin


def _dense_column(j: int, nx, rowbase, ntx: int, planes):
    """Tile id and corner-test liveness of each triangle's j-th pair."""
    dy = j // nx.clamp_min(1)
    dx = j - dy * nx
    tile_j = rowbase + dy * ntx + dx
    e0, sx, sy, margin = planes
    reach = (e0 + dx.to(torch.float32)[:, None] * sx
             + dy.to(torch.float32)[:, None] * sy + margin)
    return tile_j, (reach > 0).all(-1)


def bin_triangles(setup: TriSetup, height: int, width: int,
                  tile_h: int, tile_w: int, max_pairs: int,
                  dense_k: int | None = None, y0: int = 0,
                  full_height: int | None = None) -> TileBins:
    """``dense_k``: enumerate the first k pairs of every triangle on a
    dense [T,k] grid with a conservative corner cull, and only the span>k
    tail through the slot fill (``_bin_dense``). The dense path is taken
    under the same gate as in the JAX package, so both pick the same
    algorithm (their outputs differ: the dense path culls pairs).

    ``y0``/``full_height``: the setup is a row band [y0, y0+height) of a
    ``full_height`` viewport (``setup.restrict_rows``); the corner cull
    then tests the band's tiles where they lie in the full frame. (The
    JAX package's dense cull takes the band's own height as the viewport
    and voids live pairs of any band below the top one: ROADMAP F12.)"""
    ntx = -(-width // tile_w)
    nty = -(-height // tile_h)
    n_tiles = ntx * nty
    dev = setup.coef.device

    tx0, ty0, nx, ny, span = _tile_spans(setup, tile_h, tile_w)
    t = span.shape[0]
    tri_bits = max(1, int(t - 1).bit_length())
    tile_bits = max(1, int(n_tiles - 1).bit_length())
    rowbase = ty0 * ntx + tx0
    if (dense_k is not None and ntx <= 255
            and ((n_tiles + 1) << tri_bits) <= (1 << 32)
            and tri_bits + tile_bits <= 32 and max_pairs < (1 << 23)):
        return _bin_dense(setup, span, nx, rowbase, tx0, ty0, n_tiles, ntx,
                          max_pairs, int(dense_k), tri_bits, tile_h, tile_w,
                          width, height if full_height is None
                          else full_height, y0)

    incl = torch.cumsum(span, 0)
    offsets = incl - span
    total = incl[-1]
    n_overflow = (total - max_pairs).clamp_min(0)

    slots = torch.arange(max_pairs, dtype=torch.int64, device=dev)
    # owning triangle of each slot; slots past the total repeat the last
    # triangle with a non-empty span (the JAX fill's cummax carry)
    tri = torch.searchsorted(incl, slots, right=True)
    tris = torch.arange(t, dtype=torch.int64, device=dev)
    last = torch.where(span > 0, tris, 0).amax()
    slot_valid = slots < total.clamp_max(max_pairs)
    tri = torch.where(slot_valid, tri.clamp_max(t - 1), last)
    local = slots - offsets[tri]
    nxv = nx[tri].clamp_min(1)
    dy = torch.div(local, nxv, rounding_mode="floor")
    dx = local - dy * nxv
    tile = rowbase[tri] + dy * ntx + dx
    key = torch.where(slot_valid, tile, n_tiles)   # invalid sorts last
    sck, _ = torch.sort((key << tri_bits) | tri)
    return _segments_from_sorted(sck, tri_bits, n_tiles, n_overflow,
                                 torch.zeros((), dtype=torch.int64,
                                             device=dev))


def live_pairs_estimate(setup: TriSetup, height: int, width: int,
                        tile_h: int, tile_w: int, k: int):
    """Post-cull live pair count for ``dense_k`` binning: the dense
    columns apply the same conservative corner test as ``_bin_dense``;
    the span>k tail is assumed fully live."""
    ntx = -(-width // tile_w)
    tx0, ty0, nx, ny, span = _tile_spans(setup, tile_h, tile_w)
    planes = _corner_cull_planes(setup, tx0, ty0, tile_h, tile_w, width,
                                 height)
    rowbase = ty0 * ntx + tx0
    live = (span - k).clamp_min(0)
    for j in range(k):
        _, ok = _dense_column(j, nx, rowbase, ntx, planes)
        live = live + ((j < span) & ok).long()
    return live.sum()


def _bin_dense(setup, span, nx, rowbase, tx0, ty0, n_tiles: int, ntx: int,
               max_pairs: int, k: int, tri_bits: int, tile_h: int,
               tile_w: int, width: int, height: int,
               y0: int = 0) -> TileBins:
    """Dense-grid binning: pair (t, j) for j < min(span, k) comes from a
    [T,k] grid; the span>k tail is compacted to <= _BIG_TRI_CAP triangles
    and enumerated slot by slot; both key streams go through ONE sort
    whose first ``max_pairs`` slots are the budget — live keys sort before
    the invalid sentinel, so slicing gives the exact drop-and-count
    overflow semantics.

    Exact-coverage cull: a conservative corner test (edge value at the
    tile centre plus the tile's worst-case half-extent along the edge
    normal, padded by ~1e-5 relative slack) voids (t, tile) pairs the
    triangle cannot touch; any covered pixel keeps its pair."""
    dev = span.device
    t = span.shape[0]
    tris = torch.arange(t, dtype=torch.int64, device=dev)
    inval = n_tiles << tri_bits
    planes = _corner_cull_planes(setup, tx0, ty0, tile_h, tile_w, width,
                                 height, y0)

    key_cols, live_cols = [], []
    for j in range(k):
        tile_j, ok = _dense_column(j, nx, rowbase, ntx, planes)
        ok = ok & (j < span)           # span==0 for culled tris
        key_cols.append(torch.where(ok, (tile_j << tri_bits) | tris,
                                    inval | tris))
        live_cols.append(ok)
    dense_keys = torch.stack(key_cols, dim=1).reshape(-1)      # [t*k]
    dense_live = torch.stack(live_cols, dim=1).sum()

    # span>k tail: compact the big triangles to a sorted id prefix
    span_big = (span - k).clamp_min(0)
    big_total = span_big.sum()
    sel, _ = torch.sort(torch.where(span_big > 0, tris, tris | (1 << 31)))
    sel = sel[:_BIG_TRI_CAP]
    live_row = (sel >> 31) == 0
    big_tri = (sel & 0x7FFFFFFF).clamp_max(t - 1)
    b_span = torch.where(live_row, span_big[big_tri], 0)       # [CAP]
    kept_total = b_span.sum()          # spans of tris that fit CAP
    b_incl = torch.cumsum(b_span, 0)
    b_off = b_incl - b_span
    b_budget = max_pairs               # the tail gets the full budget
    s_slots = torch.arange(b_budget, dtype=torch.int64, device=dev)
    ok_s = s_slots < kept_total.clamp_max(b_budget)
    row = torch.searchsorted(b_incl, s_slots, right=True).clamp_max(
        sel.shape[0] - 1)
    tri_s = big_tri[row]
    nx_s = nx[tri_s].clamp_min(1)
    jloc = k + (s_slots - b_off[row])
    dy = torch.div(jloc, nx_s, rounding_mode="floor")
    dx = jloc - dy * nx_s
    tile_s = rowbase[tri_s] + dy * ntx + dx
    big_keys = torch.where(ok_s, (tile_s << tri_bits) | tri_s,
                           inval | (t - 1))
    big_live = kept_total.clamp_max(b_budget)

    ck = torch.cat([dense_keys, big_keys])
    if ck.shape[0] < max_pairs:
        ck = torch.cat([ck, torch.full((max_pairs - ck.shape[0],), inval,
                                       dtype=torch.int64, device=dev)])
    sck, _ = torch.sort(ck)
    sck = sck[:max_pairs]
    live_total = dense_live + big_live
    n_overflow = ((kept_total - b_budget).clamp_min(0)
                  + (live_total - max_pairs).clamp_min(0))
    n_tail = big_total - kept_total    # big tris past CAP
    return _segments_from_sorted(sck, tri_bits, n_tiles, n_overflow, n_tail)


def _segments_from_sorted(sck, tri_bits: int, n_tiles: int, n_overflow,
                          n_tail) -> TileBins:
    """(starts, counts) from a sorted combined-key array: live keys come
    first in tile order, so a tile's segment starts at the count of live
    keys of lower tiles. Empty tiles get start 0."""
    sorted_tri = (sck & ((1 << tri_bits) - 1)).to(torch.int32)
    sorted_key = sck >> tri_bits
    live = sorted_key < n_tiles
    counts = torch.zeros(n_tiles + 1, dtype=torch.int64, device=sck.device)
    counts = counts.scatter_add_(0, sorted_key.clamp_max(n_tiles),
                                 torch.ones_like(sorted_key))[:n_tiles]
    starts = torch.cumsum(counts, 0) - counts
    starts = torch.where(counts > 0, starts, 0)
    return TileBins(sorted_tri, live, starts.to(torch.int32),
                    counts.to(torch.int32), n_overflow, n_tail)


def count_span_overflow(setup: TriSetup, tile_h: int, tile_w: int,
                        max_pairs: int) -> torch.Tensor:
    """``TileBins.n_overflow`` without the sort: the pair total is the bbox
    span sum."""
    total = _tile_spans(setup, tile_h, tile_w)[4].sum()
    return (total - max_pairs).clamp_min(0)
