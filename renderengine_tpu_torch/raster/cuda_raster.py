"""Tile raster on the GPU: host-side pair packing, the K1 and K2 kernel
wrappers (both in ``csrc/raster_tile.cu``) and their plain PyTorch
versions.

Port of ``renderengine_tpu/raster/pallas_raster.py`` (``rasterize_pallas``
and ``_raster_kernel``: single winner or the two nearest layers, per-pixel
peel bounds, dense or sparse tile grid, row slices). Per-tile triangle
lists come from ``binning.bin_triangles``; the pair data is laid out
outside the kernel (one row gather) as

    pair_data [P, cpp] f32   cols: e0(3) e1(3) e2(3) z(3) w(3)
                             tie-eps(3) tri_f mat_f [attr planes 3*n]

one row per pair, ``cpp = 20 + 3 * n_attrs`` (20, 32 or 44: a multiple of
4 floats). The TPU packing of several pairs per 128-lane row was a DMA rule
of that chip and is gone.

K2 (``merged_tiles``, port of ``rasterize_pallas_merged`` and
``_merged_kernel``) walks two such tables, 4 attributes a pair, in one
launch: the opaque winner and the two nearest translucent layers, capped
by the opaque depth (the texture-space path).

Tie rule without branches: the pack stores eps_i = 1e-35 for edges that
accept E==0 (top-left rule) and the kernel tests ``E + eps_i > 0``. 1e-35
is a normal f32 and far below any nonzero |E| the setup can produce, so
the biased test is bit-exact with ``(E > 0) | ((E == 0) & tie)``.

Ids ride as integer-valued floats (exact below 2^24).

On a CPU tensor ``raster_tiles`` runs ``_raster_tiles_plain`` (and
``merged_tiles`` ``_merged_tiles_plain``); on a CUDA tensor each launches
its kernel or raises — there is no fallback.

The kernels' library also holds the tiered anisotropic sampler
(``csrc/aniso_slots.cu``, wrapped by ``shading.sampling.aniso_slots``)
the texture-space peel pass (``csrc/tss_peel.cu``, wrapped by
``shading.lightchart.tss_peel_composite``) and the factored texture-space
screen pass (``csrc/tss_shade.cu``, wrapped by
``shading.lightchart.tss_shade_halfres``), counted here beside K1 and K2.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

import torch

from .binning import TileBins, bin_triangles
from .reference_raster import GBuffer
from .setup import TriSetup

_TIE_EPS = 1e-35          # normal f32: survives any flush, vanishes vs |E|
TILE_H = 8                # tile pixel rows
TILE_W = 32               # tile pixel cols (TILE_H * TILE_W = 256 threads)
TRI_COL = 18              # triangle id as an exact integer-valued f32
MAT_COL = 19              # material id as an exact integer-valued f32
ATTR0 = 20                # first attribute-plane column
MAT_LIMIT = 1 << 24       # ids must stay exact as integer-valued f32

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "raster_tile.cu"          # K1 and K2
# every source of the one library: K1, K2, the tiered aniso sampler, the
# texture-space peel pass and the factored texture-space screen pass; the
# last three include the shared device functions of HEADERS
SOURCES = (SOURCE, _PKG / "csrc" / "aniso_slots.cu",
           _PKG / "csrc" / "tss_peel.cu", _PKG / "csrc" / "tss_shade.cu")
HEADERS = (_PKG / "csrc" / "sampler.cuh",)
BUILD_DIR = _PKG / "build"
K1_ATTRS = (0, 4, 8)      # the attribute counts K1 is built for
K2_ATTRS = 4              # attributes a K2 pair row carries
K2_ATTRS_B = (2, 4)       # attribute prefixes K2's blend layers interpolate

# launches of the kernels (plain-version runs do not count): the totals,
# and the same launches by variant: (n_attrs, peel, dual) for K1,
# ("merged", n_attrs_b) for K2; ``aniso_slots`` counts the tiered aniso
# sampler (``shading.sampling.aniso_slots``), ``tss_peel`` the
# texture-space peel pass (``shading.lightchart.tss_peel_composite``),
# ``tss_shade`` the factored texture-space screen pass
# (``shading.lightchart.tss_shade_halfres``). A call during a CUDA graph
# capture launches nothing: ``graph.program.CapturedProgram`` moves the
# counts of its capture into its own record and adds them back at each
# replay, which launches the kernels
launch_counts = {"raster_tile": 0, "merged_tile": 0, "aniso_slots": 0,
                 "tss_peel": 0, "tss_shade": 0}
# other device work of the wrappers, counted apart: the zeroing of a new
# or grown workspace (a memset, once per device and size)
helper_counts = {"workspace_zero": 0}
variant_counts: collections.Counter = collections.Counter()

_lib = None


def _cols_per_pair(n_attrs: int) -> int:
    """Row width of one pair: 20 columns plus 3 per attribute plane."""
    return ATTR0 + 3 * n_attrs


def attribute_planes(setup: TriSetup, corners: torch.Tensor) -> torch.Tensor:
    """[T,3*n] f32 rational attribute planes from the static per-corner
    table ``corners`` [T,3,n] (``scene.upload``'s ``corner_attr``): column
    triplet 3k..3k+2 is sum_i u_ik * e_i, so attr_k(p) = (plane_k . p) /
    sum(E_i)."""
    e = setup.coef[:, 0:3, :]                      # [T,3 edges,3 xyc]
    c = corners[:, :, :, None]                     # [T,3,n,1]
    planes = (c[:, 0] * e[:, 0, None, :] + c[:, 1] * e[:, 1, None, :]
              + c[:, 2] * e[:, 2, None, :])        # [T,n,3]
    return planes.reshape(planes.shape[0], -1)


class PreparedPairs(NamedTuple):
    """Binned + packed pair table, reusable across raster passes over the
    same geometry and camera."""
    bins: TileBins
    pair_data: torch.Tensor      # [P, cpp] f32: one row per pair
    has_mat: bool                # whether material ids were packed
    n_attrs: int = 0             # attribute planes packed per pair


def _pack_pairs(setup: TriSetup, bins: TileBins, attr_planes=None,
                tri_mat=None) -> PreparedPairs:
    """Gather sorted-pair rows into the kernel's layout: ONE row gather per
    pair. Dead slots carry zero rows (never read: the kernel walks only
    each tile's [start, start + count) span)."""
    t = setup.coef.shape[0]
    dev = setup.coef.device
    eps = torch.where(setup.tie, _TIE_EPS, 0.0).to(torch.float32)  # [T,3]
    if t >= MAT_LIMIT:
        raise ValueError("tri ids must stay f32-exact")
    tri_f = torch.arange(t, device=dev).to(torch.float32)
    has_mat = tri_mat is not None
    if has_mat:
        mat_f = tri_mat.clamp(0, MAT_LIMIT - 1).to(torch.float32)
    else:
        mat_f = torch.zeros(t, dtype=torch.float32, device=dev)
    cols = [setup.coef.reshape(t, 15), eps, tri_f[:, None], mat_f[:, None]]
    n_attrs = 0
    if attr_planes is not None:
        cols.append(attr_planes.to(torch.float32))
        n_attrs = attr_planes.shape[1] // 3
    rows = torch.cat(cols, dim=-1)
    live = bins.pair_valid
    tri = torch.where(live, bins.pair_tri.clamp(0, t - 1), 0).long()
    pair_data = torch.where(live[:, None], rows[tri], 0.0).contiguous()
    return PreparedPairs(bins, pair_data, has_mat, n_attrs)


def prepare_pairs(setup: TriSetup, height: int, width: int,
                  max_pairs: int | None = None, attr_planes=None,
                  tri_mat=None, dense_k: int | None = None, y0: int = 0,
                  full_height: int | None = None) -> PreparedPairs:
    """Bin + pack for ``rasterize_cuda``. ``dense_k``: dense-grid binning
    (see ``binning.bin_triangles``); ``y0``/``full_height``: the setup is
    a row band of a taller viewport (``setup.restrict_rows``)."""
    if max_pairs is None:
        max_pairs = 4 * setup.coef.shape[0]
    bins = bin_triangles(setup, height, width, TILE_H, TILE_W, max_pairs,
                         dense_k=dense_k, y0=y0, full_height=full_height)
    return _pack_pairs(setup, bins, attr_planes, tri_mat)


# --- the kernel and its plain version --------------------------------------

def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the kernels build on a CUDA host")


def build() -> Path:
    """Compile ``SOURCES`` into one library in ``build/`` (once per
    content of the sources and ``HEADERS``) and return its path. The
    ptxas report (registers, shared memory, spills) is kept beside it as
    ``.log``."""
    digest = hashlib.sha1(b"".join(p.read_bytes()
                                   for p in SOURCES + HEADERS))
    so = BUILD_DIR / f"libraster_tile_{digest.hexdigest()[:12]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
           "-shared", "-Xcompiler", "-fPIC", "-o", tmp,
           *map(str, SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    return so


def _library():
    """Build (if needed) and load the kernels' library, its entry points
    typed for ctypes."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.raster_item_pairs.restype = ctypes.c_int
        lib.raster_int_words.restype = ctypes.c_longlong
        lib.raster_int_words.argtypes = [ctypes.c_int, ctypes.c_longlong]
        lib.raster_key_words.restype = ctypes.c_longlong
        lib.raster_key_words.argtypes = [ctypes.c_longlong, ctypes.c_int]
        lib.raster_tile_launch.restype = ctypes.c_int
        lib.raster_tile_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        lib.merged_tile_launch.restype = ctypes.c_int
        lib.merged_tile_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.clock_stamp_launch.restype = ctypes.c_int
        lib.clock_stamp_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p]
        lib.aniso_slots_launch.restype = ctypes.c_int
        lib.aniso_slots_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 2)
        lib.tss_peel_launch.restype = ctypes.c_int
        lib.tss_peel_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.tss_shade_launch.restype = ctypes.c_int
        lib.tss_shade_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_float] * 2
            + ([ctypes.c_void_p] + [ctypes.c_longlong] * 3) * 2
            + ([ctypes.c_void_p] + [ctypes.c_longlong] * 2) * 2
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
            + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
        lib.item_pairs = lib.raster_item_pairs()
        _lib = lib
    return _lib


def stamp(buf: torch.Tensor, slot: int, exit_: bool,
          out: torch.Tensor | None, n_regions: int) -> None:
    """One device clock stamp into the int64 stamp buffer ``buf`` (see
    ``utils/profiling.py::Stamps``) on the current stream: a region's
    entry (``exit_`` False) or exit at ``slot``; with ``out``, the
    ``n_regions`` durations are then copied there and cleared. Under a
    capture it is a kernel node of the graph."""
    lib = _library()
    with torch.cuda.device(buf.device):
        rc = lib.clock_stamp_launch(
            buf.data_ptr(), slot, int(exit_),
            None if out is None else out.data_ptr(), n_regions,
            torch.cuda.current_stream(buf.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"clock stamp launch failed: CUDA error {rc}")


class _Workspace:
    """The split walk's scratch on one device: the int32 counters, tile
    arrivals and chunk queue (zeroed once, left zeroed by every launch)
    and the 64-bit keys (written before they are read), with the sizes
    they were made for and the stream of the last launch."""
    __slots__ = ("ints", "keys", "slots", "rows", "stream")

    def __init__(self, stream):
        self.ints = self.keys = None
        self.slots = self.rows = 0
        self.stream = stream


# per device index: its workspace
_workspaces: dict = {}


def _workspace(lib, dev, n_slots: int, rows: int, layers: int):
    """The workspace for a launch of ``n_slots`` slots over ``rows`` pair
    rows carrying ``layers`` layers a pixel, sized from shapes alone (no
    device read). One per device, since a launch's counters must not be
    shared with an overlapping one: a launch on another stream than the
    last is ordered after that stream's work. It grows when a launch
    needs more; a new int32 part is zeroed (counted in
    ``helper_counts``)."""
    stream = torch.cuda.current_stream(dev)
    w = _workspaces.get(dev.index)
    if torch.cuda.is_current_stream_capturing() and (
            w is None or w.stream != stream or n_slots > w.slots
            or rows > w.rows
            or w.keys.numel() < lib.raster_key_words(rows, layers)):
        # a stream switch or an allocation would be captured into the
        # graph: run the captured function once on its stream first
        raise RuntimeError("the split walk's workspace must be sized and "
                           "owned by the capture stream before a capture")
    if w is None:
        w = _workspaces[dev.index] = _Workspace(stream)
    elif w.stream != stream:
        stream.wait_stream(w.stream)
        w.ints.record_stream(stream)
        w.keys.record_stream(stream)
        w.stream = stream
    if w.ints is None or n_slots > w.slots or rows > w.rows:
        w.slots, w.rows = max(n_slots, w.slots), max(rows, w.rows)
        w.ints = torch.zeros(lib.raster_int_words(w.slots, w.rows),
                             dtype=torch.int32, device=dev)
        helper_counts["workspace_zero"] += 1
    n_keys = lib.raster_key_words(rows, layers)
    if w.keys is None or w.keys.numel() < n_keys:
        w.keys = torch.empty(n_keys, dtype=torch.int64, device=dev)
    return w


def workspace_tensors(dev) -> tuple:
    """The device's workspace tensors as they stand. A captured CUDA
    graph holds them: its launches keep the pointers, so the memory must
    outlive the graph even if a later launch grows the workspace.
    ``cuda`` without an index is the current device, whose index the
    launches file the workspace under."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return ()
    w = _workspaces.get(torch.cuda.current_device() if dev.index is None
                        else dev.index)
    return () if w is None else (w.ints, w.keys)


def count_snapshot() -> tuple:
    """The launch counters as they stand (``launch_counts``,
    ``variant_counts``)."""
    return dict(launch_counts), collections.Counter(variant_counts)


def counts_since(snap: tuple) -> tuple:
    """The launches counted since ``snap``, as (totals, by variant)."""
    totals = {k: launch_counts[k] - snap[0].get(k, 0) for k in launch_counts}
    return totals, variant_counts - snap[1]


def add_counts(delta: tuple, times: int = 1) -> None:
    """Add ``times`` x a ``counts_since`` delta to the launch counters
    (negative: take it away)."""
    totals, by_variant = delta
    for k, n in totals.items():
        launch_counts[k] += times * n
    for k, n in by_variant.items():
        variant_counts[k] += times * n
        if not variant_counts[k]:
            del variant_counts[k]


def workspace_bytes() -> int:
    """Device bytes held by the split walk's workspaces."""
    return sum(t.numel() * t.element_size() for w in _workspaces.values()
               for t in (w.ints, w.keys) if t is not None)


def _check_aligned(*tables) -> None:
    """The kernels stage pair rows with 16-byte bulk copies."""
    if any(t.data_ptr() % 16 for t in tables):
        raise ValueError("pair tables must start on a 16-byte boundary")


def _n_planes(n_attrs: int, dual: bool = False) -> int:
    """Output planes per tile: depth | tri | mat | 2 bary or n_attrs
    attribute values, once per layer."""
    return (3 + (n_attrs if n_attrs else 2)) * (2 if dual else 1)


def _tile_bounds(peel_bounds, height: int, width: int, nty: int,
                 ntx: int) -> torch.Tensor:
    """(prev [H,W], zmax [H,W]) -> [n_tiles, 2, 256] f32 rows in tile
    order. Pixels of a partial tile that lie outside the image get
    prev = 2.0 and zmax = -1.0, so nothing there passes the peel test."""
    prev, zmax = peel_bounds
    ph = nty * TILE_H - height
    pw = ntx * TILE_W - width

    def tile(a, fill):
        a = torch.nn.functional.pad(a.to(torch.float32), (0, pw, 0, ph),
                                    value=fill)
        a = a.reshape(nty, TILE_H, ntx, TILE_W).permute(0, 2, 1, 3)
        return a.reshape(nty * ntx, TILE_H * TILE_W)

    return torch.stack([tile(prev, 2.0), tile(zmax, -1.0)], dim=1).contiguous()


def sparse_tile_map(counts: torch.Tensor, active_tiles: int) -> torch.Tensor:
    """The ``active_tiles`` tiles with the most pairs, in ascending tile
    order (int32). Ties go to the lowest tile index, as ``jax.lax.top_k``
    breaks them: a stable descending sort, not ``torch.topk``."""
    sel = torch.sort(counts, descending=True, stable=True).indices
    return torch.sort(sel[:active_tiles]).values.to(torch.int32)


def raster_tiles(pair_data: torch.Tensor, starts: torch.Tensor,
                 counts: torch.Tensor, ntx: int, width: int,
                 full_height: int, y0: int = 0, n_attrs: int = 0,
                 bounds: torch.Tensor | None = None,
                 tile_map: torch.Tensor | None = None,
                 dual: bool = False) -> torch.Tensor:
    """Run K1: -> [n_sel, n_planes, 256] f32 planes (depth | tri | mat |
    2 bary or n_attrs attribute values; with ``dual`` the second layer's
    planes follow the first's).

    ``bounds``: [n_tiles, 2, 256] per-pixel (prev, zmax) rows from
    ``_tile_bounds`` — peel mode: only fragments with prev < depth <= zmax
    count. ``tile_map``: [n_sel] int32 tile ids — the sparse grid: slot s
    of the output holds tile ``tile_map[s]``; without it every tile runs
    in order. ``dual`` (needs ``bounds``): the two nearest layers in one
    walk. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if dual and bounds is None:
        raise ValueError("dual (peel_layers=2) requires peel bounds")
    n_tiles = starts.shape[0]
    if pair_data.device.type == "cpu":
        return _raster_tiles_plain(pair_data, starts, counts, ntx, width,
                                   full_height, y0, n_attrs, bounds,
                                   tile_map, dual)
    if n_attrs not in K1_ATTRS:
        raise ValueError(f"K1 is built for n_attrs {K1_ATTRS}, not {n_attrs}")
    dev = pair_data.device
    extra = [t for t in (bounds, tile_map) if t is not None]
    if dev.type != "cuda" or any(t.device != dev
                                 for t in [starts, counts] + extra):
        raise ValueError("pair_data, starts, counts, bounds and tile_map "
                         "must share a CUDA device")
    if pair_data.dtype != torch.float32 or starts.dtype != torch.int32 \
            or counts.dtype != torch.int32:
        raise TypeError("pair_data must be float32, starts/counts int32")
    if pair_data.dim() != 2 or pair_data.shape[1] != _cols_per_pair(n_attrs):
        raise ValueError(f"pair_data must be [P, {_cols_per_pair(n_attrs)}]")
    if counts.shape != starts.shape or starts.dim() != 1:
        raise ValueError("starts and counts must be [n_tiles]")
    if bounds is not None:
        if bounds.dtype != torch.float32:
            raise TypeError("bounds must be float32")
        if bounds.shape != (n_tiles, 2, TILE_H * TILE_W):
            raise ValueError("bounds must be [n_tiles, 2, 256]")
    if tile_map is not None:
        if tile_map.dtype != torch.int32:
            raise TypeError("tile_map must be int32")
        if tile_map.dim() != 1:
            raise ValueError("tile_map must be [n_sel]")
    if not all(t.is_contiguous()
               for t in [pair_data, starts, counts] + extra):
        raise ValueError("K1 inputs must be contiguous")
    _check_aligned(pair_data)
    n_sel = n_tiles if tile_map is None else tile_map.shape[0]
    out = torch.empty((n_sel, _n_planes(n_attrs, dual), TILE_H * TILE_W),
                      dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        ws = _workspace(lib, dev, n_sel, pair_data.shape[0], 2 if dual else 1)
        rc = lib.raster_tile_launch(
            pair_data.data_ptr(), starts.data_ptr(), counts.data_ptr(),
            None if tile_map is None else tile_map.data_ptr(),
            None if bounds is None else bounds.data_ptr(),
            out.data_ptr(), ws.ints.data_ptr(), ws.keys.data_ptr(),
            ws.slots, n_sel, pair_data.shape[0], ntx, width, full_height,
            y0, n_attrs, int(dual), ws.stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"raster_tile launch failed: CUDA error {rc}")
    launch_counts["raster_tile"] += 1
    variant_counts[(n_attrs, bounds is not None, dual)] += 1
    return out


def _raster_tiles_plain(pair_data, starts, counts, ntx: int, width: int,
                        full_height: int, y0: int = 0,
                        n_attrs: int = 0, bounds=None, tile_map=None,
                        dual: bool = False,
                        stats: dict | None = None) -> torch.Tensor:
    """K1 in plain torch ops with the kernel's op order: each tile walks
    its pairs in ascending order with strict depth tests. Step i updates
    the tiles holding more than i pairs; tiles are kept in descending-count
    order so those are always a prefix. Same arguments and result as
    ``raster_tiles``, and ``dual`` also runs without ``bounds`` (K2's blend
    walk). ``n_attrs`` may be less than the table's attribute planes: the
    walk then interpolates that prefix. If ``stats`` is given, its
    ``"wins"`` is set to the number of (pair, pixel) fragments that entered
    a layer (the fragments for which the kernel does its per-winner work)
    and its ``"demotes"`` to those of them that entered layer 1 of a
    ``dual`` walk, pushing the old layer 1 down."""
    dev = pair_data.device
    n_num = n_attrs if n_attrs else 2
    npx = TILE_H * TILE_W
    lane = torch.arange(npx, device=dev)
    if tile_map is None:
        sel = torch.arange(starts.shape[0], device=dev)
    else:
        sel = tile_map.to(torch.int64)
    n_sel = sel.shape[0]
    cnt = counts[sel]
    order = torch.sort(cnt, descending=True, stable=True).indices
    tiles = sel[order]
    org_x = (tiles % ntx) * TILE_W
    org_y = (tiles // ntx) * TILE_H + y0
    px = (org_x[:, None] + lane % TILE_W).to(torch.float32) \
        + (0.5 - width * 0.5)
    py = (org_y[:, None] + lane // TILE_W).to(torch.float32) \
        + (0.5 - full_height * 0.5)
    st = starts[tiles].to(torch.int64)
    active = torch.bincount(cnt.to(torch.int64).cpu(),
                            minlength=1).flip(0).cumsum(0).flip(0)
    # active[i] = tiles with count >= i; step i runs tiles with count > i
    max_count = active.shape[0] - 1
    if bounds is not None:
        prev_b = bounds[tiles, 0]
        zmax_b = bounds[tiles, 1]

    def clear_layer():
        f = dict(dtype=torch.float32, device=dev)
        return [torch.ones((n_sel, npx), **f),              # depth
                torch.full((n_sel, npx), -1.0, **f),        # tri
                torch.zeros((n_sel, npx), **f),             # mat
                torch.zeros((n_sel, npx), **f)              # edge sum
                ] + [torch.zeros((n_sel, npx), **f) for _ in range(n_num)]

    l1 = clear_layer()
    l2 = clear_layer() if dual else None
    wins = torch.zeros((), dtype=torch.int64, device=dev)
    demotes = torch.zeros((), dtype=torch.int64, device=dev)

    for i in range(max_count):
        na = int(active[i + 1])
        r = pair_data[st[:na] + i]                  # [na, cpp]
        x, y = px[:na], py[:na]

        def plane(k, r=r, x=x, y=y):
            return r[:, k:k + 1] * x + r[:, k + 1:k + 2] * y + r[:, k + 2:k + 3]

        e0, e1, e2 = plane(0), plane(3), plane(6)
        zn, wn = plane(9), plane(12)
        emin = torch.minimum(e0 + r[:, 15:16],
                             torch.minimum(e1 + r[:, 16:17], e2 + r[:, 17:18]))
        d = zn / wn
        cover = (emin > 0) & (wn > 0) & (zn >= 0) & (zn <= wn)
        if bounds is not None:
            cover = cover & (d > prev_b[:na]) & (d <= zmax_b[:na])
        d1 = l1[0][:na]
        take = cover & (d < d1)
        frag = [d, r[:, TRI_COL:TRI_COL + 1], r[:, MAT_COL:MAT_COL + 1],
                (e0 + e1) + e2]
        frag += ([e0, e1] if n_attrs == 0 else
                 [plane(ATTR0 + 3 * a) for a in range(n_attrs)])
        if dual:
            # the nearest fragment strictly behind layer 1; a new layer-1
            # winner demotes the old one
            take2 = cover & (d > d1) & (d < l2[0][:na])
            for c2, c1, f in zip(l2, l1, frag):
                c2[:na] = torch.where(take, c1[:na],
                                      torch.where(take2, f, c2[:na]))
            if stats is not None:
                wins += take2.sum()
                demotes += take.sum()
        if stats is not None:
            wins += take.sum()
        for c1, f in zip(l1, frag):
            c1[:na] = torch.where(take, f, c1[:na])

    def finish(layer):
        best, tri, mat, esum_w = layer[:4]
        inv = 1.0 / torch.where(esum_w == 0, 1.0, esum_w)
        return [best, tri, mat] + [nv * inv for nv in layer[4:]]

    planes = torch.stack(finish(l1) + (finish(l2) if dual else []), dim=1)
    out = torch.empty_like(planes)
    out[order] = planes
    if stats is not None:
        stats["wins"] = int(wins)
        stats["demotes"] = int(demotes)
    return out


def _clear_layer_like(lay: torch.Tensor) -> torch.Tensor:
    """The empty layer (depth 1, tri -1, everything else 0) in ``lay``'s
    shape [n, planes, 256]."""
    clear = torch.zeros_like(lay)
    clear[:, 0] = 1.0
    clear[:, 1] = -1.0
    return clear


def _nearer(c: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """Per pixel, whether layer ``c`` precedes ``best`` in (depth, tri)
    order. Within a tile, ascending triangle ids are ascending pair
    indices, and compares take -0.0 equal to +0.0, as the walk does."""
    return (c[:, 0] < best[:, 0]) | ((c[:, 0] == best[:, 0])
                                     & (c[:, 1] < best[:, 1]))


def merge_chunk_planes(parts, n_num: int, dual: bool = False):
    """Merge the finished planes of the chunks of each tile's span into
    the planes of the whole walk, by the rule the kernels' split walk
    relies on: layer 1 = the least (depth, tri) of the chunks' layer 1;
    layer 2 = the least (depth, tri) of every chunk's layers 1 and 2 with
    depth strictly greater than layer 1's. ``parts``: the [n, (3 + n_num)
    * layers, 256] results of ``_raster_tiles_plain`` over the chunks (one
    tile span cut by editing starts/counts). Exact because every plane of
    a layer is a function of its (pair, pixel) alone. For tests: the
    kernels merge keys on the card."""
    pp = 3 + n_num
    l1 = parts[0][:, :pp]
    for p in parts[1:]:
        c = p[:, :pp]
        l1 = torch.where(_nearer(c, l1)[:, None], c, l1)
    if not dual:
        return l1.clone()
    l2 = _clear_layer_like(l1)
    for p in parts:
        for c in (p[:, :pp], p[:, pp:2 * pp]):
            take = (c[:, 0] > l1[:, 0]) & _nearer(c, l2)
            l2 = torch.where(take[:, None], c, l2)
    return torch.cat([l1, l2], 1)


def merge_chunk_merged(parts, n_attrs_b: int):
    """``merge_chunk_planes`` for K2's planes (``_merged_tiles_plain`` over
    chunks of both tables' spans): table A's single winner and table B's
    two layers merge apart, then the fold voids each blend layer deeper
    than the merged opaque depth. For tests."""
    pa = 3 + K2_ATTRS
    a = merge_chunk_planes([p[:, :pa] for p in parts], K2_ATTRS)
    b = merge_chunk_planes([p[:, pa:] for p in parts], n_attrs_b, dual=True)
    pb = 3 + n_attrs_b
    layers = []
    for li in range(2):
        lay = b[:, li * pb:(li + 1) * pb]
        void = (lay[:, 0] > a[:, 0])[:, None]
        layers.append(torch.where(void, _clear_layer_like(lay), lay))
    return torch.cat([a] + layers, 1)


# --- the raster pass ---------------------------------------------------------

def rasterize_cuda(setup: TriSetup, height: int, width: int,
                   max_pairs: int | None = None, y0: int = 0,
                   full_height: int | None = None, peel_bounds=None,
                   attr_planes=None, tri_mat=None,
                   prepared: PreparedPairs | None = None,
                   dense_k: int | None = None,
                   active_tiles: int | None = None, peel_layers: int = 1):
    """Bin + pack + K1. Same G-buffer as ``rasterize_reference``.

    ``attr_planes``: optional [T,3n] from ``attribute_planes`` (n = 8:
    pos/normal/uv; 4: the texture-space chart uv/uv) — the kernel then
    interpolates them for the winner and the result is (GBuffer, attrs
    [H,W,n]); otherwise a GBuffer with ``bary`` filled.
    ``tri_mat``: optional [T] int material ids, returned as ``mat_id``.
    ``y0``/``full_height`` raster a row slice of a taller viewport.
    ``prepared``: a ``prepare_pairs`` result to reuse (skips binning and
    packing; ``max_pairs``/``tri_mat`` are then ignored).
    ``peel_bounds``: optional (prev [H,W], zmax [H,W]) — keep only
    fragments with prev < depth <= zmax (depth peeling).
    ``active_tiles``: run a sparse grid over only the K tiles with the most
    pairs; tiles beyond K render empty, and callers guard with the
    covered-tile count.
    ``peel_layers=2`` (requires ``peel_bounds``) extracts the two nearest
    layers in one walk and returns a list of two per-layer results, each
    (GBuffer, attrs-or-None)."""
    if peel_layers not in (1, 2):
        raise ValueError("peel_layers must be 1 or 2")
    dual = peel_layers == 2
    if dual and peel_bounds is None:
        raise ValueError("peel_layers=2 requires peel_bounds")
    fh = height if full_height is None else full_height
    ntx = -(-width // TILE_W)
    nty = -(-height // TILE_H)
    n_tiles = ntx * nty
    if prepared is None:
        prepared = prepare_pairs(setup, height, width, max_pairs,
                                 attr_planes, tri_mat, dense_k, y0, fh)
    bins = prepared.bins
    n_attrs = prepared.n_attrs
    bounds = (None if peel_bounds is None
              else _tile_bounds(peel_bounds, height, width, nty, ntx))
    sparse = active_tiles is not None and active_tiles < n_tiles
    tile_map = sparse_tile_map(bins.counts, active_tiles) if sparse else None
    blk = raster_tiles(prepared.pair_data, bins.starts, bins.counts, ntx,
                       width, fh, y0, n_attrs, bounds, tile_map, dual)
    pp = _n_planes(n_attrs)                         # planes per layer
    if sparse:
        # slot blocks back into the full tile layout; untouched tiles read
        # as empty (clear depth 1.0, no winner = tri -1) in every layer
        fill = torch.zeros(blk.shape[1], dtype=torch.float32,
                           device=blk.device)
        fill[0::pp] = 1.0
        fill[1::pp] = -1.0
        full = fill[None, :, None].repeat(n_tiles, 1, blk.shape[2])
        full[tile_map.long()] = blk
        blk = full

    def untile(a):
        a = a.reshape(nty, ntx, TILE_H, TILE_W).permute(0, 2, 1, 3)
        return a.reshape(nty * TILE_H, ntx * TILE_W)[:height, :width]

    def unpack(lb):
        tri_id = untile(lb[:, 1]).to(torch.int32)   # exact int-valued floats
        mat_id = (torch.where(tri_id >= 0,
                              untile(lb[:, 2]).to(torch.int32), 0)
                  if prepared.has_mat else None)
        if n_attrs == 0:
            bary = torch.stack([untile(lb[:, 3]), untile(lb[:, 4])], dim=-1)
            return GBuffer(untile(lb[:, 0]), tri_id, bary, mat_id), None
        g = GBuffer(untile(lb[:, 0]), tri_id, None, mat_id)
        attrs = torch.stack([untile(lb[:, 3 + a]) for a in range(n_attrs)],
                            dim=-1)
        return g, attrs

    if dual:
        return [unpack(blk[:, :pp]), unpack(blk[:, pp:])]
    g, attrs = unpack(blk)
    return (g, attrs) if n_attrs else g


# --- K2: the merged opaque + two-layer translucent launch -------------------

def _merged_planes(n_attrs_b: int) -> int:
    """Output planes per tile of K2: the opaque layer (3 + 4) and two
    blend layers of 3 + n_attrs_b."""
    return 3 + K2_ATTRS + 2 * (3 + n_attrs_b)


def merged_tiles(pairs_a: torch.Tensor, starts_a: torch.Tensor,
                 counts_a: torch.Tensor, pairs_b: torch.Tensor,
                 starts_b: torch.Tensor, counts_b: torch.Tensor, ntx: int,
                 width: int, full_height: int, y0: int = 0,
                 n_attrs_b: int = 4) -> torch.Tensor:
    """Run K2 over the dense tile grid: -> [n_tiles, 7 + 2 * (3 +
    n_attrs_b), 256] f32 planes: the opaque winner of table A (depth | tri
    | mat | 4 attributes), then the two nearest layers of table B (depth |
    tri | mat | the first ``n_attrs_b`` attributes), each voided (depth 1,
    tri -1, zeros) where deeper than the opaque depth. Both tables are
    [P, 32] (4 attribute planes a pair). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if n_attrs_b not in K2_ATTRS_B:
        raise ValueError(f"K2 is built for n_attrs_b {K2_ATTRS_B}, "
                         f"not {n_attrs_b}")
    if pairs_a.device.type == "cpu":
        return _merged_tiles_plain(pairs_a, starts_a, counts_a, pairs_b,
                                   starts_b, counts_b, ntx, width,
                                   full_height, y0, n_attrs_b)
    dev = pairs_a.device
    ints = [starts_a, counts_a, starts_b, counts_b]
    if dev.type != "cuda" or any(t.device != dev for t in ints + [pairs_b]):
        raise ValueError("both pair tables and their starts/counts must "
                         "share a CUDA device")
    cpp = _cols_per_pair(K2_ATTRS)
    for pd in (pairs_a, pairs_b):
        if pd.dtype != torch.float32:
            raise TypeError("pair tables must be float32")
        if pd.dim() != 2 or pd.shape[1] != cpp:
            raise ValueError(f"pair tables must be [P, {cpp}]")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("starts/counts must be int32")
    n_tiles = starts_a.shape[0]
    if starts_a.dim() != 1 or any(t.shape != (n_tiles,) for t in ints):
        raise ValueError("starts and counts must be [n_tiles] for both "
                         "tables")
    if not all(t.is_contiguous() for t in ints + [pairs_a, pairs_b]):
        raise ValueError("K2 inputs must be contiguous")
    _check_aligned(pairs_a, pairs_b)
    out = torch.empty((n_tiles, _merged_planes(n_attrs_b), TILE_H * TILE_W),
                      dtype=torch.float32, device=dev)
    rows = pairs_a.shape[0] + pairs_b.shape[0]
    lib = _library()
    with torch.cuda.device(dev):
        ws = _workspace(lib, dev, n_tiles, rows, 3)
        rc = lib.merged_tile_launch(
            pairs_a.data_ptr(), starts_a.data_ptr(), counts_a.data_ptr(),
            pairs_b.data_ptr(), starts_b.data_ptr(), counts_b.data_ptr(),
            out.data_ptr(), ws.ints.data_ptr(), ws.keys.data_ptr(),
            ws.slots, n_tiles, rows, ntx, width, full_height, y0, n_attrs_b,
            ws.stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"merged_tile launch failed: CUDA error {rc}")
    launch_counts["merged_tile"] += 1
    variant_counts[("merged", n_attrs_b)] += 1
    return out


def _merged_tiles_plain(pairs_a, starts_a, counts_a, pairs_b, starts_b,
                        counts_b, ntx: int, width: int, full_height: int,
                        y0: int = 0, n_attrs_b: int = 4,
                        stats: dict | None = None) -> torch.Tensor:
    """K2 in plain torch ops with the kernel's op order: K1's plain single
    walk over table A, K1's plain dual walk with no bounds over table B
    (the first ``n_attrs_b`` attributes), then the fold: a blend layer
    deeper than the opaque depth becomes the clear layer (depth 1, tri -1,
    zeros). Same arguments and result as ``merged_tiles``; ``stats``
    (optional) gets K1's per-walk counts of table A (``"wins"``) and table
    B (``"wins_b"``, ``"demotes"``)."""
    st_a = {} if stats is not None else None
    st_b = {} if stats is not None else None
    a = _raster_tiles_plain(pairs_a, starts_a, counts_a, ntx, width,
                            full_height, y0, K2_ATTRS, stats=st_a)
    b = _raster_tiles_plain(pairs_b, starts_b, counts_b, ntx, width,
                            full_height, y0, n_attrs_b, dual=True,
                            stats=st_b)
    pb = 3 + n_attrs_b
    cap = a[:, 0]
    clear = torch.zeros(pb, dtype=torch.float32, device=a.device)
    clear[0], clear[1] = 1.0, -1.0
    layers = []
    for li in range(2):
        lay = b[:, li * pb:(li + 1) * pb]
        void = (lay[:, 0] > cap)[:, None, :]
        layers.append(torch.where(void, clear[None, :, None], lay))
    if stats is not None:
        stats["wins"] = st_a["wins"]
        stats["wins_b"] = st_b["wins"]
        stats["demotes"] = st_b["demotes"]
    return torch.cat([a] + layers, 1)


def rasterize_cuda_merged(height: int, width: int, prepared: PreparedPairs,
                          prepared_blend: PreparedPairs, y0: int = 0,
                          full_height: int | None = None,
                          n_attrs_b: int | None = None):
    """One K2 launch = the opaque base pass + the two nearest translucent
    peel layers (the texture-space path). Both PreparedPairs carry 4
    attribute planes and material ids. ``n_attrs_b``: the blend layers
    interpolate only this prefix of the attributes (2 = chart uv alone,
    the pre-shaded peels). Returns ((g_opaque, attrs [H,W,4]), [(g1, a1),
    (g2, a2)]) with blend attrs [H,W,n_attrs_b]."""
    fh = height if full_height is None else full_height
    ntx = -(-width // TILE_W)
    nty = -(-height // TILE_H)
    if prepared.n_attrs != K2_ATTRS or prepared_blend.n_attrs != K2_ATTRS:
        raise ValueError(f"K2 pair tables carry {K2_ATTRS} attributes")
    nab = K2_ATTRS if n_attrs_b is None else n_attrs_b
    b, bb = prepared.bins, prepared_blend.bins
    blk = merged_tiles(prepared.pair_data, b.starts, b.counts,
                       prepared_blend.pair_data, bb.starts, bb.counts, ntx,
                       width, fh, y0, nab)

    def untile(a):
        a = a.reshape(nty, ntx, TILE_H, TILE_W).permute(0, 2, 1, 3)
        return a.reshape(nty * TILE_H, ntx * TILE_W)[:height, :width]

    def unpack(lb, has_mat, na):
        tri_id = untile(lb[:, 1]).to(torch.int32)
        mat_id = (torch.where(tri_id >= 0, untile(lb[:, 2]).to(torch.int32),
                              0) if has_mat else None)
        g = GBuffer(untile(lb[:, 0]), tri_id, None, mat_id)
        return g, torch.stack([untile(lb[:, 3 + a]) for a in range(na)], -1)

    pa, pb = 3 + K2_ATTRS, 3 + nab
    opaque = unpack(blk[:, :pa], prepared.has_mat, K2_ATTRS)
    l1 = unpack(blk[:, pa:pa + pb], prepared_blend.has_mat, nab)
    l2 = unpack(blk[:, pa + pb:], prepared_blend.has_mat, nab)
    return opaque, [l1, l2]
