"""Multi-card rendering over ``torch.distributed`` (port of the JAX
package's ``parallel/sharded.py``).

The reference is single-GPU; this is the scale-out design of the JAX
package, with its ``shard_map`` collectives as ``torch.distributed`` calls
over a process group of one rank a card:

- **Vertex stage**: data-parallel over vertices (each rank transforms
  V/world vertices of the world-space cache), then ``all_gather``.
- **Base pass**: image-row parallel. Each rank renders its band of the
  framebuffer through ``graph.frame._frame_core(y0=rank*hs, slice_h=hs)``,
  the same body as the single-card frame, so every feature runs sharded
  and both kernels run on bands; ``all_gather`` stacks the bands.
- **Shadow pass**: geometry-parallel. Each rank rasters its share of the
  triangles into full-extent depth maps, merged by ``all_reduce(MIN)``
  (the z-buffer's own collective), then packed; cached behind the
  reference's dirty flag (``RenderScene.cpp:170-181``).
- **Texture space**: each rank lights its band of the chart atlas rows
  (the specular chart pass is elementwise over texels) and
  ``all_gather`` hands every rank the whole table.

The backend is the caller's: ``nccl`` with one card a rank, ``gloo`` on
the CPU or with several ranks on one card (NCCL refuses two ranks on one
device). gloo reduces CUDA tensors but does not gather them, so with a
CUDA device its gathers go through host tensors (``Mesh.transport`` is
then ``"gloo-host"``). Every collective runs whatever the world size, so
a world of 1 still launches its backend.

The transport decides how a frame runs. Over NCCL the collectives run on
the card, so ``ShardedRenderer`` captures the band frame, the sharded
shadow pass and the texture-space bakes into CUDA graphs at init, on
every rank in the same order (the JAX package's jitted ``_fn`` and
``_shadow_fn``), and every rank replays them in lockstep; a warm frame
makes no host sync, and a capture that fails raises. Only a world of 1
over NCCL has been run captured (on one card, NCCL's one-rank path): a
capture across several NCCL ranks, and its fork and join on the group's
stream across ranks, has not been run. Over gloo the collectives run on
the host and cannot be captured: the frame is dispatched op by op.

Exactness: the gathered frame equals the single-card frame byte for byte
given the same budgets, for any height that divides over the ranks (and
bands that divide by the SSAA factor). Two places need more than the JAX
body:

- the dense binning's corner cull tests a band's tiles where they lie in
  the whole frame (``binning.bin_triangles``'s ``y0``/``full_height``);
- ``render_band`` renders more rows than its band and crops them
  (``band_extent``): it starts and ends on whole tile rows, so quad
  pairs, the 4-row dither phase, the half-res grids and every
  per-tile-row selection see the whole frame's rows, and a band that is
  not the last renders ``BAND_HALO`` rows more for the half-resolution
  upsample, which reads the half-grid row below (the JAX package renders
  the band's own rows and is not always exact there: ROADMAP F12).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import RenderConfig
from ..device import resolve_device
from ..graph import frame as fgraph
from ..graph.uniforms import unpack_params
from ..raster import cuda_raster
from ..raster.setup import VertexOutputs
from ..shading import lightchart
from ..shading import shadow as shadow_mod

VERTEX_KEYS = ("positions", "normals", "uvs", "vert_node", "world_pos",
               "world_normal")
CHART_KEYS = ("chart_pos", "chart_normal", "chart_mat", "chart_vis")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The process group as the renderer sees it: ``world`` ranks, this
    rank's index and card, and the collective backend."""

    world: int
    rank: int
    device: torch.device
    backend: str

    @property
    def transport(self) -> str:
        """How the gathers travel: ``nccl``, ``gloo`` (CPU tensors) or
        ``gloo-host`` (CUDA tensors staged through host memory)."""
        if self.backend == "gloo" and self.device.type == "cuda":
            return "gloo-host"
        return self.backend


def make_mesh(world_size: int, device=None) -> Mesh:
    """The ``Mesh`` of the initialized default process group
    (``torch.distributed.init_process_group``). Raises if its size is not
    ``world_size``: a different world would fake multi-card coverage.
    ``device`` is this rank's (``cuda:<local rank>``, or the same
    ``cuda:0`` for every rank on one card, or ``cpu``); None means
    ``cuda``, which must be available."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    n = dist.get_world_size()
    if n != world_size:
        raise RuntimeError(
            f"make_mesh({world_size}) in a process group of {n} ranks; a "
            "different world would fake multi-card coverage")
    dev = resolve_device(device)
    backend = str(dist.get_backend())
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(n, dist.get_rank(), dev, backend)


def _all_gather(t: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim``, in rank order (a
    tiled all_gather; the shapes must be equal). Over NCCL into one
    buffer, which a captured program allocates once."""
    src = t.contiguous()
    if mesh.transport == "nccl":
        out = src.new_empty((mesh.world * src.shape[0],) + src.shape[1:])
        _gather_into(out, src)
        if dim == 0:
            return out
        return out.unflatten(0, (mesh.world, src.shape[0])).movedim(
            0, dim).flatten(dim, dim + 1)
    if mesh.transport == "gloo-host":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src)
    return torch.cat(parts, dim).to(t.device)


def _gather_into(out: torch.Tensor, src: torch.Tensor) -> None:
    """The ranks' ``src`` stacked along dim 0 into ``out``."""
    dist.all_gather_into_tensor(out, src)


def pad_scene_for_mesh(scene_dev: dict, n_devices: int) -> dict:
    """Pad the vertex arrays of an upload dict to a multiple of the world
    size (padding vertices are never referenced by any triangle)."""
    v = scene_dev["positions"].shape[0]
    pad = (-v) % n_devices
    if pad:
        scene_dev = dict(scene_dev)
        for k in ("positions", "normals", "uvs", "world_pos", "world_normal"):
            a = np.asarray(scene_dev[k])
            scene_dev[k] = np.concatenate(
                [a, np.zeros((pad,) + a.shape[1:], a.dtype)])
        scene_dev["vert_node"] = np.concatenate(
            [np.asarray(scene_dev["vert_node"]), np.zeros(pad, np.int32)])
    return scene_dev


def _scene_specs(scene: dict, n_devices: int | None = None) -> dict:
    """How each scene key splits over the ranks: ``"vertex"`` (rows of a
    vertex array), ``"chart_rows"`` (atlas rows of a planar [C,Ah,Aw]
    chart plane, when ``Ah`` divides by ``n_devices``: the specular chart
    pass is elementwise over texels) or None (every rank reads it
    whole: the gather tables, the corner tables, the textures)."""
    spec = {k: "vertex" for k in VERTEX_KEYS}
    if n_devices:
        for k in CHART_KEYS:
            if k in scene and scene[k].shape[1] % n_devices == 0:
                spec[k] = "chart_rows"
    return {k: spec.get(k) for k in scene}


def shard_scene(scene: dict, mesh: Mesh) -> dict:
    """This rank's shares of the split keys (``_scene_specs``): every rank
    holds the whole uploaded scene and reads its own rows of these."""
    local = {}
    for k, s in _scene_specs(scene, mesh.world).items():
        if s == "vertex":
            n = scene[k].shape[0] // mesh.world
            local[k] = scene[k][mesh.rank * n:(mesh.rank + 1) * n]
        elif s == "chart_rows":
            n = scene[k].shape[1] // mesh.world
            local[k] = scene[k][:, mesh.rank * n:(mesh.rank + 1) * n]
    return local


def _gathered_vo(local: dict, params: dict, mesh: Mesh) -> VertexOutputs:
    """Vertex stage on the rank's vertex share, then one all_gather of the
    packed [V/world, 12] rows (world pos | normal | uv | clip): full-scene
    ``VertexOutputs``, equal to the single-card stage row for row."""
    vo = fgraph.cached_vertex_outputs(local, params["view"], params["proj"])
    rows = _all_gather(torch.cat(list(vo), -1), mesh)
    return VertexOutputs(rows[:, 0:3], rows[:, 3:6], rows[:, 6:8],
                         rows[:, 8:12])


def render_shadow_pass_sharded(scene, params, config: RenderConfig,
                               n_shadows: int, mesh: Mesh,
                               backend: str = "cuda",
                               max_pairs: int | None = None,
                               cube_bases=()):
    """Geometry-parallel shadow depth pass: each rank rasters its
    contiguous share of the (padded) triangle list into full-extent maps,
    ``all_reduce(MIN)`` merges them and every rank packs the same blocks.
    Returns (``shadow.ShadowPack``, pairs dropped over all ranks).

    The merged maps equal the single-card maps as values: each rank's
    texel holds its share's nearest depth, and the minimum over shares is
    the minimum over all triangles (a tie of -0.0 and 0.0 may come back
    with either sign; the 16-bit packing maps both to 0)."""
    d = mesh.world
    t = scene["corner_attr"].shape[0]
    if t % d:
        raise ValueError("the padded triangle count must divide by the "
                         "world size")
    ts = t // d
    lo = mesh.rank * ts
    # the single-card pass reads the static world-space corner table, so
    # a rank's share is its rows of that table (no vertex gather needed)
    local = {"corner_attr": scene["corner_attr"][lo:lo + ts],
             "n_tris": (scene["n_tris"] - lo).clamp(0, ts)}
    maps, overflow = fgraph.render_shadow_maps(
        local, params["shadow_viewproj"], config.shadow_extent, n_shadows,
        config.raster, backend, max_pairs=max_pairs, cube_bases=cube_bases)
    overflow = overflow.reshape(1)
    dist.all_reduce(maps, op=dist.ReduceOp.MIN)
    dist.all_reduce(overflow, op=dist.ReduceOp.SUM)
    return shadow_mod.pack_shadow_blocks(maps), overflow[0]


# rows a band renders past its end for the half-resolution passes (their
# upsample reads the half-grid row just below the band)
BAND_HALO = 2


def band_extent(config: RenderConfig, y0: int, hs: int) -> tuple[int, int]:
    """The rows [ys, ye) that ``render_band`` renders for the band [y0,
    y0+hs): widened to whole tile rows (a multiple of the shade and raster
    tile heights, of the 4-row dither pattern and of the SSAA factor) and,
    where a half-resolution pass runs, past the band's end by the halo."""
    fh = config.render_extent()[0]
    half = config.sky_halfres or (
        config.texture_space
        and (config.chart_density <= 0.5 if config.tss_halfres_light < 0
             else bool(config.tss_halfres_light)))
    a = math.lcm(config.raster.tile_h, cuda_raster.TILE_H, 4, config.ssaa)
    end = y0 + hs + (BAND_HALO if half else 0)
    return y0 // a * a, min(fh, -(-end // a) * a)


def render_band(scene, params, vo, shadow_maps, config: RenderConfig,
                n_shadows: int, backend: str, has_translucent: bool,
                slots_used, y0: int, hs: int, **kw):
    """The rows [y0, y0+hs) of the frame, equal to those rows of the whole
    frame: ``graph.frame._frame_core`` on ``band_extent``'s rows, cropped.
    A band skips the shadow quad, as the JAX package's does. ``kw``:
    ``_frame_core``'s keywords. Returns (img [hs/ssaa,W,4] u8, the
    rendered rows' stats: rows two bands both render count in both)."""
    f = config.ssaa
    if y0 % f or hs % f:
        raise ValueError(f"band [{y0}, {y0 + hs}) splits SSAA pixels of "
                         f"factor {f}")
    ys, ye = band_extent(config, y0, hs)
    if hs < config.render_extent()[0]:
        config = config.replace(show_shadow_quad=False)
    img, stats = fgraph._frame_core(
        scene, params, vo, shadow_maps, config, n_shadows, backend,
        has_translucent, slots_used, y0=ys, slice_h=ye - ys, **kw)
    return img[(y0 - ys) // f:(y0 - ys + hs) // f], stats


_SUM_STATS = ("pair_overflow", "pair_tail_overflow", "blend_pair_overflow",
              "penumbra_overflow")


def _reduce_stats(stats: dict, mesh: Mesh) -> dict:
    """The bands' counters as whole-frame ones: overflow counts add up
    (SUM), observed coverage in full-frame units is the busiest band's
    (MAX)."""
    keys = sorted(stats)
    parts = {op: [k for k in keys if (k in _SUM_STATS) == (op == "sum")]
             for op in ("sum", "max")}
    out = {}
    for op, ks in parts.items():
        if not ks:
            continue
        flat = torch.cat([stats[k].reshape(-1).to(torch.int64) for k in ks])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX)
        i = 0
        for k in ks:
            n = stats[k].numel()
            out[k] = flat[i:i + n].reshape(stats[k].shape)
            i += n
    return out


def render_frame_sharded(scene, params, shadow_maps, config: RenderConfig,
                         n_shadows: int, mesh: Mesh, backend: str = "cuda",
                         has_translucent: bool = False,
                         slots_used=(True, True, True, True),
                         shadow_lights=None, has_mask: bool = False,
                         alpha_is_factor: bool = False, *, local: dict):
    """One frame on every rank (minus the cached shadow pass: pass its
    packed maps, or None). Returns ([H,W,4] u8, the whole frame on every
    rank; stats summed or maxed over the bands, see ``_reduce_stats``).
    ``local``: this rank's ``shard_scene`` shares."""
    h, w = config.render_extent()
    d = mesh.world
    if h % d:
        raise ValueError(f"render height {h} must divide over {d} ranks")
    hs = h // d
    if hs % config.ssaa:
        raise ValueError(f"{d} bands of {hs} rows split SSAA pixels of "
                         f"factor {config.ssaa}")
    y0 = mesh.rank * hs
    vo = _gathered_vo(local, params, mesh)
    ls = None
    if config.texture_space:
        # the rank's atlas rows when they divide, else the whole atlas
        charts = [local.get(k, scene[k]) for k in CHART_KEYS]
        ls = lightchart.chart_light_spec(
            scene, *charts, {"view_pos": params["view_pos"],
                             "exposure": params["exposure"]})
        if "chart_pos" in local:
            ls = _all_gather(ls, mesh, dim=1)
    img, stats = render_band(
        scene, params, vo, shadow_maps, config, n_shadows, backend,
        has_translucent, slots_used, y0, hs, shadow_lights=shadow_lights,
        has_mask=has_mask, alpha_is_factor=alpha_is_factor, ls_atlas=ls)
    return _all_gather(img, mesh), _reduce_stats(stats, mesh)


class ShardedRenderer(fgraph.FrameRenderer):
    """``FrameRenderer`` over a mesh: every rank uploads the whole scene
    (padded for the mesh), renders its band of each frame and its share of
    the shadow pass (``render_frame_sharded``,
    ``render_shadow_pass_sharded``), and runs the renderer's own host side:
    the shadow dirty flag (``RenderScene.cpp:170-181``), the texture-space
    bakes, the host spans and frame records. Like the JAX package's, it has
    no budget controller: the budgets are the config's (``pair_budget`` or
    the per-triangle rule), and the shadow pass's is ``shadow_budget`` or
    the single-card default. Overflow is counted in each frame's stats and
    in ``shadow_overflow``. The frame is not stamped.

    Over NCCL it captures its programs at init (the module docstring);
    over gloo it dispatches them op by op. ``_local``'s atlas rows are
    views of the tables the bakes write in place."""

    _has_controller = False

    def __init__(self, scene_host, config: RenderConfig, mesh: Mesh,
                 backend: str = "cuda", shadow_budget: int | None = None):
        self.mesh = mesh
        self._setup(scene_host, config, mesh.device, backend)
        self._local = shard_scene(self.scene_dev, mesh)
        if shadow_budget:
            self._shadow_budget_val = int(shadow_budget)
        self._start()

    def _upload(self, **kw) -> dict:
        d = self.mesh.world
        return pad_scene_for_mesh(super()._upload(pad_tris_to=max(256, d)),
                                  d)

    def _captures(self) -> bool:
        # the collectives run on the card only over NCCL
        return self.mesh.transport == "nccl"

    @property
    def shadow_maps(self):
        """The cached packed shadow maps (``shadow.ShadowPack``) or None."""
        return self._shadow_maps

    def _frame_fn(self):
        """``render_frame_sharded`` with the renderer's state bound: the
        function the frame program captures. Every rank must call it."""
        cfg = self.config
        return lambda: render_frame_sharded(
            self.scene_dev, unpack_params(self._u, self.n_shadows),
            self._shadow_maps, cfg, self.n_shadows, self.mesh, self.backend,
            self._has_translucent, self._slots_used,
            shadow_lights=self._shadow_lights, has_mask=self._has_mask,
            alpha_is_factor=self._alpha_is_factor, local=self._local)

    def _shadow_pass(self, cfg: RenderConfig, budget: int):
        return render_shadow_pass_sharded(
            self.scene_dev, unpack_params(self._u, self.n_shadows), cfg,
            self.n_shadows, self.mesh, self.backend, max_pairs=budget,
            cube_bases=self._cube_bases)

    def program_stats(self) -> dict:
        """``FrameRenderer.program_stats`` and the collective transport."""
        return {**super().program_stats(), "transport": self.mesh.transport}


def build_sharded_renderer(scene_host, config: RenderConfig, mesh: Mesh,
                           backend: str = "cuda"):
    """Compatibility wrapper: returns (fn, scene_dev, params_builder) where
    ``fn(scene_dev, params)`` renders one frame ([H,W,4] u8, computing and
    caching the sharded shadow pass on first use) from the host params of
    ``params_builder()``. A renderer that captured its programs (NCCL)
    renders only the ``scene_dev`` it returned."""
    r = ShardedRenderer(scene_host, config, mesh, backend)

    def fn(scene_dev, params):
        if scene_dev is not r.scene_dev:
            if r._graphs:
                raise ValueError("the captured programs read the scene "
                                 "they were captured with")
            r.scene_dev = scene_dev
            r._local = shard_scene(scene_dev, mesh)
        return r._render(None, None, params)[0]

    return fn, r.scene_dev, r.params_for_camera


__all__ = ["Mesh", "make_mesh", "pad_scene_for_mesh", "shard_scene",
           "render_shadow_pass_sharded", "render_frame_sharded", "render_band",
           "ShardedRenderer", "build_sharded_renderer", "band_extent",
           "BAND_HALO"]
