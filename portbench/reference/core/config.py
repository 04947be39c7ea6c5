"""Static render configuration — the analog of the reference's pipeline
state (``GraphicsPipelineCache.h:38-54``: topology, MSAA, cull mode,
viewport, blend, depth test/write) plus the raster tiling knobs.

The JAX package's ``core/config.py`` trimmed to the fields this package
reads, with the same names, defaults and meaning, so one configuration
means the same frame in both packages. The switches of features it does
not render yet stay (``grid``, ``show_shadow_quad``), and
``graph.frame.FrameRenderer`` refuses a config that turns one on; their
tuning fields come with the slices that port them.
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum


class CullMode(IntEnum):
    NONE = 0
    BACK = 1   # reference default: back-cull, CCW front (GraphicsPipelineCache.cpp:296-297)
    FRONT = 2  # shadow pass uses front-culling to avoid peter-panning (ShadowSystem.cpp:37-53)


class DebugInput(IntEnum):
    """View-mode debug switches (reference ``ViewProperties.h:5-25``,
    consumed in ``pbr.glsl:410-425``)."""

    NONE = 0
    BASE_COLOR = 1
    DIFFUSE_COLOR = 2
    NORMALS = 3
    OCCLUSION = 4
    EMISSIVE = 5
    METALLIC = 6
    ROUGHNESS = 7


class DebugEquation(IntEnum):
    """BRDF-term debug switches (``ViewProperties.h:27-35``, ``pbr.glsl:427-440``)."""

    NONE = 0
    DIFFUSE = 1
    FRESNEL = 2
    GEOMETRY = 3
    DISTRIBUTION = 4
    SPECULAR = 5


class ShadingModel(IntEnum):
    PBR = 0    # the live reference path (surface_pbr.frag + pbr.glsl)
    PHONG = 1  # minimal-slice model (BASELINE config 1; reference phong.glsl legacy)


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Tiling and pair-table budget knobs of the tile-binned rasterizer."""

    tile_h: int = 8          # SHADE-tile pixel rows (sparse peel shading, penumbra budget units; the raster kernel owns its own 8x32 tile)
    tile_w: int = 128        # shade-tile pixel cols
    pairs_per_tri: int = 4   # pair-table budget multiplier (overflow is counted)
    dense_k: int = 0         # >0: dense-grid binning, first K pairs per tri scatter-free (binning.py::_bin_dense); FrameRenderer auto-picks from the span distribution
    pair_budget: int = 0     # absolute opaque-pass pair budget; 0 = pairs_per_tri * T + 8192 (auto-tune sets this: the bin sort/pack run over the whole STATIC budget, so integer multipliers overshoot)
    auto_tune_pairs: bool = True  # size the budget from the initial camera (1.35x headroom)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """One frame pipeline's static state (frozen, hashable)."""

    width: int = 800          # reference default extent (main.cpp:187)
    height: int = 600
    ssaa: int = 1             # supersampling factor (reference uses max MSAA; 1 = off)
    cull_mode: CullMode = CullMode.BACK
    shading: ShadingModel = ShadingModel.PBR
    shadows: bool = True
    shadow_extent: int = 4096  # reference RenderScene.cpp:26
    skybox: bool = True
    grid: bool = False        # reference constructs but never draws it (SURVEY §2.3)
    show_shadow_quad: bool = False  # TexturedQuad grayscale shadow-map preview
    translucency: bool = True # depth-peeled back-to-front blend pass
    translucency_layers: int = 2  # peel depth (reference sorts per mesh; 2+ is order-correct per pixel)
    translucency_tile_fraction: float = 1.0  # screen-fraction budget for sparse peel shading (1.0 = correct-by-default; auto-tune lowers it when blend coverage is provably smaller)
    max_anisotropy: int = 16  # anisotropic tap ceiling — the reference sampler's own request (16x, TextureCache.cpp:185-186); 1 = trilinear
    aniso_tile_fracs: tuple = (0.25, 0.15, 0.08)  # exact-path aniso tap TIERS (2/4/16 taps): per-tier fraction of row segments budgeted for the compacted tap loop (sampling.sample_slots_aniso_tiered; per-ROW selection => image-row-shard-invariant). Pixels past a tier's budget fall back to isotropic trilinear. () = dense exact taps at full cost. Dithered paths need no budget (Bayer-distributed single taps)
    aniso_slot_caps: tuple = (16, 4, 4, 4)  # per-slot tap ceilings (base, emissive, orm, normal): base color keeps the full 16x request; emissive/ORM/normal content tolerates isotropic far sooner, and capping them at 4 cuts the tiered path's gather bill ~2x (declared divergence, PARITY.md)
    debug_views: bool = True  # apply the runtime debug-view switches (pbr.glsl:410-440); False drops the selects
    penumbra_tile_budget: int = 0  # the port's two-stage PCF budget; the reference reads no budget (graph/frame.py)
    ibl_diffuse: bool = False  # consume the captured environment map as a diffuse irradiance term (replaces the flat 0.03 ambient) — one step beyond the reference's pbr.glsl:442 todo
    alpha_mask: bool = False  # glTF-correct MASK cutoff test (discard alpha<cutoff) via a peeled cutoff pass; False = MASK draws opaque (the reference's live-path behavior)
    texture_space: bool = False  # light-chart (texture-space) shading: lighting runs per chart texel (shading/lightchart.py), screen pass = 1 albedo tap + 1 light gather. Static scenes; lighting detail at chart resolution. False = reference-exact per-pixel path
    chart_density: float = 0.5   # chart texels per screen pixel (one axis) at the layout camera
    chart_budget: int = 2_000_000  # total chart texel cap (atlas size / gather-table price)
    tss_halfres_light: int = -1  # dense-pass half-res light sampling: -1 = auto (on when chart_density <= 0.5 — lighting varies at >= 2 px scale there anyway), 0 = off, 1 = on
    dither_trilinear: bool = False  # one gather per texture tap: the mip fraction ordered-dithers (4x4 Bayer) the level choice instead of blending two bilinear fetches — halves atlas gather cost for ~1/2-mip-step spatial noise on mip gradients (the 'dithered trilinear' of shipping rasterizers). False = reference-exact trilinear
    sky_halfres: bool = False  # sample the skybox on the even-pixel half grid + bilinear upsample (the sky is magnified many screen pixels per cube texel). False = reference-exact per-pixel sample
    tss_preshaded: bool = False  # fully pre-shaded charts: albedo is baked at chart resolution and rgb = albedo*ld + ls composes IN CHART SPACE, so every screen pass costs ONE 16-byte rgb9e5-block gather per pixel (translucent passes add one 4-byte alpha-block gather). Texture detail then lives at chart_density — run with chart_density 1.0 / a larger chart_budget for parity-grade detail. Requires texture_space
    tss_preshaded_blend: bool = False  # pre-shade ONLY the translucent peel passes (opaque keeps the factored full-res albedo tap): each peel layer drops from a trilinear atlas tap + light gathers to one 16-byte block gather + one 4-byte alpha gather per pixel. Chart-res albedo on a blended surface (banner at alpha<1 over a busy background) is visually mild, so this is the cheap 80% of tss_preshaded. Requires texture_space; implied by tss_preshaded
    mask_layers: int = 2      # cutoff-pass peel depth: fragments revealed through >= this many stacked discarded MASK layers fall back to the opaque surface behind
    blend_pair_budget: int = 0  # static blend-pass (tile,tri) pair budget; 0 = derive from raster.pairs_per_tri (blend geometry is few LARGE triangles — banners, glass — so its span profile needs its own budget, not the opaque per-tri one)
    blend_tile_budget: int = 0  # static covered-tile budget for the sparse peel raster grid; 0 = dense grid over every tile
    blend_layer_tile_budgets: tuple = ()  # per-PEEL-LAYER sparse-shade tile budgets (deeper layers usually cover far less than layer 1 — banner-behind-banner); () = the shared translucency_tile_fraction
    raster: RasterConfig = dataclasses.field(default_factory=RasterConfig)

    def render_extent(self) -> tuple[int, int]:
        """(H, W) actually rastered (supersampled)."""
        return self.height * self.ssaa, self.width * self.ssaa

    def aniso(self):
        """Static AnisoSpec for the sampler paths (threads through the
        ``max_aniso`` kwargs; see shading/sampling.py)."""
        from ..shading.sampling import AnisoSpec
        return AnisoSpec(self.max_anisotropy, tuple(self.aniso_tile_fracs),
                         tuple(self.aniso_slot_caps))

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
