"""The pre-shaded peel pass of a texture-space frame: the plain version of
``shading/lightchart.py::tss_peel_composite`` (``csrc/tss_peel.cu``'s
oracle) against the budgeted path it replaces on the card.

On a CUDA device the frame's two pre-shaded peel layers of the merged
launch go through one kernel that shades every covered pixel; the CPU
frame keeps ``graph/frame.py::shade_sparse`` and its per-layer tile
budgets. Held here, on the CPU: the plain version equals, bit for bit,
the frame's own sparse path (its ``shade_sparse`` calls and their
composite, recorded in the frame) wherever the budgets cover the need,
for both alpha sources (the alpha blocks, the material factor alpha), on
the whole frame and on a row band. ``tss_shade_pre`` is per pixel and
takes no derivatives, so shading a pixel alone or inside a compacted
tile gives the same bits. The wrapper checks its arguments on every
device and runs the plain version on CPU tensors."""

import numpy as np
import pytest
import torch

from renderengine_tpu_torch.graph import frame as tframe
from renderengine_tpu_torch.graph.frame import FrameRenderer
from renderengine_tpu_torch.graph.uniforms import unpack_params
from renderengine_tpu_torch.raster import cuda_raster as cr
from renderengine_tpu_torch.shading import lightchart
from renderengine_tpu_torch.tools import goldens

torch.set_num_threads(2)

_MEMO: dict = {}


def _renderer():
    """The ``shadows_pcf`` case with sky and translucency at 512x128 (four
    shade tiles a tile row), in the headline's pre-shaded-peel mode, on
    the CPU (memoized)."""
    if "r" not in _MEMO:
        tf, tc = {n: (f, c) for n, f, c in
                  goldens.golden_cases()}["shadows_pcf"]
        cfg = tc.replace(texture_space=True, tss_preshaded_blend=True,
                         debug_views=False, translucency=True, skybox=True,
                         width=512, height=128)
        r = FrameRenderer(tf(), cfg, device="cpu")
        r.render()
        _MEMO["r"] = r
    return _MEMO["r"]


def _frame_peels(r, budgets, alpha_is_factor, y0=0, slice_h=None):
    """One frame body (``_frame_core``, a row band with ``y0``/``slice_h``)
    at the shade-tile ``budgets``: its stats, each layer's ``shade_sparse``
    input and result in call order, and the frame's pre-shaded peel
    composite (``_tss_shade_fns``'s last function)."""
    cfg = r.config.replace(blend_layer_tile_budgets=budgets)
    sd = r.scene_dev
    params = unpack_params(torch.from_numpy(r.uniform_for_camera()),
                           r.n_shadows)
    vo = tframe.cached_vertex_outputs(sd, params["view"], params["proj"])
    calls, fns = [], []
    real_sparse, real_fns = tframe.shade_sparse, tframe._tss_shade_fns

    def sparse(shade_fn, frag, *a, **k):
        out = real_sparse(shade_fn, frag, *a, **k)
        calls.append((frag, out))
        return out

    def shade_fns(*a, **k):
        out = real_fns(*a, **k)
        fns.append(out[3])
        return out

    tframe.shade_sparse, tframe._tss_shade_fns = sparse, shade_fns
    try:
        _, st = tframe._frame_core(
            sd, params, vo, r._shadow_maps, cfg, r.n_shadows, "cuda", True,
            r._slots_used, shadow_lights=r._shadow_lights,
            has_mask=r._has_mask, alpha_is_factor=alpha_is_factor, y0=y0,
            slice_h=slice_h)
    finally:
        tframe.shade_sparse, tframe._tss_shade_fns = real_sparse, real_fns
    return st, calls, fns[0]


def _n_tiles(r):
    return r._shade_tile_total()


@pytest.mark.parametrize("band", [False, True], ids=["frame", "band"])
@pytest.mark.parametrize("alpha", ["blocks", "factor"])
@pytest.mark.parametrize("budget", ["every_tile", "the_need"])
def test_plain_version_equals_the_sparse_path(budget, alpha, band):
    """The frame's two merged peel layers shaded through ``shade_sparse``
    at a budget that covers them (every tile of every tile row, one tile
    short of the dense path; or the need the frame observed, which for the
    second layer selects two of a tile row's four tiles) and composited
    back to front, against the plain version on the same layers, over a
    random colour plane: bit for bit."""
    r = _renderer()
    y0, slice_h = (40, 56) if band else (0, None)
    n = _n_tiles(r)
    if budget == "every_tile":
        budgets = (n - 1, n - 1)
    else:
        st, _, _ = _frame_peels(r, (n - 1, n - 1), alpha == "factor", y0,
                                slice_h)
        budgets = tuple(min(n - 1, int(c))
                        for c in st["blend_shade_tiles"])
        # the second layer's need selects some tiles of a row, not all
        assert band or budgets[1] <= n // 2, budgets
    st, calls, peels = _frame_peels(r, budgets, alpha == "factor", y0,
                                    slice_h)
    assert int(st["blend_pair_overflow"]) == 0
    assert len(calls) == 2
    covered = [int(f["covered"].sum()) for f, _ in calls]
    assert covered[0] > 0 and covered[1] > 0, covered
    h, w = calls[0][0]["covered"].shape
    assert h == (slice_h or r.config.height)

    rgb0 = torch.rand((h, w, 3), generator=torch.Generator().manual_seed(7))
    want = rgb0
    for frag, rgba in reversed(calls):          # graph/frame.py's composite
        a = rgba[..., 3].clamp(0.0, 1.0) * frag["covered"]
        want = want * (1.0 - a[..., None]) + rgba[..., :3] * a[..., None]
    layers = [(f["tri_id"], f["attrs"], f["mat_id"]) for f, _ in calls]
    got = peels(rgb0.clone(), layers)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not torch.equal(got, rgb0)


def test_a_budget_short_of_the_need_drops_what_the_plain_version_shades():
    """Where the budget is one tile a tile row short, the sparse path
    leaves covered tiles unshaded and counts them; the plain version
    shades them."""
    r = _renderer()
    st, calls, peels = _frame_peels(r, (1, 1), False)
    assert int(st["blend_pair_overflow"]) > 0
    h, w = calls[0][0]["covered"].shape
    rgb0 = torch.zeros((h, w, 3))
    want = rgb0
    for frag, rgba in reversed(calls):
        a = rgba[..., 3].clamp(0.0, 1.0) * frag["covered"]
        want = want * (1.0 - a[..., None]) + rgba[..., :3] * a[..., None]
    got = peels(rgb0.clone(), [(f["tri_id"], f["attrs"], f["mat_id"])
                               for f, _ in calls])
    assert not torch.equal(got, want)


def _planes(h=24, w=40, ah=16, aw=32, seed=0):
    """Random inputs of the peel pass: any int32 is an rgb9e5 word and an
    alpha block; chart uvs past the atlas on both sides; half the pixels
    of each layer covered."""
    g = torch.Generator().manual_seed(seed)

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=g,
                             dtype=torch.int64).to(torch.int32)

    layers = [(torch.where(torch.rand((h, w), generator=g) < 0.5, 3, -1)
               .to(torch.int32),
               torch.rand((h, w, 2), generator=g) * (aw + 8) - 4,
               torch.randint(0, 5, (h, w), generator=g, dtype=torch.int32))
              for _ in range(2)]
    mat = (torch.rand((5, 24), generator=g) * 1.4 - 0.2).to(torch.float16)
    return (torch.rand((h, w, 3), generator=g) * 4, words(ah * aw, 4),
            words(ah * aw), layers, ah, aw, mat)


@pytest.mark.parametrize("alpha", ["blocks", "factor"])
def test_wrapper_takes_the_plain_version_on_the_cpu(alpha):
    """CPU tensors: the wrapper writes the plain version's result into
    ``rgb`` in place and launches nothing."""
    rgb, rb, ab, layers, ah, aw, mat = _planes()
    mat = mat if alpha == "factor" else None
    want = lightchart.tss_peel_composite_plain(rgb.clone(), rb, ab, layers,
                                               ah, aw, mat)
    before = dict(cr.launch_counts)
    out = rgb.clone()
    got = lightchart.tss_peel_composite(out, rb, ab, layers, ah, aw, mat)
    assert got is out
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert dict(cr.launch_counts) == before
    # uncovered pixels keep their colour
    none = (layers[0][0] < 0) & (layers[1][0] < 0)
    assert torch.equal(got[none], rgb[none])
    assert not torch.equal(got, rgb)


def _bad(case):
    rgb, rb, ab, layers, ah, aw, mat = _planes()
    kw = {}
    if case == "rgb_dtype":
        rgb = rgb.double()
    elif case == "rgb_channels":
        rgb = torch.zeros(rgb.shape[:2] + (4,))
    elif case == "blocks_shape":
        rb = rb[:-1]
    elif case == "blocks_dtype":
        rb = rb.long()
    elif case == "alpha_missing":
        ab = None
    elif case == "mat_dtype":
        kw["mat_all"] = mat.float()
    elif case == "mat_columns":
        kw["mat_all"] = mat[:, :3].contiguous()
    elif case == "one_layer":
        layers = layers[:1]
    elif case == "uv_shape":
        layers[1] = (layers[1][0], layers[1][1][..., :1].contiguous(),
                     layers[1][2])
    elif case == "tri_dtype":
        layers[0] = (layers[0][0].long(),) + layers[0][1:]
    elif case == "not_contiguous":
        layers[0] = (layers[0][0].t().contiguous().t(),) + layers[0][1:]
    elif case == "tiny_atlas":
        ah, rb, ab = 1, rb[:aw], ab[:aw]
    return (rgb, rb, ab, layers, ah, aw), kw


@pytest.mark.parametrize("case", [
    "rgb_dtype", "rgb_channels", "blocks_shape", "blocks_dtype",
    "alpha_missing", "mat_dtype", "mat_columns", "one_layer", "uv_shape",
    "tri_dtype", "not_contiguous", "tiny_atlas"])
def test_wrapper_refuses_bad_arguments(case, monkeypatch):
    """Refused before the plain version or the library is reached."""
    args, kw = _bad(case)
    monkeypatch.setattr(lightchart, "tss_peel_composite_plain", None)
    monkeypatch.setattr(cr, "_library", None)
    with pytest.raises(ValueError):
        lightchart.tss_peel_composite(*args, **kw)


def test_the_cpu_frame_keeps_the_budgeted_peels():
    """The CPU frame shades its peels through ``shade_sparse`` and reports
    their observed tiles to the controller."""
    r = _renderer()
    _, st = r.render()
    assert st["blend_shade_tiles"].shape == (2,)
    assert np.all(st["blend_shade_tiles"].numpy() > 0)
