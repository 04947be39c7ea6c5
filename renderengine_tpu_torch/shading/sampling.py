"""Device texture sampling from the block atlas (torch port of the JAX
package's ``shading/sampling.py``: 2D texture paths and the cubemap).

Replaces the reference's combined-image-sampler descriptors + fixed-function
samplers (``TextureCache.cpp:167-197``: linear min/mag, repeat wrap,
trilinear mips). Filtering happens in storage space with sRGB decode applied
by the caller afterwards — matching the reference, whose textures are Unorm
formats decoded in the shader (``pbr.glsl:100-112``).

The atlas and block tables arrive as int32 bit views of the u32 words
(``graph.frame.scene_to_device``); a channel is unpacked with an
arithmetic shift and a mask, ``(w >> s) & mask``, which is exact on int32.
Small-table row fetches are plain index gathers (the JAX package's one-hot
matmul there is a TPU device, and a TF32 matmul would not be exact).

The tiered anisotropic sampler of several slots (``aniso_slots``) is one
hand-written CUDA kernel on a CUDA device (``csrc/aniso_slots.cu``, in the
kernels' library of ``raster.cuda_raster``); its plain version,
``sample_slots_aniso_tiered_plain``, runs on the CPU and is the kernel's
comparison on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

# Platform-robust discrete decisions (mip floor, dithered-mip rounding,
# aniso tier count): every boundary is shifted by a NON-dyadic epsilon, so
# a few-ulp difference between platforms cannot flip a decision that
# procedural content parks exactly on a boundary.
SNAP_EPS = 1e-4

# log2(1+z) on [0,1]: degree-8 least-squares fit at Chebyshev nodes,
# |poly - log2| <= 4.9e-8, f32 Horner evaluation error <= 1.7e-7
_LOG2_POLY = (-8.8746966506e-03, 5.0277507368e-02, -1.3453425419e-01,
              2.3923166297e-01, -3.4599601243e-01, 4.7832354487e-01,
              -7.2111461440e-01, 1.4426867778e+00, 4.8863580535e-08)


def det_log2(x: torch.Tensor) -> torch.Tensor:
    """Platform-deterministic log2 for DISCRETE sampling decisions: the
    exponent comes exactly from the f32 bit pattern, log2 of the mantissa
    in [1,2) from a fixed polynomial with plain f32 multiply-adds. x must
    be positive (callers clamp)."""
    bits = x.to(torch.float32).view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127                 # exact exponent
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32)  # [1,2)
    z = m - 1.0
    acc = torch.full_like(z, _LOG2_POLY[0])
    for c in _LOG2_POLY[1:]:
        acc = acc * z + c
    return e.to(torch.float32) + acc


class AnisoSpec(NamedTuple):
    """Static anisotropic-sampling plan threaded through the ``max_aniso``
    kwargs. ``max_taps`` is the reference sampler's requested ratio ceiling
    (16, ``TextureCache.cpp:185``); ``tile_fracs`` enables the tiered
    row-segment-compacted exact path, one entry per tier = the fraction of
    segments budgeted for that tier's tap loop. Empty = dense exact taps."""

    max_taps: int = 1
    tile_fracs: tuple = ()
    slot_caps: tuple = ()   # optional per-slot tap ceilings
                            # (base, emissive, orm, normal); () = max_taps


def aniso_spec(a) -> AnisoSpec:
    return a if isinstance(a, AnisoSpec) else AnisoSpec(int(a), ())


def _parity_even(n: int, axis_len_shape, axis: int, device) -> torch.Tensor:
    """Bool broadcastable to ``axis_len_shape``: True where the coordinate
    along ``axis`` is even."""
    idx = torch.arange(n, device=device) % 2 == 0
    shape = [1] * len(axis_len_shape)
    shape[axis] = n
    return idx.reshape(shape)


def _expand_to(m: torch.Tensor, ndim: int) -> torch.Tensor:
    return m.reshape(m.shape + (1,) * (ndim - m.dim()))


def quad_dfdx(v: torch.Tensor) -> torch.Tensor:
    """GLSL dFdx with 2x2 quad semantics: for pixel x the derivative is
    v[x|1] - v[x&~1] along axis 1 (W). v: [H,W,...]. Odd extents behave as
    if the framebuffer were padded by edge replication."""
    w = v.shape[1]
    pad = w % 2
    if pad:
        v = torch.cat([v, v[:, -1:]], dim=1)
    nxt = torch.roll(v, -1, dims=1)
    prv = torch.roll(v, 1, dims=1)
    even = _expand_to(_parity_even(w + pad, (1, w + pad), 1, v.device),
                      v.dim())
    d = torch.where(even, nxt - v, v - prv)
    return d[:, :w]


def quad_dfdy(v: torch.Tensor) -> torch.Tensor:
    h = v.shape[0]
    pad = h % 2
    if pad:
        v = torch.cat([v, v[-1:]], dim=0)
    nxt = torch.roll(v, -1, dims=0)
    prv = torch.roll(v, 1, dims=0)
    even = _expand_to(_parity_even(h + pad, (h + pad, 1), 0, v.device),
                      v.dim())
    d = torch.where(even, nxt - v, v - prv)
    return d[:h]


def quad_pair_valid(covered: torch.Tensor):
    """(valid_x, valid_y) [H,W] bool: whether BOTH pixels of each quad
    x-pair / y-pair are covered."""
    h, w = covered.shape[0], covered.shape[1]
    cx = covered
    if w % 2:
        cx = torch.cat([cx, cx[:, -1:]], dim=1)
    ex = _parity_even(cx.shape[1], cx.shape, 1, cx.device)
    vx = cx & torch.where(ex, torch.roll(cx, -1, dims=1),
                          torch.roll(cx, 1, dims=1))
    vx = vx[:, :w]
    cy = covered
    if h % 2:
        cy = torch.cat([cy, cy[-1:]], dim=0)
    ey = _parity_even(cy.shape[0], cy.shape, 0, cy.device)
    vy = cy & torch.where(ey, torch.roll(cy, -1, dims=0),
                          torch.roll(cy, 1, dims=0))
    vy = vy[:h]
    return vx, vy


def quad_derivs(v: torch.Tensor, covered: torch.Tensor | None = None):
    """(dFdx, dFdy) with coverage-aware quad semantics: a pair is valid
    only when both pixels are covered; an invalid axis falls back to the
    other axis's difference, and an isolated pixel gets zero derivatives.

    v: [H,W,...]; covered: [H,W] bool or None (raw GLSL behavior)."""
    dx = quad_dfdx(v)
    dy = quad_dfdy(v)
    if covered is None:
        return dx, dy
    vx, vy = quad_pair_valid(covered)
    vx = _expand_to(vx, v.dim())
    vy = _expand_to(vy, v.dim())
    dx_m = torch.where(vx, dx, torch.where(vy, dy, 0.0))
    dy_m = torch.where(vy, dy, torch.where(vx, dx, 0.0))
    return dx_m, dy_m


def table_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row fetch ``table[idx]`` as f32. table [N,C]; idx [...] int (the
    caller clamps)."""
    return table[idx.long()].to(torch.float32)


def table_lookup_planar(table: torch.Tensor, idx: torch.Tensor,
                        cols) -> torch.Tensor:
    """``table_lookup`` restricted to ``cols``, channel-leading:
    [len(cols), *idx.shape]."""
    # contiguous column runs as slices: a list index would be built on
    # the host and copied to the device on every call
    runs, start = [], 0
    cols = list(cols)
    for i in range(1, len(cols) + 1):
        if i == len(cols) or cols[i] != cols[i - 1] + 1:
            runs.append(table[:, cols[start]:cols[i - 1] + 1])
            start = i
    sub = runs[0] if len(runs) == 1 else torch.cat(runs, dim=1)
    return torch.movedim(sub[idx.long()].to(torch.float32), -1, 0)


def _gather_block_words(table32: torch.Tensor, flat: torch.Tensor):
    """One block-row gather, returned as PLANAR words [C, *flat.shape]."""
    c = table32.shape[-1]
    blk = table32.reshape(-1, c)[flat.reshape(-1).long()]       # [N, C]
    return blk.t().reshape((c,) + tuple(flat.shape))


def _bilerp_words(words: torch.Tensor, fx, fy) -> torch.Tensor:
    """Planar bilinear mix of a gathered 2x2 block; scale-then-mix op
    order of the JAX package."""
    c = words.shape[0]
    if c == 4:        # u8: word k = corner k, byte ch = channel
        scale = 1.0 / 255.0

        def corner(k, ch):
            return ((words[k] >> (8 * ch)) & 255).to(torch.float32) * scale
    else:             # u16: corner k = words 2k (ch0|ch1), 2k+1 (ch2|ch3)
        scale = 1.0 / 65535.0

        def corner(k, ch):
            w = words[2 * k + (ch >> 1)]
            return ((w >> (16 * (ch & 1))) & 0xFFFF).to(torch.float32) * scale
    chans = []
    for ch in range(4):
        c00, c10 = corner(0, ch), corner(1, ch)
        c01, c11 = corner(2, ch), corner(3, ch)
        top = c00 * (1 - fx) + c10 * fx
        bot = c01 * (1 - fx) + c11 * fx
        chans.append(top * (1 - fy) + bot * fy)
    return torch.stack(chans, -1)


def _bilinear_at_level(atlas, tex, mip_y, mip_x, uv, level):
    """One bilinear fetch at integer mip ``level`` (per pixel), REPEAT
    wrap: ONE gather, since the atlas stores 2x2 texel blocks with the
    per-texture wrap baked in. tex: dict of per-pixel int tensors
    page,x,y,w,h (mip-0 placement)."""
    lvl = level.long()
    sw = (tex["w"] >> level).clamp_min(1)
    sh = (tex["h"] >> level).clamp_min(1)
    bx = mip_x[lvl] + (tex["x"] >> level)
    by = mip_y[lvl] + (tex["y"] >> level)

    st_x = uv[..., 0] * sw.to(torch.float32) - 0.5
    st_y = uv[..., 1] * sh.to(torch.float32) - 0.5
    ix0 = torch.floor(st_x).to(torch.int32)
    iy0 = torch.floor(st_y).to(torch.int32)
    fx = st_x - ix0.to(torch.float32)
    fy = st_y - iy0.to(torch.float32)

    # REPEAT wrap: atlas texture sizes are powers of two, so it is a mask
    x0 = bx + (ix0 & (sw - 1))
    y0 = by + (iy0 & (sh - 1))
    _, h, w, _ = atlas.shape
    flat = (tex["page"].long() * h + y0) * w + x0
    return _bilerp_words(_gather_block_words(atlas, flat), fx, fy)


def _bayer4(ix, iy):
    """4x4 Bayer matrix value in closed form (bit-reversed interleave of
    (x^y, y))."""
    x = ix & 3
    y = iy & 3
    xy = x ^ y
    return (((xy & 1) << 3) | ((y & 1) << 2)
            | (xy & 2) | (y >> 1)).to(torch.float32)


def _pixel_iota(shape, device):
    """(iy, ix) int tensors broadcast to ``shape`` ([...,H,W] or [W])."""
    ax = len(shape) - 1
    ix = torch.arange(shape[ax], device=device, dtype=torch.int32)
    if len(shape) >= 2:
        iy = torch.arange(shape[ax - 1], device=device, dtype=torch.int32)
        iy = iy[:, None].expand(shape[ax - 1], shape[ax])
        return iy.expand(shape), ix.expand(shape)
    return torch.zeros(shape, dtype=torch.int32, device=device), ix


def _dither_level(lod, n_mips):
    """Integer mip level from fractional lod by 4x4 ordered dithering (the
    lod fraction is the duty cycle of picking the next level across each
    4x4 block)."""
    iy, ix = _pixel_iota(lod.shape, lod.device)
    thr = (_bayer4(ix, iy) + 0.5) * (1.0 / 16.0)
    lodc = torch.minimum(lod.clamp_min(0.0), (n_mips - 1).to(torch.float32))
    l0 = torch.floor(lodc + SNAP_EPS).to(torch.int32)
    f = (lodc - l0.to(torch.float32)).clamp_min(0.0)
    return torch.minimum(l0 + (f - SNAP_EPS > thr).to(torch.int32),
                         n_mips - 1)


def _bilinear_at_level_lod(atlas, tex, mip_y, mip_x, uv, n_mips, lod,
                           dither: bool = False):
    """Trilinear: two bilinear taps mixed by the lod fraction (or ONE
    dither-rounded tap, see ``_dither_level``)."""
    if dither:
        return _bilinear_at_level(atlas, tex, mip_y, mip_x, uv,
                                  _dither_level(lod, n_mips))
    lodc = torch.minimum(lod.clamp_min(0.0), (n_mips - 1).to(torch.float32))
    l0 = torch.floor(lodc + SNAP_EPS).to(torch.int32)
    l1 = torch.minimum(l0 + 1, n_mips - 1)
    f = (lodc - l0.to(torch.float32)).clamp_min(0.0)[..., None]
    t0 = _bilinear_at_level(atlas, tex, mip_y, mip_x, uv, l0)
    t1 = _bilinear_at_level(atlas, tex, mip_y, mip_x, uv, l1)
    return (1 - f) * t0 + f * t1


def sample_texture_rows(atlas, mip_y, mip_x, tex, n_mips, uv, lod=None,
                        dither: bool = False) -> torch.Tensor:
    """Core sampler on pre-fetched table rows: bilinear at mip 0 when
    ``lod`` is None, else trilinear (or dithered). Returns f32 [...,4]."""
    if lod is None:
        return _bilinear_at_level(atlas, tex, mip_y, mip_x, uv,
                                  torch.zeros_like(n_mips))
    return _bilinear_at_level_lod(atlas, tex, mip_y, mip_x, uv, n_mips, lod,
                                  dither)


def sample_texture(atlas, tex_table, mip_y, mip_x, handle, uv,
                   lod=None) -> torch.Tensor:
    """Trilinear (or bilinear if ``lod`` is None) sample by texture
    handle: tex_table [N,6] int32 rows (page, x, y, w, h, n_mips), handle
    [...] (invalid ids clamped: the caller masks), uv [...,2]. Returns
    rgba f32 [...,4]."""
    row = tex_table[handle.clamp(0, tex_table.shape[0] - 1).long()]
    tex = dict(zip(("page", "x", "y", "w", "h"), row.unbind(-1)[:5]))
    return sample_texture_rows(atlas, mip_y, mip_x, tex, row[..., 5], uv,
                               lod)


def compute_lod(uv: torch.Tensor, tex_w, tex_h) -> torch.Tensor:
    """GLSL implicit LOD: log2(max(|ddx|, |ddy|)) of texel coords with
    quad derivatives. uv [H,W,2]; tex_w/h [H,W]."""
    tc = uv * torch.stack([tex_w.to(torch.float32),
                           tex_h.to(torch.float32)], -1)
    dx, dy = quad_dfdx(tc), quad_dfdy(tc)
    rho = torch.maximum(torch.sqrt((dx * dx).sum(-1)),
                        torch.sqrt((dy * dy).sum(-1)))
    return det_log2(rho.clamp_min(1e-20))


def _norm2(v: torch.Tensor) -> torch.Tensor:
    """Euclidean length over the last axis of size 2, a + b order."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def _aniso_footprint(tex, uv_dx, uv_dy, max_aniso: int):
    """Per-pixel anisotropy: tap count ``n``, minor-axis ``lod``, and the
    major-axis uv step (GL-style footprint split)."""
    size = torch.stack([tex["w"].to(torch.float32),
                        tex["h"].to(torch.float32)], -1)
    px = _norm2(uv_dx * size)
    py = _norm2(uv_dy * size)
    pmax = torch.maximum(px, py)
    pmin = torch.minimum(px, py).clamp_min(1e-20)
    n = torch.ceil(pmax / pmin - SNAP_EPS).clamp(1.0, float(max_aniso))
    lod = det_log2((pmax / n).clamp_min(1e-20))
    major = torch.where((px >= py)[..., None], uv_dx, uv_dy)
    return n, lod, major


def sample_texture_aniso(atlas, mip_y, mip_x, tex, n_mips, uv,
                         duv_dx, duv_dy, max_aniso: int,
                         dither: bool = False) -> torch.Tensor:
    """Anisotropic filtering, the reference's 16x sampler request
    (``TextureCache.cpp:185-186``): N trilinear taps spread along the
    major-axis footprint, LOD from the minor axis, mean-combined.

    ``dither=False``: exact N taps (the dense spec). ``dither=True``: ONE
    tap per pixel at slot ``floor(phase * n)`` of its own N-tap ladder,
    with a transposed Bayer phase."""
    n, lod, major = _aniso_footprint(tex, duv_dx, duv_dy, max_aniso)
    if dither:
        iy, ix = _pixel_iota(n.shape, n.device)
        phase = (_bayer4(iy, ix) + 0.5) * (1.0 / 16.0)
        j = torch.floor(phase * n)
        t = (j + 0.5) / n - 0.5
        return _bilinear_at_level_lod(atlas, tex, mip_y, mip_x,
                                      uv + major * t[..., None],
                                      n_mips, lod, dither=True)
    acc = torch.zeros(uv.shape[:-1] + (4,), dtype=torch.float32,
                      device=uv.device)
    for i in range(max_aniso):
        t = (i + 0.5) / n - 0.5
        w = (i < n).to(torch.float32)[..., None]
        acc = acc + w * _bilinear_at_level_lod(
            atlas, tex, mip_y, mip_x, uv + major * t[..., None], n_mips,
            lod, dither)
    return acc / n[..., None]


def tap_ladder(spec: AnisoSpec) -> list:
    """Tap ladder 2, 4, 8, ... capped at max_taps; the last tier absorbs
    the full ratio range."""
    ladder = []
    t = 2
    for i in range(len(spec.tile_fracs)):
        last = i == len(spec.tile_fracs) - 1
        ladder.append(spec.max_taps if last else min(t, spec.max_taps))
        t *= 2
    return ladder


def row_segments(h: int, w: int, seg_w: int):
    """Shard-invariant screen compaction geometry: [1, seg_w] row segments
    (every segment lies inside ONE pixel row; selection is per row)."""
    ntx = -(-w // seg_w)
    pw = ntx * seg_w - w
    return ntx, pw


def _segfy(a, ntx, pw, seg_w):
    """[H, W(,C)] -> [H, ntx, seg_w(,C)] with zero right-padding."""
    if pw:
        pad = torch.zeros((a.shape[0], pw) + a.shape[2:], dtype=a.dtype,
                          device=a.device)
        a = torch.cat([a, pad], dim=1)
    return a.reshape((a.shape[0], ntx, seg_w) + a.shape[2:])


def row_segment_counts(member, seg_w: int):
    """[H, W] bool -> per-row member count per [1, seg_w] segment [H, ntx]."""
    h, w = member.shape
    ntx, pw = row_segments(h, w, seg_w)
    return _segfy(member, ntx, pw, seg_w).sum(-1)


def select_row_segments(member, seg_w: int, frac: float):
    """Per-ROW top-k segment selection by member count.

    member [H, W] bool -> (sel [H, K] int64, K). Ties break to the lowest
    segment index, as ``jax.lax.top_k`` does: a stable descending sort,
    not ``torch.topk``, whose tie order is unspecified."""
    ntx, _ = row_segments(*member.shape, seg_w)
    k = max(1, min(int(round(frac * ntx)), ntx))
    cnt = row_segment_counts(member, seg_w)               # [H, ntx]
    sel = torch.sort(cnt, dim=-1, descending=True, stable=True).indices
    return sel[:, :k], k


def gather_row_segments(a, sel, seg_w: int):
    """Compact [H, W(,C)] screen planes to the selected [H, K, seg_w(,C)]
    segments."""
    h, w = a.shape[:2]
    ntx, pw = row_segments(h, w, seg_w)
    seg = _segfy(a, ntx, pw, seg_w)
    idx = sel.reshape(sel.shape + (1,) * (seg.dim() - 2)).expand(
        (sel.shape[0], sel.shape[1]) + seg.shape[2:])
    return torch.gather(seg, 1, idx)


def scatter_row_segments(vals, sel, h: int, w: int, seg_w: int):
    """Inverse of gather_row_segments: (values [H,K,seg_w(,C)], sel [H,K])
    -> ([H,W(,C)] scattered, have [H,W] bool coverage)."""
    ntx, pw = row_segments(h, w, seg_w)
    rows = torch.arange(h, device=sel.device)[:, None]
    scat = torch.zeros((h, ntx, seg_w) + vals.shape[3:], dtype=vals.dtype,
                       device=vals.device)
    scat[rows, sel] = vals
    have = torch.zeros((h, ntx), dtype=torch.bool, device=sel.device)
    # a device-side True: a Python scalar stored through advanced
    # indexing is built on the host and copied to the device
    have[rows, sel] = torch.ones_like(sel, dtype=torch.bool)
    have = have[:, :, None].expand(h, ntx, seg_w)

    def unseg(x):
        return x.reshape((h, ntx * seg_w) + x.shape[3:])[:, :w]
    return unseg(scat), unseg(have)


def _uv_footprint(duv_dx, duv_dy, max_taps: int):
    """Texture-size-independent anisotropy decision in UV space: tap count
    ``n`` and the major-axis uv step."""
    px = _norm2(duv_dx)
    py = _norm2(duv_dy)
    pmax = torch.maximum(px, py)
    pmin = torch.minimum(px, py).clamp_min(1e-20)
    n = torch.ceil(pmax / pmin - SNAP_EPS).clamp(1.0, float(max_taps))
    major = torch.where((px >= py)[..., None], duv_dx, duv_dy)
    return n, major


def _slot_rho2(tex, duv_dx, duv_dy):
    """Per-slot squared texel-space footprint (major axis): the isotropic
    LOD is 0.5*log2(rho2)."""
    size = torch.stack([tex["w"].to(torch.float32),
                        tex["h"].to(torch.float32)], -1)
    dx = duv_dx * size
    dy = duv_dy * size
    return torch.maximum(dx[..., 0] * dx[..., 0] + dx[..., 1] * dx[..., 1],
                         dy[..., 0] * dy[..., 0] + dy[..., 1] * dy[..., 1]
                         ).clamp_min(1e-40)


_PLANE_KEYS = ("page", "x", "y", "w", "h")
# what one ``aniso_slots`` launch carries (``csrc/aniso_slots.cu``:
# kMaxSlots, kMaxTiers)
ANISO_MAX_SLOTS = 4
ANISO_MAX_TIERS = 8


def sample_slots_aniso_tiered(atlas, mip_y, mip_x, slots, uv,
                              duv_dx, duv_dy, spec: AnisoSpec,
                              slot_caps=None, seg_w: int = 128):
    """``sample_slots_aniso_tiered_plain``'s result through ``aniso_slots``:
    one kernel launch on a CUDA device, the plain version on the CPU. The
    inputs are made contiguous first (the fragment's uv is a view of its
    attribute planes)."""
    slots = [({k: tex[k].contiguous() for k in _PLANE_KEYS}, nm.contiguous())
             for tex, nm in slots]
    return aniso_slots(atlas, mip_y, mip_x, slots, uv.contiguous(),
                       duv_dx.contiguous(), duv_dy.contiguous(), spec,
                       slot_caps, seg_w)


def sample_slots_aniso_tiered_plain(atlas, mip_y, mip_x, slots, uv,
                                    duv_dx, duv_dy, spec: AnisoSpec,
                                    slot_caps=None, seg_w: int = 128):
    """Exact anisotropic taps at compacted cost for SEVERAL texture slots
    sharing one footprint decision.

    Every pixel pays one trilinear tap per slot at the isotropic LOD;
    anisotropic pixels group into tap tiers (2 / 4 / ... / max_taps)
    decided once from the uv-space derivatives. Each tier's tap loop runs
    only on per-ROW budgeted [1, seg_w] segments (``select_row_segments``);
    inside a selected segment the result is the exact per-pixel N-tap
    average, past-budget pixels keep the isotropic tap.

    slots: list of (tex_planes, n_mips), tex_planes the page/x/y/w/h dict,
    all [H, W]. ``slot_caps``: optional per-slot tap ceilings. Returns one
    rgba [H,W,4] per slot."""
    assert uv.dim() == 3 and len(spec.tile_fracs) >= 1
    if not slots:
        return []
    h, w = uv.shape[:2]
    if slot_caps is None:
        slot_caps = (spec.max_taps,) * len(slots)
    n, major = _uv_footprint(duv_dx, duv_dy, spec.max_taps)
    rho2 = [_slot_rho2(tex, duv_dx, duv_dy) for tex, _ in slots]

    outs = []
    for si, (tex, nm) in enumerate(slots):
        lod_iso = 0.5 * det_log2(rho2[si])
        outs.append(_bilinear_at_level_lod(atlas, tex, mip_y, mip_x, uv, nm,
                                           lod_iso))

    shared = {"u": uv[..., 0], "v": uv[..., 1],
              "mu": major[..., 0], "mv": major[..., 1], "n": n}
    prev = 1.0
    for taps, frac in zip(tap_ladder(spec), spec.tile_fracs):
        member = (n > prev) & ((n <= taps) if taps < spec.max_taps
                               else torch.ones_like(n, dtype=torch.bool))
        sel, k = select_row_segments(member, seg_w, frac)
        c = {key: gather_row_segments(v, sel, seg_w)
             for key, v in shared.items()}
        uv_c = torch.stack([c["u"], c["v"]], -1)
        major_c = torch.stack([c["mu"], c["mv"]], -1)
        for si, (tex, nm) in enumerate(slots):
            taps_s = min(taps, slot_caps[si])
            if taps_s <= 1:
                continue
            tex_c = {key: gather_row_segments(tex[key], sel, seg_w)
                     for key in _PLANE_KEYS}
            nm_c = gather_row_segments(nm, sel, seg_w)
            n_c = c["n"].clamp(1.0, float(taps_s))
            # minor-axis LOD at the slot's own scale: 0.5*log2(rho2/N^2)
            lod_c = 0.5 * det_log2(gather_row_segments(rho2[si], sel, seg_w)
                                   / (n_c * n_c))
            acc = torch.zeros(uv_c.shape[:-1] + (4,), dtype=torch.float32,
                              device=uv.device)
            for i in range(taps_s):
                tt = (i + 0.5) / n_c - 0.5
                wt = (i < n_c).to(torch.float32)[..., None]
                acc = acc + wt * _bilinear_at_level_lod(
                    atlas, tex_c, mip_y, mip_x, uv_c + major_c * tt[..., None],
                    nm_c, lod_c)
            scat, have = scatter_row_segments(acc / n_c[..., None], sel, h, w,
                                              seg_w)
            hit = (member & have)[..., None]
            outs[si] = torch.where(hit, scat, outs[si])
        prev = taps
    return outs


def tier_selections(duv_dx, duv_dy, spec: AnisoSpec, seg_w: int = 128):
    """The tiered sampler's decisions, as ``sample_slots_aniso_tiered_plain``
    takes them: the footprint's tap count n [H, W] and, for each tier of
    ``tap_ladder(spec)``, (taps, member [H, W] bool, sel [H, k] int64, k):
    the tier's pixels and its per-row selected segments."""
    n, _ = _uv_footprint(duv_dx, duv_dy, spec.max_taps)
    tiers, prev = [], 1.0
    for taps, frac in zip(tap_ladder(spec), spec.tile_fracs):
        member = (n > prev) & ((n <= taps) if taps < spec.max_taps
                               else torch.ones_like(n, dtype=torch.bool))
        tiers.append((taps, member, *select_row_segments(member, seg_w, frac)))
        prev = taps
    return n, tiers


def _check_aniso_args(atlas, mip_y, mip_x, slots, uv, duv_dx, duv_dy,
                      spec: AnisoSpec, slot_caps) -> None:
    """``aniso_slots``'s argument checks, on any device."""
    if uv.dim() != 3 or uv.shape[2] != 2:
        raise ValueError("uv must be [H, W, 2]")
    hw = tuple(uv.shape[:2])
    if not 1 <= len(spec.tile_fracs) <= ANISO_MAX_TIERS:
        raise ValueError(f"the tier ladder holds 1 to {ANISO_MAX_TIERS} "
                         "tiers")
    if len(slots) > ANISO_MAX_SLOTS:
        raise ValueError(f"at most {ANISO_MAX_SLOTS} slots a call")
    if slot_caps is not None and len(slot_caps) != len(slots):
        raise ValueError("one tap cap per slot")
    if atlas.dtype != torch.int32 or atlas.dim() != 4 \
            or atlas.shape[3] not in (4, 8):
        raise TypeError("atlas must be int32 [pages, ah, aw, 4 or 8]")
    floats = {"uv": uv, "duv_dx": duv_dx, "duv_dy": duv_dy}
    ints = {"mip_y": mip_y, "mip_x": mip_x}
    for si, (tex, nm) in enumerate(slots):
        ints.update({f"slot {si} {k}": tex[k] for k in _PLANE_KEYS})
        ints[f"slot {si} n_mips"] = nm
    for name, t in {**floats, **ints}.items():
        if t.dtype != (torch.float32 if name in floats else torch.int32):
            raise TypeError(f"{name} must be "
                            f"{'float32' if name in floats else 'int32'}")
        if name in ("mip_y", "mip_x"):
            if t.dim() != 1:
                raise ValueError(f"{name} must be [levels]")
        elif tuple(t.shape) != (hw + (2,) if name in floats else hw):
            raise ValueError(f"{name} must match uv's [H, W]")
    tensors = [atlas, *floats.values(), *ints.values()]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("aniso_slots inputs must be contiguous")
    dev = uv.device
    if any(t.device != dev for t in tensors):
        raise ValueError("aniso_slots inputs must share one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("aniso_slots runs on a CUDA device or the CPU")
    # the kernel loads atlas blocks as 16-byte and uv pairs as 8-byte words
    if atlas.data_ptr() % 16 or any(t.data_ptr() % 8
                                    for t in floats.values()):
        raise ValueError("atlas must start on 16 bytes, uv planes on 8")


def aniso_slots(atlas, mip_y, mip_x, slots, uv, duv_dx, duv_dy,
                spec: AnisoSpec, slot_caps=None, seg_w: int = 128):
    """The tiered sampler's kernel (``csrc/aniso_slots.cu``): the
    arguments of ``sample_slots_aniso_tiered_plain`` (contiguous, int32
    planes, float32 uv planes), checked on every device. CPU tensors take
    the plain version. On a CUDA device the footprint's tier membership
    and each tier's per-row segment selection run here in PyTorch
    (``select_row_segments``, a small sort), and ONE launch computes every
    slot's result in place of the plain version's gathers, tap loops and
    scatters; it returns views of one [n_slots, H, W, 4] output and never
    synchronises."""
    _check_aniso_args(atlas, mip_y, mip_x, slots, uv, duv_dx, duv_dy, spec,
                      slot_caps)
    if uv.device.type == "cpu":
        return sample_slots_aniso_tiered_plain(
            atlas, mip_y, mip_x, slots, uv, duv_dx, duv_dy, spec,
            slot_caps=slot_caps, seg_w=seg_w)
    if not slots:
        return []
    from ..raster import cuda_raster
    h, w = uv.shape[:2]
    caps = (spec.max_taps,) * len(slots) if slot_caps is None else slot_caps
    sels, tiers = [], []
    for taps, _, sel, k in tier_selections(duv_dx, duv_dy, spec, seg_w)[1]:
        sels.append(sel)
        tiers += [sel.stride(0), k, taps] + [min(taps, c) for c in caps] \
            + [0] * (ANISO_MAX_SLOTS - len(slots))
    out = torch.empty((len(slots), h, w, 4), dtype=torch.float32,
                      device=uv.device)
    planes = [t.data_ptr() for tex, nm in slots
              for t in [tex[k] for k in _PLANE_KEYS] + [nm]]
    lib = cuda_raster._library()
    with torch.cuda.device(uv.device):
        rc = lib.aniso_slots_launch(
            atlas.data_ptr(), atlas.shape[0] * atlas.shape[1] * atlas.shape[2],
            atlas.shape[1], atlas.shape[2], atlas.shape[3],
            mip_x.data_ptr(), mip_y.data_ptr(), uv.data_ptr(),
            duv_dx.data_ptr(), duv_dy.data_ptr(),
            (ctypes.c_void_p * len(planes))(*planes), len(slots), h, w,
            (ctypes.c_void_p * len(sels))(*[s.data_ptr() for s in sels]),
            (ctypes.c_int * len(tiers))(*tiers), len(sels), seg_w,
            spec.max_taps, out.data_ptr(),
            torch.cuda.current_stream(uv.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"aniso_slots launch failed: CUDA error {rc}")
    cuda_raster.launch_counts["aniso_slots"] += 1
    return list(out.unbind(0))


def sample_texture_aniso_tiered(atlas, mip_y, mip_x, tex, n_mips, uv,
                                duv_dx, duv_dy, spec: AnisoSpec,
                                seg_w: int = 128):
    """Single-slot form of ``sample_slots_aniso_tiered``."""
    return sample_slots_aniso_tiered(atlas, mip_y, mip_x, [(tex, n_mips)],
                                     uv, duv_dx, duv_dy, spec,
                                     seg_w=seg_w)[0]


# --- cubemap --------------------------------------------------------------

def _cube_face_uv(dirs: torch.Tensor):
    """dirs [...,3] -> (face int64, u, v) with GL/Vulkan face conventions."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(
        is_x, torch.where(x > 0, 0, 1),
        torch.where(is_y, torch.where(y > 0, 2, 3), torch.where(z > 0, 4, 5)))
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az)).clamp_min(1e-20)
    sc = torch.where(is_x, torch.where(x > 0, -z, z),
                     torch.where(is_y, x, torch.where(z > 0, x, -x)))
    tc = torch.where(is_y, torch.where(y > 0, z, -z), -y)
    return face, 0.5 * (sc / ma + 1.0), 0.5 * (tc / ma + 1.0)


def _bilerp_f32_rows(rows16: torch.Tensor, fx, fy) -> torch.Tensor:
    """Planar bilinear mix of gathered f32 block rows [16, ...] (row
    layout c00[4] c10[4] c01[4] c11[4]); same op order as
    ``_bilerp_words``."""
    chans = []
    for ch in range(4):
        c00, c10 = rows16[ch], rows16[4 + ch]
        c01, c11 = rows16[8 + ch], rows16[12 + ch]
        top = c00 * (1 - fx) + c10 * fx
        bot = c01 * (1 - fx) + c11 * fx
        chans.append(top * (1 - fy) + bot * fy)
    return torch.stack(chans, -1)


def _sample_cube_blocks(cube: torch.Tensor, dirs: torch.Tensor,
                        gather_words) -> torch.Tensor:
    """Shared bilinear cube sampling over a 2x2-block table;
    ``gather_words`` maps (flat indices, fx, fy) -> the mixed sample."""
    face, u, v = _cube_face_uv(dirs)
    s = cube.shape[1]
    st_x = u * s - 0.5
    st_y = v * s - 0.5
    ix0 = torch.floor(st_x).to(torch.int64)
    iy0 = torch.floor(st_y).to(torch.int64)
    fx = st_x - ix0.to(torch.float32)
    fy = st_y - iy0.to(torch.float32)
    x0 = ix0.clamp(0, s - 1)           # clamp-to-edge within the face
    y0 = iy0.clamp(0, s - 1)
    return gather_words((face * s + y0) * s + x0, fx, fy)


def sample_cubemap(cube: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear cubemap sample (GL/Vulkan face conventions). cube
    [6,S,S,4] int32 words of 2x2 u8 blocks (clamp-to-edge baked in — see
    scene.textures.build_atlas); dirs [...,3]. Returns rgba f32 [...,4].
    One gather per sample."""
    return _sample_cube_blocks(
        cube, dirs,
        lambda flat, fx, fy: _bilerp_words(
            _gather_block_words(cube, flat), fx, fy))


def sample_cubemap_f32(cube: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an f32 block cube [6,S,S,16] (e.g. the
    irradiance map): same one-row-gather scheme, no unpack."""
    return _sample_cube_blocks(
        cube, dirs,
        lambda flat, fx, fy: _bilerp_f32_rows(
            _gather_block_words(cube, flat), fx, fy))
