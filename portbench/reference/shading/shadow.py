"""Shadow lookup with 3x3 PCF (torch port of the JAX package's
``shading/shadow.py``).

Port of ``Assets/Shaders/shadow.glsl:24-56``: fragment -> light clip space,
slope-scaled bias max(0.05*(1-N.L), 0.005), 3x3 PCF over texel offsets,
/9. The shadow sampler is nearest / clamp-to-edge with an opaque-white
border (``ShadowSystem.cpp:18-35``) — out-of-map lookups read depth 1.0 and
therefore never shadow.

The depth map is packed once per shadow render into 4x4-texel u16
windows anchored on a stride-2 grid, so the 9 PCF taps cost ONE 32-byte
gather at every pixel. (The port's two-stage path, a coarse min/max table
that resolves fully lit and fully shadowed pixels and a budgeted window
gather for the penumbra, equals this bit for bit while its budget drops
nothing; the benchmark's reference has no budget.)

The packed words are the JAX package's u32 words held as int32 bit views
(torch has no shifts on uint32 on the CPU): a half is unpacked with
``(w >> s) & 0xFFFF``, which is exact on int32 whatever the sign bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class ShadowPack(NamedTuple):
    """Packed shadow-map tables (one per shadow render, cached).

    blocks: [NS, A, A, 8] int32 (u32 bit views) — stride-2-anchored 4x4
            u16 windows (A = E//2 + 1); the one-gather 3x3 PCF footprint.
    """
    blocks: torch.Tensor


def _pack_halves(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two u16 values (as int64 in [0, 65535]) -> the u32 word lo | hi<<16
    as an int32 bit view. Built in int64 and narrowed by two's complement,
    so a high half >= 0x8000 keeps its bits."""
    w = lo | (hi << 16)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def pack_shadow_blocks(shadow_maps: torch.Tensor) -> ShadowPack:
    """[NS,E,E] depth -> ShadowPack. Depth is quantized to 16-bit unorm —
    the quantization step (1.5e-5) is far below the minimum shadow bias
    (0.005), so compare results are unchanged in practice. White (1.0)
    border baked in.

    A pixel with clipped center texel (iy', ix') (iy' = clip(iy,-1,E)) uses
    anchor a2 = (iy'+1) >> 1; its 3x3 taps iy'-1..iy'+1 fall inside the 4x4
    window at local rows p..p+2 where p = iy' - 2*a2 + 2 in {1, 2}.
    """
    e = shadow_maps.shape[1]
    q = torch.round(shadow_maps.clamp(0.0, 1.0) * 65535.0).to(torch.int64)
    # anchors a2 in [0, e//2]: window rows span [-2, e+2)
    p = F.pad(q, (2, 2, 2, 2), value=65535)
    na = e // 2 + 1  # anchor count per axis (a2 in 0..e//2)
    words = []
    for t in range(0, 16, 2):          # u16 index t = 4*dy + dx; word t//2
        halves = []
        for tt in (t, t + 1):
            dy, dx = tt >> 2, tt & 3
            # window row dy at anchor a2 = padded row 2*a2 + dy
            halves.append(p[:, dy: dy + 2 * na - 1: 2,
                            dx: dx + 2 * na - 1: 2])
        words.append(_pack_halves(halves[0], halves[1]))
    blocks = torch.stack(words, dim=-1).contiguous()

    return ShadowPack(blocks)


def _window_pcf(blk32, threshold, u, v, py, px_, e):
    """9-tap PCF sum from gathered 4x4 windows. blk32 [...,8] int32 words;
    returns the /9 factor (border-range tests included). Planar form: the
    window unpacks to 16 per-tap comparison planes via shifts on the
    gathered words."""
    words = torch.movedim(blk32, -1, 0)                    # [8, ...]
    scale = 1.0 / 65535.0

    def cmp(r, c):
        t = 4 * r + c       # u16 index: word t//2, half t&1
        d16 = ((words[t >> 1] >> (16 * (t & 1))) & 0xFFFF) \
            .to(torch.float32) * scale
        return (threshold > d16).to(torch.float32)

    cmpp = [[cmp(r, c) for c in range(4)] for r in range(4)]

    inv_e = 1.0 / e
    ue = u * inv_e
    ve = v * inv_e
    pyb = py.bool()
    pxb = px_.bool()
    shadow = torch.zeros_like(threshold)
    for dy in (-1, 0, 1):
        tv_in = (ve + dy * inv_e >= 0.0) & (ve + dy * inv_e < 1.0)
        for dx in (-1, 0, 1):
            d = torch.where(
                pyb,
                torch.where(pxb, cmpp[2 + dy][2 + dx], cmpp[2 + dy][1 + dx]),
                torch.where(pxb, cmpp[1 + dy][2 + dx], cmpp[1 + dy][1 + dx]))
            tu_in = (ue + dx * inv_e >= 0.0) & (ue + dx * inv_e < 1.0)
            shadow = shadow + torch.where(tu_in & tv_in, d, 0.0)
    return shadow / 9.0


def _to_light_clip(m, frag_pos):
    """Light clip coordinates m @ (pos, 1): m [4,4], frag_pos [H,W,3] ->
    [H,W,4], each row a fixed (x + y) + z sum plus the translation."""
    p = m[:, :3] * frag_pos[:, :, None, :]                 # [H,W,4,3]
    return ((p[..., 0] + p[..., 1]) + p[..., 2]) + m[:, 3]


def compute_shadow_directional(shadow_pack, shadow_transforms, shadow_index,
                               light_pos, frag_pos, normal,
                               cube: bool = False):
    """shadow_pack: ShadowPack (see ``pack_shadow_blocks``);
    shadow_transforms [NS,4,4] (= lightProj @ lightView, the
    MaterialShadowData.transform, ``shadow.glsl:31``); shadow_index 0-d
    tensor; frag_pos/normal [H,W,3]. Returns shadow factor [H,W]
    (1 = shadowed).

    ``cube``: point-light cube lookup (beyond the reference's
    directional-only path): shadow_index is the base of six consecutive
    face maps (+X -X +Y -Y +Z -Z); each fragment selects the face of its
    dominant light-to-fragment axis. The face transform is applied by a
    6-way select rather than a per-pixel matrix gather.

    Every pixel pays the window gather: the dense single stage, which the
    port's two-stage path equals bit for bit while its penumbra budget
    drops nothing (the benchmark's reference has no budget).
    """
    blocks = shadow_pack.blocks
    ns, na, _, _ = blocks.shape
    e = (na - 1) * 2
    if cube:
        d = frag_pos - light_pos
        dx, dy_, dz = d[..., 0], d[..., 1], d[..., 2]
        ax, ay, az = dx.abs(), dy_.abs(), dz.abs()
        face = torch.where(
            (ax >= ay) & (ax >= az),
            torch.where(dx >= 0, 0, 1),
            torch.where(ay >= az,
                        torch.where(dy_ >= 0, 2, 3),
                        torch.where(dz >= 0, 4, 5))).to(torch.int64)
        base = shadow_index.clamp(0, max(ns - 6, 0)).to(torch.int64)
        # six consecutive rows from a device-side base: no host read
        m6 = shadow_transforms[base + torch.arange(
            6, device=shadow_transforms.device)]
        idx = base + face                              # [H,W]
        flp = torch.zeros(frag_pos.shape[:-1] + (4,), dtype=frag_pos.dtype,
                          device=frag_pos.device)
        for f in range(6):
            flp = torch.where((face == f)[..., None],
                              _to_light_clip(m6[f], frag_pos), flp)
    else:
        idx = shadow_index.clamp(0, ns - 1).to(torch.int64)
        # a gather, not ``shadow_transforms[idx]``: indexing with a 0-d
        # tensor reads its value on the host
        m = shadow_transforms.index_select(0, idx.reshape(1))[0]
        flp = _to_light_clip(m, frag_pos)
    w = flp[..., 3]
    safe_w = torch.where(w == 0, 1.0, w)
    current = flp[..., 2] / safe_w

    # reference quirk kept: lightDir from light *position* even for
    # directional lights (shadow.glsl:33)
    ld = light_pos - frag_pos
    ld = ld / torch.sqrt((ld[..., 0] * ld[..., 0] + ld[..., 1] * ld[..., 1])
                         + ld[..., 2] * ld[..., 2]).clamp_min(1e-20)[..., None]
    nl = normal * ld
    bias = (0.05 * (1.0 - ((nl[..., 0] + nl[..., 1]) + nl[..., 2]))
            ).clamp_min(0.005)
    threshold = current - bias

    map_xy = 0.5 * (flp[..., :2] / safe_w[..., None]) + 0.5
    u = map_xy[..., 0] * e
    v = map_xy[..., 1] * e
    ix = torch.floor(u).to(torch.int64)
    iy = torch.floor(v).to(torch.int64)

    cy = iy.clamp(-1, e)                 # clipped center texel
    cx = ix.clamp(-1, e)
    a2y = (cy + 1) >> 1
    a2x = (cx + 1) >> 1
    py = cy - 2 * a2y + 1                # window-local row of tap dy=-1: {0,1}
    px_ = cx - 2 * a2x + 1

    # perspective (spot) maps: fragments behind the light plane (w <= 0)
    # project nonsensically — they are never shadowed. Ortho maps have
    # w == 1, so the guard is free for directional lights.
    invalid = (current > 1.0) | (w <= 0.0)

    blk32 = blocks.reshape(-1, 8)[(idx * na + a2y) * na + a2x]
    shadow = _window_pcf(blk32, threshold, u, v, py, px_, e)
    return torch.where(invalid, 0.0, shadow)
