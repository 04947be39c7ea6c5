"""Inputs of the tiered anisotropic sampler (``sampling.aniso_slots``)
made from a numpy seed, for its CPU and card tests: an atlas of random
block words (u8 texels: 4 words a block, u16: 8) with mip regions side by
side, a material table of per-slot descriptors (some slots without a
texture: page -1, as ``scene.scene`` packs them), a per-pixel material
id, uv and quad derivatives whose anisotropy covers every tier of the 16x
ladder, and a few isolated pixels with zero derivatives."""

import numpy as np
import torch

from renderengine_tpu_torch.shading import sampling

PLANES = ("page", "x", "y", "w", "h")
DEFAULT_SPEC = sampling.AnisoSpec(16, (0.25, 0.15, 0.08), (16, 4, 4, 4))
_REGION = 512          # mip 0 region of a page; level l at x = mip_x[l]
_LEVELS = 10


def atlas(rng, words: int, pages: int = 2):
    """(atlas [pages, 512, 1024, words] int32, mip_y, mip_x)."""
    mip_x = np.zeros(_LEVELS, np.int32)
    for lvl in range(1, _LEVELS):
        mip_x[lvl] = mip_x[lvl - 1] + (_REGION >> (lvl - 1))
    a = rng.integers(-2**31, 2**31, (pages, _REGION, 2 * _REGION, words),
                     dtype=np.int64).astype(np.int32)
    return (torch.from_numpy(a), torch.zeros(_LEVELS, dtype=torch.int32),
            torch.from_numpy(mip_x))


def material_table(rng, n_mat: int, pages: int = 2):
    """[n_mat, 4 slots, 6] int32 (page, x, y, w, h, n_mips); about one
    slot in five has no texture."""
    t = np.zeros((n_mat, 4, 6), np.int32)
    for m in range(n_mat):
        for s in range(4):
            if rng.random() < 0.2:
                t[m, s] = (-1, 0, 0, 1, 1, 1)
                continue
            w, h = (1 << int(rng.integers(2, 9)) for _ in range(2))
            x = int(rng.integers(0, _REGION // w)) * w
            y = int(rng.integers(0, _REGION // h)) * h
            n_mips = int(np.log2(min(w, h))) + 1
            t[m, s] = (rng.integers(0, pages), x, y, w, h, n_mips)
    return t


def pixels(rng, h: int, w: int, n_mat: int):
    """(mat_id [H, W], uv [H, W, 2], duv_dx, duv_dy): materials in
    blocks, anisotropy ratios 1-24 at any angle, footprints of 1/8 to 64
    texels of a 256-texel texture, zero derivatives at ~1% of pixels."""
    blk = rng.integers(0, n_mat, (-(-h // 8), -(-w // 16)))
    mat = np.repeat(np.repeat(blk, 8, 0), 16, 1)[:h, :w].astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, (h, w, 2)).astype(np.float32)
    ratio = np.where(rng.random((h, w)) < 0.3, 1.0,
                     rng.uniform(1.0, 24.0, (h, w)))
    minor = 2.0 ** rng.uniform(-3.0, 6.0, (h, w)) / 256.0
    ang = rng.uniform(0.0, 2 * np.pi, (h, w))
    c, s = np.cos(ang), np.sin(ang)
    dx = np.stack([c, s], -1) * (ratio * minor)[..., None]
    dy = np.stack([-s, c], -1) * minor[..., None]
    swap = rng.random((h, w)) < 0.5
    dx, dy = (np.where(swap[..., None], dy, dx),
              np.where(swap[..., None], dx, dy))
    zero = rng.random((h, w)) < 0.01
    dx[zero] = 0.0
    dy[zero] = 0.0
    return (torch.from_numpy(mat), torch.from_numpy(uv),
            torch.from_numpy(dx.astype(np.float32)),
            torch.from_numpy(dy.astype(np.float32)))


def slots(table, mat, used=(0, 1, 2, 3)):
    """The sampler's ``slots`` for the slots ``used``: per-pixel int32
    planes gathered from the material table."""
    tab = torch.from_numpy(table)[mat.long()]          # [H, W, 4, 6]
    return [({k: tab[..., si, i].contiguous() for i, k in enumerate(PLANES)},
             tab[..., si, 5].contiguous()) for si in used]


def case(seed: int, h: int, w: int, words: int = 4, used=(0, 1, 2, 3),
         n_mat: int = 12):
    """Every argument of ``aniso_slots`` but the spec, on the CPU:
    (atlas, mip_y, mip_x, slots, uv, duv_dx, duv_dy)."""
    rng = np.random.default_rng(seed)
    a, mip_y, mip_x = atlas(rng, words)
    table = material_table(rng, n_mat)
    mat, uv, dx, dy = pixels(rng, h, w, n_mat)
    return a, mip_y, mip_x, slots(table, mat, used), uv, dx, dy


def to(args, device):
    """``case``'s arguments on ``device``."""
    a, mip_y, mip_x, sl, uv, dx, dy = args
    return (a.to(device), mip_y.to(device), mip_x.to(device),
            [({k: v.to(device) for k, v in tex.items()}, nm.to(device))
             for tex, nm in sl],
            uv.to(device), dx.to(device), dy.to(device))


def tss_shade_case(seed: int, h: int, w: int, words: int = 4,
                   n_mat: int = 24, ah: int = 96, aw: int = 128):
    """Inputs of the factored texture-space screen pass
    (``lightchart.tss_shade_halfres``) from a numpy seed: the atlas, a
    material table packed as ``mat_all`` (f16: the factor alpha in column
    3, slot 0's descriptor in columns 16-21, about one slot in five
    without a texture), a merged light table of random rgb9e5 words, and
    planes made of surfaces of 12 x 20 pixels: an affine chart uv (about
    half a chart texel a pixel, jittered, some surfaces past the atlas's
    edges) and uv (footprints of a few texels down to a small fraction of
    one, at any anisotropy), a material id (about one surface in ten -1,
    which indexes the last row as PyTorch's indexing does) and coverage
    with holes. chart uv and uv are views of one [H, W, 4] plane, as the
    raster's attributes are. Returns (scene, chart_uv, uv, mat_id,
    light8, ah, aw, covered)."""
    rng = np.random.default_rng(seed)
    at, mip_y, mip_x = atlas(rng, words)
    table = material_table(rng, n_mat)
    mat_all = np.zeros((n_mat, 40), np.float32)
    mat_all[:, 3] = rng.uniform(0.0, 1.0, n_mat)
    mat_all[:, 16:22] = table[:, 0]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    by, bx = (np.arange(h) // 12)[:, None], (np.arange(w) // 20)[None, :]
    nb = (h // 12 + 1, w // 20 + 1)

    def per(*shape):
        return rng.uniform(0.0, 1.0, nb + shape)[by, bx]

    org = per(2) * np.array([aw + 8.0, ah + 8.0]) - 4.0
    scale = 0.5 * (0.8 + 0.4 * per())
    jitter = np.where(rng.random((h, w, 1)) < 0.05,
                      rng.uniform(-2.0, 2.0, (h, w, 2)), 0.0)
    chart = org + scale[..., None] * np.stack([xx, yy], -1) + jitter
    mag = 2.0 ** (-12.0 + 7.0 * per(2))
    ang = 2 * np.pi * per(2)
    ax = np.stack([np.cos(ang[..., 0]), np.sin(ang[..., 0])], -1)
    ay = np.stack([np.cos(ang[..., 1]), np.sin(ang[..., 1])], -1)
    uv = (per(2) * 4.0 - 1.0 + ax * (mag[..., :1] * xx[..., None])
          + ay * (mag[..., 1:] * yy[..., None]))
    attrs = torch.from_numpy(np.concatenate([chart, uv], -1)
                             .astype(np.float32))
    mat = np.where(per() < 0.1, -1, (per() * n_mat).astype(np.int32))
    covered = (per() < 0.85) & (rng.random((h, w)) < 0.97)
    light8 = rng.integers(-2**31, 2**31, (ah * aw, 8),
                          dtype=np.int64).astype(np.int32)
    scene = {"atlas": at, "mip_y": mip_y, "mip_x": mip_x,
             "mat_all": torch.from_numpy(mat_all.astype(np.float16))}
    return (scene, attrs[..., 0:2], attrs[..., 2:4],
            torch.from_numpy(mat.astype(np.int32)), torch.from_numpy(light8),
            ah, aw, torch.from_numpy(covered))
