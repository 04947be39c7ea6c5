"""Texture cache + HBM atlas builder.

Reference: ``Source/Runtime/Renderer/TextureCache.{h,cpp}`` (stb/tinyexr
loading, path-hash dedup, full mip chains via blit halving
``Texture.cpp:50-136``, samplers linear/repeat) and the bindless texture
array (``Bindless.cpp:221-241``: StoreTexture -> integer handle).

Design: instead of 1024 descriptor slots we build a **layered
atlas** — for each mip level L an array ``[pages, S>>L, S>>L, 4] uint8`` —
plus an int32 texture table ``(page, x, y, w, h, n_mips)``. A texture
handle is its row index in the table; sampling is a device gather
(``shading/sampling.py``). Textures are snapped to power-of-two sizes and
placed at size-aligned offsets so every mip level's offsets divide exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.hashing import fnv_hash_str


def _next_pot(x: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(1, x)))))


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Host-side bilinear resize, uint8/uint16 [H,W,C] (dtype-preserving)."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int32), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int32), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = np.clip(ys - y0, 0, 1)[:, None, None]
    fx = np.clip(xs - x0, 0, 1)[None, :, None]
    img_f = img.astype(np.float32)
    top = img_f[y0][:, x0] * (1 - fx) + img_f[y0][:, x1] * fx
    bot = img_f[y1][:, x0] * (1 - fx) + img_f[y1][:, x1] * fx
    out = top * (1 - fy) + bot * fy
    lim = 65535 if img.dtype == np.uint16 else 255
    return np.clip(np.round(out), 0, lim).astype(img.dtype)


def to_rgba(img: np.ndarray) -> np.ndarray:
    """Any [H,W] / [H,W,1..4] uint8/uint16 image -> [H,W,4] same dtype
    (alpha = dtype max)."""
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if c == 4:
        return np.ascontiguousarray(img)
    amax = 65535 if img.dtype == np.uint16 else 255
    out = np.empty((h, w, 4), img.dtype)
    if c == 1:
        out[..., :3] = img
    elif c == 2:  # gray + alpha
        out[..., :3] = img[..., :1]
        out[..., 3] = img[..., 1]
        return out
    else:
        out[..., :3] = img[..., :3]
    out[..., 3] = amax
    return out


def to_rgba8(img: np.ndarray) -> np.ndarray:
    """Any layout -> [H,W,4] uint8 (16-bit content scaled down)."""
    rgba = to_rgba(np.asarray(img))
    if rgba.dtype == np.uint16:
        rgba = (rgba >> 8).astype(np.uint8)
    return rgba


def generate_mips(img: np.ndarray) -> list[np.ndarray]:
    """Full mip chain by 2x2 box average — the equivalent of the
    reference's successive vkCmdBlitImage halving loop (``Texture.cpp:50-136``).
    Input must be POT-sized RGBA8."""
    mips = [img]
    lim = 65535 if img.dtype == np.uint16 else 255
    cur = img.astype(np.float32)
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        # POT dims: halve each axis that is still > 1 (non-square chains
        # end as Nx1/1xN strips, like the blit loop's max(1, d/2))
        if cur.shape[0] > 1:
            cur = (cur[0::2] + cur[1::2]) * 0.5
        if cur.shape[1] > 1:
            cur = (cur[:, 0::2] + cur[:, 1::2]) * 0.5
        mips.append(np.clip(np.round(cur), 0, lim).astype(img.dtype))
    return mips


@dataclass
class _PendingTexture:
    image: np.ndarray  # POT RGBA8
    n_mips: int


@dataclass
class TextureCache:
    """Collects textures, then ``build_atlas()`` packs them once — the
    analog of staged uploads flushed by ``UploadTextures``
    (``TextureCache.cpp:293-305``)."""

    page_size: int = 2048
    _textures: list = field(default_factory=list)   # list[_PendingTexture]
    _by_key: dict = field(default_factory=dict)     # dedup: path hash -> handle
    cubemap: np.ndarray | None = None               # [6,S,S,4] uint8
    env_cube: np.ndarray | None = None              # [6,S,S,4] f32 HDR capture (ibl.render_environment_map)

    def add_texture(self, image: np.ndarray, key: str | None = None, mips: bool = True) -> int:
        """Register an image (any uint8 layout); returns the texture handle.
        ``key`` enables path-dedup like the reference's path-hash map
        (``TextureCache.cpp:50-60``)."""
        if key is not None:
            k = fnv_hash_str(key)
            if k in self._by_key:
                return self._by_key[k]
        image = np.asarray(image)
        if image.dtype not in (np.dtype(np.uint8), np.dtype(np.uint16)):
            image = image.astype(np.uint8)
        rgba = to_rgba(image)
        h, w = rgba.shape[:2]
        ph, pw = min(_next_pot(h), self.page_size), min(_next_pot(w), self.page_size)
        rgba = resize_bilinear(rgba, ph, pw)
        n_mips = int(np.log2(min(ph, pw))) + 1 if mips else 1
        self._textures.append(_PendingTexture(rgba, n_mips))
        handle = len(self._textures) - 1
        if key is not None:
            self._by_key[fnv_hash_str(key)] = handle
        return handle

    def set_cubemap(self, faces: np.ndarray) -> None:
        """Directly install a [6,S,S,4] uint8 cubemap."""
        f = np.asarray(faces, np.uint8)
        assert f.ndim == 4 and f.shape[0] == 6 and f.shape[1] == f.shape[2]
        self.cubemap = f

    def __len__(self) -> int:
        return len(self._textures)

    def set_environment(self, cube_f32: np.ndarray) -> None:
        """Install the captured HDR environment cube (``ibl.
        render_environment_map`` output) as the lighting environment —
        the irradiance term (``RenderConfig.ibl_diffuse``) convolves it
        at upload. Without one, the display skybox is used."""
        f = np.asarray(cube_f32, np.float32)
        assert f.ndim == 4 and f.shape[0] == 6 and f.shape[1] == f.shape[2]
        self.env_cube = f

    def build_atlas(self) -> dict:
        """Pack all textures. Returns the device dict:

        - ``atlas``: [P, H, W, 4|8] uint32 — the **block atlas**: entry
          (p, y, x) holds the 2x2 RGBA texel block {(y,x), (y,x+1),
          (y+1,x), (y+1,x+1)} *with per-texture REPEAT wrap baked in*, so
          one bilinear sample is ONE row gather; rows are u32-packed
          (width 4 = u8 content, 8 = u16 content — ~30% cheaper to
          gather than 16 narrow elements). Mip 0 occupies rows
          [0, used0); all levels >= 1 share rows [used0, 1.5*used0) side
          by side at per-level offsets (mip_x).
        - ``tex_table``: int32 [N, 6] = (page, x, y, w, h, n_mips) at mip 0
        - ``mip_y``/``mip_x``: int32 [max_levels] region offset per level
        - ``cubemap``: [6,S,S,4] uint32 (u32-packed 2x2 blocks)
        """
        s = self.page_size
        # Shelf packing, biggest-first, offsets aligned to texture size so
        # mip offsets divide exactly.
        order = sorted(range(len(self._textures)),
                       key=lambda i: -self._textures[i].image.shape[0])
        table = np.zeros((max(1, len(self._textures)), 6), np.int32)
        pages: list[list] = []  # per page: list of shelves [y, height, x_used]

        def place(w: int, h: int) -> tuple[int, int, int]:
            for pi, shelves in enumerate(pages):
                for shelf in shelves:
                    y, sh, x_used = shelf
                    x = ((x_used + w - 1) // w) * w  # align x to width
                    if sh >= h and x + w <= s:
                        shelf[2] = x + w
                        return pi, x, y
                # new shelf in this page
                y_next = shelves[-1][0] + shelves[-1][1] if shelves else 0
                y_next = ((y_next + h - 1) // h) * h  # align y to height
                if y_next + h <= s:
                    shelves.append([y_next, h, w])
                    return pi, 0, y_next
            pages.append([[0, h, w]])
            return len(pages) - 1, 0, 0

        max_mips = 1
        for i in order:
            t = self._textures[i]
            h, w = t.image.shape[:2]
            page, x, y = place(w, h)
            table[i] = (page, x, y, w, h, t.n_mips)
            max_mips = max(max_mips, t.n_mips)

        n_pages = max(1, len(pages))
        n_levels = int(np.log2(s)) + 1
        # tight mip regions: level L rows sized by the USED mip-0 extent
        # (shelf y is height-aligned and heights are pow2, so (y+h)>>L ==
        # (y>>L)+(h>>L) exactly) — gather cost grows with total table
        # bytes, so unused page rows are pure slowdown
        used0, used_x = 1, 1
        for shelves in pages:
            if shelves:
                used0 = max(used0, shelves[-1][0] + shelves[-1][1])
            for shelf in shelves:
                used_x = max(used_x, shelf[2])
        used_x = min(s, -(-used_x // 128) * 128)    # lane-tile friendly
        # tight layout: mip 0 occupies rows [0, used0); ALL levels >= 1
        # share rows [used0, used0 + used0>>1) side by side at per-level x
        # offsets (widths sum to < used_x). Total = 1.5x the mip-0 extent —
        # gather cost grows with table bytes, so slack rows are slowdown.
        mip_y = np.zeros(n_levels, np.int32)
        mip_x = np.zeros(n_levels, np.int32)
        xacc = 0
        for lvl in range(1, n_levels):
            mip_y[lvl] = used0
            mip_x[lvl] = xacc
            xacc += max(1, used_x >> lvl)
        rows = used0 + max(1, used0 >> 1)
        # storage depth: u16 when any source is >8-bit (reference parity:
        # R16G16B16A16Unorm, TextureCache.h:59), u8 otherwise (half the
        # table bytes => cheaper gathers)
        depth16 = any(t.image.dtype == np.uint16 for t in self._textures)
        atlas = np.zeros((n_pages, rows, used_x, 16),
                         np.uint16 if depth16 else np.uint8)
        for i, t in enumerate(self._textures):
            page, x, y, w, h, n_mips = table[i]
            src = t.image
            if depth16 and src.dtype == np.uint8:
                src = src.astype(np.uint16) * 257   # 0xAB -> 0xABAB
            mips = generate_mips(src)
            for lvl in range(n_mips):
                img = mips[lvl]
                mh, mw = img.shape[:2]
                # 2x2 blocks with REPEAT wrap inside this texture
                xr = np.roll(img, -1, axis=1)
                yr = np.roll(img, -1, axis=0)
                xyr = np.roll(xr, -1, axis=0)
                blk = np.concatenate([img, xr, yr, xyr], axis=-1)  # [mh,mw,16]
                ry = mip_y[lvl] + (y >> lvl)
                rx = mip_x[lvl] + (x >> lvl)
                atlas[page, ry : ry + mh, rx : rx + mw] = blk

        irradiance = self._build_irradiance()
        cube = self.cubemap if self.cubemap is not None else np.zeros((6, 1, 1, 4), np.uint8)
        # cube block layout (clamp-to-edge): one 16B gather per bilinear tap
        cx = np.concatenate([cube[:, :, 1:], cube[:, :, -1:]], axis=2)
        cy = np.concatenate([cube[:, 1:], cube[:, -1:]], axis=1)
        cxy = np.concatenate([cx[:, 1:], cx[:, -1:]], axis=1)
        cube_blk = np.concatenate([cube, cx, cy, cxy], axis=-1)  # [6,S,S,16]
        # block tables ship as packed u32 rows (4 for u8 content, 8 for
        # u16): ~30% cheaper to gather than 16 narrow elements (measured
        # 8.7 vs 12.6 ms per 2M-index pass); the sampler bitcasts back
        # in-register. Content depth is recovered from the row width.
        return {
            "atlas": np.ascontiguousarray(atlas).view(np.uint32),
            "tex_table": table,
            "mip_y": mip_y,
            "mip_x": mip_x,
            "cubemap": np.ascontiguousarray(cube_blk).view(np.uint32),
            "irradiance": irradiance,
        }

    def _build_irradiance(self, size: int = 16) -> np.ndarray:
        """Cosine-convolved diffuse irradiance cube [6,S,S,16] f32 (2x2
        clamp-to-edge blocks like the skybox, so shading samples it with
        one row gather): irradiance(n) = sum_w L(w) max(0, n.w) dA / pi,
        the diffuse term the reference left as a todo (pbr.glsl:442).
        Convolves the HDR env capture if installed, else the display
        skybox (whose stored values the reference samples as linear —
        the Unorm quirk, skybox.frag:30). Zeros if neither exists."""
        from .procedural_env import cosine_convolve_cube  # lazy: tiny module

        if self.env_cube is not None:
            src = self.env_cube[..., :4]
        elif self.cubemap is not None:
            src = self.cubemap.astype(np.float32) / 255.0
        else:
            return np.zeros((6, 1, 1, 16), np.float32)
        irr = cosine_convolve_cube(src, size)
        cx = np.concatenate([irr[:, :, 1:], irr[:, :, -1:]], axis=2)
        cy = np.concatenate([irr[:, 1:], irr[:, -1:]], axis=1)
        cxy = np.concatenate([cx[:, 1:], cx[:, -1:]], axis=1)
        return np.concatenate([irr, cx, cy, cxy], axis=-1).astype(np.float32)
