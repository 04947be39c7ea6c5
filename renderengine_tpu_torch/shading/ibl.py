"""Image-based lighting system (env-map capture).

Parity with the reference's WIP ``ImageBasedLightSystem`` (``Source/Runtime/
Renderer/ImageBasedLightSystem.{h,cpp}``): load an equirectangular HDRI and
render it into a cubemap once (6 face passes in the reference,
``ImageBasedLightSystem.cpp:142-182``; here one dense gather on the
device). Like the reference, the result is **not yet consumed by the
lighting equation** (``pbr.glsl:442`` todo) — it can be installed as the
skybox, or as the irradiance source (``TextureCache.set_environment``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.asset_path import AssetPath
from ..device import resolve_device
from ..utils.exr import read_exr

INV_ATAN = np.array([0.1591, 0.3183], np.float32)  # env_cube.frag:30


def load_hdri(path) -> np.ndarray:
    """RGBA32F equirectangular map (reference ``LoadHdri``,
    ``TextureCache.cpp:109-165``)."""
    p = AssetPath(str(path)) if not isinstance(path, AssetPath) else path
    img = read_exr(str(p.get_path_on_disk()))
    if img.shape[-1] == 3:
        img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
    return img.astype(np.float32)


def _cube_directions(size: int) -> np.ndarray:
    """[6,S,S,3] direction per cubemap texel (GL face conventions, matching
    shading.sampling.sample_cubemap)."""
    t = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
    tc, sc = np.meshgrid(t, t, indexing="ij")  # tc rows (v), sc cols (u)
    one = np.ones_like(sc)
    faces = [
        np.stack([one, -tc, -sc], -1),    # +x
        np.stack([-one, -tc, sc], -1),    # -x
        np.stack([sc, one, tc], -1),      # +y
        np.stack([sc, -one, -tc], -1),    # -y
        np.stack([sc, -tc, one], -1),     # +z
        np.stack([-sc, -tc, -one], -1),   # -z
    ]
    d = np.stack(faces)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def render_environment_map(equirect, size: int = 1024,
                           device=None) -> torch.Tensor:
    """Equirect [H,W,4] f32 -> cubemap [6,S,S,4] f32 on ``device`` (``cuda``
    unless the caller passes one; a tensor input keeps its own) via
    SampleSphericalMap (``env_cube.frag:30-45``: uv = (atan2(z,x), asin(y))
    * invAtan + 0.5), bilinear-filtered like the reference's sampler."""
    if isinstance(equirect, torch.Tensor):
        env = equirect.to(device or equirect.device, torch.float32)
    else:
        env = torch.as_tensor(np.asarray(equirect, np.float32),
                              device=resolve_device(device))
    h, w = env.shape[:2]
    d = torch.from_numpy(np.ascontiguousarray(
        _cube_directions(size), np.float32)).to(env.device)
    uv_x = torch.atan2(d[..., 2], d[..., 0]) * float(INV_ATAN[0]) + 0.5
    uv_y = torch.asin(d[..., 1].clamp(-1.0, 1.0)) * float(INV_ATAN[1]) + 0.5

    st_x = uv_x * w - 0.5
    st_y = uv_y * h - 0.5
    x0 = torch.floor(st_x).to(torch.int64)
    y0 = torch.floor(st_y).to(torch.int64)
    fx = (st_x - x0)[..., None]
    fy = (st_y - y0)[..., None]
    xw0 = torch.remainder(x0, w)          # wrap horizontally
    xw1 = torch.remainder(x0 + 1, w)
    yc0 = y0.clamp(0, h - 1)              # clamp vertically
    yc1 = (y0 + 1).clamp(0, h - 1)
    flat = env.reshape(-1, env.shape[-1])

    def fetch(yy, xx):
        return flat[yy * w + xx]

    top = fetch(yc0, xw0) * (1 - fx) + fetch(yc0, xw1) * fx
    bot = fetch(yc1, xw0) * (1 - fx) + fetch(yc1, xw1) * fx
    return top * (1 - fy) + bot * fy


def environment_to_skybox_u8(cube_f32) -> np.ndarray:
    """Install-ready uint8 cubemap (tonemap: simple clamp like the
    reference's raw-unorm display path), on the host."""
    if isinstance(cube_f32, torch.Tensor):
        c = (cube_f32 * 255.0).round().clamp(0, 255).to(torch.uint8)
        return c.cpu().numpy()
    c = np.asarray(cube_f32)
    return np.clip(np.round(c * 255.0), 0, 255).astype(np.uint8)
