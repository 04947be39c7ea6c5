"""Environment-map convolution (host-side, one-time at upload).

The diffuse irradiance integral the reference's IBL system stops short of
(``pbr.glsl:442`` todo): irradiance(n) = (1/pi) * sum_w L(w) max(0, n.w)
dA(w) over the environment sphere, discretized over cube texels with
their exact solid angles.
"""

from __future__ import annotations

import numpy as np


def _cube_dirs_weights(size: int) -> tuple[np.ndarray, np.ndarray]:
    """[6,S,S,3] unit direction + [6,S,S] solid angle per cube texel.
    Face conventions match ``shading.sampling.sample_cubemap``."""
    t = (np.arange(size, dtype=np.float64) + 0.5) / size * 2.0 - 1.0
    tc, sc = np.meshgrid(t, t, indexing="ij")
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
    r2 = (d * d).sum(-1)
    # dA on the unit sphere for a texel of area (2/S)^2 on the cube face
    w = (2.0 / size) ** 2 / (r2 * np.sqrt(r2))
    return (d / np.sqrt(r2)[..., None]), w


def cosine_convolve_cube(cube: np.ndarray, out_size: int = 16,
                         src_size: int = 32) -> np.ndarray:
    """[6,S,S,4] f32 radiance -> [6,out,out,4] f32 irradiance. The source
    is box-downsampled to ``src_size`` first (the integral is low-pass, so
    32^2 x 6 samples are plenty); alpha passes through as 1."""
    cube = np.asarray(cube, np.float64)
    s = cube.shape[1]
    if s > src_size and s % src_size == 0:
        f = s // src_size
        cube = cube.reshape(6, src_size, f, src_size, f, 4).mean(axis=(2, 4))
    sdirs, sw = _cube_dirs_weights(cube.shape[1])
    flat_l = cube[..., :3].reshape(-1, 3)              # [M,3]
    flat_d = sdirs.reshape(-1, 3)
    flat_w = sw.reshape(-1)

    odirs, _ = _cube_dirs_weights(out_size)
    n = odirs.reshape(-1, 3)                           # [N,3]
    cos = np.maximum(n @ flat_d.T, 0.0)                # [N,M]
    irr = (cos * flat_w[None, :]) @ flat_l / np.pi     # [N,3]
    out = np.concatenate([irr, np.ones((irr.shape[0], 1))], -1)
    return out.reshape(6, out_size, out_size, 4).astype(np.float32)
