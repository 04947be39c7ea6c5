"""Host-side 3D math matching the reference's glm + Vulkan conventions.

The reference uses glm with ``GLM_FORCE_RADIANS`` and
``GLM_FORCE_DEPTH_ZERO_TO_ONE`` (reference ``Source/Runtime/glm_includes.h:3-4``)
and additionally pre-multiplies every projection by the GL->VK clip matrix
``glm_vk::kClip`` (y flip + z -> 0.5 z + 0.5 w, ``glm_includes.h:15-24``,
used in ``Camera.h:110-117`` and ``ShadowSystem.cpp:195-204``).

Because glm is column-major and composes as ``M @ v`` on column vectors, we
keep the same mathematical convention but store matrices **row-major numpy**:
``clip = (P @ V @ M) @ [x, y, z, 1]^T``.

All functions return float32 numpy arrays. Device-side math lives in the
raster/shading kernels; these matrices are tiny per-frame uniforms uploaded
in one packed vector (the reference's ``ViewProperties`` UBO,
``CameraViewSystem.cpp:61-72``).
"""

from __future__ import annotations

import numpy as np

# GL -> Vulkan clip matrix. glm stores columns; row-major equivalent of
# glm_vk::kClip (glm_includes.h:17-23):
#   y' = -y, z' = 0.5 z + 0.5 w.
KCLIP = np.array(
    [
        [1.0, 0.0, 0.0, 0.0],
        [0.0, -1.0, 0.0, 0.0],
        [0.0, 0.0, 0.5, 0.5],
        [0.0, 0.0, 0.0, 1.0],
    ],
    dtype=np.float32,
)


def normalize(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=np.float32)
    n = np.linalg.norm(v)
    if n == 0.0:
        return v
    return v / n


def look_at(eye, center, up) -> np.ndarray:
    """Right-handed glm::lookAt (camera forward is -z, ``Camera.h:37``)."""
    eye = np.asarray(eye, dtype=np.float32)
    center = np.asarray(center, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)
    f = normalize(center - eye)
    s = normalize(np.cross(f, up))
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective_zo(fovy_radians: float, aspect: float, near: float, far: float) -> np.ndarray:
    """glm::perspectiveRH_ZO (depth zero-to-one, per GLM_FORCE_DEPTH_ZERO_TO_ONE)."""
    tan_half = float(np.tan(fovy_radians / 2.0))
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 1.0 / (aspect * tan_half)
    m[1, 1] = 1.0 / tan_half
    m[2, 2] = far / (near - far)
    m[2, 3] = -(far * near) / (far - near)
    m[3, 2] = -1.0
    return m


def perspective_vk(fovy_radians: float, aspect: float, near: float, far: float) -> np.ndarray:
    """The reference's actual camera projection: ``kClip @ perspectiveRH_ZO``
    (``Camera.h:110-117``). Note this composition lands depth in [0.5, 1] —
    a reference quirk we reproduce exactly for pixel-matching."""
    return (KCLIP @ perspective_zo(fovy_radians, aspect, near, far)).astype(np.float32)


def ortho_zo(left, right, bottom, top, z_near, z_far) -> np.ndarray:
    """glm::orthoRH_ZO — used for the directional shadow projection
    (``ShadowSystem.cpp:195-200``)."""
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[2, 2] = -1.0 / (z_far - z_near)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -z_near / (z_far - z_near)
    return m


def ortho_vk(left, right, bottom, top, z_near, z_far) -> np.ndarray:
    """``kClip @ orthoRH_ZO`` — shadow projection (``ShadowSystem.cpp:195-204``)."""
    return (KCLIP @ ortho_zo(left, right, bottom, top, z_near, z_far)).astype(np.float32)


def translate(v) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(v, dtype=np.float32)
    return m


def scale(v) -> np.ndarray:
    v = np.broadcast_to(np.asarray(v, dtype=np.float32), (3,))
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def rotate(angle_radians: float, axis) -> np.ndarray:
    """Axis-angle rotation (Rodrigues), matching glm::rotate."""
    a = normalize(axis)
    c = float(np.cos(angle_radians))
    s = float(np.sin(angle_radians))
    x, y, z = (float(q) for q in a)
    r = np.array(
        [
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
        ],
        dtype=np.float32,
    )
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = r
    return m


def transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply a 4x4 to [N,3] points with perspective divide."""
    pts = np.asarray(pts, dtype=np.float32)
    h = pts @ m[:3, :3].T + m[:3, 3]
    w = pts @ m[3, :3].T + m[3, 3]
    return (h / w[..., None]).astype(np.float32)


def transform_dirs(m: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Apply the linear part of a 4x4 to [N,3] directions (w = 0)."""
    dirs = np.asarray(dirs, dtype=np.float32)
    return (dirs @ m[:3, :3].T).astype(np.float32)


def normal_matrix(m: np.ndarray) -> np.ndarray:
    """transpose(inverse(mat3(m))) — normal transform (``primitive.vert:55``)."""
    return np.linalg.inv(np.asarray(m, dtype=np.float32)[:3, :3]).T.astype(np.float32)


def directional_light_view(light_direction: np.ndarray) -> np.ndarray:
    """View matrix for a directional light looking along ``light_direction``
    from the origin.

    The reference's ``ComputeDirectionalLightViewMatrix``
    (``ShadowSystem.cpp:130-147``) reads an uninitialized ``up`` (UB, noted
    in SURVEY.md as a quirk NOT to replicate); we build a correct
    orthonormal basis with the same *intended* behavior: pick a reference
    axis not parallel to the light, derive up, and look from the origin.
    """
    d = normalize(light_direction)
    ref = np.array([0.0, 0.0, 1.0], dtype=np.float32)
    if abs(float(np.dot(d, ref))) > 0.9999:
        ref = np.array([1.0, 0.0, 0.0], dtype=np.float32)
    right = normalize(np.cross(d, ref))
    up = np.cross(right, d)
    return look_at(np.zeros(3, dtype=np.float32), d, up)


def frustum_corners_world(view: np.ndarray, proj: np.ndarray) -> np.ndarray:
    """The 8 NDC cube corners unprojected to world space
    (``Camera.cpp:3-25``). NDC z in [0, 1] (Vulkan)."""
    inv = np.linalg.inv((proj @ view).astype(np.float64))
    corners = []
    for x in (-1.0, 1.0):
        for y in (-1.0, 1.0):
            for z in (0.0, 1.0):
                p = inv @ np.array([x, y, z, 1.0])
                corners.append(p[:3] / p[3])
    return np.asarray(corners, dtype=np.float32)
