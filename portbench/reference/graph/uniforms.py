"""Per-frame uniform packing.

All per-frame host state travels in ONE float32 vector — the analog of the
reference's dynamic-offset DrawParameters UBO (``Bindless.cpp:34-95``):
one small host->device copy per frame.

Layout (floats): view 16 | proj 16 | pos 3 | exposure 1 | debug_input 1 |
debug_equation 1 | inv_vp_rot 16 | inv_vp 16 | shadow_viewproj NS*16.
"""

from __future__ import annotations

import numpy as np
import torch

HEADER = 16 + 16 + 3 + 1 + 1 + 1 + 16 + 16  # 70


def pack_params(params: dict, n_shadows: int) -> np.ndarray:
    u = np.zeros(HEADER + 16 * max(n_shadows, 0), np.float32)
    u[0:16] = np.asarray(params["view"], np.float32).ravel()
    u[16:32] = np.asarray(params["proj"], np.float32).ravel()
    u[32:35] = np.asarray(params["view_pos"], np.float32)
    u[35] = np.float32(params["exposure"])
    u[36] = np.float32(int(params["debug_input"]))
    u[37] = np.float32(int(params["debug_equation"]))
    u[38:54] = np.asarray(params["inv_vp_rot"], np.float32).ravel()
    u[54:70] = np.asarray(params.get("inv_vp", np.eye(4)), np.float32).ravel()
    if n_shadows > 0:
        u[70:] = np.asarray(params["shadow_viewproj"],
                            np.float32).ravel()[: 16 * n_shadows]
    return u


def upload(dst: torch.Tensor, u: np.ndarray) -> None:
    """Copy the host uniform ``u`` into the device tensor ``dst`` (which
    the captured programs read in place) without a host wait: from a
    pinned buffer of the caching host allocator, which reuses a buffer
    only once its copy has run."""
    host = torch.empty(u.shape, dtype=torch.float32,
                       pin_memory=dst.device.type == "cuda")
    host.numpy()[...] = u
    dst.copy_(host, non_blocking=True)


def unpack_params(u: torch.Tensor, n_shadows: int) -> dict:
    params = {
        "view": u[0:16].reshape(4, 4),
        "proj": u[16:32].reshape(4, 4),
        "view_pos": u[32:35],
        "exposure": u[35],
        "debug_input": u[36].to(torch.int32),
        "debug_equation": u[37].to(torch.int32),
        "inv_vp_rot": u[38:54].reshape(4, 4),
        "inv_vp": u[54:70].reshape(4, 4),
    }
    if n_shadows > 0:
        params["shadow_viewproj"] = u[70:70 + 16 * n_shadows].reshape(
            n_shadows, 4, 4)
    return params
