"""Debug overlay quad (shadow-map preview etc).

Port of ``Source/Runtime/Renderer/TexturedQuad.{h,cpp}`` +
``textured_quad.{vert,frag}``: a vertex-less NDC quad at (center, size)
displaying a texture, with a grayscale mode for depth maps (the
``kIsGrayscale`` specialization constant, ``TexturedQuad.cpp:27-38``).
Deferred form: resample the source into the quad's pixel rect and
composite over the frame's linear rgb (a nearest-texel gather on the
frame's device).
"""

from __future__ import annotations

import torch


def draw_textured_quad(rgb: torch.Tensor, source: torch.Tensor,
                       center=(-0.6, -0.6), size=(0.35, 0.35),
                       grayscale: bool | None = None) -> torch.Tensor:
    """rgb [H,W,3] f32; source [h,w] (grayscale depth) or [h,w,3/4].
    center/size in NDC as in the reference DrawParams. Returns a new
    tensor; ``rgb`` is left as it was."""
    h, w = rgb.shape[:2]
    if grayscale is None:
        grayscale = source.dim() == 2
    # quad pixel rect from NDC center/size
    x0 = int(round((center[0] - size[0] + 1) * 0.5 * w))
    x1 = int(round((center[0] + size[0] + 1) * 0.5 * w))
    y0 = int(round((center[1] - size[1] + 1) * 0.5 * h))
    y1 = int(round((center[1] + size[1] + 1) * 0.5 * h))
    x0, x1 = max(0, x0), min(w, x1)
    y0, y1 = max(0, y0), min(h, y1)
    if x1 <= x0 or y1 <= y0:
        return rgb
    qh, qw = y1 - y0, x1 - x0

    sh, sw = source.shape[:2]
    dev = source.device
    # the texel index in f32, as the JAX package computes it
    sy = ((torch.arange(qh, device=dev) + 0.5).to(torch.float32) * sh
          / qh).to(torch.int32).clamp(0, sh - 1).long()
    sx = ((torch.arange(qw, device=dev) + 0.5).to(torch.float32) * sw
          / qw).to(torch.int32).clamp(0, sw - 1).long()
    patch = source[sy[:, None], sx[None, :]]
    if grayscale:
        if patch.dim() == 3:
            patch = patch[..., 0]
        patch = torch.stack([patch] * 3, dim=-1)
    else:
        patch = patch[..., :3]
    is_u8 = source.dtype == torch.uint8
    patch = patch.to(torch.float32)
    if is_u8:
        patch = patch / 255.0
    out = rgb.clone()
    out[y0:y1, x0:x1, :] = patch
    return out
