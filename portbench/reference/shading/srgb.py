"""sRGB <-> linear conversions, exactly the reference's 'accurate' pair
(``pbr.glsl:20-34``, from the Frostbite course notes)."""

from __future__ import annotations

import torch


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    lo = c / 12.92
    hi = torch.pow((c + 0.055) / 1.055, 2.4)
    return torch.where(c <= 0.04045, lo, hi)


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    lo = c * 12.92
    hi = torch.pow(c.abs(), 1.0 / 2.4) * 1.055 - 0.055
    return torch.where(c <= 0.0031308, lo, hi)


def srgb_to_linear_rgba(c: torch.Tensor) -> torch.Tensor:
    """vec4 variant: alpha passes through (``pbr.glsl:56-65``)."""
    return torch.cat([srgb_to_linear(c[..., :3]), c[..., 3:4]], dim=-1)


def encode_srgb8(linear_rgb: torch.Tensor,
                 alpha: torch.Tensor | None = None) -> torch.Tensor:
    """Linear float -> sRGB uint8, the swapchain's R8G8B8A8-sRGB encode
    (``Swapchain.cpp:10-29``). Returns [...,4] uint8."""
    srgb = linear_to_srgb(linear_rgb.clamp(0.0, 1.0)).clamp(0.0, 1.0)
    a = (torch.ones_like(srgb[..., :1]) if alpha is None
         else alpha[..., None].clamp(0, 1))
    rgba = torch.cat([srgb, a], dim=-1)
    return torch.round(rgba * 255.0).to(torch.uint8)
