"""The differentiable rendering layer (pool -> shade), plain PyTorch.

Composes adaptive average pooling of the BRDF maps down to the lighting
grid with the hemisphere shading integral of ``core.brdf.render_envmap``,
as the JAX package's ``core/render_layer.py`` does.
"""

from __future__ import annotations

import dataclasses

import torch

from inverserenderingofindoorscene_torch.core import brdf, imageops


def pool_nhwc(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``imageops.adaptive_avg_pool`` of an NHWC tensor, NHWC out."""
    return imageops.to_nhwc(
        imageops.adaptive_avg_pool(imageops.to_nchw(x), out_hw))


@dataclasses.dataclass(frozen=True)
class RenderLayer:
    """Shading of albedo/normal/rough against per-pixel envmaps.

    The lighting grid is env_rows x env_cols (120x160), the per-pixel
    envmap env_height x env_width (8x16), fov in degrees, Fresnel F0.
    """

    env_rows: int = 120
    env_cols: int = 160
    env_height: int = 8
    env_width: int = 16
    fov_deg: float = 57.0
    f0: float = 0.05

    def forward_env(
        self,
        albedo: torch.Tensor,
        normal: torch.Tensor,
        rough: torch.Tensor,
        envmap: torch.Tensor,
    ):
        """NHWC args: albedo [B,h,w,3], normal [B,h,w,3], rough [B,h,w,1],
        envmap [B,R,C,D,3].  The BRDF maps are average-pooled to (R, C)
        before shading.  Returns (diffuse, specular), each [B,R,C,3]."""
        rc = envmap.shape[1:3]
        return brdf.render_envmap(
            pool_nhwc(albedo, rc),
            pool_nhwc(normal, rc),
            pool_nhwc(rough, rc),
            envmap,
            fov_deg=self.fov_deg,
            f0=self.f0,
            env_height=self.env_height,
            env_width=self.env_width,
        )
