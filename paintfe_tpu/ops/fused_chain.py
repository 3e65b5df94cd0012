"""The headline filter chain: BASELINE.json's benchmark workload.

4K gaussian blur + brightness/contrast + levels + sepia + soft-light
flatten, written as the composition of the public ops and left to XLA to
fuse (PERF.md has the fusion count and time measured on the card).
"""

from __future__ import annotations

from paintfe_tpu.core.blend import BlendMode, blend_u8
from paintfe_tpu.ops import filters
from paintfe_tpu.parallel.pipeline import _bc_device, _levels_device, _sepia_device


def fused_chain(img, overlay, *, sigma=2.0, brightness=10.0, contrast=20.0,
                black=10.0, white=245.0, gamma=1.1, sepia_strength=0.5,
                blend_mode=BlendMode.SOFT_LIGHT, blend_opacity=0.6):
    """u8 [H, W, 4] x2 -> u8 [H, W, 4]: gaussian_blur, _bc_device,
    _levels_device, _sepia_device, then blend_u8 of the overlay on top."""
    x = filters.gaussian_blur(img, float(sigma))
    x = _bc_device(x, brightness, contrast)
    x = _levels_device(x, black, white, gamma)
    x = _sepia_device(x, sepia_strength)
    return blend_u8(x, overlay, int(blend_mode), blend_opacity)
