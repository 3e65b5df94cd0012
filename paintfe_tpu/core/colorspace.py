"""Vectorized color-space conversions (jnp, f32).

Behavioral contract: src/ops/adjustments.rs:944-1022 (rgb_to_hsl /
hsl_to_rgb / hue_to_rgb) — including the 1e-6 epsilon branch conditions and
the max-channel tie-break order (R, then G, then B), which affect golden
parity for HSL-family adjustments.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from paintfe_tpu.utils.quant import exact_div

_EPS = 1e-6


def rgb_to_hsl(r, g, b, xp=jnp):
    """RGB in [0,1] -> (h, s, l) each in [0,1].

    `xp` selects the array module: the jnp path guards its constant
    divides against XLA's reciprocal rewrite (exact_div); numpy never
    rewrites them, so the host path (used by
    selection.select_color_range) is a plain `/` with the SAME epsilon
    branches and R->G->B tie-break order — one implementation for the
    parity minefield instead of two drifting copies."""
    if xp is jnp:
        div_c = exact_div
    else:
        div_c = lambda x, c: x / np.float32(c)  # noqa: E731
    mx = xp.maximum(xp.maximum(r, g), b)
    mn = xp.minimum(xp.minimum(r, g), b)
    l = (mx + mn) / 2.0
    d = mx - mn
    gray = xp.abs(d) < _EPS
    safe_d = xp.where(gray, 1.0, d)

    s_hi = d / xp.where(gray, 1.0, 2.0 - mx - mn)
    s_lo = d / xp.where(gray, 1.0, mx + mn)
    s = xp.where(gray, 0.0, xp.where(l > 0.5, s_hi, s_lo))

    # Hue: branch order matches the reference (R first, then G, else B).
    hr_raw = (g - b) / safe_d
    hr = div_c(xp.where(hr_raw < 0.0, hr_raw + 6.0, hr_raw), 6.0)
    hg = div_c((b - r) / safe_d + 2.0, 6.0)
    hb = div_c((r - g) / safe_d + 4.0, 6.0)
    h = xp.where(
        xp.abs(mx - r) < _EPS, hr, xp.where(xp.abs(mx - g) < _EPS, hg, hb)
    )
    h = xp.where(gray, 0.0, h)
    return h, s, l


def _hue_to_rgb(p, q, t, xp=jnp):
    t = xp.where(t < 0.0, t + 1.0, t)
    t = xp.where(t > 1.0, t - 1.0, t)
    return xp.where(
        t < 1.0 / 6.0,
        p + (q - p) * 6.0 * t,
        xp.where(
            t < 1.0 / 2.0,
            q,
            xp.where(t < 2.0 / 3.0, p + (q - p) * (2.0 / 3.0 - t) * 6.0, p),
        ),
    )


def hsl_to_rgb(h, s, l, xp=jnp):
    """HSL in [0,1] -> (r, g, b) in [0,1].  `xp` as in rgb_to_hsl."""
    q = xp.where(l < 0.5, l * (1.0 + s), l + s - l * s)
    p = 2.0 * l - q
    r = _hue_to_rgb(p, q, h + 1.0 / 3.0, xp)
    g = _hue_to_rgb(p, q, h, xp)
    b = _hue_to_rgb(p, q, h - 1.0 / 3.0, xp)
    gray = xp.abs(s) < _EPS
    return (
        xp.where(gray, l, r),
        xp.where(gray, l, g),
        xp.where(gray, l, b),
    )


def luma_bt709(r, g, b):
    """BT.709 luminance on 0..255-scaled channels (order-preserving sum)."""
    return 0.2126 * r + 0.7152 * g + 0.0722 * b


def luma_bt601_int(r_u8, g_u8, b_u8):
    """Integer BT.601 luma (299r+587g+114b)/1000 — the script-API desaturate."""
    acc = (
        r_u8.astype(jnp.uint32) * 299
        + g_u8.astype(jnp.uint32) * 587
        + b_u8.astype(jnp.uint32) * 114
    )
    return (acc // 1000).astype(jnp.uint8)
