"""Pointwise color adjustments (the adjustment stack).

Behavioral contract: src/ops/adjustments.rs.  Every op is a pure jittable
function `(img_u8 [H,W,4], mask?, params...) -> img_u8` with the reference's
semantics: f32 math on 0..255-scaled channels, round-half-up clamp to u8,
masked-out pixels (mask==0) copied through unchanged.

Device shape: ops are elementwise work that XLA fuses; tone ops are 256-LUT
gathers (see paintfe_tpu.ops.luts for host-side LUT construction and chain
fusion by composition).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from paintfe_tpu.core.colorspace import hsl_to_rgb, luma_bt709, rgb_to_hsl
from paintfe_tpu.ops import luts
from paintfe_tpu.utils.quant import exact_div, round_u8


def _f32(x):
    return jnp.asarray(x, jnp.float32)


# Selection semantics: mask==0 pixels copy through (adjustments.rs:84-90)
from paintfe_tpu.ops.common import masked as _masked  # shared (one def)


def _pointwise(img, mask, fn):
    f = img.astype(jnp.float32)
    nr, ng, nb, na = fn(f[..., 0], f[..., 1], f[..., 2], f[..., 3])
    out = round_u8(jnp.stack([nr, ng, nb, na], axis=-1))
    return _masked(img, out, mask)


# ---------------------------------------------------------------------------
# Instant ops
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=())
def invert_colors(img, mask=None):
    return _pointwise(img, mask, lambda r, g, b, a: (255.0 - r, 255.0 - g, 255.0 - b, a))


@jax.jit
def invert_alpha(img, mask=None):
    return _pointwise(img, mask, lambda r, g, b, a: (r, g, b, 255.0 - a))


@jax.jit
def sepia(img, mask=None):
    def fn(r, g, b, a):
        sr = 0.393 * r + 0.769 * g + 0.189 * b
        sg = 0.349 * r + 0.686 * g + 0.168 * b
        sb = 0.272 * r + 0.534 * g + 0.131 * b
        return (
            jnp.minimum(sr, 255.0),
            jnp.minimum(sg, 255.0),
            jnp.minimum(sb, 255.0),
            a,
        )

    return _pointwise(img, mask, fn)


@jax.jit
def desaturate(img, mask=None):
    """Menu desaturate: BT.709 weights (filters.rs:319-378)."""

    def fn(r, g, b, a):
        lum = jnp.clip(jnp.floor(luma_bt709(r, g, b) + 0.5), 0.0, 255.0)
        return lum, lum, lum, a

    return _pointwise(img, mask, fn)


@jax.jit
def desaturate_bt601(img, mask=None):
    """Script-API desaturate: integer BT.601 (scripting.rs:883-897)."""
    acc = (
        img[..., 0].astype(jnp.uint32) * 299
        + img[..., 1].astype(jnp.uint32) * 587
        + img[..., 2].astype(jnp.uint32) * 114
    )
    lum = (acc // 1000).astype(jnp.uint8)
    out = jnp.stack([lum, lum, lum, img[..., 3]], axis=-1)
    return _masked(img, out, mask)


@jax.jit
def auto_levels(img, mask=None):
    """Stretch each channel's [min, max] (over selected, non-transparent
    pixels) to [0, 255] (adjustments.rs:144-256)."""
    opaque = img[..., 3] > 0
    if mask is not None:
        opaque = jnp.logical_and(opaque, mask > 0)

    def stretch(c):
        # per-channel affine stretch evaluated directly (the LUT formula on
        # the pixel itself; the table would depend on the image)
        lo = jnp.min(jnp.where(opaque, c, 255)).astype(jnp.int32)
        hi = jnp.max(jnp.where(opaque, c, 0)).astype(jnp.int32)
        i = c.astype(jnp.float32)
        rng = (hi - lo).astype(jnp.float32)
        stretched = (i - lo.astype(jnp.float32)) / rng * 255.0
        v = jnp.where(i <= lo.astype(jnp.float32), 0.0,
                      jnp.where(i >= hi.astype(jnp.float32), 255.0, stretched))
        out = round_u8(v)
        return jnp.where(hi <= lo, c, out)

    out = jnp.stack(
        [
            stretch(img[..., 0]),
            stretch(img[..., 1]),
            stretch(img[..., 2]),
            img[..., 3],
        ],
        axis=-1,
    )
    return _masked(img, out, mask)


# ---------------------------------------------------------------------------
# Parameterized ops
# ---------------------------------------------------------------------------


@jax.jit
def brightness_contrast(img, brightness, contrast, mask=None):
    """factor = 259(c+255) / (255(259-c)); out = factor*(v+b-128)+128."""
    brightness = _f32(brightness)
    contrast = _f32(contrast)
    factor = (259.0 * (contrast + 255.0)) / (255.0 * (259.0 - contrast))

    def fn(r, g, b, a):
        adj = lambda v: factor * (v + brightness - 128.0) + 128.0
        return adj(r), adj(g), adj(b), a

    return _pointwise(img, mask, fn)


@jax.jit
def hue_saturation_lightness(img, hue_shift, saturation, lightness, mask=None):
    sat_factor = 1.0 + exact_div(_f32(saturation), 100.0)
    light_offset = exact_div(_f32(lightness) * 255.0, 100.0)
    shift = exact_div(_f32(hue_shift), 360.0)

    def fn(r, g, b, a):
        h, s, l = rgb_to_hsl(exact_div(r, 255.0), exact_div(g, 255.0), exact_div(b, 255.0))
        nh = h + shift
        nh = nh - jnp.trunc(nh)  # Rust fract()
        nh = jnp.where(nh < 0.0, nh + 1.0, nh)
        ns = jnp.clip(s * sat_factor, 0.0, 1.0)
        nr, ng, nb = hsl_to_rgb(nh, ns, l)
        return (
            nr * 255.0 + light_offset,
            ng * 255.0 + light_offset,
            nb * 255.0 + light_offset,
            a,
        )

    return _pointwise(img, mask, fn)


@jax.jit
def exposure(img, ev, mask=None):
    gain = jnp.exp2(_f32(ev))

    def fn(r, g, b, a):
        return r * gain, g * gain, b * gain, a

    return _pointwise(img, mask, fn)


@jax.jit
def highlights_shadows(img, shadows, highlights, mask=None):
    shadow_amt = exact_div(_f32(shadows), 100.0)
    highlight_amt = exact_div(_f32(highlights), 100.0)

    def fn(r, g, b, a):
        lum = exact_div(luma_bt709(r, g, b), 255.0)
        sw = (1.0 - lum) * (1.0 - lum)
        hw = lum * lum
        adj = sw * shadow_amt * 128.0 + hw * highlight_amt * 128.0
        return r + adj, g + adj, b + adj, a

    return _pointwise(img, mask, fn)


@jax.jit
def temperature_tint(img, temperature, tint, mask=None):
    temp_shift = _f32(temperature) * 1.5
    tint_shift = _f32(tint) * 1.0

    def fn(r, g, b, a):
        return r + temp_shift, g - tint_shift * 0.5, b - temp_shift, a

    return _pointwise(img, mask, fn)


@jax.jit
def threshold(img, level, mask=None):
    level = _f32(level)

    def fn(r, g, b, a):
        v = jnp.where(luma_bt709(r, g, b) >= level, 255.0, 0.0)
        return v, v, v, a

    return _pointwise(img, mask, fn)


@jax.jit
def posterize(img, levels_count, mask=None):
    factor = jnp.maximum(_f32(levels_count), 2.0)

    def p(v):
        return jnp.floor(exact_div(v, 255.0) * (factor - 1.0) + 0.5) / (factor - 1.0) * 255.0

    return _pointwise(img, mask, lambda r, g, b, a: (p(r), p(g), p(b), a))


@jax.jit
def color_balance(img, shadows, midtones, highlights, mask=None):
    """Per-tonal-band RGB shifts; band weights from luma (adjustments.rs:1319-1337)."""
    shadows = jnp.asarray(shadows, jnp.float32)
    midtones = jnp.asarray(midtones, jnp.float32)
    highlights = jnp.asarray(highlights, jnp.float32)

    def fn(r, g, b, a):
        lum = exact_div(luma_bt709(r, g, b), 255.0)
        sw = jnp.square(jnp.maximum(1.0 - lum * 2.0, 0.0))
        hw = jnp.square(jnp.maximum(lum * 2.0 - 1.0, 0.0))
        mw = jnp.maximum(1.0 - sw - hw, 0.0)

        def adj(i):
            return sw * shadows[i] + mw * midtones[i] + hw * highlights[i]

        return (
            r + adj(0) * 1.28,
            g + adj(1) * 1.28,
            b + adj(2) * 1.28,
            a,
        )

    return _pointwise(img, mask, fn)


@jax.jit
def gradient_map(img, lut_rgba, mask=None):
    """Truncated BT.709 luma indexes a 256xRGBA LUT; alpha preserved."""
    f = img.astype(jnp.float32)
    lum = luma_bt709(f[..., 0], f[..., 1], f[..., 2])
    idx = jnp.minimum(lum.astype(jnp.int32), 255)  # `as usize` truncates
    mapped = jnp.asarray(lut_rgba, jnp.uint8)[idx]
    out = jnp.concatenate([mapped[..., 0:3], img[..., 3:4]], axis=-1)
    return _masked(img, out, mask)


def gradient_map_stops(img, stops, mask=None):
    """Gradient map from color stops: luts.gradient_map_lut at the
    truncated-luma integer index."""
    from paintfe_tpu.ops.luts import gradient_map_lut

    return gradient_map(img, gradient_map_lut(stops), mask)


@jax.jit
def black_and_white(img, r_weight, g_weight, b_weight, mask=None):
    rw = _f32(r_weight)
    gw = _f32(g_weight)
    bw = _f32(b_weight)

    def fn(r, g, b, a):
        v = jnp.clip(exact_div(r * rw + g * gw + b * bw, 100.0), 0.0, 255.0)
        return v, v, v, a

    return _pointwise(img, mask, fn)


@jax.jit
def vibrance(img, amount, mask=None):
    v = exact_div(_f32(amount), 100.0)

    def fn(r, g, b, a):
        h, s, l = rgb_to_hsl(exact_div(r, 255.0), exact_div(g, 255.0), exact_div(b, 255.0))
        boost = jnp.where(v >= 0.0, v * jnp.square(1.0 - s), v * jnp.square(s))
        ns = jnp.clip(s + boost, 0.0, 1.0)
        nr, ng, nb = hsl_to_rgb(h, ns, l)
        return nr * 255.0, ng * 255.0, nb * 255.0, a

    return _pointwise(img, mask, fn)


# ---------------------------------------------------------------------------
# LUT application (levels / curves chains built in paintfe_tpu.ops.luts)
# ---------------------------------------------------------------------------


@jax.jit
def apply_rgb_lut(img, lut, mask=None):
    """One u8 LUT on R, G and B; alpha untouched."""
    lut = jnp.asarray(lut, jnp.uint8)
    out = jnp.concatenate([lut[img[..., 0:3]], img[..., 3:4]], axis=-1)
    return _masked(img, out, mask)


@jax.jit
def apply_rgba_luts(img, luts4, mask=None):
    """Independent per-channel LUTs [4, 256] (curves multi-channel)."""
    luts4 = jnp.asarray(luts4, jnp.uint8)
    out = jnp.stack(
        [luts4[c][img[..., c]] for c in range(4)],
        axis=-1,
    )
    return _masked(img, out, mask)


def levels(img, in_black, in_white, gamma, out_black, out_white, mask=None):
    """5-parameter levels (adjustments.rs:424-489) as a host-built LUT."""
    lut = luts.levels_lut(in_black, in_white, gamma, out_black, out_white)
    return apply_rgb_lut(img, lut, mask)


def levels_per_channel(img, master, r_ch, g_ch, b_ch, mask=None):
    """Master + per-channel composed levels (luts.compose_luts order)."""
    lut3 = luts.levels_multi_channel_luts(master, r_ch, g_ch, b_ch)
    luts4 = np.concatenate([lut3, luts.identity_lut()[None]], axis=0)
    return apply_rgba_luts(img, luts4, mask)


def curves(img, channel_points, mask=None):
    """Multi-channel curves [RGB, R, G, B, A] of (points, enabled), as
    host-built per-channel LUTs."""
    return apply_rgba_luts(img, luts.multi_channel_luts(channel_points), mask)


# ---------------------------------------------------------------------------
# Histogram
# ---------------------------------------------------------------------------


@jax.jit
def histogram(img, mask=None):
    """Per-channel 256-bin histograms + BT.709 luma histogram -> [4, 256] i32."""
    if mask is None:
        sel = jnp.ones(img.shape[:2], jnp.int32)
    else:
        sel = (mask > 0).astype(jnp.int32)

    def hist_of(v):
        return jnp.zeros(256, jnp.int32).at[v.reshape(-1)].add(sel.reshape(-1))

    f = img.astype(jnp.float32)
    lum = jnp.minimum(luma_bt709(f[..., 0], f[..., 1], f[..., 2]).astype(jnp.int32), 255)
    return jnp.stack(
        [
            hist_of(img[..., 0].astype(jnp.int32)),
            hist_of(img[..., 1].astype(jnp.int32)),
            hist_of(img[..., 2].astype(jnp.int32)),
            hist_of(lum),
        ]
    )


# ---------------------------------------------------------------------------
# Per-hue-band HSL (adjustments.rs:1599-1674)
# ---------------------------------------------------------------------------

BAND_CENTERS = (0.0, 60.0, 120.0, 180.0, 240.0, 300.0)  # R, Y, G, C, B, M


def _band_weight(hue_deg, center):
    """Full weight within +-30 deg, linear falloff to 0 at +-45 deg."""
    dist = jnp.abs(hue_deg - center) % 360.0
    dist = jnp.where(dist > 180.0, 360.0 - dist, dist)
    return jnp.where(
        dist <= 30.0, 1.0,
        jnp.where(dist < 45.0, 1.0 - exact_div(dist - 30.0, 15.0), 0.0),
    )


@jax.jit
def hue_saturation_per_band(img, global_hue, global_sat, global_light,
                            band_hues, band_sats, band_lights, mask=None):
    """Global HSL plus six weighted hue-band adjustments.

    band_* are [6] arrays (hue -180..180, sat -100..100, light -100..100);
    band contributions accumulate on top of the global values weighted by
    hue-wheel proximity.
    """
    g_sat = 1.0 + exact_div(_f32(global_sat), 100.0)
    g_light = exact_div(_f32(global_light) * 255.0, 100.0)
    band_hues = jnp.asarray(band_hues, jnp.float32)
    band_sats = jnp.asarray(band_sats, jnp.float32)
    band_lights = jnp.asarray(band_lights, jnp.float32)

    def fn(r, g, b, a):
        h, s, l = rgb_to_hsl(exact_div(r, 255.0), exact_div(g, 255.0), exact_div(b, 255.0))
        h_deg = h * 360.0
        extra_hue = _f32(global_hue)
        extra_sat = g_sat
        extra_light = g_light
        for i, center in enumerate(BAND_CENTERS):
            w = _band_weight(h_deg, center)
            extra_hue = extra_hue + band_hues[i] * w
            extra_sat = extra_sat + exact_div(band_sats[i], 100.0) * w
            extra_light = extra_light + exact_div(band_lights[i] * 255.0, 100.0) * w
        nh = ((h + exact_div(extra_hue, 360.0)) % 1.0 + 1.0) % 1.0
        ns = jnp.clip(s * extra_sat, 0.0, 1.0)
        nr, ng, nb = hsl_to_rgb(nh, ns, l)
        return (nr * 255.0 + extra_light, ng * 255.0 + extra_light,
                nb * 255.0 + extra_light, a)

    return _pointwise(img, mask, fn)
