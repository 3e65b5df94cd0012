"""The 25 blend modes, as vectorized JAX ops.

Behavioral contract: src/canvas/canvas_state.rs:1246-1505 in the reference
(`blend_pixel_static` + channel helpers).  Straight (non-premultiplied)
alpha; Porter-Duff source-over with un-premultiply; the final u8 cast is a
*truncating* saturating cast.  Two structural special cases: `Overwrite`
(replaces, scaling alpha by opacity) and `Xor` (symmetric difference
coverage).  Two fast paths that matter for bit-exactness:

  * a fully transparent top pixel returns the base pixel *unchanged*
    (no f32 round-trip),
  * Normal mode at full opacity with an opaque top pixel returns the top
    pixel unchanged.

Everything here is pure jnp on [..., 4] u8 arrays, designed so XLA fuses the
whole compositor fold into one kernel.  The per-layer blend-mode dispatch is
a `lax.switch` on a traced scalar, so only the selected branch executes.
"""

from __future__ import annotations

import enum

import jax
import jax.numpy as jnp

from paintfe_tpu.utils.quant import exact_div, trunc_u8


class BlendMode(enum.IntEnum):
    """Stable ids match the reference's serialization (layers.rs:125-185)."""

    NORMAL = 0
    MULTIPLY = 1
    SCREEN = 2
    ADDITIVE = 3
    REFLECT = 4
    GLOW = 5
    COLOR_BURN = 6
    COLOR_DODGE = 7
    OVERLAY = 8
    DIFFERENCE = 9
    NEGATION = 10
    LIGHTEN = 11
    DARKEN = 12
    XOR = 13
    OVERWRITE = 14
    HARD_LIGHT = 15
    SOFT_LIGHT = 16
    EXCLUSION = 17
    SUBTRACT = 18
    DIVIDE = 19
    LINEAR_BURN = 20
    VIVID_LIGHT = 21
    LINEAR_LIGHT = 22
    PIN_LIGHT = 23
    HARD_MIX = 24

    @classmethod
    def from_name(cls, name: str) -> "BlendMode":
        return cls[name.strip().upper().replace(" ", "_")]


# ---------------------------------------------------------------------------
# Channel mixers (f32 in [0,1]).  All guarded against div-by-zero so that
# both sides of a jnp.where stay finite.
# ---------------------------------------------------------------------------


def _overlay(b, t):
    return jnp.where(b < 0.5, 2.0 * b * t, 1.0 - 2.0 * (1.0 - b) * (1.0 - t))


def _color_burn(b, t):
    safe = jnp.where(t == 0.0, 1.0, t)
    return jnp.where(t == 0.0, 0.0, jnp.maximum(1.0 - (1.0 - b) / safe, 0.0))


def _color_dodge(b, t):
    safe = jnp.where(t >= 1.0, 1.0, 1.0 - t)
    return jnp.where(t >= 1.0, 1.0, jnp.minimum(b / safe, 1.0))


def _reflect(b, t):
    safe = jnp.where(t >= 1.0, 1.0, 1.0 - t)
    return jnp.where(t >= 1.0, 1.0, jnp.minimum(b * b / safe, 1.0))


def _soft_light(b, t):
    # W3C soft-light formula
    d = jnp.where(b <= 0.25, ((16.0 * b - 12.0) * b + 4.0) * b, jnp.sqrt(b))
    return jnp.where(
        t <= 0.5,
        b - (1.0 - 2.0 * t) * b * (1.0 - b),
        b + (2.0 * t - 1.0) * (d - b),
    )


def _divide(b, t):
    safe = jnp.where(t <= 0.0, 1.0, t)
    return jnp.where(t <= 0.0, 1.0, jnp.minimum(b / safe, 1.0))


def _vivid_light(b, t):
    t2_lo = 2.0 * t
    lo_safe = jnp.where(t2_lo <= 0.0, 1.0, t2_lo)
    lo = jnp.where(t2_lo <= 0.0, 0.0, jnp.maximum(1.0 - (1.0 - b) / lo_safe, 0.0))
    t2_hi = 2.0 * (t - 0.5)
    hi_safe = jnp.where(t2_hi >= 1.0, 1.0, 1.0 - t2_hi)
    hi = jnp.where(t2_hi >= 1.0, 1.0, jnp.minimum(b / hi_safe, 1.0))
    return jnp.where(t <= 0.5, lo, hi)


def _pin_light(b, t):
    return jnp.where(t <= 0.5, jnp.minimum(b, 2.0 * t), jnp.maximum(b, 2.0 * (t - 0.5)))


_RGB_MIXERS = {
    BlendMode.NORMAL: lambda b, t: t,
    BlendMode.MULTIPLY: lambda b, t: b * t,
    BlendMode.SCREEN: lambda b, t: 1.0 - (1.0 - b) * (1.0 - t),
    BlendMode.ADDITIVE: lambda b, t: jnp.minimum(b + t, 1.0),
    BlendMode.REFLECT: _reflect,
    BlendMode.GLOW: lambda b, t: _reflect(t, b),
    BlendMode.COLOR_BURN: _color_burn,
    BlendMode.COLOR_DODGE: _color_dodge,
    BlendMode.OVERLAY: _overlay,
    BlendMode.DIFFERENCE: lambda b, t: jnp.abs(b - t),
    BlendMode.NEGATION: lambda b, t: 1.0 - jnp.abs(1.0 - b - t),
    BlendMode.LIGHTEN: jnp.maximum,
    BlendMode.DARKEN: jnp.minimum,
    BlendMode.HARD_LIGHT: lambda b, t: _overlay(t, b),
    BlendMode.SOFT_LIGHT: _soft_light,
    BlendMode.EXCLUSION: lambda b, t: b + t - 2.0 * b * t,
    BlendMode.SUBTRACT: lambda b, t: jnp.maximum(b - t, 0.0),
    BlendMode.DIVIDE: _divide,
    BlendMode.LINEAR_BURN: lambda b, t: jnp.maximum(b + t - 1.0, 0.0),
    BlendMode.VIVID_LIGHT: _vivid_light,
    BlendMode.LINEAR_LIGHT: lambda b, t: jnp.clip(b + 2.0 * t - 1.0, 0.0, 1.0),
    BlendMode.PIN_LIGHT: _pin_light,
    BlendMode.HARD_MIX: lambda b, t: jnp.where(b + t >= 1.0, 1.0, 0.0),
}


def _porter_duff(mixer, base_f, top_rgb, top_a):
    """Source-over compositing of the mixed color, straight alpha.

    Mirrors the tail of blend_pixel_static: un-premultiplied output, div by
    zero coverage -> transparent black, truncating u8 cast.
    """
    base_rgb = base_f[..., 0:3]
    base_a = base_f[..., 3:4]
    rgb = mixer(base_rgb, top_rgb)
    inv = 1.0 - top_a
    out_a = top_a + base_a * inv
    safe_a = jnp.where(out_a == 0.0, 1.0, out_a)
    out_rgb = (rgb * top_a + base_rgb * base_a * inv) / safe_a
    out = jnp.concatenate([out_rgb, out_a], axis=-1)
    out = jnp.where(out_a == 0.0, 0.0, out)
    return trunc_u8(out * 255.0)


def _xor_branch(base_f, top_rgb, top_a):
    base_rgb = base_f[..., 0:3]
    base_a = base_f[..., 3:4]
    xor_a = base_a * (1.0 - top_a) + top_a * (1.0 - base_a)
    safe_a = jnp.where(xor_a == 0.0, 1.0, xor_a)
    xor_rgb = (base_rgb * base_a * (1.0 - top_a)
               + top_rgb * top_a * (1.0 - base_a)) / safe_a
    out = jnp.concatenate([xor_rgb, xor_a], axis=-1)
    out = jnp.where(xor_a == 0.0, 0.0, out)
    return trunc_u8(out * 255.0)


def _overwrite_branch(base_f, top_rgb, top_a):
    return trunc_u8(jnp.concatenate([top_rgb, top_a], axis=-1) * 255.0)


def _make_branches():
    branches = []
    for mode in BlendMode:
        if mode == BlendMode.OVERWRITE:
            branches.append(_overwrite_branch)
        elif mode == BlendMode.XOR:
            branches.append(_xor_branch)
        else:
            mixer = _RGB_MIXERS[mode]
            branches.append(
                lambda bf, tr, ta, _m=mixer: _porter_duff(_m, bf, tr, ta)
            )
    return branches


_BRANCHES = _make_branches()


def blend_u8(base, top, mode, opacity):
    """Blend `top` over `base` (both u8 [..., 4]) with a scalar mode/opacity.

    `mode` may be a Python int (branch resolved at trace time) or a traced
    scalar (lax.switch).  `opacity` is a scalar f32 in [0, 1].
    """
    opacity = jnp.clip(jnp.asarray(opacity, jnp.float32), 0.0, 1.0)
    base_f = exact_div(base.astype(jnp.float32), 255.0)
    top_f = exact_div(top.astype(jnp.float32), 255.0)
    top_rgb = top_f[..., 0:3]
    top_a = top_f[..., 3:4] * opacity

    if isinstance(mode, (int, BlendMode)):
        blended = _BRANCHES[int(mode)](base_f, top_rgb, top_a)
        is_normal = int(mode) == int(BlendMode.NORMAL)
    else:
        mode = jnp.asarray(mode, jnp.int32)
        blended = jax.lax.switch(mode, _BRANCHES, base_f, top_rgb, top_a)
        is_normal = mode == int(BlendMode.NORMAL)

    # Fast path 2: Normal, full opacity, opaque top pixel -> top verbatim.
    opaque_top = top[..., 3:4] == 255
    take_top = jnp.logical_and(jnp.logical_and(is_normal, opacity >= 1.0), opaque_top)
    blended = jnp.where(take_top, top, blended)

    # Fast path 1: fully transparent top pixel -> base verbatim (checked on
    # the raw alpha, *before* opacity scaling — matches the reference).
    return jnp.where(top[..., 3:4] == 0, base, blended)
