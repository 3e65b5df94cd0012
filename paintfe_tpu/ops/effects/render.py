"""Render effects: grid, canvas border, drop shadow, outline.

Behavioral contract: src/ops/effects/render.rs — grid_core (:52-92),
canvas_border_core (:114-165), shadow_core (:220-349, offset alpha -> optional
max-dilate spread -> Gaussian blur -> under-composite), outline_core
(:403-560, nearest opposite-alpha distance + smoothstep shell coverage).
"""

from __future__ import annotations

import enum
import functools

import jax
import jax.numpy as jnp
import numpy as np

from paintfe_tpu.ops.filters import _gaussian_fn
from paintfe_tpu.utils.quant import exact_div, round_u8

f32 = np.float32


from paintfe_tpu.ops.common import masked as _masked  # shared (one def)


class GridStyle(enum.IntEnum):
    LINES = 0
    CHECKERBOARD = 1


@functools.lru_cache(maxsize=32)
def _grid_fn(cell_w, cell_h, line_width, color, style, opacity, h, w):
    cw = max(cell_w, 2)
    ch = max(cell_h, 2)
    lw = max(line_width, 1)
    t = f32(opacity)
    col = np.asarray(color, f32)

    @jax.jit
    def run(img):
        xs = np.arange(w, dtype=np.uint32)
        ys = np.arange(h, dtype=np.uint32)
        if style == GridStyle.LINES:
            draw = ((xs % cw) < lw)[None, :] | ((ys % ch) < lw)[:, None]
        else:
            draw = ((xs // cw)[None, :] + (ys // ch)[:, None]) % 2 == 0
        src = img.astype(jnp.float32)
        mixed = src * (f32(1.0) - t) + jnp.asarray(col) * t
        out = jnp.where(jnp.asarray(draw)[..., None], mixed, src)
        return round_u8(out)

    return run


def grid(img, cell_w, cell_h, line_width, color, style=GridStyle.LINES,
         opacity=1.0, mask=None):
    h, w = img.shape[:2]
    out = _grid_fn(
        int(cell_w), int(cell_h), int(line_width), tuple(int(c) for c in color),
        GridStyle(style), float(opacity), h, w
    )(img)
    return _masked(img, out, mask)


def canvas_border(img, width: int, color, mask=None):
    """Hard frame write (render.rs:114-165)."""
    h, w = img.shape[:2]
    bw = min(max(int(width), 1), min(h, w))
    xs = np.arange(w)
    ys = np.arange(h)
    is_border = ((xs < bw) | (xs >= w - bw))[None, :] | ((ys < bw) | (ys >= h - bw))[:, None]
    out = jnp.where(
        jnp.asarray(is_border)[..., None],
        jnp.asarray(np.asarray(color, np.uint8)),
        img,
    )
    return _masked(img, out, mask)


@functools.lru_cache(maxsize=16)
def _shadow_fn(offset_x, offset_y, blur_radius, widen, color, opacity, h, w):
    col = np.asarray(color, f32)
    op = f32(opacity)

    @jax.jit
    def run(img):
        # 1. Offset alpha mask (out-of-bounds -> 0).
        a = img[..., 3]
        shadow_a = jnp.zeros((h, w), jnp.uint8)
        ys = np.arange(h) - offset_y
        xs = np.arange(w) - offset_x
        valid = ((ys >= 0) & (ys < h))[:, None] & ((xs >= 0) & (xs < w))[None, :]
        shadow_a = jnp.where(
            jnp.asarray(valid), a[np.clip(ys, 0, h - 1)][:, np.clip(xs, 0, w - 1)], 0
        )

        # 2. Optional spread: separable max-dilate by round(max(blur,1)).
        if widen:
            # Rust f32::round (half away from zero): Python's banker's
            # round() widened 2.5 -> 2 where the reference dilates by 3
            r = int(np.floor(max(blur_radius, 1.0) + 0.5))
            sa = shadow_a
            acc = sa
            for d in range(1, r + 1):
                xi0 = np.clip(np.arange(w) - d, 0, w - 1)
                xi1 = np.clip(np.arange(w) + d, 0, w - 1)
                acc = jnp.maximum(acc, jnp.maximum(sa[:, xi0], sa[:, xi1]))
            sa = acc
            acc = sa
            for d in range(1, r + 1):
                yi0 = np.clip(np.arange(h) - d, 0, h - 1)
                yi1 = np.clip(np.arange(h) + d, 0, h - 1)
                acc = jnp.maximum(acc, jnp.maximum(sa[yi0], sa[yi1]))
            shadow_a = acc

        # 3. Blur the alpha (as an RGBA image of [a,a,a,a], like the reference).
        if blur_radius > 0.5:
            rgba = jnp.stack([shadow_a] * 4, axis=-1)
            blurred = _gaussian_fn(float(blur_radius), h, w)(rgba)[..., 0]
        else:
            blurred = shadow_a

        # 4. Under-composite the shadow color beneath the source.
        sh_a = exact_div(blurred.astype(jnp.float32), 255.0) * op * f32(col[3] / f32(255.0))
        src = img.astype(jnp.float32)
        src_a = exact_div(src[..., 3], 255.0)
        out_a = src_a + sh_a * (1.0 - src_a)
        safe = jnp.where(out_a > 0.0, out_a, 1.0)
        chans = []
        for c in range(3):
            sc = f32(col[c] / f32(255.0))
            s = exact_div(src[..., c], 255.0)
            v = jnp.where(out_a > 0.0, (s * src_a + sc * sh_a * (1.0 - src_a)) / safe, 0.0)
            chans.append(round_u8(v * 255.0))
        chans.append(round_u8(out_a * 255.0))
        return jnp.stack(chans, axis=-1)

    return run


def drop_shadow(img, offset_x, offset_y, blur_radius, widen_radius, color,
                opacity, mask=None):
    h, w = img.shape[:2]
    out = _shadow_fn(
        int(offset_x), int(offset_y), float(blur_radius), bool(widen_radius),
        tuple(int(c) for c in color), float(opacity), h, w
    )(img)
    return _masked(img, out, mask)


class OutlineMode(enum.IntEnum):
    OUTSIDE = 0
    INSIDE = 1
    CENTER = 2


@functools.lru_cache(maxsize=16)
def _outline_fn(width, color, mode, anti_alias, h, w):
    radius = f32(max(width, 1))
    search_radius = int(np.ceil(radius)) + 1
    col = np.asarray(color, f32)

    def shell_coverage(distance):
        if anti_alias:
            t = jnp.clip((radius + f32(0.5) - distance) / f32(1.0), 0.0, 1.0)
            return t * t * (3.0 - 2.0 * t)
        return jnp.where(distance <= radius, 1.0, 0.0)

    @jax.jit
    def run(img):
        alpha = img[..., 3]
        filled = alpha > 0

        # Nearest matching-sample squared distance within the search window.
        # The reference scans the full (2sr+1)^2 window keeping min dist_sq
        # (render.rs:403-560); the squared EDT is exactly separable —
        # min_{dx,dy} (dx^2 + dy^2) over samples at (y+dy, x+dx) equals
        # min_{dx} (dx^2 + min_{dy} dy^2 over samples in column x+dx) —
        # so two 1-D passes of (2sr+1) static-slice taps replace the 81-tap
        # 2-D scan (w=3), with identical i32 values at every pixel.
        # Out-of-window samples stay at INF in both passes; dx^2 + INF
        # never wins the min because the dx=0 term is <= INF.
        INF = jnp.int32(2**30)
        sr = search_radius
        # vertical pass: per-column nearest dy^2 (INF rows are neither
        # filled nor empty, matching the old in-bounds mask)
        fpad = jnp.pad(filled, ((sr, sr), (0, 0)), constant_values=False)
        inbpad = jnp.pad(jnp.ones((h, w), bool), ((sr, sr), (0, 0)),
                         constant_values=False)
        col_fill = jnp.full((h, w), INF)
        col_empty = jnp.full((h, w), INF)
        for dy in range(-sr, sr + 1):
            d2 = jnp.int32(dy * dy)
            samp = fpad[sr + dy:sr + dy + h, :]
            inb = inbpad[sr + dy:sr + dy + h, :]
            col_fill = jnp.minimum(col_fill, jnp.where(inb & samp, d2, INF))
            col_empty = jnp.minimum(col_empty,
                                    jnp.where(inb & ~samp, d2, INF))
        # horizontal pass: add dx^2 and reduce over the column results
        cf = jnp.pad(col_fill, ((0, 0), (sr, sr)), constant_values=INF)
        ce = jnp.pad(col_empty, ((0, 0), (sr, sr)), constant_values=INF)
        best_fill = jnp.full((h, w), INF)
        best_empty = jnp.full((h, w), INF)
        for dx in range(-sr, sr + 1):
            d2 = jnp.int32(dx * dx)
            best_fill = jnp.minimum(best_fill,
                                    cf[:, sr + dx:sr + dx + w] + d2)
            best_empty = jnp.minimum(best_empty,
                                     ce[:, sr + dx:sr + dx + w] + d2)
        best_fill = jnp.minimum(best_fill, INF)
        best_empty = jnp.minimum(best_empty, INF)

        src_a = exact_div(alpha.astype(jnp.float32), 255.0)
        dist_fill = jnp.sqrt(best_fill.astype(jnp.float32))
        dist_empty = jnp.sqrt(best_empty.astype(jnp.float32))
        outside_cov = jnp.where(
            best_fill < INF,
            shell_coverage(jnp.maximum(dist_fill - 1.0, 0.0)),
            0.0,
        ) * (1.0 - src_a)
        inside_cov = jnp.where(best_empty < INF, shell_coverage(dist_empty), 0.0) * src_a

        if mode == OutlineMode.OUTSIDE:
            under_cov, over_cov = outside_cov, jnp.zeros_like(inside_cov)
        elif mode == OutlineMode.INSIDE:
            under_cov, over_cov = jnp.zeros_like(outside_cov), inside_cov
        else:
            under_cov, over_cov = outside_cov, inside_cov

        ca = f32(col[3] / f32(255.0))
        a_under = ca * under_cov
        a_over = ca * over_cov

        src = img.astype(jnp.float32)
        comp = [exact_div(src[..., c], 255.0) for c in range(3)]
        comp_a = src_a

        # Under-composite (outline beneath source).
        out_a1 = comp_a + a_under * (1.0 - comp_a)
        safe1 = jnp.where(out_a1 > 0.0, out_a1, 1.0)
        do_under = a_under > 0.0
        for c in range(3):
            cc = f32(col[c] / f32(255.0))
            v = (comp[c] * comp_a + cc * a_under * (1.0 - comp_a)) / safe1
            comp[c] = jnp.where(do_under & (out_a1 > 0.0), v, comp[c])
        comp_a = jnp.where(do_under, out_a1, comp_a)

        # Over-composite (outline on top).
        out_a2 = a_over + comp_a * (1.0 - a_over)
        safe2 = jnp.where(out_a2 > 0.0, out_a2, 1.0)
        do_over = a_over > 0.0
        for c in range(3):
            cc = f32(col[c] / f32(255.0))
            v = (cc * a_over + comp[c] * comp_a * (1.0 - a_over)) / safe2
            comp[c] = jnp.where(do_over & (out_a2 > 0.0), v, comp[c])
        comp_a = jnp.where(do_over, out_a2, comp_a)

        out = jnp.stack(
            [round_u8(comp[0] * 255.0), round_u8(comp[1] * 255.0),
             round_u8(comp[2] * 255.0), round_u8(comp_a * 255.0)],
            axis=-1,
        )
        # Untouched when no coverage at all (the reference writes back dst=src
        # for pixels outside the processing bbox; coverage==0 pixels reduce to
        # the identity composite, but the f32 round-trip could perturb them —
        # so copy source verbatim where nothing was drawn).
        touched = (a_under > 0.0) | (a_over > 0.0)
        return jnp.where(touched[..., None], out, img)

    return run


def outline(img, width, color, mode=OutlineMode.OUTSIDE, anti_alias=True, mask=None):
    imj = jnp.asarray(img)
    # No host-side transparency early-out (render.rs:436-438 returns the
    # image unchanged when fully transparent): on a fully-transparent
    # input the kernel's coverage is zero everywhere, so `touched` selects
    # the source verbatim — same result with zero host syncs, and the op
    # stays trace-safe (usable under jit/vmap) with no host round trip.
    h, w = imj.shape[0], imj.shape[1]
    out = _outline_fn(
        int(width), tuple(int(c) for c in color), OutlineMode(mode),
        bool(anti_alias), h, w
    )(imj)
    return _masked(img, out, mask)
