"""Convolution / neighborhood filters: the blur family, sharpen, median.

Behavioral contract: src/ops/filters.rs (separable Gaussian, kernel
truncated at ceil(3*sigma), H pass u8->f32, V pass f32->u8 round-half-up)
and src/ops/effects/{blur,noise,stylize}.rs (box / motion / bokeh / zoom
blur, median window sort, bilateral reduce-noise, unsharp mask, glow).

Device shape: each separable pass unrolls the tap loop into a chain of fused
shift+multiply+adds over the whole [H, W, 4] image — XLA fuses them into one
elementwise kernel; edge clamping becomes an edge-replicate pad.
Integer-exact ops (box, bokeh, motion, zoom, median) are order-insensitive;
the Gaussian accumulates f32 in reference tap order for golden parity.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from paintfe_tpu.utils.quant import exact_div, round_u8

f32 = np.float32


from paintfe_tpu.ops.common import masked as _masked  # shared (one def)


def _round_half_away(x):
    """Rust f32::round — half away from zero (for coordinate rounding)."""
    return jnp.sign(x) * jnp.floor(jnp.abs(x) + 0.5)


def to_radians_f32(deg) -> np.float32:
    """f32 deg->rad exactly like Rust f32::to_radians (mul by f32 PI/180)."""
    return f32(f32(deg) * (f32(np.pi) / f32(180.0)))


def _pad_x(img, r, w):
    """Edge-replicate pad along axis 1 so taps become static slices (XLA
    fuses slices of one buffer into a single elementwise kernel)."""
    if r == 0:
        return img
    return jnp.concatenate(
        [jnp.repeat(img[:, :1], r, 1), img, jnp.repeat(img[:, -1:], r, 1)], axis=1
    )


def _pad_y(img, r, h):
    if r == 0:
        return img
    return jnp.concatenate(
        [jnp.repeat(img[:1], r, 0), img, jnp.repeat(img[-1:], r, 0)], axis=0
    )


def _tap_x(padded, r, d, w):
    return jax.lax.slice_in_dim(padded, r + d, r + d + w, axis=1)


def _tap_y(padded, r, d, h):
    return jax.lax.slice_in_dim(padded, r + d, r + d + h, axis=0)


def _shift_x(img, d, w):
    idx = np.clip(np.arange(w) + d, 0, w - 1)
    return img[:, idx]


def _shift_y(img, d, h):
    idx = np.clip(np.arange(h) + d, 0, h - 1)
    return img[idx, :]


# ---------------------------------------------------------------------------
# Gaussian
# ---------------------------------------------------------------------------


def gaussian_kernel(sigma: float) -> np.ndarray:
    """1-D kernel truncated at ceil(3*sigma), normalized (f32 exact)."""
    radius = int(math.ceil(sigma * 3.0))
    if radius == 0:
        return np.ones(1, f32)
    xs = np.arange(2 * radius + 1, dtype=f32) - f32(radius)
    s2 = f32(2.0) * f32(sigma) * f32(sigma)
    k = np.exp(-xs * xs / s2).astype(f32)
    inv = f32(1.0) / f32(k.sum(dtype=f32))
    return (k * inv).astype(f32)


@functools.lru_cache(maxsize=128)
def _gaussian_fn(sigma: float, h: int, w: int):
    taps = gaussian_kernel(sigma)
    r = len(taps) // 2

    @jax.jit
    def run(img):
        src = img.astype(jnp.float32)
        padded = _pad_x(src, r, w)
        acc = jnp.zeros_like(src)
        for ki, kv in enumerate(taps):  # H pass, reference tap order
            acc = acc + _tap_x(padded, r, ki - r, w) * f32(kv)
        padded = _pad_y(acc, r, h)
        out = jnp.zeros_like(acc)
        for ki, kv in enumerate(taps):  # V pass
            out = out + _tap_y(padded, r, ki - r, h) * f32(kv)
        return round_u8(out)

    return run


def gaussian_blur(img, sigma: float, mask=None):
    """Full-image separable Gaussian blur (filters.rs:242-316)."""
    h, w = img.shape[:2]
    out = _gaussian_fn(float(sigma), h, w)(img)
    return _masked(img, out, mask)


def gaussian_blur_with_selection(img, sigma: float, mask=None):
    """Selection-aware Gaussian: blur only the padded selection bbox, then
    copy selected pixels back (filters.rs:130-207).  Bbox extraction is a
    host-side decision (data-dependent shape), matching the reference's
    region cutout semantics: clamping happens at the *cutout* edges.
    """
    if mask is None or not np.asarray(mask).any():
        if mask is not None and not np.asarray(mask).any():
            return img  # nothing selected
        return gaussian_blur(img, sigma)
    img_np = np.asarray(img)
    m = np.asarray(mask)
    ys, xs = np.nonzero(m)
    pad = int(math.ceil(sigma * 3.0))
    h, w = img_np.shape[:2]
    y0 = max(int(ys.min()) - pad, 0)
    y1 = min(int(ys.max()) + pad + 1, h)
    x0 = max(int(xs.min()) - pad, 0)
    x1 = min(int(xs.max()) + pad + 1, w)
    region = img_np[y0:y1, x0:x1]
    blurred = np.asarray(gaussian_blur(region, sigma))
    out = img_np.copy()
    sel = m[y0:y1, x0:x1] > 0
    out[y0:y1, x0:x1][sel] = blurred[sel]
    return out


# ---------------------------------------------------------------------------
# Box
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=128)
def _box_fn(r: int, h: int, w: int):
    k = 2 * r + 1
    div = np.uint32(k)
    half = np.uint32(k // 2)

    @jax.jit
    def run(img):
        src = img.astype(jnp.uint32)
        padded = _pad_x(src, r, w)
        sums = jnp.zeros_like(src)
        for d in range(-r, r + 1):
            sums = sums + _tap_x(padded, r, d, w)
        hbuf = ((sums + half) // div).astype(jnp.uint8).astype(jnp.uint32)
        padded = _pad_y(hbuf, r, h)
        sums = jnp.zeros_like(hbuf)
        for d in range(-r, r + 1):
            sums = sums + _tap_y(padded, r, d, h)
        return ((sums + half) // div).astype(jnp.uint8)

    return run


def box_blur(img, radius: float, mask=None):
    """Separable box blur, u8 intermediate, integer round-half-up
    (effects/blur.rs:233-318)."""
    if radius < 0.5:
        return img
    h, w = img.shape[:2]
    out = _box_fn(int(math.ceil(radius)), h, w)(img)
    return _masked(img, out, mask)


# ---------------------------------------------------------------------------
# Motion
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=128)
def _motion_fn(angle_deg: float, distance: float, h: int, w: int):
    angle = to_radians_f32(angle_deg)
    steps = int(math.ceil(distance))
    dx = f32(np.cos(angle))
    dy = f32(np.sin(angle))
    inv = f32(1.0) / f32(steps * 2 + 1)

    @jax.jit
    def run(img):
        src = img.astype(jnp.uint32)
        acc = jnp.zeros((h, w, 4), jnp.uint32)
        xs = jnp.arange(w, dtype=jnp.float32)
        ys = jnp.arange(h, dtype=jnp.float32)
        for i in range(-steps, steps + 1):
            sx = jnp.clip(
                _round_half_away(xs + f32(i) * dx).astype(jnp.int32), 0, w - 1
            )
            sy = jnp.clip(
                _round_half_away(ys + f32(i) * dy).astype(jnp.int32), 0, h - 1
            )
            acc = acc + src[sy][:, sx]
        return round_u8(acc.astype(jnp.float32) * inv)

    return run


def motion_blur(img, angle_deg: float, distance: float, mask=None):
    """Directional line-sample average (effects/blur.rs:144-210).  Sample
    sums are integers, so accumulation in u32 is exact."""
    if distance < 1.0:
        return img
    h, w = img.shape[:2]
    out = _motion_fn(float(angle_deg), float(distance), h, w)(img)
    return _masked(img, out, mask)


# ---------------------------------------------------------------------------
# Bokeh (equal-weight disc)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _bokeh_fn(radius: float, h: int, w: int):
    r = int(math.ceil(radius))
    r2 = f32(radius) * f32(radius)
    spans = []
    count = 0
    for dyy in range(-r, r + 1):
        remaining = r2 - f32(dyy * dyy)
        if remaining >= 0.0:
            span = int(np.floor(np.sqrt(remaining)))
            spans.append((dyy, span))
            count += span * 2 + 1
    inv = f32(1.0) / f32(count)

    @jax.jit
    def run(img):
        src = img.astype(jnp.uint32)
        padded = _pad_x(_pad_y(src, r, h), r, w)
        # per-row x-prefix sums turn each row's span into TWO slices
        # (hi - lo) instead of 2*span+1 taps: O(r) passes, not O(r^2).
        # u32 is exact (max 255 * (w + 2r) << 2^32) and the subtraction of
        # monotone prefix sums reproduces the tap sum bit-for-bit.
        c = jnp.cumsum(padded, axis=1)
        c = jnp.concatenate([jnp.zeros_like(c[:, :1]), c], axis=1)
        acc = jnp.zeros_like(src)
        for dyy, span in spans:
            rows = jax.lax.slice_in_dim(c, r + dyy, r + dyy + h, axis=0)
            hi = jax.lax.slice_in_dim(rows, r + span + 1, r + span + 1 + w, axis=1)
            lo = jax.lax.slice_in_dim(rows, r - span, r - span + w, axis=1)
            acc = acc + (hi - lo)
        return round_u8(acc.astype(jnp.float32) * inv)

    return run


def bokeh_blur(img, radius: float, mask=None):
    """Exact equal-weight disc average (effects/blur.rs:22-115)."""
    if radius < 0.5:
        return img
    h, w = img.shape[:2]
    out = _bokeh_fn(float(radius), h, w)(img)
    return _masked(img, out, mask)


# ---------------------------------------------------------------------------
# Zoom (radial)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _zoom_fn(cx_n, cy_n, strength, samples, tint, tint_strength, h, w):
    cx = f32(cx_n) * f32(w)
    cy = f32(cy_n) * f32(h)
    s = f32(np.clip(strength, 0.0, 0.99))
    n = max(int(samples), 2)
    inv_n = f32(1.0) / f32(n)
    corners = [(cx, cy), (f32(w) - cx, cy), (cx, f32(h) - cy), (f32(w) - cx, f32(h) - cy)]
    max_dist = max(max(float(np.sqrt(a * a + b * b)) for a, b in corners), 1.0)

    @jax.jit
    def run(img):
        src = img.astype(jnp.uint32)
        # the zoom map is SEPARABLE: the sample column depends only on x
        # and the sample row only on y, so each of the n taps is two 1-D
        # takes (rows then lanes) instead of a full 2-D gather — same
        # indices, bit-identical, ~100x less gather work at 4K
        xs1 = jnp.arange(w, dtype=jnp.float32)
        ys1 = jnp.arange(h, dtype=jnp.float32)
        acc = jnp.zeros((h, w, 4), jnp.uint32)
        for i in range(n):
            t = f32(1.0) - s * (f32(i) / f32(n - 1))
            sxv = jnp.clip(_round_half_away(cx + (xs1 - cx) * t)
                           .astype(jnp.int32), 0, w - 1)
            syv = jnp.clip(_round_half_away(cy + (ys1 - cy) * t)
                           .astype(jnp.int32), 0, h - 1)
            acc = acc + jnp.take(jnp.take(src, syv, axis=0), sxv, axis=1)
        out = acc.astype(jnp.float32) * inv_n
        dx = xs1[None, :] - cx
        dy = ys1[:, None] - cy
        if tint_strength > 0.001:
            dist = jnp.sqrt(dx * dx + dy * dy)
            tt = jnp.maximum(1.0 - exact_div(dist, f32(max_dist)), 0.0) * f32(tint_strength)
            tint_v = jnp.asarray(tint, jnp.float32) * 255.0
            out = out + (tint_v[None, None, :] - out) * tt[..., None]
        return round_u8(out)

    return run


def zoom_blur(img, center_x=0.5, center_y=0.5, strength=0.3, samples=8,
              tint_color=(0.0, 0.0, 0.0, 0.0), tint_strength=0.0, mask=None):
    """Radial zoom streaks toward a normalized center (effects/blur.rs:322-427)."""
    if strength < 0.001:
        return img
    h, w = img.shape[:2]
    out = _zoom_fn(
        float(center_x), float(center_y), float(strength), int(samples),
        tuple(float(c) for c in tint_color), float(tint_strength), h, w
    )(img)
    return _masked(img, out, mask)


# ---------------------------------------------------------------------------
# Unsharp mask / glow
# ---------------------------------------------------------------------------


# Module-level jits (a fresh closure per call would be a jit cache MISS
# every call — the CLAUDE.md hard-won rule); amount/intensity ride as
# traced scalars so one compile serves all parameter values per shape.
@jax.jit
def _sharpen_mix(src_u8, blur_u8, amt):
    s = src_u8.astype(jnp.float32)
    b = blur_u8.astype(jnp.float32)
    rgb = round_u8(s[..., 0:3] + amt * (s[..., 0:3] - b[..., 0:3]))
    return jnp.concatenate([rgb, src_u8[..., 3:4]], axis=-1)


@jax.jit
def _glow_mix(src_u8, blur_u8, inten):
    s = src_u8.astype(jnp.float32) / 255.0
    b = blur_u8.astype(jnp.float32) / 255.0
    res = 1.0 - (1.0 - s[..., 0:3]) * (1.0 - b[..., 0:3] * inten)
    rgb = round_u8(res * 255.0)
    return jnp.concatenate([rgb, src_u8[..., 3:4]], axis=-1)


def sharpen(img, amount: float, radius: float, mask=None):
    """Unsharp mask: out = src + amount*(src - gaussian(src, radius)); RGB
    only, alpha preserved (effects/stylize.rs:96-141)."""
    h, w = img.shape[:2]
    blurred = _gaussian_fn(float(radius), h, w)(img)
    out = _sharpen_mix(img, blurred, jnp.float32(float(amount)))
    return _masked(img, out, mask)


def glow(img, radius: float, intensity: float, mask=None):
    """Screen-blend of source with its blur scaled by intensity
    (effects/stylize.rs:26-72): 1-(1-s)(1-b*i) per RGB channel in [0,1]."""
    h, w = img.shape[:2]
    blurred = _gaussian_fn(float(radius), h, w)(img)
    out = _glow_mix(img, blurred, jnp.float32(float(intensity)))
    return _masked(img, out, mask)


# ---------------------------------------------------------------------------
# Median / reduce-noise
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _oddeven_merge_network(n: int):
    """Batcher odd-even mergesort comparator list for n inputs (pairs i<j).
    O(n log^2 n) compare-exchanges; sorts any input exactly."""
    # Batcher's construction needs a power-of-two width; pad virtually and
    # drop comparators that touch the padding (padding sorts as +inf).
    m = 1
    while m < n:
        m *= 2
    comparators = []

    def merge(lo, nn, step):
        dbl = step * 2
        if dbl < nn:
            merge(lo, nn, dbl)
            merge(lo + step, nn, dbl)
            for i in range(lo + step, lo + nn - step, dbl):
                comparators.append((i, i + step))
        elif lo + step < lo + nn:
            comparators.append((lo, lo + step))

    def sort(lo, nn):
        if nn > 1:
            mid = nn // 2
            sort(lo, mid)
            sort(lo + mid, nn - mid)
            merge(lo, nn, 1)

    sort(0, m)
    return [(i, j) for (i, j) in comparators if i < n and j < n]


@functools.lru_cache(maxsize=32)
def _median_fn(r: int, h: int, w: int):
    k = (2 * r + 1) ** 2
    network = _oddeven_merge_network(k)

    @jax.jit
    def run(img):
        padded = _pad_x(_pad_y(img, r, h), r, w)
        taps = []
        for dyy in range(-r, r + 1):
            row = _tap_y(padded, r, dyy, h)
            for dxx in range(-r, r + 1):
                taps.append(_tap_x(row, r, dxx, w))
        # compare-exchange network instead of jnp.sort: pure fused min/max
        # elementwise ops, exact same sorted result -> identical median;
        # only the comparators the median output depends on survive DCE
        for i, j in network:
            lo = jnp.minimum(taps[i], taps[j])
            hi = jnp.maximum(taps[i], taps[j])
            taps[i], taps[j] = lo, hi
        return taps[k // 2]

    return run


def median(img, radius: int, mask=None):
    """Per-channel window-sort median (effects/noise.rs:357-411)."""
    h, w = img.shape[:2]
    r = max(int(radius), 1)
    out = _median_fn(r, h, w)(img)
    return _masked(img, out, mask)


@functools.lru_cache(maxsize=64)
def _reduce_noise_fn(strength: float, r: int, h: int, w: int):
    sigma_s = f32(r)
    sigma_r = f32(strength) * f32(2.55)
    spatial_div = f32(2.0) * sigma_s * sigma_s
    range_div = f32(2.0) * sigma_r * sigma_r + f32(0.001)

    @jax.jit
    def run(img):
        src = img.astype(jnp.float32)
        padded = _pad_x(_pad_y(src, r, h), r, w)
        c = src[..., 0:3]
        sums = jnp.zeros_like(src)
        wsum = jnp.zeros((h, w), jnp.float32)
        for dyy in range(-r, r + 1):  # reference accumulation order
            row = _tap_y(padded, r, dyy, h)
            for dxx in range(-r, r + 1):
                p = _tap_x(row, r, dxx, w)
                diff = c - p[..., 0:3]
                spatial = exact_div(f32(dxx * dxx + dyy * dyy), spatial_div)
                rng = exact_div(jnp.sum(diff * diff, axis=-1), range_div)
                weight = jnp.exp(-spatial - rng)
                sums = sums + p * weight[..., None]
                wsum = wsum + weight
        inv = 1.0 / jnp.where(wsum > 0.0, wsum, 1.0)
        out = round_u8(sums * inv[..., None])
        return jnp.where((wsum > 0.0)[..., None], out, img)

    return run


def reduce_noise(img, strength: float, radius: int, mask=None):
    """Bilateral filter: spatial sigma = radius, range sigma = strength*2.55
    (effects/noise.rs:172-261)."""
    h, w = img.shape[:2]
    out = _reduce_noise_fn(float(strength), max(int(radius), 1), h, w)(img)
    return _masked(img, out, mask)
