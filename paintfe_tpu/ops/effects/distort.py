"""Inverse-mapped distortion effects: crystallize, pixelate, bulge, twist, dents.

Behavioral contract: src/ops/effects/distort.rs — jittered-grid Voronoi
crystallize (:26-169), block-center pixelate (:333-373), radial bulge
(:396-437), falloff-rotation twist (:460-500), turbulence-displacement dents
(:248-310).  All samplers are inverse maps: dst(x,y) = src(f(x,y)) with
edge-clamped bilinear gathers, which become vectorized gathers over the
whole image.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from paintfe_tpu.utils.hashing import hash_f32, turbulence_2d
from paintfe_tpu.utils.quant import exact_div, round_u8

f32 = np.float32


from paintfe_tpu.ops.common import masked as _masked  # shared (one def)


def sample_bilinear(img_u8, fx, fy):
    """Edge-clamped bilinear sample; weight order matches effects.rs:118-140."""
    h, w = img_u8.shape[:2]
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    dx = (fx - x0.astype(jnp.float32))[..., None]
    dy = (fy - y0.astype(jnp.float32))[..., None]

    def at(xi, yi):
        cx = jnp.clip(xi, 0, w - 1)
        cy = jnp.clip(yi, 0, h - 1)
        return img_u8[cy, cx].astype(jnp.float32)

    p00 = at(x0, y0)
    p10 = at(x0 + 1, y0)
    p01 = at(x0, y0 + 1)
    p11 = at(x0 + 1, y0 + 1)
    return (
        p00 * (1.0 - dx) * (1.0 - dy)
        + p10 * dx * (1.0 - dy)
        + p01 * (1.0 - dx) * dy
        + p11 * dx * dy
    )


from paintfe_tpu.ops.common import coord_grids as _coord_grids  # shared


# ---------------------------------------------------------------------------
# Pixelate
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _pixelate_fn(bs: int, h: int, w: int):
    sx = np.minimum((np.arange(w) // bs) * bs + bs // 2, w - 1)
    sy = np.minimum((np.arange(h) // bs) * bs + bs // 2, h - 1)

    @jax.jit
    def run(img):
        return img[sy][:, sx]

    return run


def pixelate(img, block_size: int, mask=None):
    """Sample each block's center pixel (distort.rs:333-373)."""
    bs = max(int(block_size), 2)
    h, w = img.shape[:2]
    out = _pixelate_fn(bs, h, w)(img)
    return _masked(img, out, mask)


# ---------------------------------------------------------------------------
# Crystallize (jittered-grid Voronoi)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _crystallize_fn(cs: float, seed: int, h: int, w: int):
    cs = f32(max(cs, 2.0))
    cells_x = max(int(np.ceil(f32(w) / cs)), 1)
    cells_y = max(int(np.ceil(f32(h) / cs)), 1)
    n_cells = cells_x * cells_y

    @jax.jit
    def run(img):
        # Jittered seed point per grid cell.
        cxs = jnp.arange(cells_x, dtype=jnp.uint32)[None, :]
        cys = jnp.arange(cells_y, dtype=jnp.uint32)[:, None]
        jx = hash_f32(cxs + jnp.zeros_like(cys), cys + jnp.zeros_like(cxs), seed)
        jy = hash_f32(cxs + jnp.zeros_like(cys), cys + jnp.zeros_like(cxs), seed + 77)
        seed_x = (cxs.astype(jnp.float32) * cs + jx * cs).reshape(-1)  # [n_cells]
        seed_y = (cys.astype(jnp.float32) * cs + jy * cs).reshape(-1)

        xs, ys = _coord_grids(h, w)
        gcx = exact_div(xs, cs).astype(jnp.int32)
        gcy = exact_div(ys, cs).astype(jnp.int32)
        px = xs + 0.5
        py = ys + 0.5

        best_dist = jnp.full((h, w), jnp.inf, jnp.float32)
        best_idx = jnp.zeros((h, w), jnp.int32)
        # 3x3 neighbor search in the reference's scan order so distance ties
        # resolve identically (strict < keeps the first-seen minimum).
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                nx = gcx + dx
                ny = gcy + dy
                valid = (nx >= 0) & (ny >= 0) & (nx < cells_x) & (ny < cells_y)
                idx = jnp.clip(ny, 0, cells_y - 1) * cells_x + jnp.clip(nx, 0, cells_x - 1)
                sx = seed_x[idx]
                sy = seed_y[idx]
                d = (px - sx) * (px - sx) + (py - sy) * (py - sy)
                d = jnp.where(valid, d, jnp.inf)
                take = d < best_dist
                best_dist = jnp.where(take, d, best_dist)
                best_idx = jnp.where(take, idx, best_idx)

        # Per-cell integer sums -> round-half-up average via the exact
        # integer identity round(s/c) == (2s + c) // (2c).  KNOWN corner
        # divergence from the reference (accepted, documented): the Rust
        # computes (sum * (1.0/count)).round() in f64, and the reciprocal's
        # rounding error can push an EXACT half (s/c == k + 0.5, e.g.
        # s=147, c=98) one ulp below the half so it rounds DOWN where this
        # integer formula rounds up.  Reproducing that bit pattern needs
        # f64 (unavailable without jax_enable_x64) or a host round trip in
        # the hot path; all 147 goldens pass with the integer formula.
        # Second corner: u32 sums overflow for a single cell holding
        # > ~16.8M pixels (255*n > 2^32) — cell_size >= ~4100 on a >=17Mpix
        # canvas; the reference's f64 sums stay exact there.
        flat_idx = best_idx.reshape(-1)
        counts = jnp.zeros(n_cells, jnp.uint32).at[flat_idx].add(1)
        sums = jnp.zeros((n_cells, 4), jnp.uint32).at[flat_idx].add(
            img.reshape(-1, 4).astype(jnp.uint32)
        )
        safe_c = jnp.maximum(counts, 1)[:, None]
        avg = ((2 * sums + safe_c) // (2 * safe_c)).astype(jnp.uint8)
        avg = jnp.where((counts > 0)[:, None], avg, 0)
        return avg[best_idx]

    return run


@functools.lru_cache(maxsize=32)
def _crystallize_fn_int(c: int, seed: int, h: int, w: int):
    """Gather/scatter-free crystallize for integer cell sizes.

    The general formulation (above) gathers jittered seed coordinates and
    the per-cell averages per pixel.  With an integer cell pitch everything regularizes: seeds are
    recomputed per pixel from the hash (pure arithmetic), per-cell sums
    become block reshape-reductions shifted at cell granularity, and the
    winning cell's average reaches each pixel by cell-level pad/slice +
    upsample-by-repeat.  Identical integer math and tie order, so results
    are bit-equal to the general path (and the golden).
    """
    cs = f32(c)
    cells_x = max(int(np.ceil(f32(w) / cs)), 1)
    cells_y = max(int(np.ceil(f32(h) / cs)), 1)
    hp, wp = cells_y * c, cells_x * c
    OFFS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]

    @jax.jit
    def run(img):
        imgp = jnp.pad(img, ((0, hp - h), (0, wp - w), (0, 0)))
        valid_px = (
            (jnp.arange(hp)[:, None] < h) & (jnp.arange(wp)[None, :] < w)
        )
        xs = jnp.arange(wp, dtype=jnp.float32)[None, :] * jnp.ones((hp, 1), jnp.float32)
        ys = jnp.arange(hp, dtype=jnp.float32)[:, None] * jnp.ones((1, wp), jnp.float32)
        gcx = exact_div(xs, cs).astype(jnp.int32)
        gcy = exact_div(ys, cs).astype(jnp.int32)
        px = xs + 0.5
        py = ys + 0.5

        best_dist = jnp.full((hp, wp), jnp.inf, jnp.float32)
        best_k = jnp.zeros((hp, wp), jnp.int32)
        for k, (dy, dx) in enumerate(OFFS):
            nx = gcx + dx
            ny = gcy + dy
            valid = (nx >= 0) & (ny >= 0) & (nx < cells_x) & (ny < cells_y)
            nxc = jnp.clip(nx, 0, cells_x - 1).astype(jnp.uint32)
            nyc = jnp.clip(ny, 0, cells_y - 1).astype(jnp.uint32)
            # same hash the general path evaluates at the cell grid
            jx = hash_f32(nxc, nyc, seed)
            jy = hash_f32(nxc, nyc, seed + 77)
            sx = nxc.astype(jnp.float32) * cs + jx * cs
            sy = nyc.astype(jnp.float32) * cs + jy * cs
            d = (px - sx) * (px - sx) + (py - sy) * (py - sy)
            d = jnp.where(valid, d, jnp.inf)
            take = d < best_dist
            best_dist = jnp.where(take, d, best_dist)
            best_k = jnp.where(take, k, best_k)

        # Per-cell sums/counts: pixels in cell g that chose neighbor g+o
        # contribute to cell g+o.  Whole-cell shifts commute with the block
        # reduction, so route every offset's contribution at PIXEL level
        # (static slices of one padded accumulator) and block-reduce ONCE —
        # 2 strided reductions instead of 45 (~4x faster at 4K).  Integer
        # sums are order-free, so results stay bit-equal.
        imgu = imgp.astype(jnp.uint32)
        acc_s = jnp.zeros((hp, wp, 4), jnp.uint32)
        acc_c = jnp.zeros((hp, wp), jnp.uint32)
        for k, (dy, dx) in enumerate(OFFS):
            m = ((best_k == k) & valid_px).astype(jnp.uint32)
            contrib = imgu * m[..., None]
            s_pad = jnp.pad(contrib, ((c, c), (c, c), (0, 0)))
            c_pad = jnp.pad(m, ((c, c), (c, c)))
            # routed[p] = contrib[p - o*c]: lands in the block of cell g+o
            acc_s = acc_s + jax.lax.slice(
                s_pad, (c - dy * c, c - dx * c, 0),
                (c - dy * c + hp, c - dx * c + wp, 4))
            acc_c = acc_c + jax.lax.slice(
                c_pad, (c - dy * c, c - dx * c),
                (c - dy * c + hp, c - dx * c + wp))
        sums = acc_s.reshape(cells_y, c, cells_x, c, 4).sum(axis=(1, 3))
        counts = acc_c.reshape(cells_y, c, cells_x, c).sum(axis=(1, 3))

        safe_c = jnp.maximum(counts, 1)[..., None]
        avg = ((2 * sums + safe_c) // (2 * safe_c)).astype(jnp.uint8)
        avg = jnp.where((counts > 0)[..., None], avg, 0)

        # Winner's average back to pixels: upsample the cell table ONCE
        # (broadcast-reshape; repeat x18 materialized gather-lowered frames
        # and dominated the op at ~200 ms/4K), then per-offset PIXEL-level
        # static shifts by whole cells — u[p + o*c] == avg[cell(p) + o]
        # because cells are aligned to multiples of c.
        u = jnp.broadcast_to(
            avg[:, None, :, None, :], (cells_y, c, cells_x, c, 4)
        ).reshape(hp, wp, 4)
        u_pad = jnp.pad(u, ((c, c), (c, c), (0, 0)))
        out = jnp.zeros((hp, wp, 4), jnp.uint8)
        for k, (dy, dx) in enumerate(OFFS):
            sh = jax.lax.slice(
                u_pad, (c + dy * c, c + dx * c, 0),
                (c + dy * c + hp, c + dx * c + wp, 4))
            out = jnp.where((best_k == k)[..., None], sh, out)
        return out[:h, :w]

    return run


def crystallize(img, cell_size: float, seed: int = 42, mask=None):
    """Jittered-grid Voronoi cell averaging (distort.rs:26-169)."""
    h, w = img.shape[:2]
    cs = float(max(cell_size, 2.0))
    if cs == int(cs):
        out = _crystallize_fn_int(int(cs), int(seed), h, w)(img)
    else:
        out = _crystallize_fn(cs, int(seed), h, w)(img)
    return _masked(img, out, mask)


# ---------------------------------------------------------------------------
# Bulge / Twist / Dents
# ---------------------------------------------------------------------------


def _bulge_coords(amount, cx, cy, max_r, strength, h, w):
    xs, ys = _coord_grids(h, w)
    dx = xs - cx
    dy = ys - cy
    dist = jnp.sqrt(dx * dx + dy * dy)
    norm = jnp.minimum(exact_div(dist, max_r), 1.0)
    falloff = 1.0 - norm
    if amount > 0.0:
        factor = 1.0 - falloff * strength * f32(0.5)
    elif amount < 0.0:
        factor = 1.0 + falloff * strength * f32(0.5)
    else:
        factor = jnp.ones_like(falloff)
    return cx + dx * factor, cy + dy * factor, norm


def _bulge_params(amount: float, ox: float, oy: float, h: int, w: int):
    wf, hf = f32(w), f32(h)
    cx = f32(np.clip(ox, 0.0, 1.0)) * max(wf - 1.0, 0.0)
    cy = f32(np.clip(oy, 0.0, 1.0)) * max(hf - 1.0, 0.0)
    max_r = f32(max(max(cx, wf - cx), max(cy, hf - cy), 1.0))
    strength = f32(max(abs(amount), 0.0001))
    return cx, cy, max_r, strength


@functools.lru_cache(maxsize=64)
def _bulge_fn(amount: float, ox: float, oy: float, h: int, w: int):
    cx, cy, max_r, strength = _bulge_params(amount, ox, oy, h, w)

    @jax.jit
    def run(img):
        src_x, src_y, norm = _bulge_coords(amount, cx, cy, max_r, strength, h, w)
        warped = round_u8(sample_bilinear(img, src_x, src_y))
        return jnp.where((norm >= 1.0)[..., None], img, warped)

    return run


def bulge(img, amount: float, origin=(0.5, 0.5), mask=None):
    """Radial scale about origin, inverse-mapped bilinear (distort.rs:396-458)."""
    h, w = img.shape[:2]
    key = (float(amount), float(origin[0]), float(origin[1]), h, w)
    out = _bulge_fn(*key)(img)
    return _masked(img, out, mask)


def _twist_coords(cx, cy, max_r, twist_amount, h, w):
    xs, ys = _coord_grids(h, w)
    dx = xs - cx
    dy = ys - cy
    dist = jnp.sqrt(dx * dx + dy * dy)
    rotation = twist_amount * (1.0 - exact_div(dist, max_r))
    cos_r = jnp.cos(rotation)
    sin_r = jnp.sin(rotation)
    return cx + dx * cos_r - dy * sin_r, cy + dx * sin_r + dy * cos_r


def _twist_params(angle_deg: float, ox: float, oy: float, h: int, w: int):
    wf, hf = f32(w), f32(h)
    cx = f32(np.clip(ox, 0.0, 1.0)) * max(wf - 1.0, 0.0)
    cy = f32(np.clip(oy, 0.0, 1.0)) * max(hf - 1.0, 0.0)
    mx = max(cx, wf - cx)
    my = max(cy, hf - cy)
    max_r = f32(max(np.sqrt(f32(mx * mx + my * my)), 1.0))
    twist_amount = f32(f32(angle_deg) * (f32(np.pi) / f32(180.0)))
    return cx, cy, max_r, twist_amount


@functools.lru_cache(maxsize=64)
def _twist_fn(angle_deg: float, ox: float, oy: float, h: int, w: int):
    cx, cy, max_r, twist_amount = _twist_params(angle_deg, ox, oy, h, w)

    @jax.jit
    def run(img):
        src_x, src_y = _twist_coords(cx, cy, max_r, twist_amount, h, w)
        return round_u8(sample_bilinear(img, src_x, src_y))

    return run


def twist(img, angle_deg: float, origin=(0.5, 0.5), mask=None):
    """Rotation by angle*(1-dist/max_r) about center (distort.rs:460-500)."""
    h, w = img.shape[:2]
    key = (float(angle_deg), float(origin[0]), float(origin[1]), h, w)
    out = _twist_fn(*key)(img)
    return _masked(img, out, mask)


def _dents_coords(scale, amount, seed, oct_n, roughness, pinch, wrap,
                  inv_scale, h, w):
    xs, ys = _coord_grids(h, w)
    nx_raw = turbulence_2d(xs * inv_scale, ys * inv_scale, seed, oct_n, roughness) * 2.0 - 1.0
    ny_raw = (
        turbulence_2d(xs * inv_scale, ys * inv_scale, (seed + 9999) & 0xFFFFFFFF, oct_n, roughness)
        * 2.0
        - 1.0
    )
    if pinch:
        cx = f32(w) * f32(0.5)
        cy = f32(h) * f32(0.5)
        dx = xs - cx
        dy = ys - cy
        dist = jnp.maximum(jnp.sqrt(dx * dx + dy * dy), 1.0)
        factor = (1.0 - exact_div(dist, f32(max(cx, cy)))) * 0.5
        nx = nx_raw + dx / dist * factor
        ny = ny_raw + dy / dist * factor
    else:
        nx, ny = nx_raw, ny_raw
    src_x = xs + nx * f32(amount) * f32(scale)
    src_y = ys + ny * f32(amount) * f32(scale)
    if wrap:
        src_x = src_x - jnp.floor(exact_div(src_x, f32(w))) * f32(w)
        src_y = src_y - jnp.floor(exact_div(src_y, f32(h))) * f32(h)
    return src_x, src_y


@functools.lru_cache(maxsize=32)
def _dents_fn(scale, amount, seed, octaves, roughness, pinch, wrap, h, w):
    inv_scale = f32(1.0) / f32(max(scale, 0.5))
    oct_n = int(np.clip(octaves, 1, 8))

    @jax.jit
    def run(img):
        src_x, src_y = _dents_coords(scale, amount, seed, oct_n, roughness,
                                     pinch, wrap, inv_scale, h, w)
        return round_u8(sample_bilinear(img, src_x, src_y))

    return run


def dents(img, scale, amount, seed=42, octaves=2, roughness=0.5, pinch=False,
          wrap=False, mask=None):
    """Turbulence-field displacement warp (distort.rs:248-310)."""
    h, w = img.shape[:2]
    key = (float(scale), float(amount), int(seed), int(octaves),
           float(roughness), bool(pinch), bool(wrap), h, w)
    out = _dents_fn(*key)(img)
    return _masked(img, out, mask)
