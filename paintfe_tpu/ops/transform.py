"""Geometric transforms: flips/rotates, resize, affine, displacement warps,
Catmull-Rom mesh warp.

Behavioral contract: src/ops/transform.rs — Interpolation -> image-crate
filters (:20-59), resize/canvas-resize/flatten (:347-500), apply_affine
homography (:826-976), DisplacementField + brush ops (:1014-1200), warp
appliers (:1206-1345), Catmull-Rom surface + mesh displacement (:1550-1761).

The resampler reproduces the Rust `image` crate's separable resize
(vertical pass then horizontal, f32 intermediate, per-window normalized
kernel weights, round-half-away final cast) so resize goldens match.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from paintfe_tpu.utils.quant import exact_div, round_u8

f32 = np.float32


# ---------------------------------------------------------------------------
# Flips / 90-degree rotates (exact permutations)
# ---------------------------------------------------------------------------


def flip_horizontal(img):
    return np.ascontiguousarray(np.asarray(img)[:, ::-1])


def flip_vertical(img):
    return np.ascontiguousarray(np.asarray(img)[::-1])


def rotate_90cw(img):
    return np.ascontiguousarray(np.rot90(np.asarray(img), k=-1))


def rotate_90ccw(img):
    return np.ascontiguousarray(np.rot90(np.asarray(img), k=1))


def rotate_180(img):
    return np.ascontiguousarray(np.asarray(img)[::-1, ::-1])


# ---------------------------------------------------------------------------
# image-crate-compatible separable resize
# ---------------------------------------------------------------------------


def _box_kernel(x):
    return np.ones_like(x)


def _triangle_kernel(x):
    a = np.abs(x)
    return np.where(a < 1.0, f32(1.0) - a, f32(0.0))


def _catmullrom_kernel(x):
    # cubic BC with b=0, c=0.5 (image crate's CatmullRom)
    a = np.abs(x).astype(f32)
    b, c = f32(0.0), f32(0.5)
    k1 = (f32(12.0) - f32(9.0) * b - f32(6.0) * c) * a**3 + (
        f32(-18.0) + f32(12.0) * b + f32(6.0) * c
    ) * a**2 + (f32(6.0) - f32(2.0) * b)
    k2 = (-b - f32(6.0) * c) * a**3 + (f32(6.0) * b + f32(30.0) * c) * a**2 + (
        f32(-12.0) * b - f32(48.0) * c
    ) * a + (f32(8.0) * b + f32(24.0) * c)
    k = np.where(a < 1.0, k1, np.where(a < 2.0, k2, f32(0.0)))
    return (k / f32(6.0)).astype(f32)


def _sinc(t):
    t = t.astype(f32)
    a = t * f32(np.pi)
    with np.errstate(invalid="ignore", divide="ignore"):
        v = np.sin(a, dtype=f32) / a
    return np.where(t == 0.0, f32(1.0), v).astype(f32)


def _lanczos3_kernel(x):
    a = np.abs(x).astype(f32)
    return np.where(a < 3.0, _sinc(x) * _sinc(x / f32(3.0)), f32(0.0)).astype(f32)


_FILTERS = {
    "nearest": (_box_kernel, 0.0),
    "bilinear": (_triangle_kernel, 1.0),
    "bicubic": (_catmullrom_kernel, 2.0),
    "lanczos3": (_lanczos3_kernel, 3.0),
}


def _sample_axis(data: np.ndarray, new_len: int, kernel, support: float) -> np.ndarray:
    """One resampling pass along axis 0 (f32 in, f32 out), mirroring the
    image crate's vertical_sample loop structure."""
    old_len = data.shape[0]
    ratio = f32(old_len) / f32(new_len)
    sratio = ratio if ratio >= 1.0 else f32(1.0)
    src_support = f32(support) * sratio

    out = np.zeros((new_len,) + data.shape[1:], f32)
    for o in range(new_len):
        inputx = (f32(o) + f32(0.5)) * ratio
        left = int(np.floor(f32(inputx - src_support)))
        left = min(max(left, 0), old_len - 1)
        right = int(np.ceil(f32(inputx + src_support)))
        right = min(max(right, left + 1), old_len)
        center = f32(inputx - f32(0.5))
        idx = np.arange(left, right)
        ws = kernel(((idx.astype(f32) - center) / sratio).astype(f32)).astype(f32)
        total = f32(0.0)
        for wv in ws:  # sequential f32 sum, matching the Rust loop
            total = f32(total + wv)
        ws = (ws / total).astype(f32)
        # accumulate in tap order (f32)
        acc = np.zeros(data.shape[1:], f32)
        for k, i in enumerate(idx):
            acc += data[i] * ws[k]
        out[o] = acc
    return out


def resize(img, new_w: int, new_h: int, interpolation: str = "bilinear") -> np.ndarray:
    """image::imageops::resize parity: vertical pass, then horizontal, f32
    intermediate, clamp + round-half-away to u8 at the end."""
    img = np.asarray(img)
    kernel, support = _FILTERS[interpolation]
    data = img.astype(f32)
    tmp = _sample_axis(data, new_h, kernel, support)  # vertical
    out = _sample_axis(np.swapaxes(tmp, 0, 1), new_w, kernel, support)
    out = np.swapaxes(out, 0, 1)
    return np.clip(np.floor(out + f32(0.5)), 0, 255).astype(np.uint8)


def resize_canvas(img, new_w: int, new_h: int, anchor=(0, 0), fill=(0, 0, 0, 0)):
    """Anchor-offset copy onto fill color (transform.rs:382-464).
    anchor components: 0=start, 1=center, 2=end."""
    img = np.asarray(img)
    old_h, old_w = img.shape[:2]
    ax, ay = anchor
    # Rust i32 division truncates toward zero; Python // floors — match Rust.
    offset_x = (0 if ax == 0
                else int((new_w - old_w) / 2) if ax == 1 else new_w - old_w)
    offset_y = (0 if ay == 0
                else int((new_h - old_h) / 2) if ay == 1 else new_h - old_h)
    out = np.empty((new_h, new_w, 4), np.uint8)
    out[...] = np.asarray(fill, np.uint8)
    sx0 = max(-offset_x, 0)
    sy0 = max(-offset_y, 0)
    dx0 = max(offset_x, 0)
    dy0 = max(offset_y, 0)
    cw = min(old_w - sx0, new_w - dx0)
    ch = min(old_h - sy0, new_h - dy0)
    if cw > 0 and ch > 0:
        out[dy0 : dy0 + ch, dx0 : dx0 + cw] = img[sy0 : sy0 + ch, sx0 : sx0 + cw]
    return out


# ---------------------------------------------------------------------------
# Affine / perspective transform
# ---------------------------------------------------------------------------


def _invert_3x3(m):
    a, b, c = m[0]
    d, e, fv = m[1]
    g, h, i = m[2]
    det = a * (e * i - fv * h) - b * (d * i - fv * g) + c * (d * h - e * g)
    if abs(det) < 1e-12:
        return np.eye(3, dtype=f32)
    inv = f32(1.0) / det
    return np.array(
        [
            [(e * i - fv * h) * inv, (c * h - b * i) * inv, (b * fv - c * e) * inv],
            [(fv * g - d * i) * inv, (a * i - c * g) * inv, (c * d - a * fv) * inv],
            [(d * h - e * g) * inv, (b * g - a * h) * inv, (a * e - b * d) * inv],
        ],
        f32,
    )


def _bilinear_gather_zero(src, sx, sy, src_h, src_w):
    """Zero-padded bilinear sample + round-half-away u8 (the shared gather
    of the affine and displacement warps; out-of-source pixels transparent)."""
    x0 = jnp.floor(sx).astype(jnp.int32)
    y0 = jnp.floor(sy).astype(jnp.int32)
    oob = (x0 < -1) | (y0 < -1) | (x0 >= src_w) | (y0 >= src_h)
    fx = (sx - x0.astype(jnp.float32))[..., None]
    fy = (sy - y0.astype(jnp.float32))[..., None]

    def sample(xi, yi):
        inb = (xi >= 0) & (yi >= 0) & (xi < src_w) & (yi < src_h)
        p = src[jnp.clip(yi, 0, src_h - 1), jnp.clip(xi, 0, src_w - 1)]
        return jnp.where(inb[..., None], p.astype(jnp.float32), 0.0)

    tl = sample(x0, y0)
    tr = sample(x0 + 1, y0)
    bl = sample(x0, y0 + 1)
    br = sample(x0 + 1, y0 + 1)
    top = tl + (tr - tl) * fx
    bot = bl + (br - bl) * fx
    out = round_u8(top + (bot - top) * fy)
    return jnp.where(oob[..., None], jnp.zeros_like(out), out), oob


def _affine_params(rotation_z, rotation_x, rotation_y, scale, offset_x,
                   offset_y, canvas_w, canvas_h) -> np.ndarray:
    """Host-side f32 homography coefficients -> f32[12] parameter vector
    [h00..h22, offset_x, offset_y, inv_scale].  Host math keeps the exact
    Rust f32 sequencing; the coefficients ride into the jitted program as
    a TRACED operand so one compiled program serves every parameter set
    (baking them as closure constants re-compiled per angle)."""
    inv_scale = f32(1.0) / f32(scale) if abs(scale) > 1e-6 else f32(1.0)
    focal = f32(max(canvas_w, canvas_h)) * f32(1.5)

    def rad(d):
        return f32(f32(d) * (f32(np.pi) / f32(180.0)))

    sz, cz = f32(np.sin(rad(rotation_z))), f32(np.cos(rad(rotation_z)))
    sxr, cxr = f32(np.sin(rad(rotation_x))), f32(np.cos(rad(rotation_x)))
    syr, cyr = f32(np.sin(rad(rotation_y))), f32(np.cos(rad(rotation_y)))

    r00 = cz * cyr
    r01 = cz * syr * sxr - sz * cxr
    r10 = sz * cyr
    r11 = sz * syr * sxr + cz * cxr
    r20 = -syr
    r21 = cyr * sxr

    hmat = np.array(
        [[focal * r00, focal * r01, 0.0], [focal * r10, focal * r11, 0.0], [r20, r21, focal]],
        f32,
    )
    hi = _invert_3x3(hmat)
    return np.array([hi[0][0], hi[0][1], hi[0][2],
                     hi[1][0], hi[1][1], hi[1][2],
                     hi[2][0], hi[2][1], hi[2][2],
                     offset_x, offset_y, inv_scale], f32)


@functools.lru_cache(maxsize=16)
def _affine_fn(canvas_w, canvas_h, src_h, src_w, nearest):
    cx = f32(canvas_w) * f32(0.5)
    cy = f32(canvas_h) * f32(0.5)

    @jax.jit
    def run(src, params):
        (h00, h01, h02, h10, h11, h12, h20, h21, h22,
         offset_x, offset_y, inv_scale) = (params[i] for i in range(12))
        xs = jnp.arange(canvas_w, dtype=jnp.float32)[None, :]
        ys = jnp.arange(canvas_h, dtype=jnp.float32)[:, None]
        u = (xs - cx - offset_x) * inv_scale
        v = (ys - cy - offset_y) * inv_scale
        wq = h20 * u + (h21 * v + h22)
        degenerate = jnp.abs(wq) < 1e-8
        # reciprocal-then-multiply like the reference (transform.rs:893);
        inv_w = jnp.float32(1.0) / jnp.where(degenerate, 1.0, wq)
        src_x = (h00 * u + (h01 * v + h02)) * inv_w + cx
        src_y = (h10 * u + (h11 * v + h12)) * inv_w + cy

        if nearest:
            nx = (jnp.sign(src_x) * jnp.floor(jnp.abs(src_x) + 0.5)).astype(jnp.int32)
            ny = (jnp.sign(src_y) * jnp.floor(jnp.abs(src_y) + 0.5)).astype(jnp.int32)
            inb = (nx >= 0) & (ny >= 0) & (nx < src_w) & (ny < src_h) & ~degenerate
            out = src[jnp.clip(ny, 0, src_h - 1), jnp.clip(nx, 0, src_w - 1)]
            return jnp.where(inb[..., None], out, 0)

        out, _oob = _bilinear_gather_zero(src, src_x, src_y, src_h, src_w)
        return jnp.where(degenerate[..., None], jnp.zeros_like(out), out)

    return run


def apply_affine(img, rotation_z=0.0, rotation_x=0.0, rotation_y=0.0, scale=1.0,
                 offset=(0.0, 0.0), canvas_size=None, interpolation="bilinear"):
    """Inverse-mapped Rz*Ry*Rx homography with focal 1.5*max(w,h) perspective,
    center-anchored; out-of-source samples transparent (transform.rs:826-976).
    Rotation args are in degrees (the reference converts with to_radians)."""
    img = np.asarray(img)
    src_h, src_w = img.shape[:2]
    ch, cw = (src_h, src_w) if canvas_size is None else (canvas_size[1], canvas_size[0])
    params = _affine_params(
        float(rotation_z), float(rotation_x), float(rotation_y), float(scale),
        float(offset[0]), float(offset[1]), cw, ch,
    )
    fn = _affine_fn(cw, ch, src_h, src_w, interpolation == "nearest")
    return fn(img, params)


def rotate_arbitrary(img, degrees: float, interpolation: str = "bilinear"):
    """Whole-canvas rotation, canvas size unchanged (transform.rs:134-186)."""
    if abs(degrees) < 0.001:
        return img
    return apply_affine(img, rotation_z=degrees, interpolation=interpolation)


# ---------------------------------------------------------------------------
# Displacement field (Liquify)
# ---------------------------------------------------------------------------


class DisplacementField:
    """(dx, dy) f32 field; output(x,y) = src(x-dx, y-dy).

    Brush ops mirror transform.rs:1051-1200 (host-side: they touch only a
    brush-radius window, which is a host-driven interactive path)."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.data = np.zeros((height, width, 2), f32)

    def _window(self, center_x, center_y, radius):
        r = f32(max(radius, 1.0))
        x0 = max(int(np.floor(f32(center_x) - r)), 0)
        y0 = max(int(np.floor(f32(center_y) - r)), 0)
        # clamp the ends at the starts too: a fully off-canvas brush center
        # gave a negative slice end that wrapped (the reference's
        # `for px in x0..x1` loop is simply empty, transform.rs:1063-1081)
        x1 = min(max(int(np.ceil(f32(center_x) + r)), x0), self.width)
        y1 = min(max(int(np.ceil(f32(center_y) + r)), y0), self.height)
        xs = np.arange(x0, x1, dtype=f32) - f32(center_x)
        ys = np.arange(y0, y1, dtype=f32) - f32(center_y)
        dx = xs[None, :] * np.ones((len(ys), 1), f32)
        dy = ys[:, None] * np.ones((1, len(xs)), f32)
        dist_sq = dx * dx + dy * dy
        inside = dist_sq <= r * r
        return (x0, y0, x1, y1), dx, dy, dist_sq, inside, r

    def apply_push(self, center_x, center_y, delta_x, delta_y, radius, strength):
        (x0, y0, x1, y1), dx, dy, dist_sq, inside, r = self._window(center_x, center_y, radius)
        sigma = r / f32(3.0)
        s2 = f32(2.0) * sigma * sigma
        weight = np.exp(-dist_sq / s2, dtype=f32) * f32(strength)
        weight = np.where(inside, weight, f32(0.0))
        self.data[y0:y1, x0:x1, 0] += f32(delta_x) * weight
        self.data[y0:y1, x0:x1, 1] += f32(delta_y) * weight
        return (x0, y0, x1, y1)

    def apply_expand(self, center_x, center_y, radius, strength):
        (x0, y0, x1, y1), dx, dy, dist_sq, inside, r = self._window(center_x, center_y, radius)
        dist = np.maximum(np.sqrt(dist_sq, dtype=f32), f32(0.001))
        t = dist / r
        weight = (f32(1.0) - t) * (f32(1.0) - t) * f32(strength) * f32(3.0)
        weight = np.where(inside, weight, f32(0.0))
        self.data[y0:y1, x0:x1, 0] += dx / dist * weight
        self.data[y0:y1, x0:x1, 1] += dy / dist * weight
        return (x0, y0, x1, y1)

    def apply_contract(self, center_x, center_y, radius, strength):
        (x0, y0, x1, y1), dx, dy, dist_sq, inside, r = self._window(center_x, center_y, radius)
        sigma = r / f32(3.0)
        s2 = f32(2.0) * sigma * sigma
        dist = np.maximum(np.sqrt(dist_sq, dtype=f32), f32(0.001))
        weight = np.exp(-dist_sq / s2, dtype=f32) * f32(strength)
        weight = np.where(inside, weight, f32(0.0))
        self.data[y0:y1, x0:x1, 0] += -dx / dist * weight * f32(2.0)
        self.data[y0:y1, x0:x1, 1] += -dy / dist * weight * f32(2.0)
        return (x0, y0, x1, y1)

    def apply_twirl(self, center_x, center_y, radius, strength, clockwise=True):
        (x0, y0, x1, y1), dx, dy, dist_sq, inside, r = self._window(center_x, center_y, radius)
        sigma = r / f32(3.0)
        s2 = f32(2.0) * sigma * sigma
        d = f32(1.0) if clockwise else f32(-1.0)
        weight = np.exp(-dist_sq / s2, dtype=f32) * f32(strength) * d
        weight = np.where(inside, weight, f32(0.0))
        self.data[y0:y1, x0:x1, 0] += -dy * weight * f32(0.1)
        self.data[y0:y1, x0:x1, 1] += dx * weight * f32(0.1)
        return (x0, y0, x1, y1)


@functools.lru_cache(maxsize=32)
def _warp_fn(h, w, src_h, src_w):
    @jax.jit
    def run(src, disp):
        xs = jnp.arange(w, dtype=jnp.float32)[None, :] * jnp.ones((h, 1), jnp.float32)
        ys = jnp.arange(h, dtype=jnp.float32)[:, None] * jnp.ones((1, w), jnp.float32)
        sx = xs - disp[..., 0]
        sy = ys - disp[..., 1]
        out, _oob = _bilinear_gather_zero(src, sx, sy, src_h, src_w)
        return out

    return run


def warp_displacement(src, field):
    """Full-image displacement warp (transform.rs:1288-1345): transparent
    outside the source, bilinear with zero-padded corners."""
    if not hasattr(src, "shape"):
        src = np.asarray(src)
    if isinstance(field, DisplacementField):
        disp = field.data
        h, w = field.height, field.width
    else:
        # keep device-resident fields on device (np.asarray would download
        # the whole 66 MB field for a 4K frame); host numpy fields are
        # still rounded to f32 FIRST so sx/sy arithmetic never runs in
        # f64 (golden parity needs bit-stable f32 end to end)
        if not hasattr(field, "shape"):
            disp = np.asarray(field, f32)
        elif field.dtype != np.float32:
            # .astype keeps jax arrays on device; covers any array-like
            disp = field.astype(f32)
        else:
            disp = field
        h, w = disp.shape[:2]
    return _warp_fn(h, w, src.shape[0], src.shape[1])(src, disp)


# ---------------------------------------------------------------------------
# Catmull-Rom mesh warp
# ---------------------------------------------------------------------------


def catmull_rom_weights(t):
    """Cardinal spline weights, tau=0.5 (transform.rs:1557-1567)."""
    t = jnp.asarray(t, jnp.float32)
    t2 = t * t
    t3 = t2 * t
    return (
        -0.5 * t3 + t2 - 0.5 * t,
        1.5 * t3 - 2.5 * t2 + 1.0,
        -1.5 * t3 + 2.0 * t2 + 0.5 * t,
        0.5 * t3 - 0.5 * t2,
    )


def catmull_rom_surface(points, cols, rows, u_global, v_global):
    """Bicubic CR surface over a (rows+1)x(cols+1) control grid; u in [0,cols],
    v in [0,rows] (transform.rs:1586-1646).  `points` is [(rows+1)*(cols+1), 2]."""
    points = jnp.asarray(points, jnp.float32)
    pts_per_row = cols + 1
    num_rows = rows + 1

    col_f = jnp.clip(jnp.asarray(u_global, jnp.float32), 0.0, f32(cols) - f32(0.0001))
    row_f = jnp.clip(jnp.asarray(v_global, jnp.float32), 0.0, f32(rows) - f32(0.0001))
    ci = jnp.minimum(col_f.astype(jnp.int32), cols - 1)
    ri = jnp.minimum(row_f.astype(jnp.int32), rows - 1)
    u = col_f - ci.astype(jnp.float32)
    v = row_f - ri.astype(jnp.float32)

    wu = catmull_rom_weights(u)
    wv = catmull_rom_weights(v)
    cu = [jnp.maximum(ci - 1, 0), ci, jnp.minimum(ci + 1, pts_per_row - 1),
          jnp.minimum(ci + 2, pts_per_row - 1)]
    rv = [jnp.maximum(ri - 1, 0), ri, jnp.minimum(ri + 1, num_rows - 1),
          jnp.minimum(ri + 2, num_rows - 1)]

    out_x = 0.0
    out_y = 0.0
    for j in range(4):
        base = rv[j] * pts_per_row
        row_x = 0.0
        row_y = 0.0
        for k in range(4):
            p = points[base + cu[k]]
            row_x = row_x + wu[k] * p[..., 0]
            row_y = row_y + wu[k] * p[..., 1]
        out_x = out_x + wv[j] * row_x
        out_y = out_y + wv[j] * row_y
    return out_x, out_y


@functools.lru_cache(maxsize=16)
def _mesh_disp_fn(cols, rows, out_w, out_h, fast):
    @jax.jit
    def run(original_points, deformed_points):
        xs = jnp.arange(out_w, dtype=jnp.float32)[None, :] + 0.5
        ys = jnp.arange(out_h, dtype=jnp.float32)[:, None] + 0.5
        u = exact_div(xs, f32(out_w)) * f32(cols) * jnp.ones((out_h, 1), jnp.float32)
        v = exact_div(ys, f32(out_h)) * f32(rows) * jnp.ones((1, out_w), jnp.float32)
        dx_def, dy_def = catmull_rom_surface(deformed_points, cols, rows, u, v)
        if fast:
            ox = xs * jnp.ones((out_h, 1), jnp.float32)
            oy = ys * jnp.ones((1, out_w), jnp.float32)
        else:
            ox, oy = catmull_rom_surface(original_points, cols, rows, u, v)
        return jnp.stack([dx_def - ox, dy_def - oy], axis=-1)

    return run


def generate_displacement_from_mesh(original_points, deformed_points, cols, rows,
                                    out_w, out_h, fast=False):
    """Displacement = deformed CR surface - original CR surface
    (transform.rs:1670-1741; fast path assumes identity original grid)."""
    fn = _mesh_disp_fn(int(cols), int(rows), int(out_w), int(out_h), bool(fast))
    return np.asarray(
        fn(np.asarray(original_points, f32), np.asarray(deformed_points, f32))
    )


def warp_mesh_catmull_rom(src, original_points, deformed_points, cols, rows,
                          out_w=None, out_h=None):
    """Mesh displacement + displacement warp (transform.rs:1743-1761)."""
    src = np.asarray(src)
    out_h = src.shape[0] if out_h is None else out_h
    out_w = src.shape[1] if out_w is None else out_w
    disp = generate_displacement_from_mesh(
        original_points, deformed_points, cols, rows, out_w, out_h
    )
    return warp_displacement(src, disp)


def uniform_grid(cols: int, rows: int, w: float, h: float) -> np.ndarray:
    """(rows+1)x(cols+1) control lattice spanning [0,w]x[0,h], row-major."""
    pts = np.zeros(((rows + 1) * (cols + 1), 2), f32)
    for r in range(rows + 1):
        for c in range(cols + 1):
            pts[r * (cols + 1) + c] = [
                f32(c) / f32(cols) * f32(w),
                f32(r) / f32(rows) * f32(h),
            ]
    return pts
