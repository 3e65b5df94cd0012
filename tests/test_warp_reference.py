"""The XLA bilinear warp gathers against a plain numpy reference.

Two samplers share the warp family: "zero" (transform.warp_displacement:
transparent outside the source) and "clamp" (the distort effects'
edge-clamped sample_bilinear).  The reference restates each in numpy f32
with the same operation order, so the comparison is exact.
"""

import jax
import numpy as np
import pytest

from paintfe_tpu.ops import transform as tfm
from paintfe_tpu.parallel import spatial

f32 = np.float32
H, W = 37, 53


def _round_u8(x):
    return np.clip(np.floor(x + f32(0.5)), 0, 255).astype(np.uint8)


def _ref_zero(src, sx, sy):
    h, w = src.shape[:2]
    x0 = np.floor(sx).astype(np.int32)
    y0 = np.floor(sy).astype(np.int32)
    fx = (sx - x0.astype(f32))[..., None]
    fy = (sy - y0.astype(f32))[..., None]

    def at(xi, yi):
        inb = (xi >= 0) & (yi >= 0) & (xi < w) & (yi < h)
        p = src[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)].astype(f32)
        return np.where(inb[..., None], p, f32(0))

    tl, tr = at(x0, y0), at(x0 + 1, y0)
    bl, br = at(x0, y0 + 1), at(x0 + 1, y0 + 1)
    top = tl + (tr - tl) * fx
    bot = bl + (br - bl) * fx
    out = _round_u8(top + (bot - top) * fy)
    oob = (x0 < -1) | (y0 < -1) | (x0 >= w) | (y0 >= h)
    return np.where(oob[..., None], np.uint8(0), out)


def _ref_clamp(src, sx, sy):
    h, w = src.shape[:2]
    x0 = np.floor(sx).astype(np.int32)
    y0 = np.floor(sy).astype(np.int32)
    dx = (sx - x0.astype(f32))[..., None]
    dy = (sy - y0.astype(f32))[..., None]

    def at(xi, yi):
        return src[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)].astype(f32)

    one = f32(1)
    v = (at(x0, y0) * (one - dx) * (one - dy)
         + at(x0 + 1, y0) * dx * (one - dy)
         + at(x0, y0 + 1) * (one - dx) * dy
         + at(x0 + 1, y0 + 1) * dx * dy)
    return _round_u8(v)


def _field(kind):
    rng = np.random.default_rng(0 if kind == "random" else 1)
    yy, xx = np.mgrid[0:H, 0:W].astype(f32)
    if kind == "random":
        dx, dy = rng.normal(0, 3, (2, H, W)).astype(f32)
    else:  # swings far past every border
        dx = (90 * np.sin(yy / 5.0) + rng.normal(0, 1, (H, W))).astype(f32)
        dy = (70 * np.cos(xx / 7.0)).astype(f32)
    return np.stack([dx, dy], -1)


def _src():
    return np.random.default_rng(5).integers(0, 256, (H, W, 4), np.uint8)


@pytest.mark.parametrize("kind", ["random", "large"])
@pytest.mark.parametrize("mode", ["zero", "clamp"])
def test_gather_matches_numpy(mode, kind):
    src = _src()
    disp = _field(kind)
    yy, xx = np.mgrid[0:H, 0:W].astype(f32)
    sx, sy = xx - disp[..., 0], yy - disp[..., 1]
    got = np.asarray(jax.jit(
        lambda a, b, c: spatial._gather(a, b, c, mode))(src, sx, sy))
    ref = _ref_zero if mode == "zero" else _ref_clamp
    np.testing.assert_array_equal(got, ref(src, sx, sy))


@pytest.mark.parametrize("kind", ["random", "large"])
def test_warp_displacement_matches_numpy(kind):
    """The public Liquify entry: output(x, y) = src(x - dx, y - dy)."""
    src = _src()
    disp = _field(kind)
    yy, xx = np.mgrid[0:H, 0:W].astype(f32)
    got = np.asarray(tfm.warp_displacement(src, disp))
    np.testing.assert_array_equal(
        got, _ref_zero(src, xx - disp[..., 0], yy - disp[..., 1]))
