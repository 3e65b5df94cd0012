"""Filters & effects vs the reference goldens (mirror of visual_filters.rs)."""

import numpy as np
import pytest

from paintfe_tpu.core import fixtures
from paintfe_tpu.ops import filters
from paintfe_tpu.ops.effects import artistic, contours as contours_mod, distort, glitch
from paintfe_tpu.ops.effects import noise as noise_mod
from paintfe_tpu.ops.effects import render, stylize

from common import assert_golden


def img64():
    return fixtures.test_gradient(64, 64)


# -- blur family -------------------------------------------------------------


def test_gaussian_blur_s2():
    assert_golden("filters", "gaussian_blur_s2", filters.gaussian_blur(img64(), 2.0))


def test_gaussian_blur_s5():
    assert_golden("filters", "gaussian_blur_s5", filters.gaussian_blur(img64(), 5.0))


def test_gaussian_blur_identity():
    out = filters.gaussian_blur(img64(), 0.0)
    np.testing.assert_array_equal(np.asarray(out), img64())


def test_bokeh_blur_r5():
    assert_golden("filters", "bokeh_blur_r5", filters.bokeh_blur(img64(), 5.0))


def test_motion_blur_45_10():
    assert_golden("filters", "motion_blur_45_10", filters.motion_blur(img64(), 45.0, 10.0))


def test_box_blur_r3():
    assert_golden("filters", "box_blur_r3", filters.box_blur(img64(), 3.0))


def test_zoom_blur():
    assert_golden(
        "filters",
        "zoom_blur",
        filters.zoom_blur(img64(), 0.5, 0.5, 0.3, 8, (0.0, 0.0, 0.0, 0.0), 0.0),
    )


# -- distort -----------------------------------------------------------------


def test_crystallize_s16():
    assert_golden("filters", "crystallize_s16", distort.crystallize(img64(), 16.0, 42))


def test_dents():
    assert_golden(
        "filters", "dents", distort.dents(img64(), 20.0, 10.0, 42, 2, 0.5, False, False)
    )


def test_pixelate_8():
    assert_golden("filters", "pixelate_8", distort.pixelate(img64(), 8))


def test_pixelate_identity():
    out = np.asarray(distort.pixelate(img64(), 1))
    assert np.abs(out.astype(int) - img64().astype(int)).max() <= 5


def test_bulge_05():
    assert_golden("filters", "bulge_05", distort.bulge(img64(), 0.5))


def test_bulge_identity():
    np.testing.assert_array_equal(np.asarray(distort.bulge(img64(), 0.0)), img64())


def test_twist_45():
    assert_golden("filters", "twist_45", distort.twist(img64(), 45.0))


def test_twist_identity():
    np.testing.assert_array_equal(np.asarray(distort.twist(img64(), 0.0)), img64())


# -- noise -------------------------------------------------------------------


def test_add_noise_uniform():
    assert_golden(
        "filters",
        "add_noise_uniform",
        noise_mod.add_noise(img64(), 30.0, noise_mod.NoiseType.UNIFORM, False, 42, 1.0, 1),
    )


def test_add_noise_gaussian_mono():
    assert_golden(
        "filters",
        "add_noise_gaussian_mono",
        noise_mod.add_noise(img64(), 30.0, noise_mod.NoiseType.GAUSSIAN, True, 42, 1.0, 1),
    )


def test_add_noise_perlin():
    assert_golden(
        "filters",
        "add_noise_perlin",
        noise_mod.add_noise(img64(), 50.0, noise_mod.NoiseType.PERLIN, False, 42, 5.0, 3),
    )


def test_reduce_noise():
    assert_golden("filters", "reduce_noise", filters.reduce_noise(img64(), 0.5, 2))


def test_median_r2():
    assert_golden("filters", "median_r2", filters.median(img64(), 2))


# -- stylize -----------------------------------------------------------------


def test_glow_r3_i05():
    assert_golden("filters", "glow_r3_i05", filters.glow(img64(), 3.0, 0.5))


def test_sharpen_a1_r1():
    assert_golden("filters", "sharpen_a1_r1", filters.sharpen(img64(), 1.0, 1.0))


def test_sharpen_identity():
    np.testing.assert_array_equal(np.asarray(filters.sharpen(img64(), 0.0, 1.0)), img64())


def test_vignette_08_05():
    assert_golden("filters", "vignette_08_05", stylize.vignette(img64(), 0.8, 0.5))


def test_vignette_identity():
    np.testing.assert_array_equal(np.asarray(stylize.vignette(img64(), 0.0, 0.5)), img64())


def test_halftone_circle():
    assert_golden(
        "filters",
        "halftone_circle",
        stylize.halftone(img64(), 4.0, 45.0, stylize.HalftoneShape.CIRCLE),
    )


# -- render ------------------------------------------------------------------


def test_grid_lines_16():
    assert_golden(
        "filters",
        "grid_lines_16",
        render.grid(img64(), 16, 16, 1, (0, 0, 0, 255), render.GridStyle.LINES, 1.0),
    )


def _square_on_transparent(color):
    img = fixtures.transparent(64, 64)
    img[16:48, 16:48] = color
    return img


def test_drop_shadow():
    img = _square_on_transparent([255, 255, 255, 255])
    assert_golden(
        "filters", "drop_shadow", render.drop_shadow(img, 5, 5, 3.0, False, (0, 0, 0, 255), 0.8)
    )


def test_outline_outside():
    img = _square_on_transparent([255, 0, 0, 255])
    assert_golden(
        "filters",
        "outline_outside",
        render.outline(img, 2, (0, 0, 255, 255), render.OutlineMode.OUTSIDE, True),
    )


def test_contours():
    assert_golden(
        "filters",
        "contours",
        contours_mod.contours(img64(), 10.0, 5.0, 1.0, (0, 0, 0, 255), 42, 2, 0.5),
    )


def test_canvas_border():
    # visual_filters.rs:229 uses a colored 2px border
    img = img64()
    out = np.asarray(render.canvas_border(img, 2, (255, 0, 0, 255)))
    assert (out[0:2] == [255, 0, 0, 255]).all()
    assert (out[:, 0:2] == [255, 0, 0, 255]).all()
    np.testing.assert_array_equal(out[2:-2, 2:-2], img[2:-2, 2:-2])


# -- glitch ------------------------------------------------------------------


def test_pixel_drag():
    assert_golden("filters", "pixel_drag", glitch.pixel_drag(img64(), 42, 50.0, 20, 0.0))


def test_rgb_displace():
    assert_golden(
        "filters", "rgb_displace", glitch.rgb_displace(img64(), (5, 0), (0, 0), (-5, 0))
    )


# -- artistic ----------------------------------------------------------------


def test_ink():
    assert_golden("filters", "ink", artistic.ink(img64(), 1.0, 0.5))


def test_oil_painting():
    assert_golden("filters", "oil_painting", artistic.oil_painting(img64(), 3, 20))


def test_color_filter_multiply():
    # visual_filters.rs:276 params
    assert_golden(
        "filters",
        "color_filter_multiply",
        artistic.color_filter(img64(), (255, 128, 0, 255), 0.5, artistic.ColorFilterMode.MULTIPLY),
    )


def test_color_filter_identity():
    out = artistic.color_filter(
        img64(), (255, 255, 255, 255), 0.0, artistic.ColorFilterMode.MULTIPLY
    )
    np.testing.assert_array_equal(np.asarray(out), img64())


def test_median_network_matches_numpy_sort_any_radius():
    """The compare-exchange network must equal a full sort's median pick
    (it is fused min/max elementwise ops instead of a sort)."""
    rng = np.random.default_rng(5)
    for r in (1, 2, 3):
        img = rng.integers(0, 256, (40, 37, 4), np.uint8)
        pad = np.pad(img, ((r, r), (r, r), (0, 0)), mode="edge")
        wins = np.stack([
            pad[dy:dy + 40, dx:dx + 37]
            for dy in range(2 * r + 1) for dx in range(2 * r + 1)
        ])
        expect = np.sort(wins, axis=0)[wins.shape[0] // 2]
        out = np.asarray(filters.median(img, r))
        np.testing.assert_array_equal(out, expect, err_msg=f"r={r}")


@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_median_matches_numpy_window_sort(r):
    """filters.median at every radius the GPU path serves equals a numpy
    window sort with edge-replicated borders, on a non-square image whose
    sides are not multiples of any tile size."""
    rng = np.random.default_rng(100 + r)
    h, w = 45, 70
    img = rng.integers(0, 256, (h, w, 4), np.uint8)
    pad = np.pad(img, ((r, r), (r, r), (0, 0)), mode="edge")
    wins = np.stack([pad[dy:dy + h, dx:dx + w]
                     for dy in range(2 * r + 1) for dx in range(2 * r + 1)])
    expect = np.sort(wins, axis=0)[wins.shape[0] // 2]
    np.testing.assert_array_equal(np.asarray(filters.median(img, r)), expect)

