"""Adjustment stack vs the reference goldens (mirror of visual_adjustments.rs)."""

import numpy as np

from paintfe_tpu.core import fixtures
from paintfe_tpu.core.canvas import canonicalize_tiles
from paintfe_tpu.ops import adjustments as adj
from paintfe_tpu.ops import luts

from common import assert_golden


def img64():
    return fixtures.test_gradient(64, 64)


def test_invert_colors():
    assert_golden("adjustments", "invert_colors", adj.invert_colors(img64()))


def test_invert_roundtrip():
    out = adj.invert_colors(adj.invert_colors(img64()))
    np.testing.assert_array_equal(np.asarray(out), img64())


def test_invert_alpha():
    # The canvas commit path drops color of fully-transparent tiles
    # (TiledImage storage semantics), which the golden bakes in.
    out = canonicalize_tiles(adj.invert_alpha(img64()))
    assert_golden("adjustments", "invert_alpha", out)


def test_invert_alpha_double():
    out = canonicalize_tiles(adj.invert_alpha(img64()))
    assert_golden("adjustments", "invert_alpha_double", out)


def test_sepia():
    assert_golden("adjustments", "sepia", adj.sepia(img64()))


def test_auto_levels():
    assert_golden("adjustments", "auto_levels", adj.auto_levels(img64()))


def test_desaturate():
    assert_golden("adjustments", "desaturate", adj.desaturate(img64()))


def test_brightness_contrast():
    assert_golden(
        "adjustments",
        "brightness_30_contrast_20",
        adj.brightness_contrast(img64(), 30.0, 20.0),
    )


def test_brightness_contrast_identity():
    out = adj.brightness_contrast(img64(), 0.0, 0.0)
    np.testing.assert_array_equal(np.asarray(out), img64())


def test_hsl():
    assert_golden(
        "adjustments",
        "hsl_h30_s-20_l10",
        adj.hue_saturation_lightness(img64(), 30.0, -20.0, 10.0),
    )


def test_hsl_identity():
    out = adj.hue_saturation_lightness(img64(), 0.0, 0.0, 0.0)
    np.testing.assert_array_equal(np.asarray(out), img64())


def test_exposure():
    assert_golden("adjustments", "exposure_1ev", adj.exposure(img64(), 1.0))


def test_exposure_identity():
    np.testing.assert_array_equal(np.asarray(adj.exposure(img64(), 0.0)), img64())


def test_highlights_shadows():
    assert_golden(
        "adjustments", "highlights_shadows", adj.highlights_shadows(img64(), 30.0, -20.0)
    )


def test_highlights_shadows_identity():
    out = adj.highlights_shadows(img64(), 0.0, 0.0)
    np.testing.assert_array_equal(np.asarray(out), img64())


def test_levels():
    assert_golden(
        "adjustments", "levels", adj.levels(img64(), 20.0, 235.0, 1.2, 0.0, 255.0)
    )


def test_levels_identity():
    out = adj.levels(img64(), 0.0, 255.0, 1.0, 0.0, 255.0)
    np.testing.assert_array_equal(np.asarray(out), img64())


def test_temperature_tint():
    assert_golden(
        "adjustments", "temperature_tint", adj.temperature_tint(img64(), 30.0, 10.0)
    )


def test_curves_identity():
    empty = []
    channels = [(empty, False)] * 5
    out = adj.curves(img64(), channels)
    np.testing.assert_array_equal(np.asarray(out), img64())


def test_threshold():
    assert_golden("adjustments", "threshold_128", adj.threshold(img64(), 128.0))


def test_posterize():
    assert_golden("adjustments", "posterize_4", adj.posterize(img64(), 4))


def test_color_balance():
    assert_golden(
        "adjustments",
        "color_balance",
        adj.color_balance(
            img64(), [10.0, 0.0, -10.0], [0.0, 0.0, 0.0], [-10.0, 0.0, 10.0]
        ),
    )


def test_color_balance_identity():
    out = adj.color_balance(img64(), [0.0] * 3, [0.0] * 3, [0.0] * 3)
    np.testing.assert_array_equal(np.asarray(out), img64())


def _warm_lut():
    # Matches the golden generator: black -> dark red -> orange -> yellow -> white
    f = np.float32
    lut = np.zeros((256, 4), np.uint8)
    for i in range(256):
        t = f(i) / f(255.0)
        lut[i] = [
            int(t * f(255.0)),
            int(t * t * f(200.0)),
            int(t * t * t * f(150.0)),
            255,
        ]
    return lut


def test_gradient_map():
    assert_golden("adjustments", "gradient_map", adj.gradient_map(img64(), _warm_lut()))


def test_black_and_white():
    img = fixtures.color_bands(64, 64)
    assert_golden(
        "adjustments", "black_and_white", adj.black_and_white(img, 0.3, 0.59, 0.11)
    )


def test_vibrance():
    assert_golden("adjustments", "vibrance_50", adj.vibrance(img64(), 50.0))


def test_vibrance_identity():
    np.testing.assert_array_equal(np.asarray(adj.vibrance(img64(), 0.0)), img64())


def test_mask_passthrough():
    img = img64()
    mask = np.zeros((64, 64), np.uint8)
    mask[:, :32] = 255
    out = np.asarray(adj.invert_colors(img, mask))
    assert (out[:, :32] == 255 - img[:, :32] * np.array([1, 1, 1, 0]) - np.array([0, 0, 0, -1]) * img[:, :32]).any()
    np.testing.assert_array_equal(out[:, 32:], img[:, 32:])


def test_lut_composition_fuses_chain():
    # levels(a) then levels(b) == composed LUT applied once
    img = img64()
    l1 = luts.levels_lut(20.0, 235.0, 1.2, 0.0, 255.0)
    l2 = luts.levels_lut(0.0, 255.0, 0.8, 10.0, 245.0)
    step = adj.apply_rgb_lut(np.asarray(adj.apply_rgb_lut(img, l1)), l2)
    fused = adj.apply_rgb_lut(img, luts.compose_luts(l1, l2))
    np.testing.assert_array_equal(np.asarray(step), np.asarray(fused))


def test_direct_builders_are_cached():
    """The jitted per-shape builders must be lru-cached (CLAUDE.md: a fresh
    jit closure per call is a cache MISS every call)."""
    from paintfe_tpu.ops import filters as flt

    assert flt._median_fn(1, 16, 16) is flt._median_fn(1, 16, 16)
    assert flt._gaussian_fn(2.0, 16, 16) is flt._gaussian_fn(2.0, 16, 16)
    assert flt._box_fn(2, 16, 16) is flt._box_fn(2, 16, 16)
    assert flt._reduce_noise_fn(30.0, 2, 16, 16) is \
        flt._reduce_noise_fn(30.0, 2, 16, 16)
