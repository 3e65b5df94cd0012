"""The headline chain (ops/fused_chain.fused_chain) equals the public ops
run one after another: XLA's fusion of the chain must not change a value."""

import jax
import numpy as np
import pytest

from paintfe_tpu.core.blend import BlendMode, blend_u8
from paintfe_tpu.ops import filters
from paintfe_tpu.ops.fused_chain import fused_chain
from paintfe_tpu.parallel.pipeline import _bc_device, _levels_device, _sepia_device


def _stepwise(img, ov, sigma, mode, opacity):
    """Each public op as its own jitted program, results pulled to host."""
    x = np.asarray(filters.gaussian_blur(img, sigma))
    x = np.asarray(jax.jit(lambda a: _bc_device(a, 10.0, 20.0))(x))
    x = np.asarray(jax.jit(lambda a: _levels_device(a, 10.0, 245.0, 1.1))(x))
    x = np.asarray(jax.jit(lambda a: _sepia_device(a, 0.5))(x))
    return np.asarray(jax.jit(
        lambda a, b: blend_u8(a, b, int(mode), opacity))(x, ov))


@pytest.mark.parametrize("sigma,mode,opacity", [
    (2.0, BlendMode.SOFT_LIGHT, 0.6),   # BASELINE's headline parameters
    (0.0, BlendMode.SOFT_LIGHT, 0.6),   # no-tap blur
    (5.0, BlendMode.MULTIPLY, 0.35),
    (1.5, BlendMode.NORMAL, 1.0),       # opaque-top fast path
])
def test_fused_chain_equals_public_ops(sigma, mode, opacity):
    rng = np.random.default_rng(int(sigma * 10) + int(mode))
    img = rng.integers(0, 256, (61, 83, 4), np.uint8)
    ov = rng.integers(0, 256, (61, 83, 4), np.uint8)
    ov[:7, :, 3] = 0      # transparent overlay rows pass the base through
    ov[7:12, :, 3] = 255  # and opaque ones
    got = np.asarray(jax.jit(lambda a, b: fused_chain(
        a, b, sigma=sigma, blend_mode=mode, blend_opacity=opacity))(img, ov))
    np.testing.assert_array_equal(got, _stepwise(img, ov, sigma, mode, opacity))
