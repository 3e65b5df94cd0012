"""Spatial sharding: one image's rows split over the device mesh; XLA
inserts the halo exchanges for neighborhood ops (parallel/spatial.py)."""

import jax
import numpy as np
import pytest

from paintfe_tpu.core import fixtures
from paintfe_tpu.ops import filters
from paintfe_tpu.parallel import spatial
from paintfe_tpu.parallel.pipeline import _bc_device, _sepia_device


def _mesh8():
    return spatial.rows_mesh(jax.devices()[:8])


def test_spatial_blur_matches_single_device():
    """The blur needs cross-shard halos; XLA's partitioner must produce a
    bit-identical result to the unsharded run."""
    img = np.asarray(fixtures.test_gradient(64, 48))
    ref = np.asarray(jax.jit(lambda x: filters.gaussian_blur(x, 3.0))(img))
    out = np.asarray(
        spatial.process_spatial(img, lambda x: filters.gaussian_blur(x, 3.0), _mesh8())
    )
    np.testing.assert_array_equal(ref, out)


def test_spatial_chain_and_ragged_height():
    # H=61 not divisible by 8 -> edge-replicate pad + crop
    img = np.asarray(fixtures.test_checkerboard(61, 40))

    def chain(x):
        x = filters.gaussian_blur(x, 1.5)
        x = _bc_device(x, 10.0, 20.0)
        return _sepia_device(x, 0.5)

    ref = np.asarray(jax.jit(chain)(img))
    out = np.asarray(spatial.process_spatial(img, chain, _mesh8()))
    np.testing.assert_array_equal(ref, out)


def test_composite_spatial_matches():
    from paintfe_tpu.core.composite import composite_stack_static

    rng = np.random.default_rng(0)
    layers = rng.integers(0, 256, (5, 61, 40, 4), np.uint8)
    modes = (0, 8, 16, 3, 21)
    opac = np.array([1.0, 0.8, 0.5, 0.9, 0.7], np.float32)
    ref = np.asarray(composite_stack_static(layers, modes, opac))
    out = np.asarray(spatial.composite_spatial(layers, modes, opac, _mesh8()))
    np.testing.assert_array_equal(ref, out)


def test_fused_chain_spatial_matches_single_device():
    """The headline chain under shard_map: ppermute halo exchange must
    reproduce the single-device result bit-exactly, including edge shards'
    replicated halos and ragged heights."""
    from paintfe_tpu.ops.fused_chain import fused_chain
    from paintfe_tpu.parallel.spatial import fused_chain_spatial

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (61, 80, 4), np.uint8)
    ov = rng.integers(0, 256, (61, 80, 4), np.uint8)
    ref = np.asarray(jax.jit(lambda a, b: fused_chain(a, b))(img, ov))
    out = np.asarray(fused_chain_spatial(img, ov, _mesh8()))
    np.testing.assert_array_equal(ref, out)


def test_median_spatial_matches_single_device():
    """The median network under shard_map: halo-extended blocks must
    reproduce the single-device op bit-exactly, including ragged heights
    where the network's own edge-replicate pad interacts with the halo
    rows."""
    rng = np.random.default_rng(7)
    for h in (64, 61):
        img = rng.integers(0, 256, (h, 40, 4), np.uint8)
        ref = np.asarray(filters.median(img, 2))
        out = np.asarray(spatial.median_spatial(img, 2, _mesh8()))
        np.testing.assert_array_equal(ref, out)


@pytest.mark.parametrize("mode", ["zero", "clamp"])
def test_warp_spatial_matches_single_device(mode):
    """The warp gather under shard_map: source replicated, coordinate
    field row-sharded.  Must be bit-identical to the single-device gather
    for both boundary semantics."""

    rng = np.random.default_rng(9)
    h, w = 61, 50
    src = rng.integers(0, 256, (h, w, 4), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    # swirl-ish field with out-of-bounds excursions at the corners
    sx = xx + 3.0 * np.sin(yy / 9.0) - 1.5
    sy = yy + 2.0 * np.cos(xx / 7.0) + 0.75
    ref = np.asarray(jax.jit(
        lambda a, b, c: spatial._gather(a, b, c, mode))(src, sx, sy))
    out = np.asarray(spatial.warp_spatial(src, sx, sy, mode=mode,
                                          mesh=_mesh8()))
    np.testing.assert_array_equal(ref, out)


@pytest.mark.slow
def test_fused_chain_spatial_bench_shape():
    """The small-shape tests above can't catch halo bugs that only appear
    at the real bench geometry.  Full 4K (2160x3840) through the
    shard_map+ppermute chain on the 8-device mesh must be bit-identical to
    the single-device chain."""
    from paintfe_tpu.ops.fused_chain import fused_chain
    from paintfe_tpu.parallel.spatial import fused_chain_spatial

    rng = np.random.default_rng(11)
    h, w = 2160, 3840
    img = rng.integers(0, 256, (h, w, 4), np.uint8)
    ov = rng.integers(0, 256, (h, w, 4), np.uint8)
    ref = np.asarray(jax.jit(lambda a, b: fused_chain(a, b))(img, ov))
    out = np.asarray(fused_chain_spatial(img, ov, _mesh8()))
    np.testing.assert_array_equal(ref, out)


def test_spatial_tiny_image_fallback():
    """Images whose shard blocks would be shorter than the halo radius
    fall back to the single-device op (one ppermute can't source a full
    halo) — results must still match exactly."""
    from paintfe_tpu.ops.fused_chain import fused_chain

    rng = np.random.default_rng(13)
    img = rng.integers(0, 256, (20, 40, 4), np.uint8)  # 20/8 = 2.5 < r=6
    ov = rng.integers(0, 256, (20, 40, 4), np.uint8)
    ref = np.asarray(jax.jit(lambda a, b: fused_chain(a, b))(img, ov))
    out = np.asarray(spatial.fused_chain_spatial(img, ov, _mesh8()))
    np.testing.assert_array_equal(ref, out)

    img2 = rng.integers(0, 256, (12, 40, 4), np.uint8)  # 12/8 = 1.5 < r=2
    ref2 = np.asarray(filters.median(img2, 2))
    out2 = np.asarray(spatial.median_spatial(img2, 2, _mesh8()))
    np.testing.assert_array_equal(ref2, out2)


def test_fused_chain_grid_2d_mesh():
    """dp x sp: batch of images on the 2-D ('batch', 'rows') mesh — each
    image's rows halo-exchange within its 'rows' submesh while images
    spread over 'batch'.  Bit-identical to the per-image single-device
    chain, including ragged heights."""
    from paintfe_tpu.ops.fused_chain import fused_chain
    from paintfe_tpu.parallel.spatial import fused_chain_grid, grid_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (CPU harness provides them)")

    rng = np.random.default_rng(17)
    mesh = grid_mesh(2, 4, jax.devices()[:8])
    for h in (64, 61):
        imgs = rng.integers(0, 256, (4, h, 80, 4), np.uint8)
        ovs = rng.integers(0, 256, (4, h, 80, 4), np.uint8)
        ref = np.stack([
            np.asarray(jax.jit(lambda a, b: fused_chain(a, b))(imgs[i], ovs[i]))
            for i in range(4)])
        out = np.asarray(fused_chain_grid(imgs, ovs, mesh))
        np.testing.assert_array_equal(ref, out)


def test_fused_chain_spatial_zero_sigma():
    """sigma=0 makes the blur a no-tap identity (halo radius r=0): the
    shard_map path must skip the halo exchange entirely instead of building
    a zero-height edge replica (round-4 review regression — jnp.repeat(.., 0)
    used to crash the broadcast inside jnp.where)."""
    from paintfe_tpu.ops.fused_chain import fused_chain
    from paintfe_tpu.parallel.spatial import fused_chain_grid, grid_mesh

    rng = np.random.default_rng(23)
    img = rng.integers(0, 256, (64, 80, 4), np.uint8)
    ov = rng.integers(0, 256, (64, 80, 4), np.uint8)
    ref = np.asarray(fused_chain(img, ov, sigma=0.0))
    out = np.asarray(spatial.fused_chain_spatial(img, ov, _mesh8(), sigma=0.0))
    np.testing.assert_array_equal(ref, out)

    if len(jax.devices()) < 8:
        # the sigma=0 single-image leg above ran (rows_mesh degrades to
        # the available devices); the 2x4 grid leg needs the CPU harness
        pytest.skip("grid leg needs 8 devices (CPU harness provides them)")
    mesh = grid_mesh(2, 4, jax.devices()[:8])
    imgs = rng.integers(0, 256, (2, 64, 80, 4), np.uint8)
    ovs = rng.integers(0, 256, (2, 64, 80, 4), np.uint8)
    refs = np.stack([np.asarray(fused_chain(imgs[i], ovs[i], sigma=0.0))
                     for i in range(2)])
    outs = np.asarray(fused_chain_grid(imgs, ovs, mesh, sigma=0.0))
    np.testing.assert_array_equal(refs, outs)
