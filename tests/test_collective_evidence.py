"""Multi-chip communication contracts, asserted on compiled HLO.

Scaling efficiency is measured on the cards; the communication STRUCTURE
is proven here: this suite compiles the batch and spatial programs on the
8-device CPU mesh and asserts, from the compiled module text, that

  * the batch path (images are the data; SURVEY §2.9 "the real sharding
    axis") is embarrassingly parallel: ZERO inter-device collectives, so
    throughput scales linearly with chips up to input bandwidth;
  * the spatial path (one image's rows span chips) exchanges EXACTLY its
    two r-row halos per neighbor pair — 2*r*W*4 bytes per shard step —
    and nothing else (no accidental all-gather of the full image).

These tests fail if someone introduces a sharding/layout change that
makes XLA insert unplanned collectives.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

_COLLECTIVES = ("all-gather", "all-reduce", "all-to-all",
                "collective-permute")

_DTYPE_BYTES = {"u8": 1, "s8": 1, "pred": 1, "u16": 2, "s16": 2, "bf16": 2,
                "f16": 2, "u32": 4, "s32": 4, "f32": 4, "u64": 8, "s64": 8,
                "f64": 8}


def _counts(hlo: str):
    # count op definitions, not strings like "collective-permute-done"
    return {k: len(re.findall(rf"=\s*\S+\s+{k}(?:-start)?\(", hlo))
            for k in _COLLECTIVES}


def _permute_bytes(hlo: str) -> int:
    """Total bytes moved by collective-permute ops (per shard step)."""
    total = 0
    for m in re.finditer(
            r"=\s*(\w+)\[([0-9,]*)\]\S*\s+collective-permute(?:-start)?\(",
            hlo):
        dtype, dims = m.group(1), m.group(2)
        n = int(np.prod([int(d) for d in dims.split(",")])) if dims else 1
        total += n * _DTYPE_BYTES.get(dtype, 4)
    return total


def _mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh (conftest)")


def test_batch_path_has_zero_collectives():
    """The sharded CLI batch program: every image lives on one device;
    any collective would mean XLA resharded behind our back."""
    _mesh8()
    from paintfe_tpu.parallel.pipeline import (PipelineOp, _batch_fn,
                                               batch_mesh, batch_sharding)

    mesh = batch_mesh()
    ops = (PipelineOp("apply_blur", (1.5,)),
           PipelineOp("apply_brightness_contrast", (10.0, 20.0)),
           PipelineOp("apply_levels", (10.0, 245.0, 1.1)),
           PipelineOp("apply_sepia", (0.5,)),
           PipelineOp("apply_median", (1,)))
    fn = _batch_fn(ops)
    x = jax.device_put(jnp.zeros((8, 32, 32, 4), jnp.uint8),
                       batch_sharding(mesh))
    hlo = fn.lower(x).compile().as_text()
    counts = _counts(hlo)
    assert counts == {k: 0 for k in _COLLECTIVES}, counts


def test_batch_compositor_has_zero_collectives():
    _mesh8()
    from jax.sharding import NamedSharding, PartitionSpec as P

    from paintfe_tpu.core.composite import composite_stack
    from paintfe_tpu.parallel.pipeline import batch_mesh

    mesh = batch_mesh()
    modes = jnp.asarray([0, 8, 16], jnp.int32)
    opac = jnp.asarray([1.0, 0.8, 0.5], jnp.float32)
    vis = jnp.asarray([True, True, True])
    flatten = jax.jit(jax.vmap(lambda ls: composite_stack(ls, modes, opac,
                                                          vis)))
    layers = jax.device_put(jnp.zeros((8, 3, 16, 16, 4), jnp.uint8),
                            NamedSharding(mesh, P("batch")))
    hlo = flatten.lower(layers).compile().as_text()
    counts = _counts(hlo)
    assert counts == {k: 0 for k in _COLLECTIVES}, counts


@pytest.mark.parametrize("sigma,w", [(2.0, 32), (4.0, 128)])
def test_spatial_path_moves_exactly_the_halos(sigma, w):
    """fused_chain_spatial: the ONLY collectives are the two r-row halo
    ppermutes (up + down), each u8[r, W, 4] — 2*r*W*4 bytes per shard —
    regardless of image height."""
    _mesh8()
    from paintfe_tpu.ops.filters import gaussian_kernel
    from paintfe_tpu.parallel import spatial

    mesh = spatial.rows_mesh()
    r = (gaussian_kernel(float(sigma)).shape[0] - 1) // 2
    fn = spatial._fused_chain_spatial_fn(
        mesh, r, tuple(sorted(dict(sigma=float(sigma)).items())))
    img = jnp.zeros((8 * max(r, 8), w, 4), jnp.uint8)
    hlo = fn.lower(img, img).compile().as_text()
    counts = _counts(hlo)
    assert counts["all-gather"] == 0, counts
    assert counts["all-reduce"] == 0, counts
    assert counts["all-to-all"] == 0, counts
    assert counts["collective-permute"] == 2, counts
    assert _permute_bytes(hlo) == 2 * r * w * 4


def test_spatial_median_moves_exactly_the_halos():
    _mesh8()
    from paintfe_tpu.parallel import spatial

    mesh = spatial.rows_mesh()
    r = 2
    fn = spatial._median_spatial_fn(mesh, r, 8, 32)
    img = jnp.zeros((64, 32, 4), jnp.uint8)
    hlo = fn.lower(img).compile().as_text()
    counts = _counts(hlo)
    assert counts["all-gather"] == 0 and counts["all-reduce"] == 0, counts
    assert counts["collective-permute"] == 2, counts
    assert _permute_bytes(hlo) == 2 * r * 32 * 4
