"""Spatial sharding: one huge canvas split across devices.

Batch sharding (parallel/pipeline.py) covers the many-images case; this
module covers the one-giant-image case (the reference clamps documents at
256 Mpix — src/canvas/tiled_image.rs:14-26 — whose f32 intermediates
outgrow one card's memory).  The image's row axis is sharded
over the mesh with `jax.sharding.NamedSharding`; ops stay the ordinary
jitted functions, and XLA's SPMD partitioner inserts the halo exchanges
(collective-permutes) that neighborhood ops like the separable
blur need at shard boundaries — no manual communication code, and results
are bit-identical to the single-device run.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def rows_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the row axis of a single image."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devices), ("rows",))


def rows_sharding(mesh: Mesh) -> NamedSharding:
    """[H, W, 4] image sharded by rows."""
    return NamedSharding(mesh, P("rows", None, None))


def process_spatial(img, fn: Callable, mesh: Optional[Mesh] = None):
    """Run `fn(image) -> image` on one image with its rows sharded over the
    mesh.  `fn` is any jittable op or op chain built from this framework's
    kernels; XLA partitions it and adds the boundary halo exchanges.

    Pads H to a multiple of the mesh size (edge-replicate, so convolution
    taps see the same neighborhood as the unpadded image) and crops back.
    Returns a committed sharded device array; np.asarray() gathers it.
    """
    mesh = mesh if mesh is not None else rows_mesh()
    n = mesh.devices.size
    img = jnp.asarray(img)
    h = img.shape[0]
    pad = (-h) % n
    if pad:
        img = jnp.concatenate([img, jnp.repeat(img[-1:], pad, axis=0)], axis=0)
    sharding = rows_sharding(mesh)
    sharded = jax.device_put(img, sharding)
    out = _process_spatial_fn(fn, sharding)(sharded)
    return out[:h] if pad else out


@functools.lru_cache(maxsize=64)
def _process_spatial_fn(fn: Callable, sharding):
    """Cached jit wrapper per (fn, sharding) — a fresh jax.jit per call is
    a jit cache MISS every call, which retraces and recompiles)."""
    return jax.jit(fn, out_shardings=sharding)


def composite_spatial(layers, modes, opacities, mesh: Optional[Mesh] = None):
    """Flatten a layer stack whose rows are sharded over the mesh: the
    [N, H, W, 4] stack is placed with H split across devices and the fused
    static compositor runs fully parallel (pointwise — no halos needed)."""
    from paintfe_tpu.core.composite import composite_stack_static

    mesh = mesh if mesh is not None else rows_mesh()
    n = mesh.devices.size
    layers = jnp.asarray(layers, jnp.uint8)
    h = layers.shape[1]
    pad = (-h) % n
    if pad:
        layers = jnp.pad(layers, ((0, 0), (0, pad), (0, 0), (0, 0)))
    sharding = NamedSharding(mesh, P(None, "rows", None, None))
    placed = jax.device_put(layers, sharding)
    modes = tuple(int(m) for m in modes)
    opacities = jnp.asarray(opacities, jnp.float32)
    out = composite_stack_static(placed, modes, opacities)
    return out[:h]


@functools.lru_cache(maxsize=32)
def _fused_chain_spatial_fn(mesh: Mesh, r: int, params_items: tuple):
    """Jitted shard_map program for (mesh, halo radius, params) — cached so
    repeated calls are jit cache HITS (a fresh shard_map closure per call
    would retrace + relower every frame)."""
    from paintfe_tpu.ops.fused_chain import fused_chain

    n = mesh.devices.size
    params = dict(params_items)

    def local(block, ov_block):
        if r == 0:  # blur has no taps (sigma ~ 0): pointwise, no halo
            return fused_chain(block, ov_block, **params)
        extended = _halo_extend(block, r, n)
        ov_ext = jnp.pad(ov_block, ((r, r), (0, 0), (0, 0)))
        out = fused_chain(extended, ov_ext, **params)
        return out[r:-r]

    fn = _shard_map(local, mesh, (P("rows", None, None),) * 2,
                    P("rows", None, None))
    return jax.jit(fn)


def grid_mesh(n_batch: int, n_rows: int,
              devices: Optional[Sequence] = None) -> Mesh:
    """2-D mesh ('batch', 'rows'): data parallelism over images x spatial
    parallelism within each image, for batches of canvases whose f32
    intermediates outgrow one card."""
    devices = list(devices) if devices is not None else jax.devices()
    assert len(devices) >= n_batch * n_rows, (
        f"need {n_batch * n_rows} devices, have {len(devices)}")
    grid = np.array(devices[:n_batch * n_rows]).reshape(n_batch, n_rows)
    return Mesh(grid, ("batch", "rows"))


@functools.lru_cache(maxsize=32)
def _fused_chain_grid_fn(mesh: Mesh, r: int, params_items: tuple):
    """Jitted shard_map program over the 2-D ('batch', 'rows') mesh: each
    device holds a [B/nb, H/nr, W, 4] block, exchanges its r boundary rows
    with its 'rows' neighbors (ppermute moves the whole local batch slab
    in one collective), and runs the headline chain vmapped over its
    local images."""
    from paintfe_tpu.ops.fused_chain import fused_chain

    n_rows = mesh.shape["rows"]
    params = dict(params_items)

    def local(blk, ov_blk):  # [b, h_blk, w, 4] u8 x2
        if r == 0:  # blur has no taps (sigma ~ 0): pointwise, no halo
            ext, ov_ext = blk, ov_blk
        else:
            idx = jax.lax.axis_index("rows")
            up = jax.lax.ppermute(blk[:, -r:], "rows",
                                  [(i, i + 1) for i in range(n_rows - 1)])
            down = jax.lax.ppermute(blk[:, :r], "rows",
                                    [(i + 1, i) for i in range(n_rows - 1)])
            top = jnp.where(idx == 0, jnp.repeat(blk[:, :1], r, axis=1), up)
            bottom = jnp.where(idx == n_rows - 1,
                               jnp.repeat(blk[:, -1:], r, axis=1), down)
            ext = jnp.concatenate([top, blk, bottom], axis=1)
            ov_ext = jnp.concatenate(
                [jnp.zeros_like(top), ov_blk, jnp.zeros_like(bottom)], axis=1)

        def one(img, ov):
            out = fused_chain(img, ov, **params)
            return out[r:-r] if r else out

        return jax.vmap(one)(ext, ov_ext)

    fn = _shard_map(local, mesh,
                    (P("batch", "rows", None, None),) * 2,
                    P("batch", "rows", None, None))
    return jax.jit(fn)


def fused_chain_grid(imgs, overlays, mesh: Mesh, **params):
    """The headline fused chain over a batch of images on the 2-D
    ('batch', 'rows') mesh: images shard over 'batch', each image's rows
    over 'rows' with a ppermute halo exchange.  Bit-identical to running
    fused_chain per image on one device.  B must be padded to a
    multiple of the batch axis by the caller (or pass B divisible)."""
    from paintfe_tpu.ops.filters import gaussian_kernel

    nb, nr = mesh.shape["batch"], mesh.shape["rows"]
    sigma = params.get("sigma", 2.0)
    r = int(gaussian_kernel(float(sigma)).shape[0] - 1) // 2

    imgs = jnp.asarray(imgs, jnp.uint8)
    overlays = jnp.asarray(overlays, jnp.uint8)
    b, h = imgs.shape[0], imgs.shape[1]
    if b % nb != 0:
        raise ValueError(f"batch {b} not divisible by mesh batch axis {nb}")
    pad = (-h) % nr
    if (h + pad) // nr < r:
        from paintfe_tpu.ops.fused_chain import fused_chain

        outs = [fused_chain(imgs[i], overlays[i], **params)
                for i in range(b)]
        return jnp.stack(outs, axis=0)
    if pad:
        imgs = jnp.concatenate(
            [imgs, jnp.repeat(imgs[:, -1:], pad, axis=1)], axis=1)
        overlays = jnp.concatenate(
            [overlays, jnp.repeat(overlays[:, -1:], pad, axis=1)], axis=1)
    sharding = NamedSharding(mesh, P("batch", "rows", None, None))
    fn = _fused_chain_grid_fn(mesh, r, tuple(sorted(params.items())))
    out = fn(jax.device_put(imgs, sharding),
             jax.device_put(overlays, sharding))
    return out[:, :h]


def _shard_map(local, mesh, in_specs, out_specs):
    """shard_map with the varying-manual-axes checker off: the edge shards'
    jnp.where between a ppermuted halo and their own replicated edge rows
    mixes values the checker would have to prove device-varying."""
    from jax import shard_map

    return shard_map(local, mesh=mesh, in_specs=in_specs,
                     out_specs=out_specs, check_vma=False)


def _halo_extend(block, r, n):
    """Exchange r boundary rows with mesh neighbors (ppermute);
    edge shards replicate their own edge rows (matches single-device
    edge-pad semantics)."""
    idx = jax.lax.axis_index("rows")
    up = jax.lax.ppermute(block[-r:], "rows",
                          [(i, i + 1) for i in range(n - 1)])
    down = jax.lax.ppermute(block[:r], "rows",
                            [(i + 1, i) for i in range(n - 1)])
    top = jnp.where(idx == 0, jnp.repeat(block[:1], r, axis=0), up)
    bottom = jnp.where(idx == n - 1, jnp.repeat(block[-1:], r, axis=0), down)
    return jnp.concatenate([top, block, bottom], axis=0)


@functools.lru_cache(maxsize=32)
def _median_spatial_fn(mesh: Mesh, r: int, hb: int, w: int):
    """Jitted shard_map program for the window median: each shard
    halo-extends its row block by r (ppermute) and runs the median network
    (ops/filters._median_fn) on the extended block.  The network's own
    edge-replicate padding then only affects the halo rows, which are
    cropped, so results are bit-identical to the single-device op."""
    from paintfe_tpu.ops.filters import _median_fn

    n = mesh.devices.size
    median = _median_fn(r, hb + 2 * r, w)

    def local(block):
        return median(_halo_extend(block, r, n))[r:-r]

    fn = _shard_map(local, mesh, (P("rows", None, None),),
                    P("rows", None, None))
    return jax.jit(fn)


def median_spatial(img, r: int, mesh: Optional[Mesh] = None):
    """Window median of one row-sharded image on the mesh; bit-identical
    to ops/filters.median single-device."""
    from paintfe_tpu.ops.filters import median

    mesh = mesh if mesh is not None else rows_mesh()
    n = mesh.devices.size
    img = jnp.asarray(img, jnp.uint8)
    if r <= 0:
        return img  # the identity window
    h, w = img.shape[0], img.shape[1]
    if (h + ((-h) % n)) // n < r:
        # shard blocks shorter than the halo radius can't source their
        # neighbors' r rows from one ppermute
        return median(img, r)
    pad = (-h) % n
    if pad:
        img = jnp.concatenate([img, jnp.repeat(img[-1:], pad, axis=0)], axis=0)
    placed = jax.device_put(img, rows_sharding(mesh))
    out = _median_spatial_fn(mesh, int(r), (h + pad) // n, w)(placed)
    return out[:h]


def _gather(src, sx, sy, mode: str):
    """Bilinear u8 gather at absolute source coordinates: "zero" is the
    displacement warp's transparent-outside sampler, "clamp" the distort
    effects' edge-clamped one."""
    from paintfe_tpu.ops.effects.distort import sample_bilinear
    from paintfe_tpu.ops.transform import _bilinear_gather_zero
    from paintfe_tpu.utils.quant import round_u8

    if mode == "zero":
        return _bilinear_gather_zero(src, sx, sy, src.shape[0], src.shape[1])[0]
    return round_u8(sample_bilinear(src, sx, sy))


@functools.lru_cache(maxsize=32)
def _warp_spatial_fn(mesh: Mesh, mode: str):
    """Jitted shard_map program for the warp gather: the source image is
    replicated (a warp gathers from arbitrary rows, so locality can't be
    assumed) and the coordinate field is row-sharded."""
    fn = _shard_map(lambda src, sx, sy: _gather(src, sx, sy, mode), mesh,
                    (P(None, None, None), P("rows", None), P("rows", None)),
                    P("rows", None, None))
    return jax.jit(fn)


def warp_spatial(src, sx, sy, mode: str = "zero",
                 mesh: Optional[Mesh] = None):
    """Bilinear warp gather with the coordinate field row-sharded over the
    mesh; bit-identical to the single-device gather (`_gather`)."""
    mesh = mesh if mesh is not None else rows_mesh()
    n = mesh.devices.size
    src_u8 = jnp.asarray(src, jnp.uint8)
    sxf = jnp.asarray(sx, jnp.float32)
    syf = jnp.asarray(sy, jnp.float32)
    h = sxf.shape[0]
    pad = (-h) % n
    if pad:  # pad rows replicate the last row's coordinates, then crop
        sxf = jnp.concatenate([sxf, jnp.repeat(sxf[-1:], pad, axis=0)], axis=0)
        syf = jnp.concatenate([syf, jnp.repeat(syf[-1:], pad, axis=0)], axis=0)
    sharding = NamedSharding(mesh, P("rows", None))
    out = _warp_spatial_fn(mesh, mode)(
        jax.device_put(src_u8, NamedSharding(mesh, P(None, None, None))),
        jax.device_put(sxf, sharding), jax.device_put(syf, sharding))
    return out[:h]


def fused_chain_spatial(img, overlay, mesh: Optional[Mesh] = None, **params):
    """The headline chain (ops/fused_chain.fused_chain) over a row-sharded
    mesh: each shard exchanges its r boundary rows with its neighbors
    (jax.lax.ppermute), runs the chain on its halo-extended block, and
    crops.  Boundary shards replicate their own edge rows where no
    neighbor exists, so the result is bit-identical to the single-device
    chain.
    """
    from paintfe_tpu.ops.filters import gaussian_kernel
    from paintfe_tpu.ops.fused_chain import fused_chain

    mesh = mesh if mesh is not None else rows_mesh()
    n = mesh.devices.size
    sigma = params.get("sigma", 2.0)
    r = int(gaussian_kernel(float(sigma)).shape[0] - 1) // 2

    img = jnp.asarray(img, jnp.uint8)
    overlay = jnp.asarray(overlay, jnp.uint8)
    h = img.shape[0]
    if (h + ((-h) % n)) // n < r:
        # shard blocks shorter than the blur radius can't fill their halo
        # from one neighbor ppermute; run the single-device chain
        return fused_chain(img, overlay, **params)
    pad = (-h) % n
    if pad:
        img = jnp.concatenate([img, jnp.repeat(img[-1:], pad, axis=0)], axis=0)
        overlay = jnp.concatenate(
            [overlay, jnp.repeat(overlay[-1:], pad, axis=0)], axis=0
        )
    sharding = rows_sharding(mesh)
    fn = _fused_chain_spatial_fn(mesh, r, tuple(sorted(params.items())))
    placed = jax.device_put(img, sharding)
    ov_placed = jax.device_put(overlay, sharding)
    out = fn(placed, ov_placed)
    return out[:h]
