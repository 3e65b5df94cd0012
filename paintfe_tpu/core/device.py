"""Device-residency management — the accelerator buffer cache.

Behavioral contract: src/gpu/renderer.rs — per-layer texture cache keyed by
a generation counter (`ensure_layer_texture` :324, `layer_is_current` :427),
VRAM accounting (:953-965), and the transfer-minimisation discipline
(upload only what changed; keep composites device-resident).  Here the
"texture" is a jax device array; jit outputs stay in HBM until the host
asks for bytes, so the cache's job is avoiding re-uploads of unchanged
layers between composites.

The device composite paths mirror Canvas.composite exactly — layer masks
(conceal), the interactive preview overlay, and in-stream adjustment
layers with the active-tile discipline — so the interactive rendering
path and the host flatten produce identical bytes.
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class DeviceLayerCache:
    """Keeps layer buffers (pixels + mask) device-resident.

    Entries hold the host array they were uploaded from and revalidate by
    object identity.  The document-model invariant making this sound:
    every op REPLACES ``layer.pixels``/``layer.mask`` with a fresh array,
    never mutates in place (ops/canvas_ops.py, ops/canvas_transform.py
    enforce this at each slice-write site) — an in-place writer would
    silently serve the stale upload forever.  ``generation`` remains for
    callers that do carry explicit counters.  Because
    the entry pins the host array, a recycled ``id()`` can never alias a
    dead buffer.  A weakref finalizer evicts a layer's entries when the
    layer itself is garbage-collected (renderer.rs frees textures for
    dropped layers, :427-447); without it dead device buffers would pin
    HBM forever and a recycled layer id could return stale pixels.
    """

    def __init__(self, device=None):
        self.device = device
        # (layer id, slot) -> (generation, host array, device array, weakref)
        self._cache: Dict[Tuple[int, str], Tuple[int, object, object, object]] = {}

    def get(self, layer, generation: Optional[int] = None, slot: str = "pixels"):
        """Device array for `layer.pixels` (or `layer.mask` with
        slot="mask"), uploading only when stale."""
        host = layer.pixels if slot == "pixels" else layer.mask
        key = (id(layer), slot)
        gen = generation if generation is not None else -1
        hit = self._cache.get(key)
        if hit is not None:
            old_gen, old_host, dev, _ = hit
            if old_host is host and (generation is None or old_gen == gen):
                return dev
        dev = jnp.asarray(np.ascontiguousarray(host, np.uint8))
        if self.device is not None:
            dev = jax.device_put(dev, self.device)
        ref = weakref.ref(layer, lambda _, k=key, c=self._cache: c.pop(k, None))
        self._cache[key] = (gen, host, dev, ref)
        return dev

    def invalidate(self, layer):
        self._cache.pop((id(layer), "pixels"), None)
        self._cache.pop((id(layer), "mask"), None)

    def clear(self):
        self._cache.clear()

    def memory_bytes(self) -> int:
        """Device-memory accounting (renderer.rs:953-965 analogue)."""
        return sum(int(np.prod(dev.shape))
                   for _, _, dev, _ in self._cache.values())

    def resident_count(self) -> int:
        return len({lid for lid, _ in self._cache})


def _layer_conceal(canvas, cache: DeviceLayerCache, layer):
    """Device conceal mask for a layer, or None when no live mask."""
    if layer.mask is not None and layer.mask_enabled:
        return cache.get(layer, slot="mask")
    return None


def composite_device(canvas, cache: DeviceLayerCache):
    """Composite with device-resident layers; returns a device array (no
    readback — the composite_to_gpu analogue, renderer.rs:805).  Bit-equal
    to Canvas.composite: conceal masks, preview pre-blend, and in-stream
    adjustment layers with the active-tile mask all apply."""
    from paintfe_tpu.core.composite import composite_stack_static

    vis = [
        (i, l) for i, l in enumerate(canvas.layers)
        if canvas.layer_effectively_visible(i)
    ]
    if not vis:
        return jnp.zeros((canvas.height, canvas.width, 4), jnp.uint8)

    acc = jnp.zeros((canvas.height, canvas.width, 4), jnp.uint8)
    run = []  # (device pixels, mode, opacity, device conceal or None)

    def flush(acc):
        if not run:
            return acc
        stack = jnp.stack([p for p, _, _, _ in run])
        modes = tuple(m for _, m, _, _ in run)
        opacities = jnp.asarray([o for _, _, o, _ in run], jnp.float32)
        conceal = None
        if any(c is not None for *_, c in run):
            zero = jnp.zeros((canvas.height, canvas.width), jnp.uint8)
            conceal = jnp.stack([c if c is not None else zero
                                 for *_, c in run])
        run.clear()
        return composite_stack_static(stack, modes, opacities, conceal,
                                      init=acc)

    has_adjustment = False
    for idx, layer in vis:
        if layer.content == "adjustment" and layer.adjustment is not None:
            has_adjustment = True
            acc = flush(acc)
            acc = layer.adjustment.apply_with_opacity(acc, layer.opacity,
                                                      xp=jnp)
        else:
            if idx == canvas.active_layer_index and canvas.preview is not None:
                # preview content changes every frame; no cache win to lose
                px = jnp.asarray(canvas._apply_preview(layer.pixels))
            else:
                px = cache.get(layer)
            run.append((px, int(layer.blend_mode), layer.opacity,
                        _layer_conceal(canvas, cache, layer)))
    out = flush(acc)
    if has_adjustment:
        tile_mask = canvas.active_tile_mask(vis)
        if tile_mask is not None:
            out = jnp.where(jnp.asarray(tile_mask)[..., None], out,
                            jnp.uint8(0))
    return out


def _bucket(v: int, step: int = 64) -> int:
    return ((v + step - 1) // step) * step


def composite_dirty_rect(canvas, cache: DeviceLayerCache, prev, rect):
    """Incremental recompute: re-composite only the dirty window and splice
    it into the previous device-resident composite.

    The reference's interactive loop recomposites and reads back only the
    dirty rect (canvas_state.rs:1511-1531 mark_dirty, renderer.rs:588
    dirty readback); the analogue here is a windowed composite +
    lax.dynamic_update_slice, leaving everything in device memory.  Window sizes are
    bucketed to 64 px so brush-sized edits reuse one compiled program.
    Every pointwise stage of the full composite (conceal, preview,
    adjustment + tile mask) applies identically on the window, so the
    splice is bit-equal to a full recomposite.

    rect = (x0, y0, x1, y1) inclusive; `prev` is a [H, W, 4] device array.
    """
    from paintfe_tpu.core.composite import composite_stack_static

    x0, y0, x1, y1 = rect
    x0 = max(int(x0), 0)
    y0 = max(int(y0), 0)
    x1 = min(int(x1), canvas.width - 1)
    y1 = min(int(y1), canvas.height - 1)
    if x1 < x0 or y1 < y0:
        return prev
    bw = min(_bucket(x1 - x0 + 1), canvas.width - x0)
    bh = min(_bucket(y1 - y0 + 1), canvas.height - y0)

    vis = [
        (i, l) for i, l in enumerate(canvas.layers)
        if canvas.layer_effectively_visible(i)
    ]
    if not vis:
        patch = jnp.zeros((bh, bw, 4), jnp.uint8)
        return jax.lax.dynamic_update_slice(prev, patch, (y0, x0, 0))

    def window(dev):  # [H, W] or [H, W, 4] device array -> dirty window
        if dev.ndim == 2:
            return jax.lax.dynamic_slice(dev, (y0, x0), (bh, bw))
        return jax.lax.dynamic_slice(dev, (y0, x0, 0), (bh, bw, 4))

    acc = jnp.zeros((bh, bw, 4), jnp.uint8)
    run = []  # (device window, mode, opacity, device conceal window or None)

    def flush(acc):
        if not run:
            return acc
        stack = jnp.stack([p for p, _, _, _ in run])
        modes = tuple(m for _, m, _, _ in run)
        opacities = jnp.asarray([o for _, _, o, _ in run], jnp.float32)
        conceal = None
        if any(c is not None for *_, c in run):
            zero = jnp.zeros((bh, bw), jnp.uint8)
            conceal = jnp.stack([c if c is not None else zero
                                 for *_, c in run])
        run.clear()
        return composite_stack_static(stack, modes, opacities, conceal,
                                      init=acc)

    has_adjustment = False
    for idx, layer in vis:
        if layer.content == "adjustment" and layer.adjustment is not None:
            has_adjustment = True
            acc = flush(acc)
            acc = layer.adjustment.apply_with_opacity(acc, layer.opacity,
                                                      xp=jnp)
        else:
            if idx == canvas.active_layer_index and canvas.preview is not None:
                # merge only the window slices host-side, upload the patch
                merged = canvas._apply_preview(
                    layer.pixels[y0:y0 + bh, x0:x0 + bw],
                    canvas.preview[y0:y0 + bh, x0:x0 + bw])
                px = jnp.asarray(merged)
            else:
                px = window(cache.get(layer))
            c = _layer_conceal(canvas, cache, layer)
            run.append((px, int(layer.blend_mode), layer.opacity,
                        None if c is None else window(c)))
    patch = flush(acc)
    if has_adjustment:
        tile_mask = canvas.active_tile_mask(vis, rect=(y0, x0, bh, bw))
        if tile_mask is not None:
            patch = jnp.where(jnp.asarray(tile_mask)[..., None], patch,
                              jnp.uint8(0))
    return jax.lax.dynamic_update_slice(prev, patch, (y0, x0, 0))
