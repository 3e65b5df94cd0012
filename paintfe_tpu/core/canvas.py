"""Host-side document model: Canvas (layer stack) and Layer.

Behavioral contract: `CanvasState` / `Layer` (src/canvas/canvas_state.rs:9-139,
src/canvas/layers.rs:366-421) minus the GUI caches.  This is deliberately a
thin Python object graph over dense device arrays: the reference's 64x64 COW
tile store exists to make clones/undo cheap on a CPU heap, but on the
accelerator the whole image lives in device memory as one dense array and XLA fuses whole-image ops, so
"transparent tiles are free" is replaced by "dense arrays are fused".
Sparse-canvas economics come back later via dirty-rect windows
(`lax.dynamic_update_slice`) rather than an Option<Arc<chunk>> store.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np

from paintfe_tpu.core.blend import BlendMode
from paintfe_tpu.core.composite import composite_stack_static

MAX_PIXELS = 256_000_000  # reference clamp (tiled_image.rs:14-26)
TILE = 64  # reference chunk size (canvas/defs.rs:7)


def clamp_dimensions(width: int, height: int) -> Tuple[int, int]:
    """TiledImage::new's overflow guard: >256 Mpix (or a zero dimension)
    clamps to 1x1 with a warning rather than erroring."""
    if width * height > MAX_PIXELS or width <= 0 or height <= 0:
        import sys

        print(f"Canvas: dimensions {width}x{height} exceed 256M pixels, "
              "clamped to 1x1", file=sys.stderr)
        return 1, 1
    return width, height


def _empty(h: int, w: int) -> np.ndarray:
    return np.zeros((h, w, 4), np.uint8)


def canonicalize_tiles(img: np.ndarray, tile: int = TILE) -> np.ndarray:
    """Zero out RGB of fully-transparent 64x64 tiles.

    The reference's sparse tile store drops fully-transparent chunks
    (TiledImage::from_rgba_image), so their color data reads back as zeros.
    Any layer-commit path must apply this for storage parity.
    """
    img = np.asarray(img)
    h, w = img.shape[:2]
    out = img.copy()
    for ty in range(0, h, tile):
        for tx in range(0, w, tile):
            blk = out[ty : ty + tile, tx : tx + tile]
            if not blk[..., 3].any():
                blk[...] = 0
    return out


@dataclasses.dataclass
class Layer:
    """One layer: straight-alpha RGBA u8 pixels + blend state.

    `content` discriminates Raster / Adjustment / Text (layers.rs:366-375);
    adjustment layers transform the accumulated composite in-stream; text
    layers carry vector data and rasterize into `pixels` on demand.
    Deep-pixel payloads (u16/f16/f32) ride alongside the u8 preview
    (layers.rs:420, experimental.rs)."""

    name: str
    pixels: np.ndarray  # u8 [H, W, 4]
    visible: bool = True
    opacity: float = 1.0
    blend_mode: BlendMode = BlendMode.NORMAL
    mask: Optional[np.ndarray] = None  # u8 [H, W] conceal (0 = show)
    mask_enabled: bool = True
    folder_id: Optional[int] = None
    content: str = "raster"  # raster | adjustment | text
    adjustment: Optional[Any] = None  # deep.AdjustmentLayerData
    text_data: Optional[Any] = None  # text.TextLayerData
    pixel_format: Any = None  # deep.PixelFormat (None -> RGBA_U8)
    deep_pixels: Optional[Any] = None  # deep.DeepRgbaBuffer
    hdr_metadata: Optional[Any] = None  # deep.HdrMetadata
    source_metadata: Optional[Any] = None  # deep.ImageMetadata

    @classmethod
    def new(cls, name: str, w: int, h: int, fill=(0, 0, 0, 0)) -> "Layer":
        px = np.empty((h, w, 4), np.uint8)
        px[...] = np.asarray(fill, np.uint8)
        return cls(name=name, pixels=px)

    @property
    def height(self) -> int:
        return self.pixels.shape[0]

    @property
    def width(self) -> int:
        return self.pixels.shape[1]

    def clone(self) -> "Layer":
        # Value semantics like the Rust Layer Clone: the optional payloads
        # (deep buffer, adjustment params, text blocks, metadata) are
        # mutated in place by edit paths, so a snapshot sharing them would
        # alias live state and survive undo.
        import copy

        return dataclasses.replace(
            self,
            pixels=self.pixels.copy(),
            mask=None if self.mask is None else self.mask.copy(),
            deep_pixels=copy.deepcopy(self.deep_pixels),
            adjustment=copy.deepcopy(self.adjustment),
            text_data=copy.deepcopy(self.text_data),
            hdr_metadata=copy.deepcopy(self.hdr_metadata),
            source_metadata=copy.deepcopy(self.source_metadata),
        )


@dataclasses.dataclass
class LayerFolder:
    id: int
    name: str
    visible: bool = True
    expanded: bool = True


@dataclasses.dataclass
class Canvas:
    """The document: an ordered layer stack (bottom first) + selection mask."""

    width: int
    height: int
    layers: List[Layer] = dataclasses.field(default_factory=list)
    folders: List[LayerFolder] = dataclasses.field(default_factory=list)
    active_layer_index: int = 0
    # Selection: None = everything selected; else u8 [H, W], 0 or 255.
    selection: Optional[np.ndarray] = None
    # Interactive preview overlay for the active layer (brush strokes etc.,
    # canvas_state.rs:24-127): pre-blended into the active layer before
    # compositing so it inherits the layer's blend mode and opacity.
    preview: Optional[np.ndarray] = None  # u8 [H, W, 4]
    preview_blend_mode: BlendMode = BlendMode.NORMAL
    preview_is_eraser: bool = False
    preview_replaces_layer: bool = False

    @classmethod
    def new(cls, width: int, height: int, background=(0, 0, 0, 0)) -> "Canvas":
        width, height = clamp_dimensions(width, height)
        c = cls(width=width, height=height)
        c.layers.append(Layer.new("Background", width, height, background))
        return c

    @classmethod
    def from_image(cls, img: np.ndarray) -> "Canvas":
        img = np.asarray(img, np.uint8)
        h, w = img.shape[:2]
        # imported images pass through the same 256-Mpix guard as new
        # canvases (the reference routes TiledImage::from_rgba_image
        # through the tiled_image.rs:14-26 clamp): an oversized decode
        # must not allocate multi-GB dense layers
        cw, ch = clamp_dimensions(w, h)
        if (cw, ch) != (w, h):
            img = img[:ch, :cw]
        c = cls(width=img.shape[1], height=img.shape[0])
        c.layers.append(Layer(name="Background", pixels=img.copy()))
        return c

    # -- layer queries ------------------------------------------------------

    def folder_visible(self, folder_id: Optional[int]) -> bool:
        if folder_id is None:
            return True
        for f in self.folders:
            if f.id == folder_id:
                return f.visible
        return True

    def layer_effectively_visible(self, idx: int) -> bool:
        layer = self.layers[idx]
        return layer.visible and self.folder_visible(layer.folder_id)

    @property
    def active_layer(self) -> Layer:
        return self.layers[self.active_layer_index]

    # -- compositing --------------------------------------------------------

    def composite(self) -> np.ndarray:
        """Flatten the visible stack to a single RGBA u8 [H, W, 4] image.

        Raster runs are fused with the jitted compositor; adjustment layers
        transform the accumulated composite in-stream between runs
        (canvas_state.rs:579-584)."""
        vis = [
            (i, l)
            for i, l in enumerate(self.layers)
            if self.layer_effectively_visible(i)
        ]
        if not vis:
            return _empty(self.height, self.width)

        acc = _empty(self.height, self.width)
        run: List[Layer] = []

        def flush_run(acc):
            if not run:
                return acc
            stack = np.stack([l.pixels for l in run])
            modes = np.array([int(l.blend_mode) for l in run], np.int32)
            opacities = np.array([l.opacity for l in run], np.float32)
            conceal = None
            if any(l.mask is not None and l.mask_enabled for l in run):
                zero = np.zeros((self.height, self.width), np.uint8)
                conceal = np.stack(
                    [
                        l.mask if (l.mask is not None and l.mask_enabled) else zero
                        for l in run
                    ]
                )
            run.clear()
            return np.asarray(
                composite_stack_static(stack, tuple(modes.tolist()), opacities,
                                       conceal, init=acc)
            )

        has_adjustment = False
        for idx, layer in vis:
            if layer.content == "adjustment" and layer.adjustment is not None:
                has_adjustment = True
                acc = flush_run(acc)
                acc = layer.adjustment.apply_with_opacity(acc, layer.opacity)
            elif idx == self.active_layer_index and self.preview is not None:
                merged = dataclasses.replace(layer)
                merged.pixels = self._apply_preview(layer.pixels)
                run.append(merged)
            else:
                run.append(layer)
        out = flush_run(acc)
        if has_adjustment:
            # The reference only processes chunks present in some visible
            # layer's store (composite_viewport active_chunks,
            # canvas_state.rs:528-551), so adjustment layers never touch
            # tiles with no data — those stay (0,0,0,0).  Without masking,
            # e.g. Invert would turn empty tiles (255,255,255,0).
            tile_mask = self.active_tile_mask(vis)
            if tile_mask is not None:
                out = np.where(tile_mask[..., None], out, np.uint8(0))
        return out

    def active_tile_mask(self, vis, rect=None) -> Optional[np.ndarray]:
        """Per-pixel bool mask of 64x64 tiles where some visible raster
        layer (or the preview overlay) holds data.  With the dense store,
        "chunk exists" is "any alpha nonzero in the tile" — the same
        storage-parity convention as canonicalize_tiles.  Returns None
        when every tile is active (the common opaque-background case).

        `rect` = (y0, x0, bh, bw) restricts the computation to the tiles
        intersecting that window (the dirty-rect path) and returns the
        mask slice for exactly that window; tiles stay aligned to the
        global 64px grid, so the slice matches the full-image mask."""
        if rect is None:
            y0, x0, bh, bw = 0, 0, self.height, self.width
        else:
            y0, x0, bh, bw = rect
        ty0 = (y0 // TILE) * TILE
        tx0 = (x0 // TILE) * TILE
        rh = min(-(-(y0 + bh) // TILE) * TILE, self.height) - ty0
        rw = min(-(-(x0 + bw) // TILE) * TILE, self.width) - tx0
        any_alpha = np.zeros((rh, rw), bool)
        for _, layer in vis:
            if layer.content == "adjustment":
                continue
            any_alpha |= layer.pixels[ty0:ty0 + rh, tx0:tx0 + rw, 3] > 0
        if self.preview is not None:
            any_alpha |= self.preview[ty0:ty0 + rh, tx0:tx0 + rw, 3] > 0
        th = -(-rh // TILE)
        tw = -(-rw // TILE)
        padded = np.zeros((th * TILE, tw * TILE), bool)
        padded[:rh, :rw] = any_alpha
        tiles = padded.reshape(th, TILE, tw, TILE).any(axis=(1, 3))
        if tiles.all():
            return None
        expanded = np.repeat(np.repeat(tiles, TILE, axis=0), TILE, axis=1)
        return expanded[y0 - ty0 : y0 - ty0 + bh, x0 - tx0 : x0 - tx0 + bw]

    def _apply_preview(self, pixels: np.ndarray,
                       preview: Optional[np.ndarray] = None) -> np.ndarray:
        """Pre-blend the preview into the active layer's pixels
        (canvas_state.rs:619-658): replace / eraser-mask / coverage-weighted
        Overwrite-Xor lerp / plain blend.  `preview` overrides self.preview
        (the dirty-rect path passes matching window slices of both)."""
        from paintfe_tpu.core.blend import blend_u8

        pp = self.preview if preview is None else preview
        if self.preview_replaces_layer:
            return pp.copy()
        has = pp[..., 3] > 0
        out = pixels.copy()
        if self.preview_is_eraser:
            strength = pp[..., 3].astype(np.float32) / np.float32(255.0)
            cur = pixels[..., 3].astype(np.float32) / np.float32(255.0)
            new_a = (np.maximum(cur * (1.0 - strength), 0.0) * np.float32(255.0)).astype(np.uint8)
            out[..., 3] = np.where(has, new_a, pixels[..., 3])
            return out
        blended = np.asarray(blend_u8(pixels, pp, int(self.preview_blend_mode), 1.0))
        if self.preview_blend_mode in (BlendMode.OVERWRITE, BlendMode.XOR):
            cov = pp[..., 3:4].astype(np.float32) / np.float32(255.0)
            mixed = (pixels.astype(np.float32) * (1.0 - cov)
                     + blended.astype(np.float32) * cov + np.float32(0.5)).astype(np.uint8)
            return np.where(has[..., None], mixed, pixels)
        return np.where(has[..., None], blended, pixels)

    # -- selection ----------------------------------------------------------

    def selection_mask_f32(self) -> Optional[np.ndarray]:
        """Selection as f32 [H, W] in {0, 1}, or None when all selected."""
        if self.selection is None:
            return None
        return (self.selection > 0).astype(np.float32)

    def has_selection(self) -> bool:
        return self.selection is not None
