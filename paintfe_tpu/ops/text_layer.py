"""Text layers: rich-text blocks, layout, geometric warps, effects.

Behavioral contract: src/ops/text_layer/core.rs — TextLayerData with cache
generations (:7-58), TextBlock/TextRun/TextStyle/ParagraphStyle (:60-165),
TextWarp {None, Arc, Circular, PathFollow, Envelope} (:171-298),
TextEffects (outline/shadow, :299-340) — and src/ops/text.rs glyph
rasterization.  Glyph rendering uses FreeType via PIL (the reference uses
ab_glyph); glyph-level metrics differ, so parity here is structural and
invariant-level (mirroring tests/text_layer.rs, which asserts invariants,
not goldens).
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import json
from typing import List, Optional, Tuple

import numpy as np

f32 = np.float32


def _pil():
    """Pillow's (Image, ImageDraw, ImageFont): glyph rendering needs them,
    and nothing else in this module does."""
    from paintfe_tpu.io.codecs import CodecError

    try:
        from PIL import Image, ImageDraw, ImageFont
    except ImportError as e:
        raise CodecError(
            "text rasterization needs Pillow, which is not installed") from e
    return Image, ImageDraw, ImageFont

_FONT_PATHS = {
    ("default", False, False): "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
    ("default", True, False): "/usr/share/fonts/truetype/dejavu/DejaVuSans-Bold.ttf",
    ("default", False, True): "/usr/share/fonts/truetype/dejavu/DejaVuSans-Oblique.ttf",
    ("default", True, True): "/usr/share/fonts/truetype/dejavu/DejaVuSans-BoldOblique.ttf",
    ("mono", False, False): "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf",
    ("serif", False, False): "/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf",
}


@functools.lru_cache(maxsize=64)
def _load_font(family: str, size: int, bold: bool, italic: bool):
    key = (family if family in ("mono", "serif") else "default", bold, italic)
    path = _FONT_PATHS.get(key) or _FONT_PATHS.get((key[0], False, False)) \
        or _FONT_PATHS[("default", False, False)]
    ImageFont = _pil()[2]
    try:
        return ImageFont.truetype(path, size=max(int(size), 1))
    except OSError:
        return ImageFont.load_default(size=max(int(size), 1))


class TextAlignment(enum.Enum):
    LEFT = "left"
    CENTER = "center"
    RIGHT = "right"


@dataclasses.dataclass
class TextStyle:
    font_family: str = "default"
    font_weight: int = 400
    font_size: float = 24.0
    italic: bool = False
    underline: bool = False
    strikethrough: bool = False
    color: Tuple[int, int, int, int] = (0, 0, 0, 255)
    letter_spacing: float = 0.0
    baseline_offset: float = 0.0
    width_scale: float = 1.0
    height_scale: float = 1.0

    @property
    def bold(self) -> bool:
        return self.font_weight >= 600


@dataclasses.dataclass
class TextRun:
    text: str
    style: TextStyle = dataclasses.field(default_factory=TextStyle)


@dataclasses.dataclass
class ParagraphStyle:
    alignment: TextAlignment = TextAlignment.LEFT
    line_spacing: float = 1.2
    indent: float = 0.0


# -- warps --------------------------------------------------------------------


@dataclasses.dataclass
class ArcWarp:
    bend: float = 0.5  # -1..1, positive bows upward


@dataclasses.dataclass
class CircularWarp:
    radius: float = 100.0
    start_angle_deg: float = -90.0
    clockwise: bool = True


@dataclasses.dataclass
class PathFollowWarp:
    # cubic Bezier control points, block-local
    p0: Tuple[float, float] = (0.0, 0.0)
    p1: Tuple[float, float] = (50.0, -40.0)
    p2: Tuple[float, float] = (100.0, 40.0)
    p3: Tuple[float, float] = (150.0, 0.0)


@dataclasses.dataclass
class EnvelopeWarp:
    # vertical displacement of the top and bottom edges at t=0, 0.5, 1
    top: Tuple[float, float, float] = (0.0, -20.0, 0.0)
    bottom: Tuple[float, float, float] = (0.0, 20.0, 0.0)


TextWarp = Optional[object]  # None | ArcWarp | CircularWarp | PathFollowWarp | EnvelopeWarp


# -- effects --------------------------------------------------------------------


class OutlinePosition(enum.Enum):
    INSIDE = "inside"
    OUTSIDE = "outside"
    CENTER = "center"


@dataclasses.dataclass
class OutlineEffect:
    color: Tuple[int, int, int, int] = (0, 0, 0, 255)
    width: float = 2.0
    position: OutlinePosition = OutlinePosition.OUTSIDE


@dataclasses.dataclass
class ShadowEffect:
    color: Tuple[int, int, int, int] = (0, 0, 0, 160)
    offset_x: float = 3.0
    offset_y: float = 3.0
    blur_radius: float = 2.0
    spread: float = 0.0


@dataclasses.dataclass
class TextEffects:
    outline: Optional[OutlineEffect] = None
    shadow: Optional[ShadowEffect] = None


# -- blocks / layer data --------------------------------------------------------


@dataclasses.dataclass
class TextBlock:
    id: int = 0
    position: Tuple[float, float] = (0.0, 0.0)
    rotation: float = 0.0
    runs: List[TextRun] = dataclasses.field(default_factory=list)
    paragraph: ParagraphStyle = dataclasses.field(default_factory=ParagraphStyle)
    max_width: Optional[float] = None
    warp: TextWarp = None

    def plain_text(self) -> str:
        return "".join(r.text for r in self.runs)


@dataclasses.dataclass
class TextLayerData:
    blocks: List[TextBlock] = dataclasses.field(default_factory=list)
    effects: TextEffects = dataclasses.field(default_factory=TextEffects)
    cache_generation: int = 1
    raster_generation: int = 0
    next_block_id: int = 1

    def add_block(self, block: TextBlock) -> TextBlock:
        block.id = self.next_block_id
        self.next_block_id += 1
        self.blocks.append(block)
        self.mark_dirty()
        return block

    def mark_dirty(self):
        self.cache_generation += 1

    def needs_rasterize(self) -> bool:
        return self.raster_generation != self.cache_generation

    def rasterize(self, width: int, height: int) -> np.ndarray:
        """Render all blocks + layer effects to RGBA u8 [H, W, 4]."""
        img = _pil()[0].new("RGBA", (width, height), (0, 0, 0, 0))
        for block in self.blocks:
            _render_block(img, block)
        out = np.asarray(img, np.uint8).copy()
        out = _apply_effects(out, self.effects)
        self.raster_generation = self.cache_generation
        return out


# -- container (de)serialization -----------------------------------------------

_WARP_TYPES = {"arc": ArcWarp, "circular": CircularWarp,
               "path": PathFollowWarp, "envelope": EnvelopeWarp}


def text_data_to_json(data: TextLayerData) -> bytes:
    """Serialize a TextLayerData tree for the PFE container's text payload
    (the reference bincodes its TextLayerData into LayerDataV2/V3's
    text_data bytes, io.rs:331-360; our payload is self-describing JSON —
    cross-decoding the Rust bincode layout is part of the accepted
    text-parity gap)."""

    def enc(obj):
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            d = {f.name: enc(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)}
            for tag, cls in _WARP_TYPES.items():
                if isinstance(obj, cls):
                    d["_warp"] = tag
            return d
        if isinstance(obj, enum.Enum):
            return obj.value
        if isinstance(obj, (list, tuple)):
            return [enc(v) for v in obj]
        return obj

    def jsonable(v):  # numpy scalars (e.g. a computed rotation) -> native
        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, np.floating):
            return float(v)
        raise TypeError(f"unserializable text field value {v!r}")

    return json.dumps(enc(data), default=jsonable).encode("utf-8")


def text_data_from_json(blob: bytes) -> Optional[TextLayerData]:
    """Inverse of text_data_to_json; returns None for payloads this build
    cannot decode (e.g. reference-written bincode text data)."""
    try:
        raw = json.loads(blob.decode("utf-8"))

        def style(d):
            d = dict(d)
            d["color"] = tuple(d["color"])
            return TextStyle(**d)

        def warp(d):
            if d is None:
                return None
            tag = d.pop("_warp", None)
            cls = _WARP_TYPES.get(tag)
            if cls is None:
                # unknown/missing warp tag: fail the WHOLE payload (-> None,
                # layer keeps its rasterized pixels) rather than silently
                # decoding with the warp dropped — a later rasterize() would
                # overwrite correct pixels with un-warped text
                raise ValueError(f"unknown text warp tag {tag!r}")
            return cls(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in d.items()})

        def block(d):
            runs = [TextRun(text=r["text"], style=style(r["style"]))
                    for r in d["runs"]]
            para = ParagraphStyle(
                alignment=TextAlignment(d["paragraph"]["alignment"]),
                line_spacing=d["paragraph"]["line_spacing"],
                indent=d["paragraph"]["indent"])
            return TextBlock(id=d["id"], position=tuple(d["position"]),
                             rotation=d["rotation"], runs=runs,
                             paragraph=para, max_width=d["max_width"],
                             warp=warp(d["warp"]))

        eff = raw["effects"]
        outline = shadow = None
        if eff.get("outline"):
            o = dict(eff["outline"])
            o["color"] = tuple(o["color"])
            o["position"] = OutlinePosition(o["position"])
            outline = OutlineEffect(**o)
        if eff.get("shadow"):
            s = dict(eff["shadow"])
            s["color"] = tuple(s["color"])
            shadow = ShadowEffect(**s)
        return TextLayerData(
            blocks=[block(b) for b in raw["blocks"]],
            effects=TextEffects(outline=outline, shadow=shadow),
            cache_generation=raw.get("cache_generation", 1),
            raster_generation=raw.get("raster_generation", 0),
            next_block_id=raw.get("next_block_id", 1),
        )
    except (ValueError, KeyError, TypeError, AttributeError,
            UnicodeDecodeError):
        return None


# -- layout + rendering -----------------------------------------------------------


def _glyph_positions_linear(block: TextBlock):
    """Per-character layout with wrapping; yields (char, style, x, y, angle)."""
    x = block.paragraph.indent
    y = 0.0
    line_chars = []
    lines = []
    for run in block.runs:
        for ch in run.text:
            if ch == "\n":
                lines.append(line_chars)
                line_chars = []
                x = block.paragraph.indent
                continue
            font = _load_font(run.style.font_family, int(run.style.font_size),
                              run.style.bold, run.style.italic)
            try:
                adv = font.getlength(ch) * run.style.width_scale
            except Exception:
                adv = run.style.font_size * 0.6
            if (block.max_width is not None and line_chars
                    and x + adv > block.max_width):
                lines.append(line_chars)
                line_chars = []
                x = block.paragraph.indent
            line_chars.append((ch, run.style, x, adv))
            x += adv + run.style.letter_spacing
    if line_chars:
        lines.append(line_chars)

    out = []
    y = 0.0
    for line in lines:
        line_h = max((c[1].font_size for c in line), default=24.0)
        width_used = (line[-1][2] + line[-1][3]) if line else 0.0
        offset = 0.0
        if block.max_width is not None:
            if block.paragraph.alignment == TextAlignment.CENTER:
                offset = (block.max_width - width_used) / 2.0
            elif block.paragraph.alignment == TextAlignment.RIGHT:
                offset = block.max_width - width_used
        for ch, style, cx, _adv in line:
            out.append((ch, style, cx + offset, y + style.baseline_offset, 0.0))
        y += line_h * block.paragraph.line_spacing
    return out


def _bezier_point(p0, p1, p2, p3, t):
    mt = 1.0 - t
    x = (mt**3 * p0[0] + 3 * mt * mt * t * p1[0] + 3 * mt * t * t * p2[0] + t**3 * p3[0])
    y = (mt**3 * p0[1] + 3 * mt * mt * t * p1[1] + 3 * mt * t * t * p2[1] + t**3 * p3[1])
    return x, y


def _warp_positions(block: TextBlock, glyphs):
    """Apply the block warp to linear glyph positions -> (x, y, angle)."""
    warp = block.warp
    if warp is None:
        return glyphs
    total_w = max((g[2] for g in glyphs), default=1.0) + 1.0
    # vertical span of the block (baseline min..max plus one glyph height),
    # for the envelope's top/bottom interpolation fraction
    y_min = min((g[3] for g in glyphs), default=0.0)
    y_max = max((g[3] for g in glyphs), default=0.0)
    glyph_h = max((g[1].font_size for g in glyphs), default=24.0)
    total_h = (y_max - y_min) + glyph_h
    out = []
    for ch, style, x, y, _ang in glyphs:
        t = x / total_w
        if isinstance(warp, ArcWarp):
            # parabolic arc: vertical offset + slope-derived rotation
            dy = -warp.bend * 4.0 * t * (1.0 - t) * total_w * 0.25
            slope = -warp.bend * (4.0 - 8.0 * t) * 0.25
            out.append((ch, style, x, y + dy, float(np.arctan(slope))))
        elif isinstance(warp, CircularWarp):
            sweep = total_w / max(warp.radius, 1.0)
            direction = 1.0 if warp.clockwise else -1.0
            ang = np.deg2rad(warp.start_angle_deg) + direction * sweep * t
            cx = warp.radius * np.cos(ang)
            cy = warp.radius * np.sin(ang)
            out.append((ch, style, float(cx), float(cy) + y, float(ang + direction * np.pi / 2)))
        elif isinstance(warp, PathFollowWarp):
            px, py = _bezier_point(warp.p0, warp.p1, warp.p2, warp.p3, t)
            eps = 1e-3
            qx, qy = _bezier_point(warp.p0, warp.p1, warp.p2, warp.p3, min(t + eps, 1.0))
            ang = float(np.arctan2(qy - py, qx - px))
            out.append((ch, style, float(px), float(py) + y, ang))
        elif isinstance(warp, EnvelopeWarp):
            def quad(vals, tt):
                a, b, c = vals
                mt = 1.0 - tt
                return mt * mt * a + 2 * mt * tt * b + tt * tt * c
            top = quad(warp.top, t)
            bottom = quad(warp.bottom, t)
            # interpolate by the glyph's vertical position within the block
            # (the reference resamples pixels between the two curves,
            # warp.rs:446-530; at glyph granularity the baseline sits ~80%
            # down its line box).  A constant 0.5 made the default
            # symmetric envelope cancel to a literal no-op.
            frac = min(max((y - y_min + 0.8 * glyph_h) / total_h, 0.0), 1.0)
            out.append((ch, style, x, y + top * (1 - frac) + bottom * frac, 0.0))
        else:
            out.append((ch, style, x, y, 0.0))
    return out


def _render_block(img: "Image.Image", block: TextBlock):
    Image, ImageDraw, _ = _pil()
    glyphs = _warp_positions(block, _glyph_positions_linear(block))
    bx, by = block.position
    rot = block.rotation
    cos_r, sin_r = float(np.cos(rot)), float(np.sin(rot))
    draw = ImageDraw.Draw(img)
    for ch, style, gx, gy, ang in glyphs:
        font = _load_font(style.font_family, int(style.font_size),
                          style.bold, style.italic)
        # block rotation applied to glyph offsets
        rx = gx * cos_r - gy * sin_r + bx
        ry = gx * sin_r + gy * cos_r + by
        total_ang = ang + rot
        if abs(total_ang) < 1e-3 and style.width_scale == 1.0 and style.height_scale == 1.0:
            draw.text((rx, ry), ch, font=font, fill=tuple(style.color))
            if style.underline or style.strikethrough:
                wlen = font.getlength(ch)
                asc, desc = font.getmetrics()
                if style.underline:
                    yy = ry + asc + 1
                    draw.line([(rx, yy), (rx + wlen, yy)], fill=tuple(style.color))
                if style.strikethrough:
                    yy = ry + asc * 0.6
                    draw.line([(rx, yy), (rx + wlen, yy)], fill=tuple(style.color))
        else:
            # render glyph to a small tile, scale/rotate, paste
            pad = int(style.font_size) + 8
            tile = Image.new("RGBA", (pad * 2, pad * 2), (0, 0, 0, 0))
            ImageDraw.Draw(tile).text((pad // 2, pad // 2), ch, font=font,
                                      fill=tuple(style.color))
            # the glyph origin inside the tile; the paste must land it on
            # the path anchor (rx, ry) — before and after any transform
            qx, qy = pad // 2, pad // 2
            if style.width_scale != 1.0 or style.height_scale != 1.0:
                new_w = max(int(tile.width * style.width_scale), 1)
                new_h = max(int(tile.height * style.height_scale), 1)
                qx *= new_w / tile.width
                qy *= new_h / tile.height
                tile = tile.resize((new_w, new_h), Image.BILINEAR)
            if abs(total_ang) >= 1e-3:
                # expand-rotate moves content about the tile center and
                # re-centers in the grown box: track the glyph origin
                # through PIL's forward map (visual-CCW by `deg` in
                # y-down coords) instead of assuming a fixed offset — a
                # width//4 constant displaced rotated glyphs by up to
                # ~font_size px off their path
                deg = -np.rad2deg(total_ang)
                cx, cy = tile.width / 2.0, tile.height / 2.0
                a = np.deg2rad(deg)
                dxq, dyq = qx - cx, qy - cy
                rqx = dxq * np.cos(a) + dyq * np.sin(a)
                rqy = -dxq * np.sin(a) + dyq * np.cos(a)
                tile = tile.rotate(deg, resample=Image.BILINEAR, expand=True)
                qx = tile.width / 2.0 + rqx
                qy = tile.height / 2.0 + rqy
            img.alpha_composite(tile, (int(rx) - int(round(qx)),
                                       int(ry) - int(round(qy))))


def _disc_dilate(mask: np.ndarray, radius: float) -> np.ndarray:
    """Circular max-dilation of a float coverage mask (the reference's
    dilate_mask, text_layer/effects.rs:167-214: Euclidean disc, preserves
    anti-aliased values)."""
    ir = int(np.ceil(radius))
    if ir <= 0:
        return mask
    r_sq = radius * radius
    h, w = mask.shape
    out = mask.copy()
    shifted = np.zeros_like(mask)
    for dy in range(-ir, ir + 1):
        if dy * dy > r_sq:
            continue
        for dx in range(-ir, ir + 1):
            if (dx == 0 and dy == 0) or dx * dx + dy * dy > r_sq:
                continue
            shifted[:] = 0.0
            ys0, ys1 = max(0, -dy), min(h, h - dy)
            xs0, xs1 = max(0, -dx), min(w, w - dx)
            shifted[ys0:ys1, xs0:xs1] = mask[ys0 + dy:ys1 + dy,
                                             xs0 + dx:xs1 + dx]
            np.maximum(out, shifted, out=out)
    return out


def _render_text_shadow(rgba: np.ndarray, s: "ShadowEffect",
                        mask_from: Optional[np.ndarray] = None) -> np.ndarray:
    """The text drop shadow (text_layer/effects.rs render_shadow:220-300):
    offset the coverage, disc-dilate by `spread`, tint with the shadow color
    applying its alpha ONCE, Gaussian-blur, and composite beneath the text.
    `mask_from` supplies the coverage source when `rgba` already carries
    other effects (the reference derives every effect from the raw glyph
    coverage, effects.rs:9-35).  Distinct from
    ops.effects.render.drop_shadow, whose widen pass is blur-derived and
    which takes a separate opacity (render.rs:175-260)."""
    from paintfe_tpu.core.blend import BlendMode, blend_u8
    from paintfe_tpu.ops.filters import gaussian_blur

    h, w = rgba.shape[:2]
    cov_src = rgba if mask_from is None else mask_from
    cov = cov_src[..., 3].astype(np.float32)  # coverage * 255
    dx, dy = int(round(s.offset_x)), int(round(s.offset_y))
    mask = np.zeros((h, w), np.float32)
    ys0, ys1 = max(0, dy), min(h, h + dy)
    xs0, xs1 = max(0, dx), min(w, w + dx)
    if ys1 > ys0 and xs1 > xs0:
        mask[ys0:ys1, xs0:xs1] = cov[ys0 - dy:ys1 - dy, xs0 - dx:xs1 - dx]
    if s.spread > 0.5:
        mask = _disc_dilate(mask, float(s.spread))
    sr, sg, sb, sa = (int(c) for c in s.color)
    shadow = np.empty((h, w, 4), np.uint8)
    shadow[..., 0] = sr
    shadow[..., 1] = sg
    shadow[..., 2] = sb
    shadow[..., 3] = np.clip(
        np.floor(mask * np.float32(sa / 255.0) + np.float32(0.5)), 0, 255
    ).astype(np.uint8)
    if s.blur_radius > 0.5:
        shadow = np.asarray(gaussian_blur(shadow, float(s.blur_radius)))
    # text over shadow (the reference renders the shadow first, then draws
    # outline/fill on top)
    return np.asarray(blend_u8(shadow, rgba, int(BlendMode.NORMAL), 1.0))


def _apply_effects(rgba: np.ndarray, effects: TextEffects) -> np.ndarray:
    """Every effect derives from the GLYPH coverage (effects.rs:9-35):
    outline first (its coverage source is the raw text image — deriving
    it after the shadow would trace a ring around the blurred shadow
    blob), then the shadow composites beneath the outlined text with the
    text alpha as its mask."""
    from paintfe_tpu.ops.effects import render as render_fx

    out = rgba
    if effects.outline is not None:
        o = effects.outline
        pos = {OutlinePosition.OUTSIDE: render_fx.OutlineMode.OUTSIDE,
               OutlinePosition.INSIDE: render_fx.OutlineMode.INSIDE,
               OutlinePosition.CENTER: render_fx.OutlineMode.CENTER}[o.position]
        out = np.asarray(render_fx.outline(out, int(max(o.width, 1)), tuple(o.color), pos, True))
    if effects.shadow is not None:
        out = _render_text_shadow(out, effects.shadow, mask_from=rgba)
    return out


def make_text_layer_data(text: str, x: float = 0.0, y: float = 0.0,
                         size: float = 24.0, color=(0, 0, 0, 255)) -> TextLayerData:
    """Convenience: one block, one run."""
    td = TextLayerData()
    block = TextBlock(position=(x, y),
                      runs=[TextRun(text=text, style=TextStyle(font_size=size, color=tuple(color)))])
    td.add_block(block)
    return td


def ensure_text_layers_rasterized(canvas):
    """Rasterize dirty text layers into their pixel buffers
    (canvas_state.rs:460-480)."""
    for layer in canvas.layers:
        if layer.content == "text" and layer.text_data is not None:
            if layer.text_data.needs_rasterize():
                layer.pixels = layer.text_data.rasterize(canvas.width, canvas.height)
