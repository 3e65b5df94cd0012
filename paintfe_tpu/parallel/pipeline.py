"""Effect pipelines: a script's apply_* chain, traced once and fused by XLA.

The reference's CLI loops over glob inputs serially, re-running the Rhai
interpreter per image (cli.rs:159, SURVEY §3.1).  Here: record
the op sequence once (scripts that never read individual pixels are pure
op chains), compose it into one jittable image->image function, vmap it over
the batch, and shard the batch axis over the device mesh.  One compile,
whole-chain fusion, no host round-trips between ops.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from paintfe_tpu.ops import adjustments as adj
from paintfe_tpu.ops import filters
from paintfe_tpu.ops import transform as tfm
from paintfe_tpu.ops.effects import artistic, distort, glitch, render, stylize
from paintfe_tpu.ops.effects import noise as noise_mod
from paintfe_tpu.parallel.mesh import batch_mesh, batch_sharding


@dataclasses.dataclass(frozen=True)
class PipelineOp:
    name: str
    params: tuple


class NotVectorizable(Exception):
    """Raised when a script touches pixels directly and must run per-image."""


# op name -> (fn(img, *params) -> img) — all golden-exact ops with static params
_OP_TABLE = {
    "apply_blur": lambda img, sigma: filters.gaussian_blur(img, sigma),
    "apply_box_blur": lambda img, r: filters.box_blur(img, float(r)),
    "apply_motion_blur": lambda img, a, d: filters.motion_blur(img, a, d),
    "apply_sharpen": lambda img, amount: filters.sharpen(img, amount, 1.0),
    "apply_reduce_noise": lambda img, s: filters.reduce_noise(img, s, 2),
    "apply_median": lambda img, r: filters.median(img, max(int(r), 1)),
    "apply_invert": lambda img: jnp.concatenate(
        [255 - img[..., 0:3], img[..., 3:4]], axis=-1
    ),
    "apply_desaturate": lambda img: adj.desaturate_bt601(img),
    "apply_sepia": lambda img, *s: _sepia_device(img, *s),
    "apply_brightness_contrast": lambda img, b, c: _bc_device(img, b, c),
    "apply_exposure": lambda img, ev: _exposure_device(img, ev),
    "apply_levels": lambda img, b, w, g: _levels_device(img, b, w, g),
    "apply_noise": lambda img, amount, mono: noise_mod.add_noise(
        img, amount, noise_mod.NoiseType.GAUSSIAN, bool(mono), 42, 1.0, 1
    ),
    "apply_pixelate": lambda img, size: distort.pixelate(img, max(int(size), 1)),
    "apply_crystallize": lambda img, size: distort.crystallize(img, float(max(int(size), 1)), 42),
    "apply_bulge": lambda img, amount: distort.bulge(img, amount),
    "apply_twist": lambda img, angle: distort.twist(img, angle),
    "apply_glow": lambda img, r, i: filters.glow(img, r, i),
    "apply_vignette": lambda img, s, soft: stylize.vignette(img, s, soft),
    "apply_halftone": lambda img, dot: stylize.halftone(img, dot, 45.0),
    "apply_ink": lambda img, s, t: artistic.ink(img, s, t),
    "apply_oil_painting": lambda img, r: artistic.oil_painting(img, max(int(r), 1), 20),
    "flip_horizontal": lambda img: img[:, ::-1],
    "flip_vertical": lambda img: img[::-1],
    "rotate_180": lambda img: img[::-1, ::-1],
}


def _sepia_device(img, strength=None):
    """Script-sepia (truncating cast) on device (scripting.rs:900-938)."""
    f = img.astype(jnp.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    sr = jnp.minimum(r * 0.393 + g * 0.769 + b * 0.189, 255.0)
    sg = jnp.minimum(r * 0.349 + g * 0.686 + b * 0.168, 255.0)
    sb = jnp.minimum(r * 0.272 + g * 0.534 + b * 0.131, 255.0)
    if strength is not None:
        s = jnp.float32(np.clip(strength, 0.0, 1.0))
        inv = 1.0 - s
        sr, sg, sb = r * inv + sr * s, g * inv + sg * s, b * inv + sb * s
    out = jnp.stack([sr, sg, sb], axis=-1).astype(jnp.uint8)
    return jnp.concatenate([out, img[..., 3:4]], axis=-1)


def _bc_device(img, brightness, contrast):
    c = jnp.float32(contrast)
    factor = (259.0 * (c + 255.0)) / (255.0 * (259.0 - c))
    f = img.astype(jnp.float32)
    rgb = jnp.clip(factor * (f[..., 0:3] + jnp.float32(brightness) - 128.0) + 128.0, 0.0, 255.0)
    return jnp.concatenate([rgb.astype(jnp.uint8), img[..., 3:4]], axis=-1)


def _exposure_device(img, ev):
    gain = jnp.exp2(jnp.float32(ev))
    f = img.astype(jnp.float32)
    rgb = jnp.clip(f[..., 0:3] * gain, 0.0, 255.0)
    return jnp.concatenate([rgb.astype(jnp.uint8), img[..., 3:4]], axis=-1)


def _levels_device(img, black, white, gamma):
    """Script-levels evaluated directly per pixel (truncating cast, matching
    scripting.rs:1054-1075).  Formula evaluation == LUT lookup bit-exactly
    for integer pixels."""
    from paintfe_tpu.utils.quant import exact_div

    in_black = np.float32(black)
    in_range = np.maximum(np.float32(white) - in_black, np.float32(1.0))
    inv_gamma = np.float32(1.0) / np.maximum(np.float32(gamma), np.float32(0.01))
    v = img[..., 0:3].astype(jnp.float32)
    normalized = jnp.clip(exact_div(v - in_black, in_range), 0.0, 1.0)
    out = jnp.clip(jnp.power(normalized, inv_gamma) * 255.0, 0.0, 255.0)
    return jnp.concatenate([out.astype(jnp.uint8), img[..., 3:4]], axis=-1)


# Per-op argument conversion matching the host API's validators EXACTLY
# (scripting/api.py register("apply_*")): the traced batch path must accept
# and reject the same arguments as the per-image interpreter — int() where
# the API uses _as_int would silently truncate 2.5 where the oracle errors.
# tests/test_pipeline_equivalence.py's coverage guard keeps this table in
# lockstep with _OP_TABLE.
def _build_arg_specs():
    from paintfe_tpu.scripting.api import _as_float, _as_int

    def int_min1(v):
        return max(_as_int(v), 1)

    def int_min1_f(v):
        return float(max(_as_int(v), 1))

    def int_f(v):
        return float(_as_int(v))

    def passthrough(v):
        return v

    return {
        "apply_blur": (_as_float,),
        "apply_box_blur": (int_f,),
        "apply_motion_blur": (_as_float, _as_float),
        "apply_sharpen": (_as_float,),
        "apply_reduce_noise": (_as_float,),
        "apply_median": (int_min1,),
        "apply_sepia": (_as_float,),
        "apply_brightness_contrast": (_as_float, _as_float),
        "apply_exposure": (_as_float,),
        "apply_levels": (_as_float, _as_float, _as_float),
        "apply_noise": (_as_float, passthrough),
        "apply_pixelate": (int_min1,),
        "apply_crystallize": (int_min1_f,),
        "apply_bulge": (_as_float,),
        "apply_twist": (_as_float,),
        "apply_glow": (_as_float, _as_float),
        "apply_vignette": (_as_float, _as_float),
        "apply_halftone": (_as_float,),
        "apply_ink": (_as_float, _as_float),
        "apply_oil_painting": (int_min1,),
    }


def trace_script(source: str, dims: Optional[Tuple[int, int]] = None
                 ) -> List[PipelineOp]:
    """Record a script's op chain by running it against a recording context.

    Only works for scripts that are pure op chains (no pixel reads, no
    selections, no RNG-dependent flow).  Raises NotVectorizable otherwise.

    `dims` = (width, height) reported by the script's width()/height()
    calls.  When None, those calls raise NotVectorizable("width"/"height"):
    the trace runs against a 1x1 dummy, so dimension-derived op parameters
    would be silently wrong — callers re-trace per shape bucket with the
    bucket's real dims instead (run_sharded_batch does).
    """
    from paintfe_tpu.scripting.api import ScriptContext, build_host_fns
    from paintfe_tpu.scripting.interp import Interpreter

    ops: List[PipelineOp] = []
    ctx = ScriptContext(np.zeros((1, 1, 4), np.uint8), 1, 1, None, rng_seed=0)
    interp_ref = {}
    fns = build_host_fns(ctx, interp_ref)
    arg_specs = _build_arg_specs()

    recorded = {}
    for name in fns:
        if name in _OP_TABLE:
            def make(name=name):
                spec = arg_specs.get(name)

                def rec(*args, _host_fn=fns[name]):
                    if spec is not None:
                        # arity parity with the per-image path: bind
                        # against the REAL host fn so required/optional
                        # args match the oracle exactly (apply_sepia()
                        # is legal, apply_levels(a, b) is not)
                        import inspect

                        try:
                            inspect.signature(_host_fn).bind(*args)
                        except TypeError:
                            from paintfe_tpu.scripting.interp import (
                                RhaiRuntimeError, _type_of)

                            sig = ", ".join(_type_of(a) for a in args)
                            raise RhaiRuntimeError(
                                f"function not found: {name} ({sig})")
                        args = tuple(conv(a) for conv, a in zip(spec, args))
                    else:
                        args = tuple(
                            float(a) if isinstance(a, (int, float))
                            and not isinstance(a, bool) else a for a in args)
                    ops.append(PipelineOp(name, args))
                    from paintfe_tpu.scripting.interp import UNIT
                    return UNIT
                return rec
            recorded[name] = make()
        elif name in ("width", "height"):
            def make_dim(name=name):
                def dim():
                    if dims is None:
                        raise NotVectorizable(name)
                    return dims[0] if name == "width" else dims[1]
                return dim
            recorded[name] = make_dim()
        elif name in ("print", "print_line", "progress", "sleep", "PI",
                      "clamp", "clamp_f", "lerp", "distance", "abs", "min", "max",
                      "floor", "ceil", "round", "sqrt", "pow", "sin", "cos", "tan",
                      "atan2", "rgb_to_hsl", "hsl_to_rgb"):
            recorded[name] = fns[name]
        else:
            def make_bail(name=name):
                def bail(*args):
                    raise NotVectorizable(name)
                return bail
            recorded[name] = make_bail(name)

    interp = Interpreter(recorded)
    interp_ref["interp"] = interp
    try:
        interp.run(source)
    except NotVectorizable:
        raise
    return ops


def compile_pipeline(ops: Sequence[PipelineOp]) -> Callable:
    """Compose the op chain into one image->image function (not yet jitted)."""

    def run(img):
        for op in ops:
            img = _OP_TABLE[op.name](img, *op.params)
        return img

    return run


@functools.lru_cache(maxsize=64)
def _batch_fn(ops: tuple):
    """Compiled vmapped chain, cached across calls (a fresh jit per call
    would recompile per batch)."""
    chain = compile_pipeline(ops)
    return jax.jit(jax.vmap(chain))


def run_batch(images: np.ndarray, ops: Sequence[PipelineOp], mesh=None):
    """Apply an op chain to a [N, H, W, 4] batch, sharded over the mesh.

    Returns the processed batch as a numpy array.  The whole chain is traced
    once per (ops, shape); XLA partitions the fused kernels over the batch
    axis.
    """
    mesh = mesh if mesh is not None else batch_mesh()
    fn = _batch_fn(tuple(ops))
    sharding = batch_sharding(mesh)
    n = images.shape[0]
    d = mesh.devices.size
    pad = (-n) % d
    if pad:
        images = np.concatenate([images, np.zeros((pad,) + images.shape[1:], images.dtype)])
    batch = jax.device_put(jnp.asarray(images), sharding)
    out = np.asarray(fn(batch))
    return out[:n]
