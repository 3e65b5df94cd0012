"""Quantization helpers matching the reference's u8 semantics.

The reference (Rust) uses two distinct float->u8 quantizations:
  * effects/adjustments: ``v.round().clamp(0, 255) as u8`` — round half away
    from zero (src/ops/effects.rs:91-95).  For non-negative clamped values
    this equals ``floor(v + 0.5)``.
  * the blend compositor: ``(v * 255.0).clamp(0.0, 255.0) as u8`` — a
    *truncating* saturating cast (src/canvas/canvas_state.rs:1418-1422).

Pixel-exact golden parity requires reproducing both exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def exact_div(x, c):
    """IEEE-correct division by a compile-time constant.

    XLA's algebraic simplifier rewrites `x / const` into `x * (1/const)`,
    which is 1 ulp off for non-power-of-two constants and breaks golden
    parity at u8 rounding boundaries; hiding the divisor behind an
    optimization barrier forces a true divide.

    The divide itself is correctly rounded on both backends: XLA:CPU emits
    IEEE division, and on the GPU the package sets LLVM's NVPTX options for
    IEEE division and square root (paintfe_tpu/__init__.py).  Measured on
    an H100 (700 W): without them, 255 of the 256 quotients u8/255 and
    18,735 of 65,280 u8/u8 quotients came out 1 ulp off; with them, none
    of those nor of 4M random quotients did.  XLA:GPU does not contract
    mul+add into FMA (0 of 4M products differed from the separately
    rounded result), so no refinement step is needed, and a Newton step
    without FMA would not restore correct rounding anyway.
    """
    cb = jax.lax.optimization_barrier(jnp.float32(c))
    return x / cb


def round_u8(x):
    """Round-half-up then clamp to [0, 255] and truncate to u8.

    Matches Rust ``v.round().clamp(0,255) as u8`` for all finite v (values
    below 0.5 floor to <=0 and clamp to 0 either way).
    """
    return jnp.clip(jnp.floor(x + 0.5), 0.0, 255.0).astype(jnp.uint8)


def trunc_u8(x):
    """Clamp to [0, 255] then truncate toward zero (Rust saturating `as u8`)."""
    return jnp.clip(x, 0.0, 255.0).astype(jnp.uint8)


def to_f32(u8_img):
    """u8 -> f32 in [0, 255] (no normalization)."""
    return u8_img.astype(jnp.float32)


def to_unit(u8_img):
    """u8 -> f32 in [0, 1] (divide by 255, matching reference normalization)."""
    return u8_img.astype(jnp.float32) / 255.0
