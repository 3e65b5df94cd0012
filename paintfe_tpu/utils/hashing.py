"""Deterministic coordinate-hash noise (jnp uint32).

Behavioral contract: src/ops/effects.rs:144-162 (hash_u32 3-round avalanche,
hash_f32 in [0,1)), src/ops/effects/noise.rs:53-71 (quintic-fade value
noise), src/ops/effects/distort.rs:229-246 (multi-octave turbulence).
Wrapping u32 arithmetic is exact in jnp uint32, so noise fields are
bit-identical to the reference for golden parity.
"""

from __future__ import annotations

import jax.numpy as jnp

_U = jnp.uint32


def _u32(x):
    return jnp.asarray(x).astype(_U)


def hash_u32(x):
    x = _u32(x)
    x = x * _U(0x9E3779B9)
    x = x ^ (x >> 16)
    x = x * _U(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * _U(0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def hash_f32(x, y, seed):
    """Coordinate hash -> f32 in [0, 1) with 24 bits of mantissa."""
    h = hash_u32(_u32(x) * _U(374761393) + _u32(y) * _U(668265263) + _u32(seed))
    return (h & _U(0x00FFFFFF)).astype(jnp.float32) / 16777216.0


def perlin_noise_2d(x, y, seed):
    """Quintic-fade value noise on the integer lattice; f32 in [0, 1]."""
    xi = jnp.floor(x).astype(jnp.int32)
    yi = jnp.floor(y).astype(jnp.int32)
    xf = x - xi.astype(jnp.float32)
    yf = y - yi.astype(jnp.float32)

    def fade(t):
        return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)

    u = fade(xf)
    v = fade(yf)

    n00 = hash_f32(xi, yi, seed)
    n10 = hash_f32(xi + 1, yi, seed)
    n01 = hash_f32(xi, yi + 1, seed)
    n11 = hash_f32(xi + 1, yi + 1, seed)

    nx0 = n00 + u * (n10 - n00)
    nx1 = n01 + u * (n11 - n01)
    return nx0 + v * (nx1 - nx0)


def turbulence_2d(x, y, seed, octaves: int, roughness: float):
    """Octave sum of value noise; amplitude *= roughness, frequency *= 2."""
    import numpy as np

    octaves = max(int(octaves), 1)
    total = jnp.zeros_like(jnp.asarray(x, jnp.float32))
    amplitude = jnp.float32(1.0)
    frequency = jnp.float32(1.0)
    # the amplitude sum is a host-computable f32 constant (same op order)
    max_amplitude = np.float32(0.0)
    amp_host = np.float32(1.0)
    for i in range(octaves):
        s = (_u32(seed) + _U(i * 1000)).astype(_U)
        total = total + perlin_noise_2d(x * frequency, y * frequency, s) * amplitude
        max_amplitude = np.float32(max_amplitude + amp_host)
        amp_host = np.float32(amp_host * np.float32(roughness))
        amplitude = amplitude * jnp.float32(roughness)
        frequency = frequency * jnp.float32(2.0)
    # TRUE division like the reference (a bare `/` by this compile-time
    # constant gets rewritten by XLA into multiply-by-reciprocal — 1 ulp
    # off for non-power-of-two sums, e.g. octaves=2 -> 1.5; measured
    # 1297/4096 sample points off); exact_div barriers the divisor
    from paintfe_tpu.utils.quant import exact_div

    return exact_div(total, float(max_amplitude))
