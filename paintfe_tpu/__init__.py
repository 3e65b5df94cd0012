"""paintfe_tpu — a JAX image-processing framework.

A ground-up JAX/XLA re-design of the capabilities of PaintFE
(reference: a Rust/wgpu raster editor): layered compositing with 25 blend
modes, a LUT-fused adjustment stack, convolution/neighborhood filters,
geometric warps (Liquify / Catmull-Rom mesh warp), a sandboxed scripting
engine, and a headless CLI batch mode whose glob workload shards across a
device mesh.

Design stance (accelerator-first, not a port):
  * images are device-resident dense arrays, u8 at rest, f32 in kernels
  * every op is a pure jittable function (image, mask, params) -> image
  * effect chains are traced once and fused by XLA
  * the batch axis (many images) shards over a `jax.sharding.Mesh`
"""

__version__ = "0.1.0"

import os as _os

# XLA:GPU compiles f32 division to PTX div.full (up to 2 ulp off) and
# square root to sqrt.approx; the u8 quantization of every op needs the
# correctly rounded results the CPU path computes.  These LLVM options make
# the NVPTX backend emit div.rn and libdevice's sqrt.rn (checked in the
# PTX XLA dumps on an H100).  They must be in XLA_FLAGS before JAX creates
# its GPU client, and other backends ignore them; a caller who sets
# xla_backend_extra_options keeps its own.
if "xla_backend_extra_options" not in _os.environ.get("XLA_FLAGS", ""):
    _os.environ["XLA_FLAGS"] = (
        _os.environ.get("XLA_FLAGS", "")
        + " --xla_backend_extra_options=-nvptx-prec-divf32=2,"
          "-nvvm-reflect-add=__CUDA_PREC_SQRT=1").strip()

# Lazy re-exports (PEP 562): the eager imports pulled jax into EVERY
# consumer of the package — including the encode-pool spawn workers,
# whose whole job is zlib+numpy (the jax import tax per worker erased the
# pool's win).  paintfe_tpu.BlendMode etc. still work.
_EXPORTS = {
    "BlendMode": ("paintfe_tpu.core.blend", "BlendMode"),
    "Canvas": ("paintfe_tpu.core.canvas", "Canvas"),
    "Layer": ("paintfe_tpu.core.canvas", "Layer"),
    "Project": ("paintfe_tpu.core.project", "Project"),
}


def __getattr__(name):
    try:
        mod_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module 'paintfe_tpu' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod_name), attr)


def __dir__():
    return sorted(list(globals()) + list(_EXPORTS))
