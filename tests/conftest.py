"""Test configuration: force the CPU backend with 8 virtual devices.

Golden-parity tests want IEEE f32 (bit-stable vs the reference's CPU math),
and sharding tests want a multi-device mesh without accelerator hardware.  Both are
served by XLA's host platform with a forced device count.
"""

import os
import sys
import pathlib

# Tests run on the CPU backend even on a machine with a GPU: golden parity
# needs the pinned CPU math below, and tiny kernels would spend their time
# compiling for the card.  The persistent compile cache stays off so test
# processes write nothing into the checkout.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("PAINTFE_NO_COMPILE_CACHE", "1")
_flags0 = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags0:
    # SSE4_2: XLA:CPU's LLVM backend contracts mul+add into FMA on AVX2+,
    # which breaks bit-exact parity with the reference's strict f32 (off-by-
    # one u8 at .5 rounding boundaries).  Capping the ISA below FMA keeps the
    # golden comparison pixel-exact.
    os.environ["XLA_FLAGS"] = (
        _flags0
        + " --xla_force_host_platform_device_count=8 --xla_cpu_max_isa=SSE4_2"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
