"""Multi-host distribution layer: 2 real processes x 4 virtual CPU devices.

Each test spawns fresh Python processes (the current test process already
holds a single-process JAX backend, and jax.distributed can only be
initialized once per process).  Workers force the CPU platform in-process
before touching the backend — the environment's platform wrapper defeats
JAX_PLATFORMS alone (see conftest.py).
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(code: str, pid: int, nproc: int, port: int, tmp: pathlib.Path,
           extra_env=None):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PAINTFE_COORDINATOR"] = f"localhost:{port}"
    env["PAINTFE_NUM_PROCESSES"] = str(nproc)
    env["PAINTFE_PROCESS_ID"] = str(pid)
    env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
    if extra_env:
        env.update(extra_env)
    return subprocess.Popen(
        [sys.executable, "-c", code], env=env, cwd=str(tmp),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _run_pair(code: str, tmp: pathlib.Path, timeout=180, extra_env=None):
    port = _free_port()
    procs = [_spawn(code, pid, 2, port, tmp, extra_env) for pid in (0, 1)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=timeout)
        outs.append((p.returncode, out))
    return outs


WORKER_PRELUDE = """
import jax
jax.config.update("jax_platforms", "cpu")
from paintfe_tpu.parallel import distributed
assert distributed.maybe_initialize()
"""


def test_two_process_mesh_and_collective(tmp_path):
    code = WORKER_PRELUDE + """
assert jax.process_count() == 2
assert jax.local_device_count() == 4
assert jax.device_count() == 8

# 2-D hosts x local mesh shape and axis placement
m = distributed.slice_mesh()
assert m.devices.shape == (2, 4)
assert m.axis_names == ("hosts", "local")
# every device in row p belongs to process p
for p in range(2):
    assert all(d.process_index == p for d in m.devices[p])

# deterministic round-robin input sharding, disjoint + covering
mine = distributed.shard_inputs(list(range(10)))
assert mine == list(range(jax.process_index(), 10, 2))

# a real cross-host collective: psum over the global batch mesh
import numpy as np
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P
mesh = distributed.global_batch_mesh()
y = jax.jit(shard_map(lambda x: jax.lax.psum(x, "batch"),
                      mesh=mesh, in_specs=P("batch"), out_specs=P()))(
    jnp.ones((8, 2)))
assert float(np.asarray(y)[0, 0]) == 8.0

# exit-code agreement: process 1 reports failure, both must see it
ok = distributed.all_processes_ok(jax.process_index() != 1)
assert ok is False
print("WORKER-OK", jax.process_index())
"""
    outs = _run_pair(code, tmp_path)
    for rc, out in outs:
        assert rc == 0, out
        assert "WORKER-OK" in out


def test_two_process_cli_shard(tmp_path):
    # four distinct tiny inputs; both hosts run the same CLI invocation and
    # split the work between them
    from PIL import Image

    for i in range(4):
        a = np.zeros((16, 16, 4), np.uint8)
        a[..., 0] = 40 * (i + 1)
        a[..., 3] = 255
        Image.fromarray(a, "RGBA").save(tmp_path / f"in{i}.png")
    (tmp_path / "out").mkdir()
    (tmp_path / "fx.rhai").write_text("apply_invert();\n")

    code = WORKER_PRELUDE + """
import sys
from paintfe_tpu import cli
rc = cli.main([
    "-i", "in*.png", "-s", "fx.rhai", "--shard",
    "--output-dir", "out", "-f", "png",
])
print("CLI-RC", rc)
sys.exit(rc)
"""
    outs = _run_pair(code, tmp_path)
    for rc, out in outs:
        assert rc == 0, out

    from PIL import Image

    for i in range(4):
        p = tmp_path / "out" / f"in{i}.png"
        assert p.exists(), f"missing output for input {i}"
        px = np.asarray(Image.open(p).convert("RGBA"))
        assert px[0, 0, 0] == 255 - 40 * (i + 1)  # invert applied


def test_two_process_cli_shard_keep_going_exit_code(tmp_path):
    # one host hits a decode failure -> BOTH processes must exit 1
    from PIL import Image

    for i in range(4):
        a = np.full((8, 8, 4), 10 * i, np.uint8)
        Image.fromarray(a, "RGBA").save(tmp_path / f"in{i}.png")
    # corrupt one file (round-robin sends in1/in3 to process 1)
    (tmp_path / "in1.png").write_bytes(b"not a png at all")
    (tmp_path / "out").mkdir()

    code = WORKER_PRELUDE + """
import sys
from paintfe_tpu import cli
rc = cli.main([
    "-i", "in*.png", "--shard", "--output-dir", "out", "-f", "png",
])
sys.exit(rc)
"""
    outs = _run_pair(code, tmp_path)
    for rc, out in outs:
        assert rc == 1, out
