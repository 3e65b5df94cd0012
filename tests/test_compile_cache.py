"""Persistent XLA compilation cache: the CLI's cold-start fix.

The reference CLI is a native binary with zero per-process warmup
(src/cli.rs:105-216); our JAX process must instead reach warm behavior via
the on-disk executable cache.  These tests drive the real CLI in fresh
subprocesses (the cache only matters across processes) on the CPU backend.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from paintfe_tpu.io import codecs

REPO = pathlib.Path(__file__).resolve().parent.parent


# Like conftest.py, the subprocess pins the CPU backend via jax.config
# before any backend initializes, then runs the real CLI main().
_LAUNCHER = (
    "import jax; jax.config.update('jax_platforms', 'cpu');"
    "import sys; from paintfe_tpu.cli import main;"
    "sys.exit(main(sys.argv[1:]))"
)


def _run_cli(tmp_path, cache_dir, tag):
    src = tmp_path / f"in_{tag}.png"
    rng = np.random.default_rng(3)
    codecs.save_image(rng.integers(0, 256, (24, 24, 4)).astype(np.uint8),
                      src, "png")
    script = tmp_path / "s.rhai"
    # apply_blur routes through a jitted XLA program (the pointwise
    # script-only ops are plain numpy and would compile nothing)
    script.write_text("apply_blur(2.0);")
    out = tmp_path / f"out_{tag}.png"
    env = dict(os.environ)
    env.pop("PAINTFE_NO_COMPILE_CACHE", None)
    env["JAX_COMPILATION_CACHE_DIR"] = str(cache_dir)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _LAUNCHER, "-i", str(src),
         "-s", str(script), "-o", str(out), "--profile"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr
    assert out.exists()
    return proc.stdout + proc.stderr


def _cache_files(cache_dir):
    return [p for p in pathlib.Path(cache_dir).rglob("*") if p.is_file()]


def test_cli_populates_and_hits_persistent_cache(tmp_path):
    cache = tmp_path / "xla_cache"
    out1 = _run_cli(tmp_path, cache, "a")
    files = _cache_files(cache)
    assert files, "first CLI run must populate the persistent cache"
    m1 = re.search(r"compile cache.*?(\d+) hit", out1)
    assert m1, out1

    out2 = _run_cli(tmp_path, cache, "b")
    assert len(_cache_files(cache)) >= len(files)
    m2 = re.search(r"compile cache.*?(\d+) hit", out2)
    assert m2, out2
    assert int(m2.group(1)) > 0, f"second cold process saw no cache hits:\n{out2}"


def test_cache_disabled_via_env(tmp_path, monkeypatch):
    monkeypatch.setenv("PAINTFE_NO_COMPILE_CACHE", "1")
    from paintfe_tpu.utils import compile_cache

    assert compile_cache.enable_persistent_cache() is None


@pytest.mark.parametrize("environ,expected", [
    ({"JAX_COMPILATION_CACHE_DIR": "/some/dir"}, "/some/dir"),
    ({}, "checkout"),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, "checkout"),
    ({"PAINTFE_NO_COMPILE_CACHE": "1",
      "JAX_COMPILATION_CACHE_DIR": "/some/dir"}, None),
    ({"PAINTFE_NO_COMPILE_CACHE": "0"}, "checkout"),
])
def test_cache_dir_resolution(environ, expected):
    """$JAX_COMPILATION_CACHE_DIR wins whenever it is set; otherwise the
    cache sits at a fixed path inside the checkout, listed in .gitignore."""
    from paintfe_tpu.utils import compile_cache

    got = compile_cache.resolve_cache_dir(environ)
    if expected == "checkout":
        assert got == str(REPO / ".xla_cache")
        ignored = (REPO / ".gitignore").read_text().split()
        assert ".xla_cache/" in ignored
    else:
        assert got == expected


def test_cli_caches_only_in_the_env_directory(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the CLI's entries land there and
    the in-checkout default directory gains nothing."""
    from paintfe_tpu.utils import compile_cache

    default = compile_cache.CHECKOUT_CACHE_DIR
    before = set(_cache_files(default)) if default.exists() else set()
    cache = tmp_path / "env_cache"
    _run_cli(tmp_path, cache, "env")
    assert _cache_files(cache)
    after = set(_cache_files(default)) if default.exists() else set()
    assert after == before
