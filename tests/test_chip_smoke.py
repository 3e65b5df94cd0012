"""chip_smoke.py refuses to report success anywhere but on a GPU.

It runs on the card only; here (CPU) it must exit non-zero without
printing an ok result, both beside the package and on its own.
"""

import os
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent


def _run(script: pathlib.Path, cwd: pathlib.Path):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)  # the script finds the package beside it
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, cwd=str(cwd), env=env, timeout=300)


def test_fails_without_a_gpu(tmp_path):
    proc = _run(REPO / "chip_smoke.py", tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_fails_without_the_package(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", lone)
    proc = _run(lone, tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
