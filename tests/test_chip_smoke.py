"""chip_smoke.py refuses to report success without a GPU or without the
package beside it."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, os.path.join(script_dir, "chip_smoke.py")],
        cwd=script_dir, env=env, capture_output=True, text=True, timeout=300)


def _assert_failed(proc):
    assert proc.returncode != 0
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    assert '"ok": true' not in last


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    if where == "alone":
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        script_dir = str(tmp_path)
    else:
        script_dir = ROOT
    proc = _run(script_dir)
    _assert_failed(proc)
    assert "no GPU" in proc.stderr
