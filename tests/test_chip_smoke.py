"""chip_smoke.py refuses to report a result anywhere but on a GPU next to
the package: without a GPU, and as a lone copy of the script, it exits
non-zero and prints no result line."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300,
    )


def _assert_refused(proc):
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_exits_nonzero_without_gpu():
    proc = _run(os.path.join(REPO, "chip_smoke.py"), REPO)
    _assert_refused(proc)
    assert "needs a GPU" in proc.stderr


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    _assert_refused(proc)
    assert "flgp_tpu" in proc.stderr
