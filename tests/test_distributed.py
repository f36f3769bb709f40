"""Two-process jax.distributed integration test (SURVEY §5 backend row).

Every other test fakes multi-chip with a single-process virtual mesh; this
one actually crosses a process boundary: two subprocesses (4 virtual CPU
devices each) bootstrap through parallel.mesh.init_distributed with a
localhost coordinator, build a process-aware global_mesh, and run the
sharded spectral stage + sharded GPC Laplace tail with Gloo-backed
cross-process psums, asserting equality with single-device oracles
(tests/distributed_worker.py).
"""

import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed():
    port = _free_port()
    env_base = {
        k: v for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "PYTHONPATH")
    }
    procs = []
    for pid in range(2):
        env = dict(
            env_base,
            PYTHONPATH=_REPO,  # this checkout's package, nothing preloaded
            FLGP_COORDINATOR=f"127.0.0.1:{port}",
            FLGP_NUM_PROCESSES="2",
            FLGP_PROCESS_ID=str(pid),
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, os.path.join(_HERE, "distributed_worker.py")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
        )
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, f"worker failed (rc={rc}):\n{out}\n{err[-2000:]}"
        assert "DISTRIBUTED_OK" in out, out
