"""REAL multi-process bootstrap + cross-process distributed BA (P5-COMM).

Every other distributed test runs on a single-process virtual mesh; this one
executes the actual `jax.distributed.initialize` path (`init_multihost`) with
TWO OS processes, each owning 4 virtual CPU devices, forming one 8-device
global mesh. The landmark-sharded Schur BA's psums then genuinely cross the
process boundary (Gloo transport on CPU; the identical code rides NCCL
across GPUs). Closes the one "partial" row of SURVEY.md section 2.2: the
multi-host bootstrap had shipped without ever executing (VERDICT r4 P5).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "scripts" / "multihost_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_bootstrap_and_cross_process_ba():
    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("PYTHONPATH", None)
    procs = [
        subprocess.Popen([sys.executable, str(WORKER), str(i), "2", str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env, cwd=ROOT)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))

    by_pid = {o["pid"]: o for o in outs}
    assert by_pid[0]["global_devices"] == 8
    assert by_pid[1]["global_devices"] == 8
    assert by_pid[0]["local_devices"] == 4
    # Replicated outputs agree across processes (they came out of the same
    # cross-process psums).
    assert abs(by_pid[0]["cost"] - by_pid[1]["cost"]) < 1e-9
    # Process 0's in-worker parity assertion ran.
    assert by_pid[0]["parity"] == "OK"
    assert by_pid[0]["x_diff_vs_single"] < 1e-4
    # Time-sharded PGO (ring-ppermute halos ACROSS processes) also agreed
    # with the dense single-device solver.
    assert by_pid[0]["pgo_parity"] == "OK"
    assert abs(by_pid[0]["pgo_cost"] - by_pid[1]["pgo_cost"]) < 1e-9
