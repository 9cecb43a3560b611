"""Multi-host smoke test: 2-process jax.distributed over CPU.

Exercises initialize_multihost + make_sharded_search across real process
boundaries (2 processes x 2 virtual devices each), and checks the results
equal a single-process run of the same workload.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "multihost_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed():
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    # workers stay on the CPU backend and never open an accelerator
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, coord, "2", str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            pytest.fail(f"worker timed out; stderr tail: {err[-2000:]}")
        assert p.returncode == 0, f"worker failed: {err[-3000:]}"
        outs.append(out)

    results = {}
    for out in outs:
        m = re.search(r"RESULT process=(\d+) total_hits=(\d+) "
                      r"n_chained=(\d+) ani_sum=([0-9.]+)", out)
        assert m, f"no RESULT line in: {out[-1000:]}"
        results[int(m.group(1))] = (int(m.group(2)), int(m.group(3)),
                                    float(m.group(4)))
    assert results[0] == results[1], "processes disagree"

    # equality with a single-process run of the identical workload
    ref = subprocess.run(
        [sys.executable, WORKER, "", "1", "0"],
        capture_output=True, text=True, timeout=540, env=env)
    assert ref.returncode == 0, ref.stderr[-3000:]
    m = re.search(r"RESULT process=0 total_hits=(\d+) n_chained=(\d+) "
                  r"ani_sum=([0-9.]+)", ref.stdout)
    assert m
    assert (int(m.group(1)), int(m.group(2))) == results[0][:2]
    assert abs(float(m.group(3)) - results[0][2]) < 1e-4
