"""Multi-process distributed execution tests.

Launches real ``jax.distributed`` process groups (2 and 4 workers on
localhost) running tests/multiproc_worker.py — the JAX analogue of
the reference's ``mpiexec -n 2/4`` distributed test strategy
(reference: tests/runtests.sh:14-37).  Worker processes cannot address each
other's shards, so this exercises the true multi-process code paths:
multi-controller PFFT execution, DistArray process_allgather, and the IO
writers' per-process hyperslab turns.
"""
import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "multiproc_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_group(nprocs, tmpdir):
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # worker sets its own device count
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), str(nprocs), str(port),
             str(tmpdir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for i in range(nprocs)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors="replace"))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert "ALL OK" in out, f"worker {i} incomplete:\n{out}"


@pytest.mark.parametrize("nprocs", (2, 4))
def test_multiproc(nprocs, tmp_path):
    # n=2 and n=4 process groups, matching the reference's mpiexec -n 2/4
    # sweep (reference: tests/runtests.sh:22-37)
    _run_group(nprocs, tmp_path)


def test_weak_scaling_harness():
    """Timed multi-process transposes: the weak-scaling measurement
    protocol (BASELINE >=70% host->pod north-star) must run end-to-end
    on the 2proc x 4dev CPU mesh and emit its efficiency JSON.  The CPU
    TCP number itself is not meaningful — the pod artifact is produced
    by the same script with a per-host launcher."""
    import json
    import subprocess
    out = subprocess.run(
        [sys.executable,
         os.path.join(HERE, os.pardir, "scripts", "bench_weak_scaling.py"),
         "2", "4", "32", "5"],
        stdout=subprocess.PIPE, timeout=600)
    assert out.returncode == 0
    line = [l for l in out.stdout.decode().splitlines()
            if l.startswith('{')][-1]
    r = json.loads(line)
    assert r["weak_scaling_efficiency"] > 0
    assert r["t_transpose_ms_1proc"] > 0 and r["t_transpose_ms_2proc"] > 0
