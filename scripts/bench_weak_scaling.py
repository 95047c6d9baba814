"""Weak-scaling harness: multi-process pencil transposes.

This script is a weak-scaling measurement protocol, exercised end-to-end
on a multi-process CPU mesh (P jax.distributed processes x D virtual
devices each — the analogue of the reference's oversubscribed ``mpiexec``
runs): run the same timed transpose at 1 process and at P processes with
a CONSTANT per-process data volume, and report the efficiency t_1 / t_P.
With one process per GPU the identical program measures NVLink instead
of TCP; only the launcher changes.

The timed operation is the production data-movement path: the pencil
rotation pencil(axis=2) <-> pencil(axis=0) over the FULL device mesh —
a tiled ``lax.all_to_all`` whose participating group spans the process
boundary, executed inside shard_map exactly as the PFFT executors emit
it (parallel/mpifft.py, parallel/planar.py; role of the reference's
``Alltoallw``, mpi4py_fft/pencil.py:182-201).

Usage:
    python scripts/bench_weak_scaling.py [P] [D] [n] [reps]
        parent: spawns the 1-process baseline then the P-process group,
        prints one summary JSON line (default P=2, D=4, n=64, reps=20)
    python scripts/bench_weak_scaling.py --worker <pid> <P> <port> <D> <n> <reps>
        one worker process (internal)

Also reachable as ``python bench.py --weak-scaling``.
"""
import json
import os
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _worker(pid, nprocs, port, ndev_local, n, reps):
    sys.path.insert(0, ROOT)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags +
            f" --xla_force_host_platform_device_count={ndev_local}").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    if nprocs > 1:
        from mpi4py_fft_jax.parallel import multihost
        multihost.initialize(coordinator_address=f"localhost:{port}",
                             num_processes=nprocs, process_id=pid)
    import jax.numpy as jnp
    import numpy as np
    from jax import lax
    from mpi4py_fft_jax.parallel import Subcomm

    ndev = len(jax.devices())
    assert ndev == nprocs * ndev_local, (ndev, nprocs, ndev_local)

    # weak scaling: the distributed axis grows with the process count, so
    # every process keeps the same shard volume (n/D, n, n) per device
    shape = (n * nprocs, n, n)
    sub = Subcomm(None, [0, 1, 1])              # all devices on axis 0
    # participating group for the rotation axis2 <-> axis0: the device
    # group that shards axis 0 (spans the process boundary when P > 1)
    g = sub[0].name
    chain = 4

    def rot(x):
        for _ in range(chain // 2):
            x = lax.all_to_all(x, g, split_axis=2, concat_axis=0,
                               tiled=True)
            x = lax.all_to_all(x, g, split_axis=0, concat_axis=2,
                               tiled=True)
        return x

    from jax.sharding import PartitionSpec as P
    spec = P(sub[0].name, None, None)           # pencil A layout (axis 0
    f = jax.jit(jax.shard_map(rot, mesh=sub.mesh,   # sharded, axis 2
                              in_specs=(spec,), out_specs=spec))  # whole)
    x = jax.device_put(
        jnp.zeros(shape, jnp.float32),
        jax.sharding.NamedSharding(sub.mesh, spec))
    y = f(x)
    jax.block_until_ready(y)
    for _ in range(2):                          # warmup
        y = f(y)
    jax.block_until_ready(y)
    if nprocs > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("ws_t0")
    t0 = time.perf_counter()
    for _ in range(reps):
        y = f(y)
    jax.block_until_ready(y)
    if nprocs > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("ws_t1")
    dt = (time.perf_counter() - t0) / (reps * chain)
    gb_local = np.prod(shape) * 4 / nprocs / 1e9
    print(json.dumps({"pid": pid, "nprocs": nprocs,
                      "t_transpose_ms": dt * 1e3,
                      "per_process_GBps": gb_local / dt}), flush=True)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_group(nprocs, ndev_local, n, reps, timeout=600):
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(i),
         str(nprocs), str(port), str(ndev_local), str(n), str(reps)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for i in range(nprocs)]
    t_ms = None
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, \
            f"worker {i} failed:\n{out.decode(errors='replace')}"
        for ln in out.decode(errors="replace").splitlines():
            if ln.startswith('{'):
                r = json.loads(ln)
                if r["pid"] == 0:
                    t_ms = r["t_transpose_ms"]
                    gbps = r["per_process_GBps"]
    assert t_ms is not None, "no timing from process 0"
    return t_ms, gbps


def main(nprocs=2, ndev_local=4, n=64, reps=20):
    # single-process baseline: same per-process volume, same local mesh
    t1, gb1 = _run_group(1, ndev_local, n, reps)
    tp, gbp = _run_group(nprocs, ndev_local, n, reps)
    eff = t1 / tp
    print(json.dumps({
        "metric": f"pencil-transpose weak scaling "
                  f"{nprocs}proc x {ndev_local}dev vs 1proc",
        "t_transpose_ms_1proc": round(t1, 3),
        f"t_transpose_ms_{nprocs}proc": round(tp, 3),
        "per_process_GBps_1proc": round(gb1, 3),
        f"per_process_GBps_{nprocs}proc": round(gbp, 3),
        "weak_scaling_efficiency": round(eff, 3),
        "note": "per-process shard volume held constant; the same "
                "protocol on a pod measures the >=70% host->pod target "
                "(BASELINE.md north-star)",
    }), flush=True)
    return eff


if __name__ == '__main__':
    if len(sys.argv) > 1 and sys.argv[1] == '--worker':
        _worker(*map(int, sys.argv[2:8]))
    else:
        args = [int(a) for a in sys.argv[1:5]]
        main(*args)
