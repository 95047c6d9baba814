"""Worker program for the multi-process distributed tests.

Each worker is one jax.distributed process with 4 virtual CPU devices; the
global mesh spans ``num_processes * 4`` devices.  This is the exact
analogue of the reference's oversubscribed ``mpiexec -n 2/4`` distributed
test runs (reference: tests/runtests.sh:14-37): the same program runs on
every process, arrays are globally sharded, and no process can address the
other's shards — exercising the multi-process paths of PFFT, DistArray
(process_allgather) and the IO writers (per-process hyperslab turns).

Usage: python multiproc_worker.py <process_id> <num_processes> <port> <tmpdir>
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

PROC = int(sys.argv[1])
NPROCS = int(sys.argv[2])
PORT = sys.argv[3]
TMP = sys.argv[4]

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax                                                    # noqa: E402
jax.config.update("jax_platforms", "cpu")

from mpi4py_fft_jax.parallel import multihost                 # noqa: E402
multihost.initialize(coordinator_address=f"localhost:{PORT}",
                     num_processes=NPROCS, process_id=PROC)

import numpy as np                                            # noqa: E402
from mpi4py_fft_jax import PFFT, newDistArray, DistArray      # noqa: E402

assert multihost.is_multihost()
assert multihost.process_count() == NPROCS
NDEV = len(jax.devices())
assert NDEV == 4 * NPROCS, NDEV


def check(cond, label):
    assert cond, f"[proc {PROC}] FAILED: {label}"
    print(f"[proc {PROC}] ok: {label}", flush=True)


# ---- PFFT forward/backward round-trip over the multi-process mesh --------
shape = (16, 16, 16)
fft = PFFT(None, shape, dtype='d', grid=(NDEV // 2, 2))
u = newDistArray(fft, False)
rng = np.random.default_rng(0)          # same seed everywhere -> same X
X = rng.random(shape)
u[...] = X
assert not u.v.is_fully_addressable     # really multi-process
u_hat = fft.forward(u)
ref = np.fft.rfftn(X) / np.prod(shape)
check(np.allclose(np.asarray(u_hat), ref, rtol=0, atol=2e-10),
      "PFFT forward matches numpy")
uj = fft.backward(u_hat)
check(np.allclose(np.asarray(uj), X, rtol=0, atol=2e-10),
      "PFFT roundtrip")

# ---- uneven extents across processes (reference 12/13-style shapes) ------
# padded at-rest shards + lcm-padded shard_map pipeline, multi-controller
shape_u = (12, 13, 14)
fft_u = PFFT(None, shape_u, dtype='D')
Xu = (rng.random(shape_u) + 1j * rng.random(shape_u))
uu = newDistArray(fft_u, False)
uu[...] = Xu
uu_hat = fft_u.forward(uu)
refu = np.fft.fftn(Xu) / np.prod(shape_u)
check(np.allclose(np.asarray(uu_hat), refu, rtol=0, atol=2e-10),
      "uneven-extent PFFT forward matches numpy")
uuj = fft_u.backward(uu_hat)
check(np.allclose(np.asarray(uuj), Xu, rtol=0, atol=2e-10),
      "uneven-extent PFFT roundtrip")

# ---- PlanarPFFT shard_map executor across processes -----------------------
# explicit tiled lax.all_to_all transposes spanning process boundaries
from mpi4py_fft_jax.parallel.planar import PlanarPFFT      # noqa: E402
pp = PlanarPFFT(None, (16, 16, 16), dtype='D', executor='shard_map')
assert pp.executor == 'shard_map'
Xp = (rng.random((16, 16, 16)) + 1j * rng.random((16, 16, 16)))
pin = jax.device_put(
    np.ascontiguousarray(np.stack([Xp.real, Xp.imag])),
    pp.pencil[0].boundary_sharding(1))
phat = pp.forward(pin)
from mpi4py_fft_jax.parallel.mpifft import _host_value     # noqa: E402
ph = _host_value(phat)
refp = np.fft.fftn(Xp) / Xp.size
check(np.allclose(ph[0] + 1j * ph[1], refp, rtol=0, atol=2e-10),
      "PlanarPFFT shard_map forward matches numpy")

# ---- DistArray redistribute across processes ------------------------------
a = DistArray((8, 12, 16), alignment=0, dtype='d')
Y = rng.random((8, 12, 16))
a[...] = Y
b = a.redistribute(2)
check(np.allclose(np.asarray(b), Y), "redistribute across processes")

# ---- HDF5 concurrent (VDS) write + reshard-on-load ------------------------
# default mode: every process streams its shards to a sidecar in
# parallel, process 0 stitches a virtual dataset (the reference's
# all-ranks-write-simultaneously mpio behavior, io/h5py_file.py:33,72)
h5 = os.path.join(TMP, "mp.h5")
u.write(h5, name="u", step=0)
multihost.sync_global_devices("after-write")
v = newDistArray(fft, False)
v.read(h5, name="u", step=0)
check(np.allclose(np.asarray(v), X), "HDF5 concurrent write/read roundtrip")

# read into a DIFFERENT decomposition (reader != writer, docs/io.rst:61-62)
w = DistArray(shape, alignment=0, dtype='d')
w.read(h5, name="u", step=0)
check(np.allclose(np.asarray(w), X), "HDF5 reshard-on-load")

# serialized turn-taking fallback must produce byte-identical data
os.environ['MPI4PY_FFT_JAX_H5_MODE'] = 'serial'
h5s = os.path.join(TMP, "mp_serial.h5")
u.write(h5s, name="u", step=0)
multihost.sync_global_devices("after-write-serial")
del os.environ['MPI4PY_FFT_JAX_H5_MODE']
if PROC == 0:
    import h5py
    with h5py.File(h5, 'r') as fv, h5py.File(h5s, 'r') as fs:
        dv = np.asarray(fv["u/3D/0"])
        ds = np.asarray(fs["u/3D/0"])
    check(dv.tobytes() == ds.tobytes(),
          "VDS and serial writes byte-identical")
multihost.sync_global_devices("after-compare")

# repack=True: sidecars streamed in parallel, then drained into ONE
# self-contained contiguous file (the reference's single mpio artifact,
# io/h5py_file.py:33,72) and deleted
from mpi4py_fft_jax import HDF5File                         # noqa: E402
h5r = os.path.join(TMP, "mp_repack.h5")
frp = HDF5File(h5r, mode='w', domain=((0, 1),) * 3, repack=True)
frp.write(0, {"u": [u]})
multihost.sync_global_devices("after-write-repack")
if PROC == 0:
    import glob
    import h5py
    check(not glob.glob(h5r + ".p*.h5"),
          "repack removed every sidecar file")
    with h5py.File(h5r, 'r') as fr, h5py.File(h5s, 'r') as fs:
        check(not fr["u/3D/0"].is_virtual,
              "repacked dataset is contiguous, not virtual")
        dr = np.asarray(fr["u/3D/0"])
        ds = np.asarray(fs["u/3D/0"])
    check(dr.tobytes() == ds.tobytes(),
          "repacked and serial writes byte-identical")
multihost.sync_global_devices("after-repack-compare")

multihost.sync_global_devices("done")
print(f"[proc {PROC}] ALL OK", flush=True)
