#!/bin/bash
# Test runner (role of the reference tests/runtests.sh:14-37).
#
# The reference runs serial tests, then re-runs the distributed ones under
# `mpiexec -n 2` and `-n 4`.  The single-controller analogue is one run on
# a virtual multi-device CPU mesh; the device count is swept to cover the
# decomposition variants (conftest.py pins 8 devices by default — the env
# var below overrides it per sweep).
set -e
cd "$(dirname "$0")/.."

run () {
  n=$1; shift
  echo "=== devices=$n: $* ==="
  XLA_FLAGS="--xla_force_host_platform_device_count=$n" \
    python -m pytest "$@" -q
}

# serial-layer tests (device count irrelevant)
run 1 tests/test_fftw.py tests/test_libfft.py tests/test_speed.py \
      tests/test_native.py

# distributed layers at 2, 4 and 8 devices (≙ mpiexec -n 2 / 4 / 8)
for n in 2 4 8; do
  run $n tests/test_pencil.py tests/test_darray.py tests/test_planar.py
done
run 8 tests/test_mpifft.py tests/test_io.py tests/test_local_stage.py \
      tests/test_shmap_executor.py tests/test_overlap.py \
      tests/test_profiling.py

# the gspmd executor is a SUPPORTED alternative to the shard_map default
# (PFFT(executor='gspmd') / MPI4PY_FFT_JAX_EXECUTOR=gspmd): re-run the
# full PFFT + planar matrices with every 'auto' selection forced to it,
# so it gets the same 8-device coverage as the production path
echo "=== devices=8 (executor=gspmd sweep) ==="
MPI4PY_FFT_JAX_EXECUTOR=gspmd \
  XLA_FLAGS="--xla_force_host_platform_device_count=8" \
  python -m pytest tests/test_mpifft.py tests/test_planar.py \
  tests/test_io.py -q

# TRUE multi-process groups: 2 jax.distributed workers x 4 devices
# (≙ reference mpiexec -n 2, runtests.sh:14-37)
run 8 tests/test_multiproc.py

# end-to-end DNS workload (≙ reference runtests.sh:36)
run 8 tests/test_dns.py

# examples must run clean (≙ reference runtests.sh examples run)
echo "=== examples ==="
XLA_FLAGS="--xla_force_host_platform_device_count=8" JAX_PLATFORMS=cpu \
  python examples/transforms.py
XLA_FLAGS="--xla_force_host_platform_device_count=8" JAX_PLATFORMS=cpu \
  python examples/darray.py
