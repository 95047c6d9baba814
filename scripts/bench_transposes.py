"""Transposes/s: rate of pencil rotations (the all-to-all data-movement path).

BASELINE.json's metric includes "transposes/s at 1 chip / 1 host / N
hosts".  This harness times a jitted chain of pencil rotations (A->B->A)
on the ambient JAX platform's devices (for the 8-device virtual CPU mesh
set JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8;
on one device the rotation is a local relayout).
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from mpi4py_fft_jax.parallel import Subcomm, Pencil

    n = int(os.environ.get('TRANSPOSE_N', 256))
    reps = int(os.environ.get('TRANSPOSE_REPS', 10))
    chain = int(os.environ.get('TRANSPOSE_CHAIN', 8))  # rotations per call

    sub = Subcomm(None, [0, 0, 1])
    shape = (n, n, n)
    pA = Pencil(sub, shape, axis=2)
    pB = pA.pencil(0)

    @jax.jit
    def rotate(x):
        for _ in range(chain // 2):
            x = pB.constrain(x)
            x = pA.constrain(x)
        return x

    rng = np.random.default_rng(0)
    x = jax.device_put(jnp.asarray(rng.standard_normal(shape)
                                   .astype(np.float32)),
                       pA.boundary_sharding())
    y = rotate(x)
    y.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(reps):
        y = rotate(x)
    y.block_until_ready()
    dt = (time.perf_counter() - t0) / (reps * chain)
    gb = n ** 3 * 4 / 1e9
    print(f"pencil rotation {n}^3 f32 over {len(jax.devices())} devices: "
          f"{dt * 1e3:.2f} ms/transpose = {1 / dt:.1f} transposes/s "
          f"({gb / dt:.1f} GB/s moved)")


if __name__ == '__main__':
    main()
