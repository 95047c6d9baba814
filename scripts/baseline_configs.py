"""Run the five BASELINE.json milestone configs and report status/timing.

Configs (BASELINE.md):
  1. serial 2-D c2c + r2c 128x128 (single device)
  2. 3-D c2c slab 256^3 round-trip vs numpy.fft
  3. 3-D r2c pencil 512^3 with 3/2 dealiasing padding
  4. DCT-II/DST-II 3-D 256^3 pencil
  5. spectral DNS solver (64^3 quick / 512^3 full via DNS_N env)

Runs on the ambient JAX platform (for the 8-device virtual CPU mesh set
JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8).
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np


def timed(tag, fn):
    t0 = time.perf_counter()
    fn()
    print(f"  [{tag}] OK  ({time.perf_counter() - t0:.2f} s)", flush=True)


def config1():
    from mpi4py_fft_jax import fftw
    rng = np.random.default_rng(0)
    A = fftw.aligned((128, 128), dtype='D')
    plan = fftw.fftn(A, axes=(0, 1))
    A[:] = rng.random((128, 128)) + 1j * rng.random((128, 128))
    B = plan()
    assert np.allclose(B, np.fft.fftn(A), atol=1e-8)
    Ar = fftw.aligned((128, 128), dtype='d')
    rplan = fftw.rfftn(Ar, axes=(0, 1))
    Ar[:] = rng.random((128, 128))
    Br = rplan()
    assert np.allclose(Br, np.fft.rfftn(Ar), atol=1e-8)


def config2():
    from mpi4py_fft_jax import PFFT, newDistArray
    n = int(os.environ.get('C2_N', 256))
    fft = PFFT(None, (n, n, n), grid=(-1,), dtype='D')
    rng = np.random.default_rng(1)
    u = newDistArray(fft, False)
    u[:] = rng.random(u.shape) + 1j * rng.random(u.shape)
    uh = fft.forward(u)
    ref = np.fft.fftn(np.asarray(u)) / n ** 3
    assert np.allclose(np.asarray(uh), ref, atol=1e-8)
    ub = fft.backward(uh)
    assert np.allclose(np.asarray(ub), np.asarray(u), atol=1e-8)


def config3():
    from mpi4py_fft_jax import PFFT, newDistArray
    n = int(os.environ.get('C3_N', 512))
    fft = PFFT(None, (n, n, n), padding=[1.5, 1.5, 1.5], dtype='d')
    rng = np.random.default_rng(2)
    uh = newDistArray(fft, True)
    sh = uh.shape
    uh[:] = rng.random(sh) + 1j * rng.random(sh)
    up = fft.backward(uh)
    uh2 = fft.forward(up)
    up2 = fft.backward(uh2)
    uh3 = fft.forward(up2)
    assert np.allclose(np.asarray(uh3), np.asarray(uh2), atol=1e-7)


def config4():
    import functools
    from mpi4py_fft_jax import PFFT, newDistArray, fftw
    n = int(os.environ.get('C4_N', 256))
    dct2 = functools.partial(fftw.dctn, type=2)
    idct2 = functools.partial(fftw.idctn, type=2)
    dst2 = functools.partial(fftw.dstn, type=2)
    idst2 = functools.partial(fftw.idstn, type=2)
    fft = PFFT(None, (n, n, n), axes=((0,), (1,), (2,)),
               transforms={(0,): (dct2, idct2), (1,): (dct2, idct2),
                           (2,): (dst2, idst2)})
    rng = np.random.default_rng(3)
    u = newDistArray(fft, False)
    u[:] = rng.random(u.shape)
    uh = fft.forward(u)
    ub = fft.backward(uh)
    assert np.allclose(np.asarray(ub), np.asarray(u), atol=1e-7)


def config5():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__),
                                    os.pardir, 'examples'))
    import spectral_dns_solver as dns
    n = int(os.environ.get('DNS_N', 64))
    k = dns.run(N=(n, n, n), verbose=False)
    if n == 64:
        assert round(k - 0.124953117517, 7) == 0, k


if __name__ == '__main__':
    timed('1 serial 2D c2c+r2c 128^2', config1)
    timed('2 c2c slab 256^3 roundtrip', config2)
    timed('3 r2c pencil 3/2-padding', config3)
    timed('4 DCT-II/DST-II pencil', config4)
    timed('5 spectral DNS', config5)
    print('ALL BASELINE CONFIGS PASS')
