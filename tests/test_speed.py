"""Serial timing harness with correctness asserts.

Port of the reference performance harness at its full breadth
(reference: tests/test_speed.py:36-155): forward AND inverse transforms
over the reference's axis specs ((1,2), 0, 1, 2), c2c and r2c, this
wrapper vs numpy (pocketfft) vs scipy, plus a libfft backend-vs-backend
table — correctness ``allclose`` asserts, printed tables, no stored
thresholds (the reference stores none either).
"""
from time import time

import numpy as np
import scipy.fft as sfft

import jax

from mpi4py_fft_jax import fftw
from mpi4py_fft_jax.libfft import FFT
from mpi4py_fft_jax.ops import core

N = (64, 64, 64)
AXIS_SPECS = ((1, 2), 0, 1, 2)          # reference: tests/test_speed.py:36
LOOPS = 5


def _time(fn, loops=LOOPS):
    out = fn()  # warmup / compile
    if hasattr(out, 'block_until_ready'):
        out.block_until_ready()
    t0 = time()
    for _ in range(loops):
        out = fn()
    if hasattr(out, 'block_until_ready'):
        out.block_until_ready()
    return (time() - t0) / loops


def _axes(spec):
    return tuple(spec) if np.ndim(spec) else (spec,)


def test_speed_c2c():
    """c2c forward + inverse over the reference's axis specs
    (reference: tests/test_speed.py:36-100)."""
    rng = np.random.default_rng(0)
    C = (rng.random(N) + 1j * rng.random(N)).astype('D')

    rows = []
    for spec in AXIS_SPECS:
        axes = _axes(spec)
        plan = fftw.fftn(fftw.aligned(N, dtype='D'), axes=axes)
        iplan = fftw.ifftn(fftw.aligned_like(plan.output_array),
                           axes=axes)
        plan.input_array[...] = C

        t_us = _time(lambda: plan())
        t_np = _time(lambda: np.fft.fftn(C, axes=axes))
        t_sp = _time(lambda: sfft.fftn(C, axes=axes))
        ref = np.fft.fftn(C, axes=axes)
        assert np.allclose(plan(), ref, atol=1e-8)

        Ch = np.asarray(plan())
        ti_us = _time(lambda: iplan(Ch, normalize=True))
        ti_np = _time(lambda: np.fft.ifftn(Ch, axes=axes))
        assert np.allclose(iplan(Ch, normalize=True), C, atol=1e-8)
        rows.append((str(spec), t_us, t_np, t_sp, ti_us, ti_np))

    print(f"\n64^3 c2c fwd/inv (engine: {core.get_fft_impl()})")
    print(f"  {'axes':>6} {'ours':>9} {'numpy':>9} {'scipy':>9} "
          f"{'i-ours':>9} {'i-numpy':>9}")
    for r in rows:
        print(f"  {r[0]:>6} " + " ".join(f"{t*1e3:8.2f}m" for t in r[1:]))

    # pure-device timing (no host copies) of the jitted engine
    import jax.numpy as jnp
    xd = jnp.asarray(C)
    f = jax.jit(lambda v: core.c2c(v, (0, 1, 2), True))
    t_dev = _time(lambda: f(xd))
    print(f"  device-only jit (0,1,2): {t_dev*1e3:8.2f} ms")


def test_speed_r2c():
    """r2c/c2r forward + inverse over the axis specs
    (reference: tests/test_speed.py:103-155)."""
    rng = np.random.default_rng(1)
    A = rng.random(N)

    rows = []
    for spec in AXIS_SPECS:
        axes = _axes(spec)
        plan = fftw.rfftn(fftw.aligned(N, dtype='d'), axes=axes)
        plan.input_array[...] = A
        t_us = _time(lambda: plan())
        t_np = _time(lambda: np.fft.rfftn(A, axes=axes))
        ref = np.fft.rfftn(A, axes=axes)
        assert np.allclose(plan(), ref, atol=1e-8)

        iplan = fftw.irfftn(fftw.aligned_like(plan.output_array),
                            axes=axes, s=[N[ax] for ax in axes])
        Ah = np.asarray(plan())
        ti_us = _time(lambda: iplan(Ah, normalize=True))
        ti_np = _time(lambda: np.fft.irfftn(Ah, axes=axes,
                                            s=[N[ax] for ax in axes]))
        assert np.allclose(iplan(Ah, normalize=True), A, atol=1e-8)
        rows.append((str(spec), t_us, t_np, ti_us, ti_np))

    print("\n64^3 r2c fwd/inv")
    print(f"  {'axes':>6} {'ours':>9} {'numpy':>9} "
          f"{'i-ours':>9} {'i-numpy':>9}")
    for r in rows:
        print(f"  {r[0]:>6} " + " ".join(f"{t*1e3:8.2f}m" for t in r[1:]))


def test_speed_backends():
    """libfft backend-vs-backend table (the reference's pyfftw/fftw/
    scipy three-way comparison, tests/test_speed.py:40-66; here the
    genuinely distinct planners are jax, numpy, scipy and torch —
    fftw/pyfftw/mkl alias the jax engine, docs/installation.md)."""
    rng = np.random.default_rng(2)
    A = (rng.random(N) + 1j * rng.random(N)).astype('D')

    results = {}
    try:
        import torch  # noqa: F401
        bks = ('jax', 'numpy', 'scipy', 'torch')
    except ImportError:
        bks = ('jax', 'numpy', 'scipy')
    for backend in bks:
        fft = FFT(N, axes=(0, 1, 2), dtype='D', backend=backend)
        fft.forward.input_array[...] = A
        results[backend] = (_time(lambda: fft.forward()),
                            np.asarray(fft.forward()))
    ref = np.fft.fftn(A) / np.prod(N)       # forward normalizes
    print("\n64^3 c2c libfft backends")
    for backend, (t, out) in results.items():
        assert np.allclose(out, ref, atol=1e-8), backend
        print(f"  {backend:>6} {t*1e3:8.2f} ms")
