"""Serial transform layer tests.

Port of the reference L1 test strategy (reference: tests/test_fftw.py):
exhaustive sweep over dims x sizes x precisions x axis windows, round-trips
for r2c/c2r, c2c, hfft/ihfft, r2r types 1-4 vs scipy, random mixed r2r kinds
vs scipy composed per-axis, and the wisdom surface.  The 'g' (long double)
tier does not exist in XLA and is skipped via fftlib membership, exactly how
the reference skips unavailable precisions (test_fftw.py:37-40).
"""
from itertools import product

import numpy as np
import pytest
import scipy.fft

from mpi4py_fft_jax import fftw

abstol = dict(f=5e-4, d=1e-12)

kinds = {'dst4': fftw.FFTW_RODFT11,
         'dct4': fftw.FFTW_REDFT11,
         'dst3': fftw.FFTW_RODFT01,
         'dct3': fftw.FFTW_REDFT01,
         'dct2': fftw.FFTW_REDFT10,
         'dst2': fftw.FFTW_RODFT10,
         'dct1': fftw.FFTW_REDFT00,
         'dst1': fftw.FFTW_RODFT00}
rkinds = {val: key for key, val in kinds.items()}


def allclose(a, b):
    atol = abstol[np.dtype(a.dtype).char.lower()]
    return np.allclose(a, b, atol=atol)


def _types():
    return [t for t in 'fd' if t.upper() in fftw.fftlib]


@pytest.mark.parametrize("typecode", _types())
@pytest.mark.parametrize("dim", (1, 2, 3))
def test_fftw(typecode, dim):
    rng = np.random.default_rng(42)
    sizes = (7, 8, 10)
    fflags = (fftw.FFTW_ESTIMATE, fftw.FFTW_DESTROY_INPUT)
    iflags = (fftw.FFTW_ESTIMATE, fftw.FFTW_DESTROY_INPUT)
    threads = 1

    if dim < 3:
        shapes = list(product(*([sizes] * dim)))
    else:
        # sample of the full product: odd/even/r2c-edge combinations are
        # exhaustively covered by the dim-1/2 sweeps already
        shapes = [(7, 8, 10), (8, 8, 8), (10, 7, 8), (7, 7, 7)]
    for shape in shapes:
        allaxes = tuple(reversed(range(dim)))
        for i in range(dim):
            for j in range(i + 1, dim):
                axes = allaxes[i:j]

                # r2c <-> c2r
                input_array = fftw.aligned(shape, dtype=typecode)
                outshape = list(shape)
                outshape[axes[-1]] = shape[axes[-1]] // 2 + 1
                output_array = fftw.aligned(outshape, dtype=typecode.upper())
                oa = output_array if typecode == 'd' else None
                rfftn = fftw.rfftn(input_array, None, axes, threads, fflags,
                                   output_array=oa)
                A = rng.random(shape).astype(typecode)
                input_array[:] = A
                B = rfftn()
                assert id(B) == id(rfftn.output_array)
                B2 = np.fft.rfftn(input_array, axes=axes)
                assert allclose(B, B2), np.linalg.norm(B - B2)
                ia = input_array if typecode == 'd' else None
                sa = (np.take(input_array.shape, axes)
                      if shape[axes[-1]] % 2 == 1 else None)
                irfftn = fftw.irfftn(output_array, sa, axes, threads, iflags,
                                     output_array=ia)
                irfftn.input_array[...] = B
                A2 = irfftn(normalize=True)
                assert allclose(A, A2), np.linalg.norm(A - A2)

                # Hermitian transforms
                hfftn = fftw.hfftn(output_array, sa, axes, threads, fflags,
                                   output_array=ia)
                hfftn.input_array[...] = B
                AC = hfftn().copy()
                ihfftn = fftw.ihfftn(input_array, None, axes, threads, iflags,
                                     output_array=oa)
                A2 = ihfftn(AC, implicit=False, normalize=True)
                assert allclose(A2, B), np.linalg.norm(A2 - B)

                # c2c
                input_array = fftw.aligned(shape, dtype=typecode.upper())
                output_array = fftw.aligned_like(input_array)
                oa = output_array if typecode == 'd' else None
                fftn = fftw.fftn(input_array, None, axes, threads, fflags,
                                 output_array=oa)
                C = (rng.random(shape) + 1j * rng.random(shape)).astype(
                    typecode.upper())
                fftn.input_array[...] = C
                D = fftn().copy()
                D2 = np.fft.fftn(C, axes=axes)
                assert allclose(D, D2), np.linalg.norm(D - D2)
                ifftn = fftw.ifftn(input_array, None, axes, threads, iflags,
                                   output_array=oa)
                ifftn.input_array[...] = D
                C2 = ifftn(normalize=True)
                assert allclose(C, C2), np.linalg.norm(C - C2)

                # r2r types 1-4 round-trip + scipy comparison
                input_array = fftw.aligned(shape, dtype=typecode)
                output_array = fftw.aligned_like(input_array)
                oa = output_array if typecode == 'd' else None
                A = rng.random(shape).astype(typecode)
                for type_ in (1, 2, 3, 4):
                    dct = fftw.dctn(input_array, None, axes, type_, threads,
                                    fflags, output_array=oa)
                    B = dct(A).copy()
                    idct = fftw.idctn(input_array, None, axes, type_, threads,
                                      iflags, output_array=oa)
                    A2 = idct(B, implicit=True, normalize=True)
                    assert allclose(A, A2), np.linalg.norm(A - A2)
                    B2 = scipy.fft.dctn(A, axes=axes, type=type_, norm=None)
                    assert allclose(B, B2), np.linalg.norm(B - B2)

                    dst = fftw.dstn(input_array, None, axes, type_, threads,
                                    fflags, output_array=oa)
                    B = dst(A).copy()
                    idst = fftw.idstn(input_array, None, axes, type_, threads,
                                      iflags, output_array=oa)
                    A2 = idst(B, implicit=True, normalize=True)
                    assert allclose(A, A2), np.linalg.norm(A - A2)
                    B2 = scipy.fft.dstn(A, axes=axes, type=type_, norm=None)
                    assert allclose(B, B2), np.linalg.norm(B - B2)

                # random mixed r2r kinds, one per axis, vs scipy per-axis
                naxes = len(axes)
                kds = rng.integers(3, 11, size=naxes)
                tsf = [rkinds[k] for k in kds]
                T = fftw.get_planned_FFT(input_array, input_array.copy(),
                                         axes=axes, kind=kds,
                                         threads=threads, flags=fflags)
                C = T(A)
                TI = fftw.get_planned_FFT(
                    input_array.copy(), input_array.copy(), axes=axes,
                    kind=[fftw.inverse[kd] for kd in kds],
                    threads=threads, flags=iflags)
                C2 = TI(C)
                M = fftw.get_normalization(list(kds), input_array.shape, axes)
                assert allclose(C2 * M, A)
                Aref = A.copy()
                for m, ts in enumerate(tsf):
                    fn = scipy.fft.dct if ts.startswith('dct') else scipy.fft.dst
                    Aref = fn(Aref, axis=axes[m], type=int(ts[-1]), norm=None)
                assert allclose(C, Aref), np.linalg.norm(C - Aref)


def test_wisdom(tmp_path):
    """Wisdom == persistent XLA compilation cache
    (reference: tests/test_fftw.py:140-144).  Asserts the cache directory
    actually gains entries on compile and that a fresh process reuses
    them (cache-hit logging)."""
    import os
    import subprocess
    import sys
    w = str(tmp_path / 'newwisdom.dat')
    prog = (
        "import sys; sys.path.insert(0, {root!r});"
        "import os;"
        "os.environ['XLA_FLAGS']='--xla_force_host_platform_device_count=8';"
        "os.environ['JAX_PLATFORMS']='cpu';"
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from mpi4py_fft_jax import fftw;"
        "fftw.import_wisdom({w!r});"
        "a = fftw.aligned((8, 8), dtype='d');"
        "fftw.rfftn(a)()"
    ).format(root=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
             w=w)
    fftw.export_wisdom(w)
    fftw.forget_wisdom()   # drop in-memory plans so the compile really runs
    a = fftw.aligned((8, 8), dtype='d')
    plan = fftw.rfftn(a)
    plan()  # compile -> populates cache dir
    from mpi4py_fft_jax.ops.plan import _wisdom_dir
    cache_dir = _wisdom_dir(w)
    entries = os.listdir(cache_dir)
    assert len(entries) > 0, "wisdom export produced no cache entries"
    # a fresh process importing the wisdom must HIT the cache (logged by
    # jax as 'Persistent compilation cache hit')
    env = dict(os.environ)
    env['JAX_DEBUG_LOG_MODULES'] = 'jax._src.compiler'
    env.pop('XLA_FLAGS', None)
    out = subprocess.run([sys.executable, '-c', prog], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert 'cache hit' in (out.stderr + out.stdout).lower(), \
        "fresh process did not reuse exported wisdom"
    fftw.import_wisdom(w)
    fftw.forget_wisdom()


def test_timelimit():
    """set_timelimit is accepted and recorded (planner budget has no XLA
    equivalent; reference: tests/test_fftw.py:146-158)."""
    fftw.set_timelimit(0.01)
    input_array = fftw.aligned((32, 32), dtype='d')
    plan = fftw.rfftn(input_array, flags=(fftw.FFTW_PATIENT,))
    plan()
    fftw.cleanup()


def test_aligned():
    a = fftw.aligned((4, 4), n=32, dtype='d', fill=0)
    assert fftw.get_alignment(a) == 32
    b = fftw.aligned_like(a)
    assert b.shape == a.shape and b.dtype == a.dtype


def test_r2r_fft_impl():
    """FFT-backed r2r — ALL eight DCT/DST kinds at even AND odd N
    (DCT-I via the 2(N-1)-point even extension, DST-I via 2(N+1), the
    type-IV pair via half-sample-shift twiddles + parallel prefix, odd-N
    II/III via the generalized Makhoul permutation) — vs the dense
    basis and scipy, both precisions (reference: the guru planner covers
    every kind in O(N log N), fftw/fftw_planxfftn.c:60-70; tolerances
    tests/test_fftw.py:15)."""
    import jax.numpy as jnp
    from mpi4py_fft_jax.ops import core
    from mpi4py_fft_jax.ops.kinds import (
        FFTW_REDFT00, FFTW_REDFT10, FFTW_REDFT01, FFTW_REDFT11,
        FFTW_RODFT00, FFTW_RODFT10, FFTW_RODFT01, FFTW_RODFT11)
    kind2scipy = {FFTW_REDFT00: ('dct', 1), FFTW_REDFT10: ('dct', 2),
                  FFTW_REDFT01: ('dct', 3), FFTW_REDFT11: ('dct', 4),
                  FFTW_RODFT00: ('dst', 1), FFTW_RODFT10: ('dst', 2),
                  FFTW_RODFT01: ('dst', 3), FFTW_RODFT11: ('dst', 4)}
    rng = np.random.default_rng(11)
    prev = core._R2R_IMPL
    try:
        for N in (8, 13, 20, 31):
            for kind, (fn, tp) in kind2scipy.items():
                for dt, tol in (('float32', 2e-5), ('float64', 1e-12)):
                    x = rng.standard_normal((4, N, 3)).astype(dt)
                    core.set_r2r_impl('fft')
                    out = np.asarray(core.r2r(jnp.asarray(x), (1,),
                                              (kind,)))
                    core.set_r2r_impl('dense')
                    dense = np.asarray(core.r2r(jnp.asarray(x), (1,),
                                                (kind,)))
                    ref = getattr(scipy.fft, fn)(
                        x.astype('float64'), type=tp, axis=1, norm=None)
                    sc = max(1.0, float(np.abs(ref).max()))
                    assert np.abs(out - ref).max() / sc < tol, \
                        (N, kind, dt)
                    assert np.abs(dense - ref).max() / sc < tol, \
                        (N, kind, dt)
        # DHT has no scipy reference: cross-check the FFT path (the
        # default engine at N >= 16) against the dense basis
        from mpi4py_fft_jax.ops.kinds import FFTW_DHT
        for N in (8, 13, 20, 31, 64):
            x = rng.standard_normal((3, N, 4))
            core.set_r2r_impl('fft')
            out = np.asarray(core.r2r(jnp.asarray(x), (1,), (FFTW_DHT,)))
            core.set_r2r_impl('dense')
            dense = np.asarray(core.r2r(jnp.asarray(x), (1,),
                                        (FFTW_DHT,)))
            sc = max(1.0, float(np.abs(dense).max()))
            assert np.abs(out - dense).max() / sc < 1e-12, N
    finally:
        core.set_r2r_impl(prev)
