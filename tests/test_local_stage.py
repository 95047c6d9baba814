"""The local transform stage (ops/matfft.py) on both engines, vs numpy.

Every planar pipeline stage goes through ``matfft.fft1d_p`` /
``rfftn_p`` / ``irfftn_p``.  The ``fft_engine`` fixture (conftest.py)
runs each case on the default 'xla' engine (``jnp.fft``) and on the
dense-DFT 'matmul' engine: axis positions and signs, folded scaling,
3*2^a and long axes, prime (Bluestein) lengths, r2c/c2r with
shardable-extent padding, the 3/2-rule truncation and padding, native
f64 accuracy, and the f64 planar pipeline on one device and under
shard_map (reference test model: mpi4py_fft tests/test_fftw.py and
tests/test_mpifft.py round trips against numpy).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mpi4py_fft_jax.libfft import (pad_planar, pad_spectral,
                                   truncate_planar, truncate_spectral)
from mpi4py_fft_jax.ops import core, matfft
from mpi4py_fft_jax.parallel.planar import PlanarPFFT

F32_TOL = 5e-6
F64_TOL = 1e-12


def _cplx(shape, dtype=np.complex64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _planar(z):
    return jnp.asarray(np.stack([z.real, z.imag]))


def _unplanar(p):
    p = np.asarray(p)
    return p[0] + 1j * p[1]


def _relerr(got, ref):
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _ref_axis(z, axis, forward):
    if forward:
        return np.fft.fft(z, axis=axis)
    return np.fft.ifft(z, axis=axis) * z.shape[axis]


AXIS_CASES = [
    ((64, 32), 1),          # last axis
    ((32, 8, 16), 0),       # leading axis
    ((4, 32, 2, 16), 1),    # middle axis, 4-D
    ((8, 32, 16), 1),       # middle axis
    ((32, 64), 0),          # leading axis, 2-D
    ((64, 8, 16), 2),       # last axis, small N
    ((128, 16), 1),         # last axis, N=16
]


@pytest.mark.parametrize('scale', [None, 0.25])
@pytest.mark.parametrize('forward', [True, False])
@pytest.mark.parametrize('shape,axis', AXIS_CASES)
def test_fft1d_axis(fft_engine, shape, axis, forward, scale):
    z = _cplx(shape, seed=42)
    y = matfft.fft1d_p(_planar(z), axis, forward, scale=scale)
    ref = _ref_axis(z, axis, forward) * (1.0 if scale is None else scale)
    assert y.dtype == np.float32
    assert _relerr(_unplanar(y), ref) < F32_TOL


@pytest.mark.parametrize('pos', ['lead', 'mid', 'last'])
@pytest.mark.parametrize('N', [96, 384, 768])
def test_radix3_lengths(fft_engine, N, pos):
    """3*2^a lengths (the 3/2-rule dealiasing extents, e.g. 768 = 1.5*512)
    at every axis position, forward and scaled inverse round trip."""
    shape, axis = {'lead': ((N, 4, 8), 0), 'mid': ((4, N, 8), 1),
                   'last': ((16, N), 1)}[pos]
    z = _cplx(shape, seed=11)
    p = _planar(z)
    y = matfft.fft1d_p(p, axis, True)
    assert _relerr(_unplanar(y), np.fft.fft(z, axis=axis)) < F32_TOL
    b = matfft.fft1d_p(y, axis, False, scale=1.0 / N)
    assert _relerr(np.asarray(b), np.asarray(p)) < F32_TOL


@pytest.mark.parametrize('forward', [True, False])
@pytest.mark.parametrize('shape,axis', [((2048, 4, 8), 0), ((4, 4096, 8), 1)])
def test_long_axes(fft_engine, shape, axis, forward):
    z = _cplx(shape, seed=23)
    y = matfft.fft1d_p(_planar(z), axis, forward)
    assert _relerr(_unplanar(y), _ref_axis(z, axis, forward)) < F32_TOL


@pytest.mark.parametrize('forward', [True, False])
@pytest.mark.parametrize('N', [37, 61])
def test_prime_lengths(fft_engine, N, forward):
    """Prime extents past the largest radix: Bluestein on the matmul
    engine, the library's own plan on the xla engine."""
    z = _cplx((6, N), dtype=np.complex128, seed=5)
    y = matfft.fft1d_p(_planar(z), 1, forward)
    assert _relerr(_unplanar(y), _ref_axis(z, 1, forward)) < F64_TOL


@pytest.mark.parametrize('shape,axis,hext', [
    ((64, 32), 1, None),
    ((64, 32), 1, 20),          # shardable-extent zero rows (N//2+1 = 17)
    ((32, 4, 16), 0, None),
    ((4, 32, 16), 1, 18),
    ((4, 30, 16), 1, None),     # even, not a power of two
    ((5, 33), 1, 20),           # odd length
])
def test_r2c_c2r(fft_engine, shape, axis, hext):
    """r2c writes the Hermitian half (plus exact zero pad rows up to
    ``hext``); c2r ignores pad rows and returns the real signal (FFTW
    r2c guru-path parity, reference: fftw/fftw_planxfftn.c:50-56)."""
    x = np.random.default_rng(33).standard_normal(shape).astype(np.float32)
    y = matfft.rfftn_p(jnp.asarray(x), (axis,), hext=hext)
    got = _unplanar(y)
    ref = np.fft.rfft(x, axis=axis)
    nh = ref.shape[axis]
    assert got.shape[axis] == (hext or nh)
    assert _relerr(np.take(got, range(nh), axis=axis), ref) < F32_TOL
    if got.shape[axis] > nh:
        tail = np.take(got, range(nh, got.shape[axis]), axis=axis)
        assert float(np.abs(tail).max()) == 0.0
    N = shape[axis]
    xr = matfft.irfftn_p(y, (axis,), N, scale=1.0 / N)
    assert xr.shape == x.shape and xr.dtype == np.float32
    assert _relerr(np.asarray(xr), x) < F32_TOL


TRUNC_CASES = [((8, 64, 16), 1, 43), ((512, 24), 1, 9), ((24, 4, 16), 0, 9)]


@pytest.mark.parametrize('shape,axis,Nt', TRUNC_CASES)
def test_r2c_hermitian_truncation(fft_engine, shape, axis, Nt):
    """r2c + planar HERMITIAN 3/2-rule truncation == the reference rule
    on numpy's half spectrum (reference: libfft.py:263-284)."""
    x = np.random.default_rng(41).standard_normal(shape)
    got = truncate_planar(matfft.rfftn_p(jnp.asarray(x), (axis,)),
                          1 + axis, Nt, hermitian=True)
    full = np.fft.rfft(x, axis=axis)
    tshape = list(shape)
    tshape[axis] = Nt
    ref = truncate_spectral(full, tuple(tshape), axis, True, xp=np)
    assert _relerr(_unplanar(got), ref) < F64_TOL


@pytest.mark.parametrize('shape,axis,Nt', TRUNC_CASES)
def test_c2r_hermitian_padding(fft_engine, shape, axis, Nt):
    """Planar HERMITIAN zero-padding + c2r == the reference padding rule
    followed by numpy's irfft (reference: libfft.py:286-311)."""
    N = shape[axis]
    x = np.random.default_rng(43).standard_normal(shape)
    tshape = list(shape)
    tshape[axis] = Nt
    t = truncate_spectral(np.fft.rfft(x, axis=axis), tuple(tshape), axis,
                          True, xp=np)
    p = pad_planar(_planar(t), 1 + axis, N // 2 + 1, hermitian=True)
    got = np.asarray(matfft.irfftn_p(p, (axis,), N, scale=1.0 / N))
    hshape = list(shape)
    hshape[axis] = N // 2 + 1
    ref = np.fft.irfft(pad_spectral(t, tuple(hshape), axis, True, xp=np),
                       n=N, axis=axis)
    assert _relerr(got, ref) < F64_TOL


@pytest.mark.parametrize('shape,axis,Nt', [((8, 24, 16), 1, 16),
                                           ((36, 8), 0, 24),
                                           ((4, 6, 48), 2, 32)])
def test_c2c_truncation_padding(fft_engine, shape, axis, Nt):
    """Full-axis 3/2-rule truncation after the forward transform and the
    symmetric zero-padding before the inverse, vs the reference rules."""
    z = _cplx(shape, dtype=np.complex128, seed=47)
    got = truncate_planar(matfft.fft1d_p(_planar(z), axis, True),
                          1 + axis, Nt, hermitian=False)
    tshape = list(shape)
    tshape[axis] = Nt
    ref = truncate_spectral(np.fft.fft(z, axis=axis), tuple(tshape), axis,
                            False, xp=np)
    assert _relerr(_unplanar(got), ref) < F64_TOL
    back = matfft.fft1d_p(pad_planar(got, 1 + axis, shape[axis], False),
                          axis, False)
    refb = np.fft.ifft(pad_spectral(ref, shape, axis, False, xp=np),
                       axis=axis) * shape[axis]
    assert _relerr(_unplanar(back), refb) < F64_TOL


@pytest.mark.parametrize('N', [64, 128, 256, 512])
def test_f64_accuracy(fft_engine, N):
    """Native f64: a complex128 transform agrees with numpy to ~1e-15."""
    z = _cplx((N, 4, 8), dtype=np.complex128, seed=2)
    y = matfft.fft1d_p(_planar(z), 0, True)
    assert y.dtype == np.float64
    assert _relerr(_unplanar(y), np.fft.fft(z, axis=0)) < F64_TOL


def _pipeline_case(dtype, shape, grid):
    pfft = PlanarPFFT(None, shape, dtype=dtype, grid=grid)
    if dtype == 'D':
        z = _cplx(shape, dtype=np.complex128, seed=7)
        x, ref = _planar(z), np.fft.fftn(z) / z.size
    else:
        xr = np.random.default_rng(7).standard_normal(shape)
        x, ref = jnp.asarray(xr), np.fft.rfftn(xr) / xr.size
    uh = pfft.forward(x)
    assert _relerr(_unplanar(uh), ref) < F64_TOL
    back = pfft.backward(uh)
    assert _relerr(np.asarray(back), np.asarray(x)) < F64_TOL
    return pfft


@pytest.mark.parametrize('dtype', ['D', 'd'])
def test_f64_pipeline_single_device(fft_engine, dtype):
    pfft = _pipeline_case(dtype, (32, 32, 32), (1, 1, 1))
    assert pfft.executor == 'gspmd'


@pytest.mark.parametrize('dtype', ['D', 'd'])
def test_f64_pipeline_shard_map(fft_engine, dtype):
    if jax.device_count() < 8:
        pytest.skip("needs the 8-device mesh")
    pfft = _pipeline_case(dtype, (32, 32, 32), (4, 2))
    assert pfft.executor == 'shard_map'


@pytest.mark.parametrize('dtype', ['F', 'f'])
def test_donated_chain_roundtrip(fft_engine, dtype):
    """Chained forward/backward pairs in one jitted call on a DONATED
    input (the in-place buffer schedule a solver loop uses)."""
    shape = (16, 32, 32)
    pfft = PlanarPFFT(None, shape, dtype=dtype, grid=(1, 1, 1))

    def chain(q):
        for _ in range(3):
            q = pfft.backward_fn(pfft.forward_fn(q, True), False)
        return q
    step = jax.jit(chain, donate_argnums=(0,))
    x = np.random.default_rng(9).standard_normal(
        pfft.global_shape(False)).astype(np.float32)
    y = step(jnp.asarray(x))
    assert y.shape == x.shape and y.dtype == np.float32
    assert _relerr(np.asarray(y), x) < F32_TOL


def test_engine_choice(monkeypatch):
    """'xla' is the default engine (measured faster on the GPU); an
    unknown engine is refused."""
    import importlib
    prev = core.get_fft_impl()
    monkeypatch.delenv('MPI4PY_FFT_JAX_FFT_IMPL', raising=False)
    importlib.reload(core)
    try:
        assert core.get_fft_impl() == 'xla'
        with pytest.raises(ValueError):
            core.set_fft_impl('bogus')
    finally:
        core.set_fft_impl(prev)


def test_engine_lowering(fft_engine):
    """The xla engine lowers a stage to XLA's FFT op; the matmul engine
    to dot products and no FFT op."""
    p = jnp.zeros((2, 8, 64), jnp.float32)
    txt = jax.jit(lambda v: matfft.fft1d_p(v, 1, True)).lower(p).as_text()
    if fft_engine == 'xla':
        assert 'stablehlo.fft' in txt
    else:
        assert 'stablehlo.fft' not in txt and 'dot_general' in txt
