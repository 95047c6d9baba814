"""The full-featured PFFT's multi-device production path.

PFFT(backend='jax') on a multi-device mesh routes through the shard_map
executor: explicit tiled lax.all_to_all pencil transposes + per-shard
kernels (parallel/mpifft.py Transform._impl_shmap).  These tests assert:

* executor selection (auto -> shard_map on the 8-device mesh, opt-out);
* numerical agreement between the shard_map and gspmd executors across
  the feature matrix (r2c, c2c, uneven extents, dealiasing padding,
  collapse, r2r transforms dicts);
* the compiled HLO moves pencils with all-to-all (no all-gather in the
  pipeline) for production (evenly divisible) shapes.
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mpi4py_fft_jax import PFFT, newDistArray, fftw


def _rand(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == 'c':
        return (rng.random(shape) + 1j * rng.random(shape)).astype(dtype)
    return rng.random(shape).astype(dtype)


def test_executor_selection():
    fft = PFFT(None, (16, 16, 16), dtype='d')
    assert fft.executor == 'shard_map'
    assert fft.forward._executor == 'shard_map'
    assert fft.backward._executor == 'shard_map'
    fft2 = PFFT(None, (16, 16, 16), dtype='d', executor='gspmd')
    assert fft2.executor == 'gspmd'
    # host backends have no device executor
    fft3 = PFFT(None, (16, 16, 16), dtype='d', backend='numpy')
    assert fft3.executor == 'gspmd'


@pytest.mark.parametrize("case", [
    dict(shape=(16, 16, 16), dtype='d'),
    dict(shape=(16, 16, 16), dtype='D'),
    dict(shape=(12, 13, 14), dtype='D'),          # uneven extents
    dict(shape=(18, 19), dtype='d'),              # 2-D slab r2c
    dict(shape=(12, 13, 12, 13), dtype='D', kw=dict(grid=(2, 4))),  # 4-D
    dict(shape=(16, 16, 16), dtype='d',
         kw=dict(padding=[1.5, 1.5, 1.5])),       # dealiasing
    dict(shape=(12, 13, 14, 15), dtype='D',
         kw=dict(grid=(2, 4), collapse=True)),    # collapse groups
])
def test_shmap_matches_gspmd(case):
    shape, dtype = case['shape'], case['dtype']
    kw = case.get('kw', {})
    fa = PFFT(None, shape, dtype=dtype, executor='shard_map', **kw)
    fb = PFFT(None, shape, dtype=dtype, executor='gspmd', **kw)
    assert fa.executor == 'shard_map' and fb.executor == 'gspmd'
    u = _rand(fa.forward._in_shape, fa.forward._in_dtype)
    ya = np.asarray(fa.forward(u.copy()))
    yb = np.asarray(fb.forward(u.copy()))
    assert ya.shape == yb.shape
    assert np.allclose(ya, yb, rtol=0, atol=1e-12), \
        np.abs(ya - yb).max()
    xa = np.asarray(fa.backward(ya.copy()))
    xb = np.asarray(fb.backward(yb.copy()))
    assert np.allclose(xa, xb, rtol=0, atol=1e-12)
    if kw.get('padding'):
        # dealiasing truncates spectra: the invariant is the spectral
        # fixpoint, not physical round-trip (reference test_mpifft.py:181)
        ya2 = np.asarray(fa.forward(xa.copy()))
        assert np.allclose(ya2, ya, rtol=0, atol=1e-10)
    else:
        assert np.allclose(xa, u, rtol=0, atol=1e-10)


def test_shmap_r2r_transforms():
    dct = functools.partial(fftw.dctn, type=2)
    idct = functools.partial(fftw.idctn, type=2)
    transforms = {(1,): (dct, idct), (2,): (dct, idct)}
    fa = PFFT(None, (16, 16, 16), dtype='d', executor='shard_map',
              transforms=transforms, axes=((0,), (1,), (2,)))
    fb = PFFT(None, (16, 16, 16), dtype='d', executor='gspmd',
              transforms=transforms, axes=((0,), (1,), (2,)))
    u = _rand((16, 16, 16), 'd')
    ya = np.asarray(fa.forward(u.copy()))
    yb = np.asarray(fb.forward(u.copy()))
    assert np.allclose(ya, yb, rtol=0, atol=1e-12)
    xa = np.asarray(fa.backward(ya.copy()))
    assert np.allclose(xa, u, rtol=0, atol=1e-10)


def test_shmap_hlo_all_to_all(fft_engine):
    fft = PFFT(None, (16, 16, 16), dtype='D', executor='shard_map')
    p = jnp.zeros((2, 16, 16, 16), jnp.float64)
    txt = jax.jit(lambda v: fft.forward.fn_p(v, True)).lower(
        p).compile().as_text()
    assert 'all-to-all' in txt
    assert 'all-gather' not in txt
    if fft_engine == 'matmul':
        assert 'complex' not in txt                # complex-free pipeline
    else:
        assert 'fft(' in txt                       # XLA's own FFT op


def test_shmap_distarray_roundtrip():
    # DistArray buffers (incl. padded at-rest storage) through shard_map
    fft = PFFT(None, (12, 13, 14), dtype='D')
    u = newDistArray(fft, forward_output=False)
    val = _rand(u.shape, u.dtype, seed=9)
    u[:] = val
    u_hat = fft.forward(u)
    ref = np.fft.fftn(val) / val.size
    assert np.allclose(np.asarray(u_hat), ref, rtol=0, atol=1e-10)
    uj = fft.backward(u_hat)
    assert np.allclose(np.asarray(uj), val, rtol=0, atol=1e-10)
