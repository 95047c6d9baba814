"""Chunked (overlappable) pencil transposes — parallel/overlap.py.

The executors chunk each all_to_all+stage step along an uninvolved axis
so XLA's latency-hiding scheduler can overlap chunk k's transform with
chunk k+1's transfer (the reference's hot loop is strictly sequential,
mpifft.py:68-72 + pencil.py:182-183).  Chunking is a pure
reassociation, so results must match the unchunked executor exactly.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mpi4py_fft_jax.parallel import overlap
from mpi4py_fft_jax.parallel.mpifft import PFFT
from mpi4py_fft_jax.parallel.planar import PlanarPFFT


def _ndev():
    return len(jax.devices())


def test_resolve():
    MB = 2 ** 20
    # auto: big shards chunk 4-way, small ones stay whole
    assert overlap.resolve(0, 64 * MB, 128) == 4
    assert overlap.resolve(0, 1 * MB, 128) == 1
    # explicit counts are honored, clamped to divisors of the extent
    assert overlap.resolve(2, 1 * MB, 128) == 2
    assert overlap.resolve(5, 64 * MB, 128) == 4   # 5 -> largest divisor
    assert overlap.resolve(8, 64 * MB, 6) == 6
    assert overlap.resolve(1, 64 * MB, 128) == 1


def test_overlapped_identity():
    x = jnp.arange(48, dtype=jnp.float32).reshape(4, 12)
    got = overlap.overlapped(x, 1, 4, lambda c: c * 2.0)
    assert np.array_equal(np.asarray(got), np.asarray(x) * 2)
    # non-divisible chunk counts fall back to one chain
    got = overlap.overlapped(x, 1, 5, lambda c: c * 2.0)
    assert np.array_equal(np.asarray(got), np.asarray(x) * 2)


@pytest.mark.skipif(_ndev() < 4, reason="needs a multi-device mesh")
@pytest.mark.parametrize('chunks', [2, 4])
def test_pfft_chunked_matches_unchunked(chunks):
    """PFFT shard_map executor: chunked == unchunked, exactly."""
    shape = (16, 8, 16)
    rng = np.random.default_rng(5)
    u = rng.standard_normal(shape)
    base = PFFT(None, shape, dtype='d', executor='shard_map',
                a2a_chunks=1)
    chk = PFFT(None, shape, dtype='d', executor='shard_map',
               a2a_chunks=chunks)
    yb = np.asarray(base.forward(u.copy()))
    yc = np.asarray(chk.forward(u.copy()))
    # the data movement is a pure reassociation (bit-exact); the stage
    # kernels may compile with different batch vectorization per chunk
    # shape, so allow reduction-order ulps in the transform itself
    assert np.allclose(yb, yc, rtol=0, atol=1e-15), np.abs(yb - yc).max()
    rb = np.asarray(chk.backward(yc))
    assert np.allclose(rb, u, atol=2e-10)


@pytest.mark.skipif(_ndev() < 4, reason="needs a multi-device mesh")
def test_pfft_chunked_hlo_has_parallel_chains():
    """The compiled chunked program must carry one all_to_all per chunk
    per transpose — the independent chains the latency-hiding scheduler
    overlaps (unchunked: exactly one per transpose)."""
    shape = (16, 16, 16)

    def n_a2a(pfft):
        x = jnp.zeros(shape, dtype=complex)
        txt = jax.jit(lambda v: pfft.forward.fn(v)).lower(x) \
            .compile().as_text()
        return txt.count('all-to-all-start') or txt.count('all-to-all(')

    base = PFFT(None, shape, dtype='D', executor='shard_map',
                a2a_chunks=1)
    chk = PFFT(None, shape, dtype='D', executor='shard_map',
               a2a_chunks=4)
    n_transposes = len(base.transfer)
    assert n_a2a(base) == n_transposes
    # c2c power-of-two extents chunk exactly 4-way on every transpose
    # (r2c/odd extents degrade per-transpose to the largest divisor)
    assert n_a2a(chk) == 4 * n_transposes


@pytest.mark.skipif(_ndev() < 4, reason="needs a multi-device mesh")
@pytest.mark.parametrize('dtype', ['f', 'F'])
def test_planar_chunked_matches_unchunked(dtype):
    """PlanarPFFT executor: chunked == unchunked (c2c and r2c)."""
    shape = (16, 8, 16)
    rng = np.random.default_rng(7)
    if dtype == 'F':
        x = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(np.complex64)
        p = jnp.asarray(np.stack([x.real, x.imag]).astype(np.float32))
    else:
        x = rng.standard_normal(shape).astype(np.float32)
        p = jnp.asarray(x)
    base = PlanarPFFT(None, shape, dtype=dtype, a2a_chunks=1)
    chk = PlanarPFFT(None, shape, dtype=dtype, a2a_chunks=4)
    yb = np.asarray(jax.jit(lambda v: base.forward_fn(v))(p))
    yc = np.asarray(jax.jit(lambda v: chk.forward_fn(v))(p))
    # see test_pfft_chunked_matches_unchunked: movement is exact, stage
    # vectorization may reassociate at f32 ulp level
    scale = np.abs(yb).max()
    assert np.abs(yb - yc).max() <= 1e-6 * scale, np.abs(yb - yc).max()
    rb = np.asarray(jax.jit(lambda v: chk.backward_fn(v, normalize=False))(
        jnp.asarray(yc)))
    ref = np.asarray(jax.jit(
        lambda v: base.backward_fn(v, normalize=False))(jnp.asarray(yb)))
    assert np.abs(rb - ref).max() <= 1e-6 * np.abs(ref).max()
