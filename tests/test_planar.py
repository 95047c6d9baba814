"""Planar-complex pipeline tests (parallel/planar.py).

The planar representation carries complex data as a leading real axis of
size 2 between the pipeline's stages (ops/matfft.py docstring).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mpi4py_fft_jax.ops import matfft
from mpi4py_fft_jax.parallel.planar import PlanarPFFT


def test_planar_core_matches_complex():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 12, 16)) + 1j * rng.standard_normal((4, 12, 16))
    p = matfft.planar(jnp.asarray(x))
    y = matfft.fftn_p(p, (0, 1, 2), True)
    ref = np.fft.fftn(x)
    got = np.asarray(y[0]) + 1j * np.asarray(y[1])
    assert np.allclose(got, ref, atol=1e-10)


@pytest.mark.parametrize("shape", [(16, 16, 16), (12, 13, 15)])
def test_planar_pfft_c2c(shape):
    rng = np.random.default_rng(1)
    pfft = PlanarPFFT(None, shape, dtype='D')
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    p = matfft.planar(jnp.asarray(x))
    ph = pfft.forward(p)
    ref = np.fft.fftn(x) / np.prod(shape)
    got = np.asarray(ph[0]) + 1j * np.asarray(ph[1])
    assert np.allclose(got, ref, atol=1e-10), np.abs(got - ref).max()
    p2 = pfft.backward(ph)
    got2 = np.asarray(p2[0]) + 1j * np.asarray(p2[1])
    assert np.allclose(got2, x, atol=1e-10)


@pytest.mark.parametrize("shape", [(16, 14, 12), (8, 12, 16)])
def test_planar_pfft_r2c(shape):
    rng = np.random.default_rng(2)
    pfft = PlanarPFFT(None, shape, dtype='d')
    x = rng.standard_normal(shape)
    ph = pfft.forward(jnp.asarray(x))
    ref = np.fft.rfftn(x) / np.prod(shape)
    got = np.asarray(ph[0]) + 1j * np.asarray(ph[1])
    assert np.allclose(got, ref, atol=1e-10), np.abs(got - ref).max()
    x2 = pfft.backward(ph)
    assert np.allclose(np.asarray(x2), x, atol=1e-10)


def test_planar_no_complex_hlo(matmul_engine):
    """On the matmul engine the planar pipeline contains no complex-typed
    ops (the 'xla' engine calls the complex FFT op by design)."""
    pfft = PlanarPFFT(None, (16, 16, 16), dtype='f')
    x = jnp.zeros((16, 16, 16), jnp.float32)
    txt = jax.jit(lambda v: pfft.forward_fn(v)).lower(x).as_text()
    assert 'complex<' not in txt, "complex dtype leaked into the planar path"


def test_planar_collectives():
    """Pencil transposes must lower to all-to-all, not all-gather.

    Checked on the c2c path where every extent divides the grid evenly.
    (The r2c half-spectrum axis N//2+1 is odd, and GSPMD reshards uneven
    extents with gather+slice; test_r2c_pencil_no_allgather covers the
    padded r2c form.)
    """
    if len(jax.devices()) < 4:
        pytest.skip("needs a 2x2 device grid")
    pfft = PlanarPFFT(None, (32, 32, 32), dtype='F', grid=(2, 2, 1))
    x = jnp.zeros((2, 32, 32, 32), jnp.float32)
    txt = jax.jit(lambda v: pfft.forward_fn(v)).lower(x).compile().as_text()
    assert txt.count('all-to-all') > 0
    assert txt.count('all-gather') == 0, "transpose degraded to all-gather"


@pytest.mark.parametrize("dtype", ['d', 'D'])
def test_planar_pfft_padding(dtype):
    """3/2-rule dealiasing on the planar pipeline: fwd∘bwd∘fwd fixed point
    and agreement with the complex-dtype PFFT reference path."""
    rng = np.random.default_rng(7)
    shape = (16, 16, 16)
    pfft = PlanarPFFT(None, shape, dtype=dtype, padding=[1.5, 1.5, 1.5])
    sh = pfft.global_shape(True)
    # random spectral data, planar
    ph = jnp.asarray(rng.standard_normal(sh))
    up = pfft.backward(ph)
    ph2 = pfft.forward(up)
    up2 = pfft.backward(ph2)
    ph3 = pfft.forward(up2)
    assert np.allclose(np.asarray(ph3), np.asarray(ph2), atol=1e-10)

    # cross-check against the complex-dtype PFFT padding path
    from mpi4py_fft_jax import PFFT
    cfft = PFFT(None, list(shape), padding=[1.5, 1.5, 1.5],
                dtype=dtype)
    zh = np.asarray(ph2[0]) + 1j * np.asarray(ph2[1])
    upc = cfft.backward(zh)
    if dtype == 'd':
        assert np.allclose(np.asarray(up2), np.asarray(upc), atol=1e-10), \
            np.abs(np.asarray(up2) - np.asarray(upc)).max()
    else:
        got = np.asarray(up2[0]) + 1j * np.asarray(up2[1])
        assert np.allclose(got, np.asarray(upc), atol=1e-10)


def test_r2c_pencil_no_allgather():
    """The halved r2c axis is zero-padded to an evenly shardable extent so
    every pencil transpose lowers to a pure all-to-all; with
    pad_spectrum=True no all-gather appears anywhere in the pipeline."""
    import re
    if jax.device_count() < 8:
        pytest.skip("needs the 8-device mesh")
    rng = np.random.default_rng(5)
    pfft = PlanarPFFT(None, (32, 32, 32), dtype='f', grid=(4, 2),
                      pad_spectrum=True)
    x = jnp.asarray(rng.standard_normal((32, 32, 32)).astype(np.float32))
    fwd = jax.jit(lambda q: pfft.forward_fn(q, normalize=False))
    txt = fwd.lower(x).compile().as_text()
    assert 'all-gather' not in txt
    assert 'all-to-all' in txt
    y = fwd(x)
    assert y.shape == pfft.global_shape(True)
    got = np.asarray(y[0]) + 1j * np.asarray(y[1])
    ref = np.fft.rfftn(np.asarray(x))
    nh = ref.shape[-1]
    assert np.linalg.norm(got[..., :nh] - ref) / np.linalg.norm(ref) < 1e-5
    assert float(np.abs(got[..., nh:]).max()) == 0.0
    # padded spectrum round-trips exactly through backward
    bwd = jax.jit(lambda q: pfft.backward_fn(q, normalize=True))
    rt = np.asarray(bwd(y))
    assert np.linalg.norm(rt - np.asarray(x)) / np.linalg.norm(np.asarray(x)) < 1e-5


@pytest.mark.parametrize("dt,grid", [('F', (4, 2)), ('f', (4, 2)),
                                     ('F', (8,)), ('f', (2, 4))])
def test_shardmap_executor_matches_gspmd(dt, grid):
    """The explicit shard_map executor (lax.all_to_all transposes, local
    transforms) must agree with the GSPMD executor and numpy."""
    if jax.device_count() < 8:
        pytest.skip("needs the 8-device mesh")
    rng = np.random.default_rng(11)
    shape = (32, 32, 32)
    if dt == 'F':
        z = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(np.complex64)
        x = jnp.asarray(np.stack([z.real, z.imag]))
        ref = np.fft.fftn(z)
    else:
        xr = rng.standard_normal(shape).astype(np.float32)
        x = jnp.asarray(xr)
        ref = np.fft.rfftn(xr)
    outs = {}
    for ex in ('gspmd', 'shard_map'):
        pfft = PlanarPFFT(None, shape, dtype=dt, grid=grid, executor=ex,
                          pad_spectrum=True)
        y = pfft.forward(x, normalize=False)
        got = np.asarray(y[0]) + 1j * np.asarray(y[1])
        nh = ref.shape[-1]
        assert np.linalg.norm(got[..., :nh] - ref) / np.linalg.norm(ref) < 1e-5
        rt = pfft.backward(y, normalize=True)
        assert np.linalg.norm(np.asarray(rt) - np.asarray(x)) \
            / np.linalg.norm(np.asarray(x)) < 1e-5
        outs[ex] = got
    assert np.allclose(outs['gspmd'], outs['shard_map'], atol=1e-4)


@pytest.mark.parametrize("shape,dt,grid", [
    ((12, 13, 15), 'F', (4, 2)),
    ((12, 13, 15), 'D', (2, 4)),
    ((13, 12, 16), 'f', (4, 2)),
    ((12, 13, 14), 'd', (8,)),
])
def test_shardmap_uneven_extents(shape, dt, grid):
    """The shard_map executor covers non-divisible (reference 12/13-style)
    extents by padding each axis to the lcm of the group sizes that shard
    it — transposes stay pure tiled all_to_all (reference
    shapes: tests/test_mpifft.py:58)."""
    if jax.device_count() < 8:
        pytest.skip("needs the 8-device mesh")
    rng = np.random.default_rng(29)
    pfft = PlanarPFFT(None, shape, dtype=dt, grid=grid,
                      executor='shard_map')
    if dt in ('F', 'D'):
        z = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(
                 np.complex64 if dt == 'F' else np.complex128)
        x = jnp.asarray(np.stack([z.real, z.imag]))
        ref = np.fft.fftn(z)
    else:
        xr = rng.standard_normal(shape).astype(
            np.float32 if dt == 'f' else np.float64)
        x = jnp.asarray(xr)
        ref = np.fft.rfftn(xr)
    y = pfft.forward(x, normalize=False)
    got = np.asarray(y[0]) + 1j * np.asarray(y[1])
    nh = ref.shape[-1]
    tol = 1e-5 if dt in 'fF' else 1e-10
    assert np.linalg.norm(got[..., :nh] - ref) / np.linalg.norm(ref) < tol
    rt = pfft.backward(y, normalize=True)
    assert np.linalg.norm(np.asarray(rt) - np.asarray(x)) \
        / np.linalg.norm(np.asarray(x)) < tol
    # the per-shard program itself must contain no gathers — uneven
    # extents ride the padded form; only the jit-boundary slice may
    # reshard
    txt = jax.jit(lambda q: pfft._forward_shmap(q, False)).lower(
        jnp.zeros_like(x)).compile().as_text()
    assert 'all-to-all' in txt


def test_shardmap_uneven_dealiasing():
    """3/2-rule dealiasing + uneven extents under shard_map: spectral
    fixed point (reference test model: test_libfft.py:64-98)."""
    if jax.device_count() < 8:
        pytest.skip("needs the 8-device mesh")
    rng = np.random.default_rng(31)
    for shape, dt in [((12, 13, 15), 'F'), ((12, 14, 16), 'f')]:
        pfft = PlanarPFFT(None, shape, dtype=dt, grid=(4, 2), padding=1.5,
                          executor='shard_map')
        yh = jnp.asarray(rng.standard_normal(
            pfft.global_shape(True)).astype(np.float32))
        u = pfft.backward(yh, normalize=False)
        assert u.shape == pfft.global_shape(False)
        yh2 = pfft.forward(u, normalize=True)
        u2 = pfft.backward(yh2, normalize=False)
        yh3 = pfft.forward(u2, normalize=True)
        a, b = np.asarray(yh2), np.asarray(yh3)
        assert np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30) < 1e-5


def test_shardmap_dealiasing():
    """3/2-rule dealiasing under the shard_map executor: forward of the
    padded transform equals truncation semantics (fixed point under
    fwd∘bwd∘fwd, reference test_libfft.py:64-98 model)."""
    if jax.device_count() < 8:
        pytest.skip("needs the 8-device mesh")
    rng = np.random.default_rng(13)
    shape = (16, 16, 16)
    pfft = PlanarPFFT(None, shape, dtype='F', grid=(4, 2), padding=1.5,
                      executor='shard_map')
    # physical space is PADDED (24^3); spectral space is truncated (16^3).
    # Start from random spectral coefficients, like the reference
    # (test_libfft.py:64-98 — padded physical space cannot be initialized
    # directly), and check the fwd∘bwd fixed point in spectral space.
    spec = pfft.global_shape(True)
    yh = jnp.asarray(rng.standard_normal(spec).astype(np.float32))
    u = pfft.backward(yh, normalize=False)
    assert u.shape == pfft.global_shape(False)       # padded 24^3
    yh2 = pfft.forward(u, normalize=True)
    u2 = pfft.backward(yh2, normalize=False)
    yh3 = pfft.forward(u2, normalize=True)
    a, b = np.asarray(yh2), np.asarray(yh3)
    assert np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30) < 1e-5
