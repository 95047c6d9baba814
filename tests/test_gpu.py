"""Tests that need an NVIDIA GPU (marker ``gpu``; skipped elsewhere).

Run on a GPU host with
    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -p no:xdist
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mpi4py_fft_jax import PFFT, newDistArray
from mpi4py_fft_jax.parallel.planar import PlanarPFFT

pytestmark = pytest.mark.gpu


def _relerr(got, ref):
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def test_f32_pipeline_is_full_precision(gpu):
    """256^3 c2c f32 against a complex128 numpy reference: an f32 FFT is
    accurate to ~1e-7; a TF32 pass (about three decimal digits) anywhere
    in the pipeline would show as ~1e-3."""
    n = 256
    rng = np.random.default_rng(0)
    z = (rng.standard_normal((n,) * 3)
         + 1j * rng.standard_normal((n,) * 3)).astype(np.complex64)
    pfft = PlanarPFFT(None, (n,) * 3, dtype='F')
    y = np.asarray(pfft.forward(jnp.asarray(np.stack([z.real, z.imag])),
                                normalize=False))
    ref = np.fft.fftn(z.astype(np.complex128))
    assert _relerr(y[0] + 1j * y[1], ref) <= 1e-5


def test_complex_distarray_stays_on_device(gpu):
    """fft.forward(u) on a complex DistArray returns a spectrum that lives
    on the GPU, with the output pencil's sharding."""
    fft = PFFT(None, (64, 64, 64), dtype='D')
    u = newDistArray(fft, forward_output=False)
    rng = np.random.default_rng(1)
    u[:] = rng.standard_normal(u.shape) + 1j * rng.standard_normal(u.shape)
    u_hat = fft.forward(u)
    assert isinstance(u_hat.v, jax.Array)
    assert u_hat.v.dtype == np.complex128
    assert {d.platform for d in u_hat.v.devices()} == {'gpu'}
    assert u_hat.v.sharding.is_equivalent_to(
        fft.pencil[1].boundary_sharding(), 3)
    ref = np.fft.fftn(np.asarray(u)) / u.v.size
    assert _relerr(np.asarray(u_hat), ref) <= 1e-12


@pytest.mark.parametrize('dtype', ['F', 'f', 'D', 'd'])
def test_roundtrip_128(gpu, dtype):
    n = 128
    rng = np.random.default_rng(2)
    pfft = PlanarPFFT(None, (n,) * 3, dtype=dtype)
    shape = pfft.global_shape(False)
    x = jnp.asarray(rng.standard_normal(shape).astype(pfft.rdtype))
    back = np.asarray(pfft.backward(pfft.forward(x)))
    tol = 1e-5 if dtype in 'fF' else 1e-12
    assert _relerr(back, np.asarray(x)) <= tol
