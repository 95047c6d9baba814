"""Serial FFT-class tests across backends.

Port of the reference L2' strategy (reference: tests/test_libfft.py):
forward(backward) == identity across backends; padding tested via the
fwd-bwd-fwd fixed point (padded physical space cannot be initialized
directly); custom transforms dicts per backend.
"""
import functools

import numpy as np
import pytest

from mpi4py_fft_jax.libfft import FFT
from mpi4py_fft_jax import fftw

abstol = dict(f=5e-5, d=1e-13)

# 'jax' is the native XLA path; numpy/scipy are host cross-checks
# (role of the reference's 5-backend list, tests/test_libfft.py:10-15)
try:
    import torch  # noqa: F401
    _HAS_TORCH = True
except ImportError:
    _HAS_TORCH = False

backends = ['jax', 'numpy', 'scipy'] + (['torch'] if _HAS_TORCH else [])


def allclose(a, b):
    atol = abstol[np.dtype(a.dtype).char.lower()]
    return np.allclose(a, b, rtol=0, atol=atol)


@pytest.mark.parametrize("backend", backends)
def test_libfft(backend):
    from itertools import product
    dims = (1, 2, 3)
    sizes = (7, 8, 9)
    types = 'fdFD'
    rng = np.random.default_rng(7)

    for typecode in types:
        for dim in dims:
            if dim < 3:
                shapes = list(product(*([sizes] * dim)))
            else:
                shapes = [(7, 8, 9), (8, 8, 8), (9, 7, 8)]
            for shape in shapes:
                allaxes = tuple(reversed(range(dim)))
                for i in range(dim):
                    axes = allaxes[i:]
                    fft = FFT(shape, axes, dtype=typecode, backend=backend)
                    A = fft.forward.input_array
                    B = fft.forward.output_array
                    A[...] = rng.random(A.shape).astype(typecode)
                    X = A.copy()
                    B.fill(0)
                    B = fft.forward(A, B)
                    A.fill(0)
                    A = fft.backward(B, A)
                    assert allclose(A, X), np.linalg.norm(A - X)


@pytest.mark.parametrize("backend", ['jax', 'numpy'] + (['torch'] if _HAS_TORCH else []))
def test_libfft_padding(backend):
    """fwd∘bwd∘fwd == fwd fixed point with 3/2 and 2.0 padding
    (reference: tests/test_libfft.py:64-98)."""
    from itertools import product
    dims = (1, 2)
    sizes = (8, 9, 16)
    types = 'dD'
    rng = np.random.default_rng(11)

    for padding in (1.5, 2.0):
        for typecode in types:
            for dim in dims:
                for shape in product(*([sizes] * dim)):
                    if np.issubdtype(np.dtype(typecode), np.floating) \
                            and shape[-1] % 2:
                        continue
                    # padding applies to a single (last) transformed axis
                    axis = dim - 1
                    pads = [1.0] * dim
                    pads[axis] = padding
                    shape = list(shape)
                    shape[axis] = int(shape[axis] * padding)
                    fft = FFT(shape, (axis,), dtype=typecode,
                              padding=pads, backend=backend)
                    A = fft.forward.input_array
                    B = fft.forward.output_array
                    B[...] = (rng.random(B.shape)
                              + (1j * rng.random(B.shape)
                                 if np.dtype(B.dtype).kind == 'c' else 0)
                              ).astype(B.dtype)
                    A = fft.backward(B, A)
                    X = A.copy()
                    B2 = np.zeros_like(B)
                    B2 = fft.forward(A, B2)
                    A2 = np.zeros_like(A)
                    A2 = fft.backward(B2, A2)
                    assert allclose(A2, X), np.linalg.norm(A2 - X)
                    B3 = np.zeros_like(B)
                    B3 = fft.forward(A2, B3)
                    assert allclose(B2, B3), np.linalg.norm(B2 - B3)


@pytest.mark.parametrize("backend", ['jax'])
def test_libfft_transforms(backend):
    """Custom transforms dict (reference: tests/test_libfft.py:100-135)."""
    rng = np.random.default_rng(3)
    transforms = {
        (0,): (fftw.dctn, fftw.idctn),
        (1,): (functools.partial(fftw.dstn, type=3),
               functools.partial(fftw.idstn, type=3)),
    }
    for axes in ((0,), (1,)):
        fft = FFT((8, 10), axes, dtype='d', backend=backend,
                  transforms=transforms)
        A = fft.forward.input_array
        A[...] = rng.random(A.shape)
        X = A.copy()
        B = fft.forward()
        A2 = fft.backward(B)
        assert np.allclose(A2, X, atol=1e-12), np.linalg.norm(A2 - X)
