"""Mixed-transform configuration demo.

Port of the reference demo (reference: examples/transforms.py): rFFT along
axis 0 combined with DCT-3 along axes 1-2 via a custom transforms dict,
slab decomposition, collapsed axes, and 3/2-rule padding — running on the
device mesh through the fused JAX pipeline.
"""
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import functools

import numpy as np

from mpi4py_fft_jax import PFFT, newDistArray
from mpi4py_fft_jax.fftw import dctn, idctn

N = np.array([18, 18, 18], dtype=int)

dct = functools.partial(dctn, type=3)
idct = functools.partial(idctn, type=3)
transforms = {(1, 2): (dct, idct)}

fft = PFFT(None, N, axes=None, collapse=True, grid=(-1,),
           transforms=transforms)
pfft = PFFT(None, N, axes=((0,), (1, 2)), grid=(-1,),
            padding=[1.5, 1.0, 1.0], transforms=transforms)

assert fft.axes == pfft.axes

u = newDistArray(fft, forward_output=False)
u[:] = np.random.random(u.shape).astype(u.dtype)

u_hat = newDistArray(fft, forward_output=True)
u_hat = fft.forward(u, u_hat)
uj = newDistArray(fft, forward_output=False)
uj = fft.backward(u_hat, uj)
assert np.allclose(np.asarray(uj), np.asarray(u))

u_padded = newDistArray(pfft, forward_output=False)
uc = np.asarray(u_hat).copy()
u_padded = pfft.backward(u_hat, u_padded)
u_hat = pfft.forward(u_padded, u_hat)
assert np.allclose(np.asarray(u_hat), uc)

cfft = PFFT(None, N, dtype=complex)
uc = np.random.random(cfft.backward.input_array.shape).astype(complex)
u2 = cfft.backward(uc)
u3 = cfft.forward(u2)
assert np.allclose(uc, np.asarray(u3))

fft.destroy()
pfft.destroy()
cfft.destroy()
print("transforms demo OK")
