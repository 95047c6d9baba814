"""DistArray redistribution walk-through.

Port of the reference demo (reference: examples/darray.py): global
redistributions between alignments, darray-driven PFFT construction, and
tensor-rank arrays — sums/norms are global (single-controller), so the
reference's allreduce calls become plain numpy reductions.
"""
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np

from mpi4py_fft_jax import DistArray, newDistArray, PFFT

N = (16, 14, 12)
z0 = DistArray(N, dtype=float, alignment=0)
z0[:] = np.random.randint(0, 10, z0.shape).astype(float)
s0 = np.sum(np.asarray(z0))
z1 = z0.redistribute(2)
s1 = np.sum(np.asarray(z1))
z2 = z1.redistribute(1)
s2 = np.sum(np.asarray(z2))
assert s0 == s1 == s2

fft = PFFT(None, darray=z2, axes=(0, 2, 1))
z3 = newDistArray(fft, forward_output=True)
z2c = np.asarray(z2).copy()
fft.forward(z2, z3)
fft.backward(z3, z2)
s0, s1 = np.linalg.norm(np.asarray(z2)), np.linalg.norm(z2c)
assert abs(s0 - s1) < 1e-10, s0 - s1

v0 = newDistArray(fft, forward_output=False, rank=1)
v0[...] = np.random.random(v0.shape)
v0c = np.asarray(v0).copy()
v1 = newDistArray(fft, forward_output=True, rank=1)

for i in range(3):
    v1[i] = fft.forward(v0[i], v1[i])
for i in range(3):
    v0[i] = fft.backward(v1[i], v0[i])
s0, s1 = np.linalg.norm(v0c), np.linalg.norm(np.asarray(v0))
assert abs(s0 - s1) < 1e-10

nfft = PFFT(None, darray=v0[0], axes=(0, 2, 1))
for i in range(3):
    v1[i] = nfft.forward(v0[i], v1[i])
for i in range(3):
    v0[i] = nfft.backward(v1[i], v0[i])
s0, s1 = np.linalg.norm(v0c), np.linalg.norm(np.asarray(v0))
assert abs(s0 - s1) < 1e-10

N = (8, 8, 8)
z = DistArray(N, dtype=float, alignment=0)
z[:] = 3.0
g0 = z.get((0, slice(None), 0))
z2 = z.redistribute(2)
z = z2.redistribute(out=z)
g1 = z.get((0, slice(None), 0))
assert np.all(g0 == g1)

N = (3, 3, 8, 8, 8)
z2 = DistArray(N, dtype=float, val=1, alignment=2, rank=2)
z2[...] = 2.0
z1 = z2.redistribute(1)
z0 = z1.redistribute(0)
assert abs(np.linalg.norm(np.asarray(z2)) - np.linalg.norm(np.asarray(z0))) < 1e-12
z1 = z0.redistribute(out=z1)
z0 = z1.redistribute(out=z0)

N = (8, 8, 8, 8, 8)
m0 = DistArray(N, dtype=float, alignment=2)
m0[:] = 1.5
m1 = m0.redistribute(4)
m0 = m1.redistribute(out=m0)
assert abs(np.linalg.norm(np.asarray(m0)) - np.linalg.norm(np.asarray(m1))) < 1e-10
print("darray demo OK")
