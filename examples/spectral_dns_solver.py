"""Spectral DNS Navier-Stokes solver (Taylor-Green vortex, RK4).

JAX re-design of the reference demo
(reference: examples/spectral_dns_solver.py): instead of per-rank arrays
mutated through buffer transforms, the entire RK4 stage — 9 parallel
transform pipelines plus the pointwise spectral algebra — is composed into
ONE jitted XLA program via ``Transform.fn``, so XLA fuses the pointwise ops
into the transform stages and overlaps the transpose collectives.

Correctness anchor: kinetic energy == 0.124953117517 (to 7 decimals) after
T=0.1, dt=0.01 on a 64^3 grid (reference: spectral_dns_solver.py:126-129).

Runs on the ambient JAX platform; for the 8-device virtual CPU mesh use
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/spectral_dns_solver.py
"""
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from time import time

import numpy as np

import jax
import jax.numpy as jnp

from mpi4py_fft_jax import PFFT


def make_solver(N=(64, 64, 64), L=(2 * np.pi, 4 * np.pi, 4 * np.pi),
                nu=0.000625, dt=0.01, padding=False):
    """Build the jitted RK4 stepper and the initial condition."""
    fft = PFFT(None, list(N), collapse=False, dtype='d')
    fft_pad = (PFFT(None, list(N), padding=[1.5, 1.5, 1.5], dtype='d')
               if padding else fft)

    # physical mesh (global; reference: spectral_dns_solver.py:44-49)
    X = np.ogrid[tuple(slice(0, n) for n in N)]
    X = [x * L[i] / N[i] for i, x in enumerate(X)]

    # wavenumber mesh (global; reference: spectral_dns_solver.py:51-61)
    k = [np.fft.fftfreq(n, 1. / n).astype(int) for n in N[:-1]]
    k.append(np.fft.rfftfreq(N[-1], 1. / N[-1]).astype(int))
    Ks = np.meshgrid(*k, indexing='ij', sparse=True)
    Lp = 2 * np.pi / np.asarray(L)
    K = [Ks[i] * Lp[i] for i in range(3)]
    K = [np.broadcast_to(ki, fft.global_shape(True)).astype(float)
         for ki in K]
    K = np.array(K)
    K2 = np.sum(K * K, 0)
    K_over_K2 = K / np.where(K2 == 0, 1, K2)

    a = jnp.asarray([1. / 6., 1. / 3., 1. / 3., 1. / 6.])
    b = jnp.asarray([0.5, 0.5, 1.])

    fwd = fft_pad.forward.fn        # normalized forward
    bck = fft_pad.backward.fn       # unnormalized backward

    # the operators are arguments of the jitted step, not closed over: a
    # closure-captured array becomes a program constant
    ops = (jnp.asarray(K), jnp.asarray(K2), jnp.asarray(K_over_K2))

    def compute_rhs(U_hat, Kj, K2j, KoK2j):
        """Reference: spectral_dns_solver.py:82-91 — 9 transform chains +
        pressure projection + viscous term, all in one traced graph."""
        u = [bck(U_hat[j]) for j in range(3)]
        w = [bck(1j * (Kj[1] * U_hat[2] - Kj[2] * U_hat[1])),
             bck(1j * (Kj[2] * U_hat[0] - Kj[0] * U_hat[2])),
             bck(1j * (Kj[0] * U_hat[1] - Kj[1] * U_hat[0]))]
        rhs = jnp.stack([fwd(u[1] * w[2] - u[2] * w[1]),
                         fwd(u[2] * w[0] - u[0] * w[2]),
                         fwd(u[0] * w[1] - u[1] * w[0])])
        P_hat = jnp.sum(rhs * KoK2j, 0)
        rhs = rhs - P_hat * Kj
        rhs = rhs - nu * K2j * U_hat
        return rhs

    @jax.jit
    def _step(U_hat, ops):
        """One RK4 time step (reference: spectral_dns_solver.py:104-113)."""
        U_hat0 = U_hat
        U_hat1 = U_hat
        for rk in range(4):
            dU = compute_rhs(U_hat, *ops)
            if rk < 3:
                U_hat = U_hat0 + b[rk] * dt * dU
            U_hat1 = U_hat1 + a[rk] * dt * dU
        return U_hat1

    def step(U_hat):
        return _step(U_hat, ops)

    # Taylor-Green initial condition (reference: :94-98)
    U0 = np.zeros((3,) + tuple(N))
    U0[0] = np.sin(X[0]) * np.cos(X[1]) * np.cos(X[2])
    U0[1] = -np.cos(X[0]) * np.sin(X[1]) * np.cos(X[2])
    U_hat = jax.jit(lambda U: jnp.stack(
        [fft.forward.fn(U[i]) for i in range(3)]))(U0)

    @jax.jit
    def _energy(U_hat):
        U = jnp.stack([fft.backward.fn(U_hat[i]) for i in range(3)])
        return jnp.sum(U * U) / N[0] / N[1] / N[2] / 2

    def energy(U_hat):
        return float(_energy(U_hat))

    return fft, U_hat, step, energy


def run(N=(64, 64, 64), T=0.1, dt=0.01, padding=False, verbose=True):
    fft, U_hat, step, energy = make_solver(N=N, dt=dt, padding=padding)
    t = 0.0
    t0 = time()
    nsteps = 0
    while t < T - 1e-8:
        t += dt
        nsteps += 1
        U_hat = step(U_hat)
    U_hat.block_until_ready()
    k = energy(U_hat)
    if verbose:
        print(f'Time = {time() - t0:.3f} s  ({nsteps} steps)')
        print(f'Energy = {k:.12f}')
    return k


if __name__ == '__main__':
    M = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    n = 2 ** M
    k = run(N=(n, n, n))
    if n == 64:
        assert round(k - 0.124953117517, 7) == 0, k
        print('energy check PASSED')
