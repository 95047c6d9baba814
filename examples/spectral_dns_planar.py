"""Spectral DNS solver on the planar pipeline (parallel/planar.py).

Same Taylor-Green/RK4 workload as spectral_dns_solver.py (reference:
examples/spectral_dns_solver.py) but with every spectral array carried in
planar form (real (2,)+shape), so the full time step — 9 r2c/c2r
pipelines + spectral algebra — is ONE jitted XLA program over sparse
rank-1 wavenumber operators.

Runs on the ambient JAX platform; for the 8-device virtual CPU mesh use
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/spectral_dns_planar.py 5
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from time import time

import numpy as np
import jax
import jax.numpy as jnp

from mpi4py_fft_jax.parallel.planar import PlanarPFFT


def make_solver(N=(64, 64, 64), L=(2 * np.pi, 4 * np.pi, 4 * np.pi),
                nu=0.000625, dt=0.01, dtype='d'):
    pfft = PlanarPFFT(None, N, dtype=dtype)
    rdt = pfft.rdtype

    X = np.ogrid[tuple(slice(0, n) for n in N)]
    X = [x * L[i] / N[i] for i, x in enumerate(X)]

    k = [np.fft.fftfreq(n, 1. / n) for n in N[:-1]]
    k.append(np.fft.rfftfreq(N[-1], 1. / N[-1]))
    Lp = 2 * np.pi / np.asarray(L)
    spec = pfft.global_shape(True)[1:]
    # SPARSE spectral operators: each wavenumber component is a rank-1
    # broadcastable vector (a few KB), never a dense volume — K^2 and
    # K/K^2 are formed on the fly inside the fused elementwise passes.
    # Dense (3,)+spec operator volumes are ~1.9 GB at 512^3 f64, which
    # would crowd device memory and, captured by a jit closure, become
    # program constants.
    Kv = []
    for i in range(3):
        ki = (k[i] * Lp[i]).astype(rdt)
        if len(ki) < spec[i]:               # shardable-extent pad rows
            ki = np.pad(ki, (0, spec[i] - len(ki)))
        sh = [1, 1, 1]
        sh[i] = spec[i]
        Kv.append(jnp.asarray(ki.reshape(sh)))
    Kj = tuple(Kv)

    a_rk = [1. / 6., 1. / 3., 1. / 3., 1. / 6.]
    b_rk = [0.5, 0.5, 1.]

    fwd = lambda u: pfft.forward_fn(u)           # real -> planar
    bck = lambda p: pfft.backward_fn(p)          # planar -> real

    def pmul_i(K_ax, p):
        """planar multiply by (i*K): (re, im) -> (-K*im, K*re)."""
        return jnp.stack([-K_ax * p[1], K_ax * p[0]])

    # The sparse operator vectors are passed as ARGUMENTS to every
    # jitted program, never closed over (a closure-captured concrete
    # jax.Array becomes a program constant).
    def _project(rhs, U_hat, K):
        """Pressure projection + viscous term, all operators formed
        in-fusion from the rank-1 wavenumber vectors."""
        K0, K1, K2v = K
        K2 = K0 * K0 + K1 * K1 + K2v * K2v
        K2s = jnp.where(K2 == 0, 1, K2)
        P_hat = (rhs[0] * K0 + rhs[1] * K1 + rhs[2] * K2v) / K2s
        rhs = rhs - jnp.stack([P_hat * K0, P_hat * K1, P_hat * K2v])
        return rhs - nu * K2 * U_hat

    def compute_rhs(U_hat, K):
        K0, K1, K2v = K
        u = [bck(U_hat[j]) for j in range(3)]
        w = [bck(pmul_i(K1, U_hat[2]) - pmul_i(K2v, U_hat[1])),
             bck(pmul_i(K2v, U_hat[0]) - pmul_i(K0, U_hat[2])),
             bck(pmul_i(K0, U_hat[1]) - pmul_i(K1, U_hat[0]))]
        rhs = jnp.stack([fwd(u[1] * w[2] - u[2] * w[1]),
                         fwd(u[2] * w[0] - u[0] * w[2]),
                         fwd(u[0] * w[1] - u[1] * w[0])])
        return _project(rhs, U_hat, K)

    @jax.jit
    def _step_fused(U_hat, K):
        U_hat0 = U_hat
        U_hat1 = U_hat
        for rk in range(4):
            dU = compute_rhs(U_hat, K)
            if rk < 3:
                U_hat = U_hat0 + b_rk[rk] * dt * dU
            U_hat1 = U_hat1 + a_rk[rk] * dt * dU
        return U_hat1

    def step(U_hat):
        return _step_fused(U_hat, Kj)

    # split-step driver: one jitted program per RK substage (9 transforms
    # each) instead of the 36-transform fused step — a smaller program
    # with a smaller live set.  The stage weights travel as traced
    # scalars so 2 compiled programs cover all 4 substages.
    @jax.jit
    def _rk_mid(U_hat, U_hat0, U_hat1, b, a, K):
        dU = compute_rhs(U_hat, K)
        return U_hat0 + (b * dt) * dU, U_hat1 + (a * dt) * dU

    @jax.jit
    def _rk_last(U_hat, U_hat1, a, K):
        return U_hat1 + (a * dt) * compute_rhs(U_hat, K)

    def step_split(U_hat):
        U0 = U1 = U_hat
        Uc = U_hat
        for rk in range(3):
            Uc, U1 = _rk_mid(Uc, U0, U1, jnp.asarray(b_rk[rk], rdt),
                             jnp.asarray(a_rk[rk], rdt), Kj)
        return _rk_last(Uc, U1, jnp.asarray(a_rk[3], rdt), Kj)
    step.split = step_split

    # per-pipeline driver: ONE compiled program per transform (36
    # dispatches/step) + small jitted pointwise programs — the smallest
    # programs, at the cost of per-dispatch launch overhead.
    bk1 = jax.jit(lambda p: pfft.backward_fn(p))
    fw1 = jax.jit(lambda u: pfft.forward_fn(u))

    curl_spec = jax.jit(lambda Uh, K: jnp.stack([
        pmul_i(K[1], Uh[2]) - pmul_i(K[2], Uh[1]),
        pmul_i(K[2], Uh[0]) - pmul_i(K[0], Uh[2]),
        pmul_i(K[0], Uh[1]) - pmul_i(K[1], Uh[0])]))
    cross_r = jax.jit(lambda u0, u1, u2, w0, w1, w2: (
        u1 * w2 - u2 * w1, u2 * w0 - u0 * w2, u0 * w1 - u1 * w0))

    @jax.jit
    def _proj_mid(r0, r1, r2, U_hat, U_hat0, U_hat1, b, a, K):
        rhs = _project(jnp.stack([r0, r1, r2]), U_hat, K)
        return U_hat0 + (b * dt) * rhs, U_hat1 + (a * dt) * rhs

    @jax.jit
    def _proj_last(r0, r1, r2, U_hat, U_hat1, a, K):
        rhs = _project(jnp.stack([r0, r1, r2]), U_hat, K)
        return U_hat1 + (a * dt) * rhs

    def _substage(U_hat):
        u = [bk1(U_hat[j]) for j in range(3)]
        c = curl_spec(U_hat, Kj)
        w = [bk1(c[j]) for j in range(3)]
        cr = cross_r(*u, *w)
        return [fw1(cr[j]) for j in range(3)]

    def step_perpipe(U_hat):
        U0 = U1 = U_hat
        Uc = U_hat
        for rk in range(3):
            r = _substage(Uc)
            Uc, U1 = _proj_mid(*r, Uc, U0, U1,
                               jnp.asarray(b_rk[rk], rdt),
                               jnp.asarray(a_rk[rk], rdt), Kj)
        r = _substage(Uc)
        return _proj_last(*r, Uc, U1, jnp.asarray(a_rk[3], rdt), Kj)
    step.perpipe = step_perpipe

    U0 = np.zeros((3,) + tuple(N), dtype=rdt)
    U0[0] = np.sin(X[0]) * np.cos(X[1]) * np.cos(X[2])
    U0[1] = -np.cos(X[0]) * np.sin(X[1]) * np.cos(X[2])
    U_hat = jnp.stack([fwd(jnp.asarray(U0[i])) for i in range(3)])

    @jax.jit
    def _energy(U_hat):
        U = jnp.stack([bck(U_hat[i]) for i in range(3)])
        return jnp.sum(U * U) / N[0] / N[1] / N[2] / 2

    def energy(U_hat):
        return float(_energy(U_hat))

    return pfft, U_hat, step, energy


def run(N=(64, 64, 64), T=0.1, dt=0.01, dtype='d', verbose=True):
    pfft, U_hat, step, energy = make_solver(N=N, dt=dt, dtype=dtype)
    t, nsteps = 0.0, 0
    t0 = time()
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
    dtype = os.environ.get('DNS_DTYPE', 'd')
    k = run(N=(n, n, n), dtype=dtype)
    if n == 64 and dtype == 'd':
        assert round(k - 0.124953117517, 7) == 0, k
        print('energy check PASSED')
