"""Smoke test of the distributed FFT on NVIDIA GPUs, at full size.

Drives the library through the entry points a user calls and checks every
result against a plain reference computed outside the library
(``jnp.fft`` / ``numpy.fft`` and the reference's 3/2-rule truncation):

  0. the card tests: ``pytest tests/ -m gpu`` in a child process, run
     before this process imports JAX (one JAX process per card);
  1. device check: JAX must find a GPU, no CPU fallback;
  2. 1024^3 c2c f32 through PlanarPFFT, forward + backward, donated;
  3. 512^3 r2c f64 with 3/2-rule padding (768^3 physical) through PFFT;
  4. the buffer API: PFFT(None, (256,)*3, dtype='D') on complex DistArrays;
  5. the spectral DNS example: the Taylor-Green energy at 64^3 and three
     RK4 steps at 512^3 f64.

Usage:
    python chip_smoke.py           one GPU, phases 0-5
    python chip_smoke.py --four    four GPUs: 1024^3 PlanarPFFT on a 2x2
                                   pencil grid and a 1x4 slab (c2c) and on
                                   2x2 (r2c), each against the one-card
                                   jnp.fft result; no other phase

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
it is printed only when every phase passed.  The compile cache is
``JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.xla_cache``.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0


def log(*a):
    print(*a, flush=True)


def phase0_card_tests():
    env = dict(os.environ, JAX_PLATFORMS='cuda')
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, '-m', 'pytest', 'tests', '-m', 'gpu', '-q',
         '-p', 'no:xdist', '-p', 'no:cacheprovider'],
        cwd=HERE, env=env, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"phase 0: card tests failed (rc {r.returncode})")
    log(f"phase 0: card tests passed ({time.perf_counter() - t0:.1f} s)")


def phase1_device(ncards):
    import jax
    from mpi4py_fft_jax.ops.plan import use_compile_cache
    from mpi4py_fft_jax.utils.profiling import card_info
    devs = jax.devices()
    if devs[0].platform != 'gpu':
        raise RuntimeError(f"phase 1: JAX found {devs[0].platform}, "
                           "not a GPU")
    if len(devs) < ncards:
        raise RuntimeError(f"phase 1: {ncards} GPUs needed, "
                           f"{len(devs)} found")
    cache = use_compile_cache(os.path.join(HERE, '.xla_cache'))
    log(f"card: {card_info()}")
    log(f"jax {jax.__version__}; devices: {len(devs)} x "
        f"{devs[0].device_kind}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {cache}")
    return devs


def _relerr(a, b):
    """Relative L2 error of ``a`` against ``b``, reduced in f64."""
    import jax.numpy as jnp
    d = jnp.abs(a - b).astype(jnp.float64)
    r = jnp.abs(b).astype(jnp.float64)
    return jnp.sqrt(jnp.sum(d * d) / jnp.sum(r * r))


def _planar_noise(key, shape):
    import jax
    import jax.numpy as jnp
    return jax.random.normal(key, (2,) + shape, jnp.float32)


def _as_complex(p):
    from jax import lax
    return lax.complex(p[0], p[1])


def _peak(dev):
    return (dev.memory_stats() or {}).get('peak_bytes_in_use')


def phase2_c2c1024(dev):
    import jax
    import jax.numpy as jnp
    from mpi4py_fft_jax.parallel.planar import PlanarPFFT
    n = 1024
    shape = (n, n, n)
    key = jax.random.PRNGKey(SEED)
    gen = jax.jit(lambda k: _planar_noise(k, shape))
    ref = jax.jit(lambda k: jnp.fft.fftn(_as_complex(_planar_noise(k, shape))))(key)
    pfft = PlanarPFFT(None, shape, dtype='F', donate=True)
    t0 = time.perf_counter()
    y = pfft.forward(gen(key)).block_until_ready()
    log(f"phase 2: forward compiled and ran in "
        f"{time.perf_counter() - t0:.1f} s")
    err = float(jax.jit(lambda y, r: _relerr(_as_complex(y) * n ** 3, r))(
        y, ref))
    del ref
    log(f"phase 2: 1024^3 c2c f32 forward vs jnp.fft.fftn: rel L2 {err:.3e}")
    if not err <= 1e-5:
        raise RuntimeError(f"phase 2: forward error {err} > 1e-5")
    t0 = time.perf_counter()
    z = pfft.backward(y).block_until_ready()
    log(f"phase 2: backward compiled and ran in "
        f"{time.perf_counter() - t0:.1f} s")
    # one untimed pair: the chained inputs are the pipeline's own outputs
    z = pfft.backward(pfft.forward(z)).block_until_ready()
    tf, tb = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        y = pfft.forward(z).block_until_ready()
        tf.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        z = pfft.backward(y).block_until_ready()
        tb.append(time.perf_counter() - t0)
    rt = float(jax.jit(_relerr)(z, gen(key)))
    log(f"phase 2: round trip (5 forward+backward pairs) rel L2 {rt:.3e}")
    if not rt <= 1e-5:
        raise RuntimeError(f"phase 2: round-trip error {rt} > 1e-5")
    ms_f, ms_b = 1e3 * sum(tf) / 3, 1e3 * sum(tb) / 3
    log(f"phase 2: 1024^3 c2c f32 ms per transform: forward {ms_f:.2f}, "
        f"backward {ms_b:.2f}, mean {(ms_f + ms_b) / 2:.2f} (3 reps)")
    log(f"phase 2: peak_bytes_in_use {_peak(dev)}")
    spec = jax.ShapeDtypeStruct((2,) + shape, jnp.float32)
    mem = pfft._jit_forward.lower(spec, True).compile().memory_analysis()
    log(f"phase 2: forward memory_analysis: {mem}")


def _truncate_full(X, N, axis):
    """3/2-rule truncation of a full (not halved) spectral axis to even N:
    modes 0..N/2 and the top N/2, the two Nyquist rows summed
    (reference semantics: mpi4py_fft/libfft.py:263-284)."""
    import jax.numpy as jnp
    from jax import lax
    assert N % 2 == 0
    Np, h = X.shape[axis], N // 2
    head = lax.slice_in_dim(X, 0, h + 1, axis=axis)
    tail = lax.slice_in_dim(X, Np - h, Np, axis=axis)
    mid = lax.slice_in_dim(head, h, h + 1, axis=axis) \
        + lax.slice_in_dim(tail, 0, 1, axis=axis)
    return jnp.concatenate([lax.slice_in_dim(head, 0, h, axis=axis), mid,
                            lax.slice_in_dim(tail, 1, h, axis=axis)],
                           axis=axis)


def phase3_r2c512pad(dev):
    import jax
    import jax.numpy as jnp
    from jax import lax
    from mpi4py_fft_jax import PFFT
    n = 512
    fft = PFFT(None, (n, n, n), padding=[1.5, 1.5, 1.5], dtype='d')
    shape = fft.shape(False)
    assert shape == (768, 768, 768), shape
    key = jax.random.PRNGKey(SEED + 1)
    u = jax.random.normal(key, shape, jnp.float64)

    @jax.jit
    def reference(u):
        X = jnp.fft.rfftn(u)                       # complex128
        X = lax.slice_in_dim(X, 0, n // 2 + 1, axis=2)
        X = _truncate_full(_truncate_full(X, n, 1), n, 0)
        return X / float(768 ** 3)

    fwd = jax.jit(lambda v: fft.forward.fn(v))
    bwd = jax.jit(lambda v: fft.backward.fn(v))
    t0 = time.perf_counter()
    uh = fwd(u).block_until_ready()
    log(f"phase 3: forward compiled and ran in "
        f"{time.perf_counter() - t0:.1f} s; spectrum {uh.shape} {uh.dtype}")
    err = float(jax.jit(_relerr)(uh, reference(u)))
    log(f"phase 3: 512^3 r2c f64 (768^3 padded) forward vs jnp.fft.rfftn + "
        f"3/2 truncation: rel L2 {err:.3e}")
    if not err <= 1e-12:
        raise RuntimeError(f"phase 3: forward error {err} > 1e-12")
    uh2 = fwd(bwd(uh))
    gap = float(jnp.max(jnp.abs(uh2 - uh)))
    log(f"phase 3: spectral fixed point forward(backward(u_hat)): "
        f"max abs {gap:.3e}")
    if not gap <= 2e-10:
        raise RuntimeError(f"phase 3: round trip {gap} > 2e-10 atol")
    log(f"phase 3: peak_bytes_in_use {_peak(dev)}")


def phase4_buffer_api():
    import jax
    import numpy as np
    from mpi4py_fft_jax import PFFT, newDistArray
    n = 256
    fft = PFFT(None, (n, n, n), dtype='D')
    u = newDistArray(fft, forward_output=False)
    rng = np.random.default_rng(SEED + 2)
    host = rng.standard_normal(u.shape) + 1j * rng.standard_normal(u.shape)
    u[:] = host
    u_hat = fft.forward(u)
    if not isinstance(u_hat.v, jax.Array) or \
            {d.platform for d in u_hat.v.devices()} != {'gpu'}:
        raise RuntimeError("phase 4: the spectrum is not a GPU array")
    ref = np.fft.fftn(host) / host.size
    err = np.linalg.norm(np.asarray(u_hat) - ref) / np.linalg.norm(ref)
    back = fft.backward(u_hat)
    rt = np.linalg.norm(np.asarray(back) - host) / np.linalg.norm(host)
    log(f"phase 4: buffer API 256^3 c2c f64: forward vs numpy.fft.fftn "
        f"rel L2 {err:.3e}, round trip {rt:.3e}; u_hat on "
        f"{sorted(str(d) for d in u_hat.v.devices())}")
    if not (err <= 1e-12 and rt <= 1e-12):
        raise RuntimeError(f"phase 4: error {err} / {rt} > 1e-12")


def phase5_dns(dev):
    import numpy as np
    sys.path.insert(0, os.path.join(HERE, 'examples'))
    import spectral_dns_solver as dns
    k = dns.run(N=(64, 64, 64), T=0.1, dt=0.01, verbose=False)
    log(f"phase 5: DNS 64^3 f64 Taylor-Green energy {k:.12f}")
    if round(k - 0.124953117517, 7) != 0:
        raise RuntimeError(f"phase 5: energy {k} != 0.124953117517")
    n = 512
    fft, U_hat, step, energy = dns.make_solver(N=(n, n, n))
    t0 = time.perf_counter()
    U_hat = step(U_hat).block_until_ready()
    log(f"phase 5: 512^3 RK4 step compiled and ran in "
        f"{time.perf_counter() - t0:.1f} s")
    es = [energy(U_hat)]
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        U_hat = step(U_hat).block_until_ready()
        ts.append(time.perf_counter() - t0)
        es.append(energy(U_hat))
    log(f"phase 5: 512^3 f64 DNS ms per RK4 step: "
        f"{', '.join(f'{1e3 * t:.1f}' for t in ts)} "
        f"(mean {1e3 * sum(ts) / 3:.1f}); energies "
        f"{', '.join(f'{e:.12f}' for e in es)}")
    if not all(np.isfinite(es)) or \
            any(b > a * (1 + 1e-12) for a, b in zip(es, es[1:])):
        raise RuntimeError(f"phase 5: energy not finite or increasing: {es}")
    log(f"phase 5: peak_bytes_in_use {_peak(dev)}")


def _four_case(devs, grid, real):
    import jax
    import jax.numpy as jnp
    from mpi4py_fft_jax.parallel.planar import PlanarPFFT
    n = 1024
    shape = (n, n, n)
    key = jax.random.PRNGKey(SEED + 3)
    if real:
        gen = jax.jit(lambda k: jax.random.normal(k, shape, jnp.float32))
        ref = jax.jit(lambda k: jnp.fft.rfftn(gen(k)))(key)
    else:
        gen = jax.jit(lambda k: _planar_noise(k, shape))
        ref = jax.jit(lambda k: jnp.fft.fftn(_as_complex(gen(k))))(key)
    pfft = PlanarPFFT(None, shape, dtype='f' if real else 'F', grid=grid)
    if pfft.executor != 'shard_map':
        raise RuntimeError(f"--four: executor {pfft.executor}")
    # move the one-card reference and the input off card 0 before the
    # pipeline runs, so the per-card usage below shows the pipeline's own
    ref = jax.device_put(ref, pfft.pencils[-1].boundary_sharding())
    x = jax.device_put(gen(key), pfft.pencil[0].boundary_sharding(
        0 if real else 1))
    t0 = time.perf_counter()
    y = pfft.forward(x).block_until_ready()
    dt = time.perf_counter() - t0
    used = [(d.memory_stats() or {}).get('bytes_in_use') for d in devs[:4]]
    err = float(jax.jit(lambda y, r: _relerr(_as_complex(y) * n ** 3, r))(
        y, ref))
    del ref
    z = pfft.backward(y)
    rt = float(jax.jit(_relerr)(z, jax.device_put(gen(key), z.sharding)))
    z = pfft.backward(pfft.forward(z)).block_until_ready()
    t0 = time.perf_counter()
    for _ in range(3):
        y = pfft.forward(z).block_until_ready()
        z = pfft.backward(y).block_until_ready()
    ms = 1e3 * (time.perf_counter() - t0) / 6
    name = f"1024^3 {'r2c' if real else 'c2c'} f32 grid {grid}"
    log(f"--four: {name}: executor {pfft.executor}; forward vs one-card "
        f"jnp.fft rel L2 {err:.3e}; round trip {rt:.3e}; first forward "
        f"{dt:.1f} s; ms per transform {ms:.2f} (3 pairs)")
    log(f"--four: {name}: bytes_in_use per card after forward {used}")
    if not (err <= 1e-5 and rt <= 1e-5):
        raise RuntimeError(f"--four: {name}: error {err} / {rt} > 1e-5")


def main(argv):
    four = '--four' in argv
    if not four:
        phase0_card_tests()
    devs = phase1_device(4 if four else 1)
    if four:
        for grid, real in (((2, 2), False), ((1, 4), False),
                           ((2, 2), True)):
            _four_case(devs, grid, real)
    else:
        phase2_c2c1024(devs[0])
        phase3_r2c512pad(devs[0])
        phase4_buffer_api()
        phase5_dns(devs[0])
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == '__main__':
    main(sys.argv[1:])
