"""Device timings for the BASELINE.md milestone configs #3/#4/#5.

  #3  512^3 r2c pencil with 3/2 dealiasing padding
  #4  DCT-II/DST-II 256^3 pencil
  #5  spectral DNS at 512^3 (wall-time/step + per-stage split)

All run the unified PFFT at f32 (reference perf surface:
tests/test_speed.py) and print per-transform wall times, each ended by
``block_until_ready``.

Run on a GPU:  python scripts/bench_milestones.py [m3|m4|m5|stages ...]
"""
import functools
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

os.environ.setdefault('MPI4PY_FFT_JAX_X64', '0')

import numpy as np


def _bench(jax, fn, x, reps, tag):
    """Per-call wall time of ``fn(x)`` after one compiling call."""
    t0 = time.perf_counter()
    fn(x).block_until_ready()
    tc = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        y = fn(x)
    y.block_until_ready()
    dt = (time.perf_counter() - t0) / reps
    print(f"{tag:44s} {dt * 1e3:9.3f} ms   (compile {tc:.0f}s)", flush=True)
    return dt


def m3():
    """512^3 r2c + 3/2 padding: the dealiased spectral-solver transform."""
    import jax
    import jax.numpy as jnp
    from mpi4py_fft_jax import PFFT

    n = int(os.environ.get('M3_N', 512))
    fft = PFFT(None, (n, n, n), padding=[1.5, 1.5, 1.5], dtype='f')
    print(f"m3: r2c {n}^3 + 3/2-rule padding "
          f"(physical {fft.shape(False)}, spectral {fft.shape(True)})",
          flush=True)
    rng = np.random.default_rng(2)
    # planar spectral input (2,) + spectral shape — the pipeline form
    uh = jnp.asarray(rng.standard_normal((2,) + fft.shape(True))
                     .astype(np.float32))

    bwd = jax.jit(lambda p: fft.backward.fn_p(p, False))
    fwd = jax.jit(lambda u: fft.forward.fn_p(u, True))
    # correctness: spectral fix-point under the padded roundtrip
    up = bwd(uh)
    uh2 = fwd(up)
    uh3 = fwd(bwd(uh2))
    rel = (np.linalg.norm(np.asarray(uh3) - np.asarray(uh2))
           / np.linalg.norm(np.asarray(uh2)))
    print(f"  padded spectral fixpoint rel err: {rel:.3e}", flush=True)
    assert rel < 1e-4, rel
    del uh, uh3          # free device memory before timing

    reps = int(os.environ.get('M3_REPS', 10))
    tb = _bench(jax, bwd, uh2, reps, f"  backward (pad to {int(1.5 * n)}^3)")
    tf = _bench(jax, fwd, up, reps, f"  forward (truncate to {n}^3)")
    # flop model on the padded physical grid
    m = int(1.5 * n)
    flops = 2.5 * m ** 3 * (np.log2(m) * 3)  # r2c ~ half of 5NlogN
    print(f"  r2c-padded GFLOP/s: fwd {flops / tf / 1e9:.0f} "
          f"bwd {flops / tb / 1e9:.0f}", flush=True)


def m4():
    """DCT-II/DST-II 256^3: the r2r pencil milestone."""
    import jax
    import jax.numpy as jnp
    from mpi4py_fft_jax import PFFT, fftw

    n = int(os.environ.get('M4_N', 256))
    dct2 = functools.partial(fftw.dctn, type=2)
    idct2 = functools.partial(fftw.idctn, type=2)
    dst2 = functools.partial(fftw.dstn, type=2)
    idst2 = functools.partial(fftw.idstn, type=2)
    fft = PFFT(None, (n, n, n), axes=((0,), (1,), (2,)),
               transforms={(0,): (dct2, idct2), (1,): (dct2, idct2),
                           (2,): (dst2, idst2)}, dtype='f')
    print(f"m4: DCT-II/DCT-II/DST-II {n}^3", flush=True)
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.standard_normal((n, n, n)).astype(np.float32))

    fwd = jax.jit(lambda v: fft.forward.fn_p(v, True))
    bwd = jax.jit(lambda p: fft.backward.fn_p(p, False))
    ub = np.asarray(bwd(fwd(u)))
    rel = np.linalg.norm(ub - np.asarray(u)) / np.linalg.norm(np.asarray(u))
    print(f"  roundtrip rel err: {rel:.3e}", flush=True)
    assert rel < 1e-5, rel
    # correctness vs scipy at 64^3 (same plan family, host-checkable size)
    from scipy import fft as sfft
    f64 = PFFT(None, (64,) * 3, axes=((0,), (1,), (2,)),
               transforms={(0,): (dct2, idct2), (1,): (dct2, idct2),
                           (2,): (dst2, idst2)}, dtype='f')
    X = rng.standard_normal((64,) * 3).astype(np.float32)
    got = np.asarray(jax.jit(lambda v: f64.forward.fn_p(v, True))(
        jnp.asarray(X)))
    ref = sfft.dstn(sfft.dctn(X, axes=(0, 1), type=2), axes=(2,), type=2)
    ref /= (2 * 64) ** 3  # forward-normalized (1/(2N) per r2r axis)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    print(f"  64^3 vs scipy rel err: {rel:.3e}", flush=True)
    assert rel < 1e-4, rel

    reps = int(os.environ.get('M4_REPS', 20))
    tf = _bench(jax, fwd, u, reps, "  forward (3x r2r)")
    _bench(jax, bwd, fwd(u), reps, "  backward")
    flops = 5 * n ** 3 * np.log2(n) * 3  # each r2r ~ one length-n FFT
    print(f"  r2r GFLOP/s (5NlogN-equiv): {flops / tf / 1e9:.0f}",
          flush=True)


def m5():
    """Spectral DNS at 512^3 f32: wall-time per RK4 step on the GPU."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                    'examples'))
    import jax
    import spectral_dns_planar as dns

    n = int(os.environ.get('M5_N', 512))
    print(f"m5: spectral DNS {n}^3 f32 (9 transforms x 4 RK stages/step)",
          flush=True)
    pfft, U_hat, step, energy = dns.make_solver(N=(n, n, n), dtype='f')
    t0 = time.perf_counter()
    mode = os.environ.get('M5_MODE',
                          'split' if os.environ.get('M5_SPLIT') == '1'
                          else 'fused')
    drivers = {'fused': step, 'split': step.split,
               'perpipe': step.perpipe}
    # escalating fallback: fused 36-transform program -> 9-transform
    # substage programs -> one program per transform
    order = {'fused': ('fused', 'split', 'perpipe'),
             'split': ('split', 'perpipe'),
             'perpipe': ('perpipe',)}[mode]
    for i, name in enumerate(order):
        step = drivers[name]
        try:
            U_hat = step(U_hat).block_until_ready()
            print(f"  driver: {name}", flush=True)
            break
        except Exception as e:                      # noqa: BLE001
            if i == len(order) - 1:
                raise
            print(f"  {name} step failed ({type(e).__name__}); trying "
                  f"{order[i + 1]}", flush=True)
    print(f"  first step (incl. compile): {time.perf_counter() - t0:.1f}s",
          flush=True)
    nsteps = int(os.environ.get('M5_STEPS', 5))
    t0 = time.perf_counter()
    for _ in range(nsteps):
        U_hat = step(U_hat)
    U_hat.block_until_ready()
    dt = (time.perf_counter() - t0) / nsteps
    # 36 transforms/step on the n^3 grid, r2c ~ 2.5 N log2 N
    flops = 36 * 2.5 * n ** 3 * np.log2(n) * 3
    print(f"  wall/step: {dt * 1e3:.1f} ms  "
          f"({flops / dt / 1e12:.2f} TFLOP/s transform-equiv)", flush=True)
    print(f"  energy: {energy(U_hat):.9f}", flush=True)


def stages():
    """Per-stage split of a 512^3 r2c forward (transform vs transpose)."""
    import jax
    import jax.numpy as jnp
    from mpi4py_fft_jax import PFFT
    from mpi4py_fft_jax.utils.profiling import stage_times

    n = int(os.environ.get('M5_N', 512))
    fft = PFFT(None, (n, n, n), dtype='f')
    rng = np.random.default_rng(5)
    u = jnp.asarray(rng.standard_normal((n, n, n)).astype(np.float32))
    out = stage_times(fft.forward, u, reps=int(os.environ.get('REPS', 5)))
    tot_t = sum(v for k, v in out.items() if k.startswith('stage'))
    tot_x = sum(v for k, v in out.items() if k.startswith('transpose'))
    print(f"stage split: r2c {n}^3 forward", flush=True)
    for k, v in out.items():
        if k.startswith('_'):           # carried arrays, not timings
            continue
        print(f"  {k:12s} {v * 1e3:9.3f} ms", flush=True)
    print(f"  transforms {tot_t * 1e3:.3f} ms | transposes "
          f"{tot_x * 1e3:.3f} ms", flush=True)


if __name__ == '__main__':
    which = sys.argv[1:] or ['m3', 'm4', 'stages', 'm5']
    for w in which:
        globals()[w]()
