"""Benchmark: device time of the parallel FFT pipelines on one GPU.

Cells (one JSON line each, in the order given on the command line):

  c2c1024    1024^3 c2c f32 through PlanarPFFT (BASELINE.json north star):
             normalized forward + backward in one jitted call, donated
  r2c512pad  512^3 r2c f64 through PFFT with 3/2-rule padding (768^3
             physical): forward + backward in one jitted call, donated

The local-transform engine is the one ops/core.py selects
(``MPI4PY_FFT_JAX_FFT_IMPL=xla|matmul``), so an engine A/B is two runs of
this script inside one machine session.  Each time is the host wall clock
around one call ended by ``block_until_ready``, after two untimed calls;
a cell reports the median of ``BENCH_REPS`` calls and every call's time.
Every line names the device and the card's power limit; the script fails
when JAX finds no GPU.

Usage:  python bench.py [c2c1024] [r2c512pad]
        python bench.py --weak-scaling [P D n reps]   (CPU protocol)
"""
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPS = int(os.environ.get('BENCH_REPS', 5))


def _timed(f, x, reps):
    """Seconds of each of ``reps`` calls of ``f`` chained on its own
    output (donated), and the first call's seconds.  The first call
    compiles for the fresh input; the second may compile again for an
    input that is the program's own output (another sharding), so both
    stay out of the timed calls."""
    t0 = time.perf_counter()
    y = f(x).block_until_ready()
    compile_s = time.perf_counter() - t0
    y = f(y).block_until_ready()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        y = f(y).block_until_ready()
        ts.append(time.perf_counter() - t0)
    return ts, compile_s


def _result(ts, compile_s, flops_per_transform):
    """Two transforms per call: per-transform median, spread, rate."""
    ms = [t / 2 * 1e3 for t in ts]
    med = float(np.median(ms))
    return dict(ms_per_transform=med, ms_reps=ms, compile_s=compile_s,
                gflops=flops_per_transform / med / 1e6)


def cell_c2c1024():
    import jax
    import jax.numpy as jnp
    from mpi4py_fft_jax.parallel.planar import PlanarPFFT
    n = 1024
    pfft = PlanarPFFT(None, (n, n, n), dtype='F')
    f = jax.jit(lambda p: pfft.backward_fn(pfft.forward_fn(p, True), False),
                donate_argnums=(0,))
    p = jax.random.uniform(jax.random.PRNGKey(0), (2, n, n, n), jnp.float32,
                           -0.5, 0.5)
    ntot = float(n) ** 3
    return _result(*_timed(f, p, REPS), 5.0 * ntot * np.log2(ntot))


def cell_r2c512pad():
    import jax
    import jax.numpy as jnp
    from mpi4py_fft_jax import PFFT
    n = 512
    fft = PFFT(None, (n, n, n), padding=[1.5, 1.5, 1.5], dtype='d')
    f = jax.jit(lambda u: fft.backward.fn_p(fft.forward.fn_p(u, True),
                                            False), donate_argnums=(0,))
    shape = fft.shape(False)
    u = jax.random.uniform(jax.random.PRNGKey(1), shape, jnp.float64)
    ntot = float(np.prod(shape))
    return _result(*_timed(f, u, REPS), 2.5 * ntot * np.log2(ntot))


CELLS = {'c2c1024': cell_c2c1024, 'r2c512pad': cell_r2c512pad}


def main(names):
    import jax
    from mpi4py_fft_jax.ops import core
    from mpi4py_fft_jax.ops.plan import use_compile_cache
    from mpi4py_fft_jax.utils.profiling import card_info
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        raise SystemExit(f"bench.py measures a GPU; JAX found "
                         f"{dev.platform} ({dev.device_kind})")
    cache = use_compile_cache(os.path.join(HERE, '.xla_cache'))
    card = card_info()
    print(f"# card: {card}; compile cache: {cache}; "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    for name in names:
        res = CELLS[name]()
        res.update(cell=name, engine=core.get_fft_impl(), reps=REPS,
                   device=dict(platform=dev.platform, kind=dev.device_kind,
                               count=len(jax.devices())),
                   card=card,
                   peak_bytes_in_use=dev.memory_stats().get(
                       'peak_bytes_in_use'))
        print(json.dumps(res), flush=True)


if __name__ == '__main__':
    if len(sys.argv) > 1 and sys.argv[1] == '--weak-scaling':
        sys.path.insert(0, os.path.join(HERE, 'scripts'))
        import bench_weak_scaling
        bench_weak_scaling.main(*[int(a) for a in sys.argv[2:6]])
    else:
        main(sys.argv[1:] or list(CELLS))
