"""Tracing and per-stage profiling.

The reference has no built-in observability beyond ``fftw.print_plan`` and
manual timing scripts (reference: fftw/fftw_xfftn.pyx:173-175,
tests/test_speed.py); SURVEY.md §5 makes profiler hooks + per-stage timers a
first-class feature of this framework.

Provides:

* :func:`trace` — context manager around ``jax.profiler.trace`` producing a
  TensorBoard/XProf trace of everything run inside;
* :class:`Timer` — wall-clock timer with named laps (device-synchronized);
* :func:`card_info` — the GPU's name and power limit from ``nvidia-smi``;
* :func:`stage_times` — per-stage breakdown of a PFFT Transform: each serial
  transform and each transpose is jitted and timed separately so the cost of
  local transforms vs all-to-all traffic is visible (the fused pipeline
  itself is one XLA program and cannot be timed from Python).
"""
import contextlib
import subprocess
import time

import jax
import numpy as np

__all__ = ['trace', 'Timer', 'stage_times', 'annotate', 'card_info']


def card_info():
    """The GPUs' names and power limits as ``nvidia-smi`` reports them
    (one ``name, power.limit`` line per card), or None without it.  A card
    set below its maximum power runs slower under load, so every device
    time is reported beside this line."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


@contextlib.contextmanager
def trace(logdir='mpi4py_fft_jax_trace'):
    """Capture an XProf/TensorBoard device trace of the enclosed block."""
    with jax.profiler.trace(logdir):
        yield logdir


def annotate(name):
    """Named profiler scope; stage names show up in XProf timelines."""
    return jax.profiler.TraceAnnotation(name)


class Timer(object):
    """Device-synchronized wall-clock timer with named laps."""

    def __init__(self):
        self.laps = {}
        self._t0 = time.perf_counter()

    def lap(self, name, value=None):
        """Record time since last lap under ``name``; if ``value`` is a jax
        array it is block_until_ready'd first."""
        if value is not None and hasattr(value, 'block_until_ready'):
            value.block_until_ready()
        t = time.perf_counter()
        self.laps.setdefault(name, []).append(t - self._t0)
        self._t0 = t
        return value

    def report(self):
        lines = []
        for name, ts in self.laps.items():
            ts = np.asarray(ts)
            lines.append(f"{name:30s} n={len(ts):4d} "
                         f"mean={ts.mean()*1e3:9.3f} ms  "
                         f"min={ts.min()*1e3:9.3f} ms")
        return "\n".join(lines)


def stage_times(transform, x=None, reps=3):
    """Time each serial-transform stage and each transpose of a Transform
    separately (forward direction of the given Transform).

    The pipeline runs in its real form: logically complex stage data is
    planar ((2,)+shape real, ``transform._planars``), and every reshard is
    applied at the planar rank the fused executor uses
    (parallel/mpifft.py Transform._impl) — so the staged data flow is
    exactly the production pipeline, cut at stage boundaries.

    Returns dict: {'stage0': s, 'transpose0': s, 'stage1': s, ...,
                   'fused_total': s} — fused_total is the production path
    (one XLA program); the per-stage numbers are measured on separately
    jitted pieces and indicate where time goes, at the cost of losing
    XLA's compute/communication overlap.
    """
    import jax.numpy as jnp
    if x is None:
        x = transform.input_array.v
    x = np.asarray(x)
    pl = getattr(transform, '_planars',
                 (False,) * (len(transform._stages) + 1))
    if pl[0] and np.dtype(x.dtype).kind == 'c':
        # host boundary: complex input -> planar pipeline form
        x = np.ascontiguousarray(np.stack([x.real, x.imag]))
    x = jnp.asarray(x)

    out = {}
    normalize = transform._default_normalize
    cur = x

    def timed(fn, v):
        jfn = jax.jit(fn)
        y = jfn(v).block_until_ready()      # compile + warm up
        t0 = time.perf_counter()
        for _ in range(reps):
            y = jfn(v)
        y.block_until_ready()
        return y, (time.perf_counter() - t0) / reps

    cur, dt = timed(lambda v: transform._stages[0](v, normalize), cur)
    out['stage0'] = dt
    for i, (stage, reshard) in enumerate(
            zip(transform._stages[1:], transform._reshards)):
        # the data entering stage i+1 is planar iff _planars[i+1] — the
        # reshard must treat the leading planar axis as replicated
        rank = int(pl[i + 1])
        cur, dt = timed(lambda v, f=reshard, r=rank: f(v, rank=r), cur)
        out[f'transpose{i}'] = dt
        cur, dt = timed(lambda v, s=stage: s(v, normalize), cur)
        out[f'stage{i + 1}'] = dt
    out['_staged_result'] = cur

    if transform._jit is not None:
        y = transform._jit(x, normalize).block_until_ready()
        t0 = time.perf_counter()
        for _ in range(reps):
            y = transform._jit(x, normalize)
        y.block_until_ready()
        out['fused_total'] = (time.perf_counter() - t0) / reps
        out['_fused_result'] = y
    return out
