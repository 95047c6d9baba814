"""Per-stage profiling: stage_times must reproduce the fused pipeline.

An earlier ``stage_times`` applied reshards at rank=0 while the
planar pipeline carries a leading (2,) axis that the fused executor
constrains at rank=1 (parallel/mpifft.py Transform._impl) — the staged
data flow diverged from production.  These tests cut a 3-stage transform
at its stage boundaries and assert the staged chain computes the SAME
result as the fused program.
"""
import numpy as np
import pytest

from mpi4py_fft_jax import PFFT
from mpi4py_fft_jax.utils.profiling import stage_times, Timer


def _staged_keys(out, nstages):
    for i in range(nstages):
        assert f'stage{i}' in out, out.keys()
    for i in range(nstages - 1):
        assert f'transpose{i}' in out, out.keys()
    assert 'fused_total' in out


@pytest.mark.parametrize("typecode", ['f', 'D'])
def test_stage_times_matches_fused(typecode):
    # 3 stages / 2 transposes on the 8-device mesh; complex dtype runs the
    # planar pipeline (leading (2,) axis) — the case that was broken
    shape = (16, 16, 16)
    fft = PFFT(None, shape, dtype=typecode)
    rng = np.random.default_rng(11)
    if typecode == 'D':
        u = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype('D')
    else:
        u = rng.standard_normal(shape).astype('f')
    out = stage_times(fft.forward, u, reps=1)
    _staged_keys(out, nstages=3)
    staged = np.asarray(out['_staged_result'])
    fused = np.asarray(out['_fused_result'])
    assert staged.shape == fused.shape
    # XLA fuses differently in the staged vs fused programs — identical
    # math, slightly different rounding
    atol = 1e-6 if typecode == 'f' else 1e-12
    assert np.allclose(staged, fused, rtol=0, atol=atol), \
        np.abs(staged - fused).max()
    for k, v in out.items():
        if not k.startswith('_'):
            assert v > 0.0


def test_stage_times_sum_approximates_total():
    # per-stage sum tracks the fused total (same math, staged dispatch);
    # CPU timing is noisy, so only a loose plausibility band is asserted
    fft = PFFT(None, (16, 16, 16), dtype='D')
    rng = np.random.default_rng(5)
    u = (rng.standard_normal((16, 16, 16))
         + 1j * rng.standard_normal((16, 16, 16))).astype('D')
    out = stage_times(fft.forward, u, reps=3)
    parts = sum(v for k, v in out.items()
                if k.startswith(('stage', 'transpose')))
    assert parts > 0 and out['fused_total'] > 0
    # staged pieces can be faster or slower than fused per-run, but the
    # same work is done: demand agreement within two orders of magnitude
    assert parts < 100 * out['fused_total']
    assert out['fused_total'] < 100 * parts


def test_timer_laps():
    t = Timer()
    t.lap('a')
    t.lap('a')
    t.lap('b')
    assert len(t.laps['a']) == 2 and len(t.laps['b']) == 1
    assert 'a' in t.report() and 'b' in t.report()
