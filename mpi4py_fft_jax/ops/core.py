"""Pure-JAX serial transform math (FFTW conventions, unnormalized).

This is the compute core replacing the reference's native FFTW engine
(reference: mpi4py_fft/fftw/fftw_planxfftn.c:10-77 and
fftw_xfftn.pyx:109-296).  Design notes:

* every function here is *pure* and *jittable* with static ``axes``/``kind``
  arguments — the distributed PFFT layer composes them into one fused XLA
  program, so "plan construction" is trace+compile and "wisdom" is the XLA
  persistent compilation cache;
* complex FFTs use the engine chosen by :func:`get_fft_impl` (by default
  the XLA FFT, which lowers to cuFFT on an NVIDIA GPU);
* real-to-real transforms (DCT/DST I-IV, DHT) use FFT-backed O(N log N)
  algorithms, with dense cosine/sine basis contractions via
  ``dot_general`` for tiny axes;
* all transforms are **unnormalized** exactly like FFTW; normalization
  constants are applied by the plan layer (reference: fftw/xfftn.py:763-816).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .kinds import (
    FFTW_R2HC, FFTW_HC2R, FFTW_DHT,
    FFTW_REDFT00, FFTW_REDFT01, FFTW_REDFT10, FFTW_REDFT11,
    FFTW_RODFT00, FFTW_RODFT01, FFTW_RODFT10, FFTW_RODFT11,
)

__all__ = ['c2c', 'r2c', 'c2r', 'r2r', 'r2r_output_length']


# ---------------------------------------------------------------------------
# complex transforms — engine dispatch
# ---------------------------------------------------------------------------
# 'xla' (default): the backend's native FFT op (jnp.fft) — cuFFT on an
#     NVIDIA GPU, ducc on the CPU.  It is also the local-stage engine of
#     the parallel pipelines (ops.matfft), sharded layouts included.
# 'matmul': the dense-DFT mixed-radix engine (ops.matfft), measured
#     3.9-4.9x slower than 'xla' on an H100 (PERF.md).
import os as _os

_FFT_IMPL = _os.environ.get('MPI4PY_FFT_JAX_FFT_IMPL', 'xla')


def set_fft_impl(impl):
    """Select the complex-FFT engine: 'xla' (jnp.fft) or 'matmul'.
    Clears jit caches — compiled plans bake the engine in."""
    global _FFT_IMPL
    if impl not in ('matmul', 'xla'):
        raise ValueError(f"unknown FFT engine {impl!r}: 'xla' or 'matmul'")
    if impl != _FFT_IMPL:
        _FFT_IMPL = impl
        jax.clear_caches()


def get_fft_impl():
    return _FFT_IMPL


def c2c(x, axes, forward=True):
    """Unnormalized complex-to-complex FFT over ``axes``.

    forward: sign -1 exponent (FFTW_FORWARD); backward: sign +1, *not* scaled
    (FFTW convention — reference: fftw/fftw_planxfftn.c:43-49).
    """
    if _FFT_IMPL == 'matmul':
        from . import matfft
        return matfft.fftn(x, axes, forward)
    if forward:
        return jnp.fft.fftn(x, axes=axes)
    return jnp.fft.ifftn(x, axes=axes, norm="forward")


def r2c(x, axes):
    """Unnormalized real-to-complex FFT; ``axes[-1]`` is the halved axis
    (length N -> N//2+1), matching FFTW guru r2c layout
    (reference: fftw/fftw_planxfftn.c:50-56, fftw/xfftn.py:228-240)."""
    if _FFT_IMPL == 'matmul':
        from . import matfft
        return matfft.rfftn(x, axes)
    # jnp.fft.rfftn halves the *last* entry of axes, same convention.
    return jnp.fft.rfftn(x, axes=axes)


def c2r(x, axes, last_size):
    """Unnormalized complex-to-real inverse FFT; output length along
    ``axes[-1]`` is ``last_size`` (resolves the 2N-2 vs 2N-1 ambiguity,
    reference: fftw/xfftn.py:306-326)."""
    if _FFT_IMPL == 'matmul':
        from . import matfft
        return matfft.irfftn(x, axes, last_size)
    s = tuple(x.shape[a] for a in axes[:-1]) + (int(last_size),)
    return jnp.fft.irfftn(x, s=s, axes=axes, norm="forward")


# ---------------------------------------------------------------------------
# real-to-real transforms — basis contractions
# ---------------------------------------------------------------------------

def r2r_output_length(N, kind):
    """Logical output length of a 1-D r2r transform of input length N.
    All FFTW r2r kinds are length-preserving."""
    return N


@functools.lru_cache(maxsize=None)
def _r2r_basis(N, kind, dtype_str):
    """Dense (N_out, N_in) basis matrix for an FFTW r2r kind, f64-built.

    Definitions follow FFTW's unnormalized conventions
    (http://fftw.org Real-to-Real Transform Kinds; validated against
    scipy.fft.dct/dst norm=None in tests/test_fftw.py).
    """
    n = np.arange(N)[None, :].astype(np.float64)   # input index
    k = np.arange(N)[:, None].astype(np.float64)   # output index
    if kind == FFTW_REDFT00:                       # DCT-I
        assert N > 1, "REDFT00 requires N >= 2"
        B = 2.0 * np.cos(np.pi * n * k / (N - 1))
        B[:, 0] *= 0.5
        B[:, -1] *= 0.5
    elif kind == FFTW_REDFT10:                     # DCT-II
        B = 2.0 * np.cos(np.pi * (n + 0.5) * k / N)
    elif kind == FFTW_REDFT01:                     # DCT-III
        B = 2.0 * np.cos(np.pi * n * (k + 0.5) / N)
        B[:, 0] *= 0.5
    elif kind == FFTW_REDFT11:                     # DCT-IV
        B = 2.0 * np.cos(np.pi * (n + 0.5) * (k + 0.5) / N)
    elif kind == FFTW_RODFT00:                     # DST-I
        B = 2.0 * np.sin(np.pi * (n + 1) * (k + 1) / (N + 1))
    elif kind == FFTW_RODFT10:                     # DST-II
        B = 2.0 * np.sin(np.pi * (n + 0.5) * (k + 1) / N)
    elif kind == FFTW_RODFT01:                     # DST-III
        B = 2.0 * np.sin(np.pi * (n + 1) * (k + 0.5) / N)
        B[:, -1] *= 0.5
    elif kind == FFTW_RODFT11:                     # DST-IV
        B = 2.0 * np.sin(np.pi * (n + 0.5) * (k + 0.5) / N)
    elif kind == FFTW_DHT:                         # discrete Hartley
        B = np.cos(2 * np.pi * n * k / N) + np.sin(2 * np.pi * n * k / N)
    else:
        raise ValueError(f"no dense basis for r2r kind {kind}")
    return B.astype(np.dtype(dtype_str))


def _apply_basis(x, B, axis):
    """Contract array axis with basis matrix B (N_out, N_in)."""
    y = jnp.tensordot(x, B, axes=((axis,), (1,)),
                      precision=lax.Precision.HIGHEST)
    return jnp.moveaxis(y, -1, axis)


def _r2hc_1d(x, axis):
    """FFTW halfcomplex forward along one axis: output layout
    [r0..r_{N/2}, i_{(N+1)//2-1}..i_1] (FFTW halfcomplex format).
    Routed through the planar engine."""
    from . import matfft
    N = x.shape[axis]
    P = matfft.rfftn_p(x, (axis,))        # planar (2, ..., N//2+1)
    re = P[0]
    n_im = (N + 1) // 2 - 1
    if n_im > 0:
        idx = jnp.arange(n_im, 0, -1)
        im = jnp.take(P[1], idx, axis=axis)
        return jnp.concatenate([re, im], axis=axis)
    return re


def _hc2r_1d(x, axis):
    """FFTW halfcomplex unnormalized inverse along one axis.
    Routed through the planar engine."""
    from . import matfft
    N = x.shape[axis]
    re = jnp.take(x, jnp.arange(N // 2 + 1), axis=axis)
    n_im = (N + 1) // 2 - 1
    if n_im > 0:
        idx = jnp.arange(N - 1, N - 1 - n_im, -1)
        im = jnp.take(x, idx, axis=axis)
        pad = [(0, 0)] * x.ndim
        pad[axis] = (1, N // 2 + 1 - (1 + n_im))
        im = jnp.pad(im, pad)
    else:
        im = jnp.zeros_like(re)
    P = jnp.stack([re, im])
    return matfft.irfftn_p(P, (axis,), N)


# ---------------------------------------------------------------------------
# FFT-backed DCT-II/III and DST-II/III (Makhoul's N-point real-FFT method)
# — rides the planar engine in O(N log N) instead of the dense O(N^2)
# basis contraction.
# Unnormalized FFTW conventions, validated vs scipy in tests/test_fftw.py.
# ---------------------------------------------------------------------------

# r2r engine: 'dense' = basis matmul; 'fft' = Makhoul real-FFT method;
# 'auto' = fft for the kinds/shapes it supports, dense otherwise.
_R2R_IMPL = _os.environ.get('MPI4PY_FFT_JAX_R2R', 'auto')


def set_r2r_impl(impl):
    global _R2R_IMPL
    assert impl in ('auto', 'fft', 'dense')
    _R2R_IMPL = impl


_FFT_R2R_KINDS = (FFTW_REDFT00, FFTW_REDFT10, FFTW_REDFT01, FFTW_REDFT11,
                  FFTW_RODFT00, FFTW_RODFT10, FFTW_RODFT01, FFTW_RODFT11,
                  FFTW_DHT)


def _use_fft_r2r(N, kind):
    """Every FFTW r2r kind has an O(N log N) path here (the guru planner
    covers them all in the reference, fftw/fftw_planxfftn.c:60-70); the
    dense basis remains for tiny axes (where one small matmul beats
    the FFT's reorder passes) and for the forced 'dense' impl."""
    if _R2R_IMPL == 'dense' or kind not in _FFT_R2R_KINDS:
        return False
    if _R2R_IMPL == 'fft':
        return True
    return N >= 16


def _take(x, idx, axis):
    return jnp.take(x, jnp.asarray(idx), axis=axis)


def _makhoul_idx(N):
    """Makhoul's permutation for any N: even input indices ascending,
    then odd indices descending (v[n] = x[2n], v[N-1-n] = x[2n+1])."""
    hi = N - 1 if N % 2 == 0 else N - 2      # largest odd index
    return np.concatenate([np.arange(0, N, 2), np.arange(hi, 0, -2)])


@functools.lru_cache(maxsize=None)
def _makhoul_consts(N, dtype_str):
    """cos/sin(pi*k/(2N)) rows for k = 0..N-1 (f64-built)."""
    th = np.pi * np.arange(N) / (2.0 * N)
    return (np.cos(th).astype(dtype_str), np.sin(th).astype(dtype_str))


def _rowshape(vec, ndim, axis):
    sh = [1] * ndim
    sh[axis] = len(vec)
    return jnp.asarray(vec).reshape(sh)


def _dct2_fft(x, axis):
    """REDFT10: X[k] = 2 sum x[n] cos(pi (n+1/2) k / N)  (Makhoul 1980).

    v = [x[0], x[2], ..., x[N-1], ..., x[3], x[1]];  V = rfft(v);
    X[k] = 2 Re(e^{-i pi k/2N} V[k]), Hermitian-extended past N/2.
    """
    from . import matfft
    N = x.shape[axis]
    v = _take(x, _makhoul_idx(N), axis)
    P = matfft.rfftn_p(v, (axis,))             # (2, ..., N//2+1)
    # full-length spectrum by Hermitian reflection V[k>N/2] = conj(V[N-k])
    k = np.arange(N)
    refl = np.where(k <= N // 2, k, N - k)
    sgn = np.where(k <= N // 2, 1.0, -1.0).astype(x.dtype)
    Vr = _take(P[0], refl, axis)
    Vi = _take(P[1], refl, axis) * _rowshape(sgn, x.ndim, axis)
    c, s = _makhoul_consts(N, np.dtype(x.dtype).name)
    return 2.0 * (Vr * _rowshape(c, x.ndim, axis)
                  + Vi * _rowshape(s, x.ndim, axis))


def _dct3_fft(y, axis):
    """REDFT01 (unnormalized DCT-III, the transpose of REDFT10):
    X[n] = y[0] + 2 sum_{k>=1} y[k] cos(pi k (n+1/2) / N).

    Inverse Makhoul: V[k] = e^{+i pi k/2N} (y[k] - i y[N-k]) / 2
    (y[N]:=0) for k = 0..N/2 is the rfft of the even/odd-reordered
    2N-rule sequence v; REDFT01(y) = 2N * reorder^{-1}(IDFT(V)).  The
    planar c2r is FFTW-unnormalized (returns N*IDFT), so the factors
    cancel: REDFT01(y) = reorder^{-1}(c2r((y[k] - i y[N-k]) e^{+i pi
    k/2N})).  Verified vs scipy dct type 3 in tests/test_fftw.py.
    """
    from . import matfft
    N = y.shape[axis]
    nh = N // 2 + 1
    k = np.arange(nh)
    ydt = np.dtype(y.dtype).name
    c, s = _makhoul_consts(N, ydt)
    c, s = c[:nh], s[:nh]
    yk = _take(y, k, axis)
    # y[N-k] with y[N] := 0
    back = (N - k) % N
    ynk = _take(y, back, axis)
    mask = np.ones(nh, dtype=ydt)
    mask[0] = 0.0
    ynk = ynk * _rowshape(mask, y.ndim, axis)
    # V = (yk - i*ynk) * (c + i s) = (yk*c + ynk*s) + i(yk*s - ynk*c)
    Wr = yk * _rowshape(c, y.ndim, axis) + ynk * _rowshape(s, y.ndim, axis)
    Wi = yk * _rowshape(s, y.ndim, axis) - ynk * _rowshape(c, y.ndim, axis)
    P = jnp.stack([Wr, Wi])
    v = matfft.irfftn_p(P, (axis,), N)          # unnormalized c2r
    # undo reorder: x[2n] = v[n], x[2n+1] = v[N-1-n]
    return _take(v, np.argsort(_makhoul_idx(N)), axis)


def _alt_signs(N, dtype_str):
    return ((-1.0) ** np.arange(N)).astype(dtype_str)


def _dst2_fft(x, axis):
    """RODFT10 via REDFT10: DST-II(x)[k] = DCT-II(u)[N-1-k] with
    u[n] = (-1)^n x[n] (standard index-reversal identity)."""
    N = x.shape[axis]
    u = x * _rowshape(_alt_signs(N, np.dtype(x.dtype).name), x.ndim, axis)
    X = _dct2_fft(u, axis)
    return _take(X, np.arange(N - 1, -1, -1), axis)


def _dst3_fft(y, axis):
    """RODFT01 via REDFT01 (transpose of the DST-II identity):
    DST-III(y)[n] = (-1)^n DCT-III(y[N-1-k])[n]."""
    N = y.shape[axis]
    yr = _take(y, np.arange(N - 1, -1, -1), axis)
    X = _dct3_fft(yr, axis)
    return X * _rowshape(_alt_signs(N, np.dtype(y.dtype).name), y.ndim, axis)


def _dct1_fft(x, axis):
    """REDFT00 (DCT-I): X[k] = x[0] + (-1)^k x[N-1]
    + 2 sum_{1<=n<=N-2} x[n] cos(pi n k / (N-1)).

    The even extension v = [x[0..N-1], x[N-2..1]] of length M = 2(N-1)
    has a purely real DFT with V[k] = X[k]; rfft(v) yields exactly
    M//2+1 = N rows, so X = Re(rfft(v)) with no reflection pass."""
    from . import matfft
    N = x.shape[axis]
    ext = _take(x, np.arange(N - 2, 0, -1), axis)
    v = jnp.concatenate([x, ext], axis=axis)
    return matfft.rfftn_p(v, (axis,))[0]


def _dst1_fft(x, axis):
    """RODFT00 (DST-I): X[k] = 2 sum x[n] sin(pi (n+1)(k+1) / (N+1)).

    The odd extension v = [0, x[0..N-1], 0, -x[N-1..0]] of length
    M = 2(N+1) has DFT V[k] = -i X[k-1] (purely imaginary), so
    X = -Im(rfft(v))[1:N+1]."""
    from . import matfft
    N = x.shape[axis]
    zshape = list(x.shape)
    zshape[axis] = 1
    z = jnp.zeros(zshape, x.dtype)
    rev = _take(x, np.arange(N - 1, -1, -1), axis)
    v = jnp.concatenate([z, x, z, -rev], axis=axis)
    P = matfft.rfftn_p(v, (axis,))               # (2, ..., N+2)
    return -_take(P[1], np.arange(1, N + 1), axis)


@functools.lru_cache(maxsize=None)
def _dct4_consts(N, dtype_str):
    """(cos(pi(2n+1)/(4N)) pre-twiddle, signed cumsum weights, (-1)^k)."""
    pre = 2.0 * np.cos(np.pi * (2 * np.arange(N) + 1) / (4.0 * N))
    w = np.full(N, 2.0)
    w[0] = 1.0
    w *= (-1.0) ** np.arange(N)
    sk = (-1.0) ** np.arange(N)
    dt = np.dtype(dtype_str)
    return pre.astype(dt), w.astype(dt), sk.astype(dt)


def _dct4_fft(x, axis):
    """REDFT11 (DCT-IV): X[k] = 2 sum x[n] cos(pi (2n+1)(2k+1) / (4N)).

    Product-to-sum on the half-sample-shift twiddle gives
    DCT2(2 x[n] cos(pi(2n+1)/4N))[k] = X[k] + X[k-1] with X[-1] = V[0],
    i.e. X[0] = V[0] and X[k] = 2 V[k] - X[k-1] — solved in parallel as
    an alternating-sign cumulative sum (log-depth in XLA), so the whole
    kind rides the FFT-backed DCT-II at any N."""
    N = x.shape[axis]
    pre, w, sk = _dct4_consts(N, np.dtype(x.dtype).name)
    u = x * _rowshape(pre, x.ndim, axis)
    V = _dct2_fft(u, axis) * 0.5                 # V[k] as derived above
    S = jnp.cumsum(V * _rowshape(w, x.ndim, axis), axis=axis)
    return S * _rowshape(sk, x.ndim, axis)


def _dst4_fft(x, axis):
    """RODFT11 via REDFT11: DST-IV(x)[k] = DCT-IV((-1)^n x)[N-1-k]."""
    N = x.shape[axis]
    u = x * _rowshape(_alt_signs(N, np.dtype(x.dtype).name), x.ndim, axis)
    X = _dct4_fft(u, axis)
    return _take(X, np.arange(N - 1, -1, -1), axis)


def _dht_fft(x, axis):
    """FFTW_DHT: X[k] = sum x[n] (cos + sin)(2 pi n k / N)
    = Re(V[k]) - Im(V[k]) for V = DFT(x); real input, so one rfft plus
    the Hermitian reflection (Im flips sign past N/2)."""
    from . import matfft
    N = x.shape[axis]
    P = matfft.rfftn_p(x, (axis,))
    k = np.arange(N)
    refl = np.where(k <= N // 2, k, N - k)
    sgn = np.where(k <= N // 2, 1.0, -1.0).astype(x.dtype)
    Vr = _take(P[0], refl, axis)
    Vi = _take(P[1], refl, axis) * _rowshape(sgn, x.ndim, axis)
    return Vr - Vi


_FFT_R2R_FN = {FFTW_REDFT10: _dct2_fft, FFTW_REDFT01: _dct3_fft,
               FFTW_RODFT10: _dst2_fft, FFTW_RODFT01: _dst3_fft,
               FFTW_REDFT00: _dct1_fft, FFTW_RODFT00: _dst1_fft,
               FFTW_REDFT11: _dct4_fft, FFTW_RODFT11: _dst4_fft,
               FFTW_DHT: _dht_fft}


def r2r(x, axes, kinds):
    """Separable real-to-real transform: ``kinds[i]`` applied along
    ``axes[i]`` (reference semantics: fftw/fftw_planxfftn.c:57-76 r2r path,
    one FFTW kind per transformed dimension)."""
    assert len(axes) == len(kinds)
    dtype_str = np.dtype(x.dtype).name
    for axis, kind in zip(axes, kinds):
        if kind == FFTW_R2HC:
            x = _r2hc_1d(x, axis)
        elif kind == FFTW_HC2R:
            x = _hc2r_1d(x, axis)
        elif _use_fft_r2r(x.shape[axis], kind):
            x = _FFT_R2R_FN[kind](x, axis)
        else:
            B = _r2r_basis(x.shape[axis], kind, dtype_str)
            x = _apply_basis(x, jnp.asarray(B), axis)
    return x
