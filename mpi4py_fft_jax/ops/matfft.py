"""Local 1-D transforms on planar-complex data: the stage engine of the
parallel pipelines.

Representation — planar complex: a complex array of shape S travels as a
real array of shape (2,) + S (index 0 = real, 1 = imaginary part).  The
parallel executors (parallel/planar.py, parallel/mpifft.py) carry every
logically complex stage in this form; the functions here transform one
or more axes of it.

Two engines compute the transform, selected by ``core.get_fft_impl()``
(environment variable ``MPI4PY_FFT_JAX_FFT_IMPL``):

* ``'xla'`` (default): ``jnp.fft`` on ``lax.complex(p[0], p[1])``, split
  back with ``.real`` / ``.imag``; r2c and c2r call ``jnp.fft.rfft`` /
  ``irfft`` directly on the real axis.  XLA lowers these to the
  platform's FFT library (cuFFT on an NVIDIA GPU, ducc on the CPU).
* ``'matmul'``: a mixed-radix Cooley-Tukey decomposition whose radix
  stages are batched dense DFT-matrix contractions (radix <= 32) with
  the twiddles applied elementwise, in explicit real arithmetic:
      (xr + i xi)(Wr + i Wi) -> (xr Wr - xi Wi) + i (xr Wi + xi Wr)
  Prime factors > 32 use Bluestein's chirp-z algorithm (two power-of-two
  transforms of length >= 2N-1).  All constants are built in float64
  numpy (cached) and embedded as XLA constants.

Everything is pure and jittable with static shapes.
"""
import functools

import numpy as np
import jax.numpy as jnp
from jax import lax

_BASE_RADIX = 32

# Matmul precision of the 'matmul' engine's f32 radix stages: 'highest'
# is true f32 arithmetic, 'high' and 'default' let the GPU use reduced-
# precision tensor-core passes (TF32 for 'default', which keeps about
# three decimal digits and is too lossy for spectral work).  f64 always
# uses HIGHEST (true f64).
import os as _os
from jax import lax as _lax

from . import core as _core

_PRECISIONS = {
    'highest': _lax.Precision.HIGHEST,
    'high': _lax.Precision.HIGH,
    'default': _lax.Precision.DEFAULT,
}
_PRECISION = _PRECISIONS[_os.environ.get('MPI4PY_FFT_JAX_PRECISION',
                                         'highest')]


def set_precision(name):
    """Select f32 matmul precision: 'highest' | 'high' | 'default'."""
    global _PRECISION
    _PRECISION = _PRECISIONS[name]


def _prec(dtype):
    if np.dtype(dtype).itemsize == 8:
        return _lax.Precision.HIGHEST
    return _PRECISION


def _use_xla():
    return _core.get_fft_impl() == 'xla'


# ---------------------------------------------------------------------------
# constants (numpy, cached, f64-built)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _factorize(N):
    """Factor N into radices <= _BASE_RADIX (largest first); a leftover
    prime > _BASE_RADIX is returned as a single (Bluestein) factor.
    Radices are balanced (e.g. 1024 -> 32*32) so no stage degenerates
    into a small-K contraction.
    """
    factors = []
    m = N
    for p in range(2, _BASE_RADIX + 1):
        while m % p == 0 and m > _BASE_RADIX:
            factors.append(p)
            m //= p
        if m <= _BASE_RADIX:
            break
    if m > 1:
        factors.append(m)
    factors.sort()
    merged = []
    while factors:
        f = factors.pop()
        while factors and f * factors[0] <= _BASE_RADIX:
            f *= factors.pop(0)
        merged.append(f)
    return tuple(sorted(merged, reverse=True))


@functools.lru_cache(maxsize=None)
def _dft_matrix(N, sign, dtype_str):
    """(2, N, N) planar DFT matrix exp(sign*2j*pi*n*k/N): [0]=cos, [1]=sin."""
    n = np.arange(N)
    ang = sign * 2 * np.pi * np.outer(n, n) / N
    W = np.stack([np.cos(ang), np.sin(ang)])
    return W.astype(np.dtype(dtype_str))


@functools.lru_cache(maxsize=None)
def _twiddle(N1, N2, sign, dtype_str):
    """(2, N1, N2) planar twiddle exp(sign*2j*pi*k1*n2/(N1*N2))."""
    k1 = np.arange(N1)[:, None]
    n2 = np.arange(N2)[None, :]
    ang = sign * 2 * np.pi * k1 * n2 / (N1 * N2)
    W = np.stack([np.cos(ang), np.sin(ang)])
    return W.astype(np.dtype(dtype_str))


@functools.lru_cache(maxsize=None)
def _bluestein_consts(N, sign, dtype_str):
    """Planar chirp arrays for Bluestein: (w[2,N], fft(b)[2,M], M)."""
    M = 1
    while M < 2 * N - 1:
        M *= 2
    n = np.arange(N)
    ang = sign * np.pi * n * n / N
    w = np.stack([np.cos(ang), np.sin(ang)])
    b = np.zeros(M, dtype=np.complex128)
    wc = np.exp(-1j * ang)
    b[:N] = wc
    b[M - N + 1:] = wc[1:][::-1]
    fb = np.fft.fft(b)
    fbp = np.stack([fb.real, fb.imag])
    return (w.astype(np.dtype(dtype_str)), fbp.astype(np.dtype(dtype_str)), M)


# ---------------------------------------------------------------------------
# planar helpers
# ---------------------------------------------------------------------------

def planar(z):
    """Complex array -> planar real array (2,) + z.shape."""
    return jnp.stack([jnp.real(z), jnp.imag(z)])


def unplanar(p, dtype=None):
    """Planar real array -> complex array (drops the leading axis)."""
    z = lax.complex(p[0], p[1])
    return z.astype(dtype) if dtype is not None else z


def _pmul(a, b):
    """Planar elementwise complex multiply; a,b: (2, ...) broadcastable."""
    re = a[0] * b[0] - a[1] * b[1]
    im = a[0] * b[1] + a[1] * b[0]
    return jnp.stack([re, im])


def _wblock(W):
    """Planar W (2, n, k) -> batched block form (2, n, 2k):
    [0] = [Wr | Wi], [1] = [Wi | Wr].

    One planar-batched dot against this computes all four real products of
    a complex contraction while reading each input part exactly once:
        out[0] = [xr Wr | xr Wi],  out[1] = [xi Wi | xi Wr]
        y_re = out[0,:k] - out[1,:k];  y_im = out[0,k:] + out[1,k:]
    (vs. four separate dots that each re-read x from device memory).
    """
    Wr, Wi = W[0], W[1]
    return jnp.stack([jnp.concatenate([Wr, Wi], axis=1),
                      jnp.concatenate([Wi, Wr], axis=1)])


def _pmatstage(p, W):
    """Planar radix stage: p (2, ..., n, t) contracted with planar W
    (2, n, k) over n -> (2, ..., k, t).  One batched einsum."""
    prec = _prec(p.dtype)
    k = W.shape[-1]
    Wb = _wblock(W)                       # (2, n, 2k)
    out = jnp.einsum('p...nt,pnk->p...kt', p, Wb, precision=prec)
    return jnp.stack([out[0, ..., :k, :] - out[1, ..., :k, :],
                      out[0, ..., k:, :] + out[1, ..., k:, :]])


def _pmatmul_last(p, W):
    """Planar contraction of the last axis with planar W (2, N, K).
    One batched dot (see _wblock)."""
    prec = _prec(p.dtype)
    k = W.shape[-1]
    Wb = _wblock(W)                       # (2, N, 2k)
    out = jnp.einsum('p...n,pnk->p...k', p, Wb, precision=prec)
    return jnp.stack([out[0, ..., :k] - out[1, ..., :k],
                      out[0, ..., k:] + out[1, ..., k:]])


# ---------------------------------------------------------------------------
# planar core transform (last axis)
# ---------------------------------------------------------------------------

def _fft_last_p(p, sign):
    """Unnormalized planar DFT along the last axis.

    p: (2, ..., N) real.  sign=-1 forward, +1 inverse (unscaled).
    """
    N = p.shape[-1]
    if N == 1:
        return p
    dtype_str = np.dtype(p.dtype).name
    factors = _factorize(N)
    if len(factors) == 1:
        f = factors[0]
        if f <= _BASE_RADIX:
            return _pmatmul_last(p, jnp.asarray(_dft_matrix(N, sign, dtype_str)))
        return _bluestein_p(p, sign)
    N1 = factors[0]
    N2 = N // N1
    batch = p.shape[1:-1]
    x = p.reshape((2,) + batch + (N1, N2))      # x[n1, n2], n = n1*N2 + n2
    a = _pmatstage(x, jnp.asarray(_dft_matrix(N1, sign, dtype_str)))
    a = _pmul(a, jnp.asarray(_twiddle(N1, N2, sign, dtype_str)).reshape(
        (2,) + (1,) * len(batch) + (N1, N2)))
    c = _fft_last_p(a, sign)                    # c[k1, k2]
    c = jnp.swapaxes(c, -1, -2)                 # X[k2*N1 + k1]
    return c.reshape((2,) + batch + (N,))


def _bluestein_p(p, sign):
    """Planar chirp-z transform for prime lengths > _BASE_RADIX."""
    N = p.shape[-1]
    dtype_str = np.dtype(p.dtype).name
    w, fb, M = _bluestein_consts(N, sign, dtype_str)
    w = jnp.asarray(w).reshape((2,) + (1,) * (p.ndim - 2) + (N,))
    fb = jnp.asarray(fb).reshape((2,) + (1,) * (p.ndim - 2) + (M,))
    a = jnp.zeros(p.shape[:-1] + (M,), dtype=p.dtype)
    a = a.at[..., :N].set(_pmul(p, w))
    fa = _fft_last_p(a, -1)
    conv = _fft_last_p(_pmul(fa, fb), +1) / M
    return _pmul(conv[..., :N], w)


# Mid-axis strategy: 'moveaxis' transposes the transform axis to the end
# (two full HBM transposes per non-final axis); 'einsum' contracts the
# axis in place — the (N1, N2) split of a middle axis is metadata-only,
# and only the final k1<->k2 swap moves data.
_MID_AXIS = _os.environ.get('MPI4PY_FFT_JAX_MID_AXIS', 'einsum')


def set_mid_axis_strategy(mode):
    global _MID_AXIS
    assert mode in ('moveaxis', 'einsum')
    _MID_AXIS = mode


def _pmatstage_mid(p, W, axis):
    """Planar contraction of p's ``axis`` (in planar coords) with planar
    W (2, n, k), output k at the same position.  One batched einsum
    (see _wblock)."""
    prec = _prec(p.dtype)
    nd = p.ndim
    k = W.shape[-1]
    sub = 'abcdefgh'[:nd - 1]
    lhs = 'p' + sub[:axis - 1] + 'n' + sub[axis - 1:nd - 2]
    out = 'p' + sub[:axis - 1] + 'k' + sub[axis - 1:nd - 2]
    expr = f'{lhs},pnk->{out}'
    Wb = _wblock(W)
    o = jnp.einsum(expr, p, Wb, precision=prec)
    ksl_lo = [slice(None)] * nd
    ksl_hi = [slice(None)] * nd
    ksl_lo[axis] = slice(0, k)
    ksl_hi[axis] = slice(k, 2 * k)
    lo = o[tuple(ksl_lo)]
    hi = o[tuple(ksl_hi)]
    return jnp.stack([lo[0] - lo[1], hi[0] + hi[1]])


def _fft_axis_einsum(p, axis, sign):
    """In-place-axis planar DFT: no moveaxis; recursion splits the axis
    with metadata-only reshapes."""
    nd = p.ndim
    ax = 1 + axis                  # planar coords
    N = p.shape[ax]
    if N == 1:
        return p
    dtype_str = np.dtype(p.dtype).name
    factors = _factorize(N)
    if len(factors) == 1 and factors[0] <= _BASE_RADIX:
        return _pmatstage_mid(p, jnp.asarray(_dft_matrix(N, sign, dtype_str)),
                              ax)
    if len(factors) == 1:
        # Bluestein needs the axis last; fall back to moveaxis
        p2 = jnp.moveaxis(p, ax, -1)
        y = _bluestein_p(p2, sign)
        return jnp.moveaxis(y, -1, ax)
    N1 = factors[0]
    N2 = N // N1
    shape = p.shape
    x = p.reshape(shape[:ax] + (N1, N2) + shape[ax + 1:])   # metadata only
    a = _pmatstage_mid(x, jnp.asarray(_dft_matrix(N1, sign, dtype_str)), ax)
    tw = jnp.asarray(_twiddle(N1, N2, sign, dtype_str))
    tw = tw.reshape((2,) + (1,) * (ax - 1) + (N1, N2)
                    + (1,) * (len(shape) - ax - 1))
    a = _pmul(a, tw)
    # recurse on the N2 sub-axis (complex coordinate axis+1 of ``a``)
    c = _fft_axis_einsum(a, axis + 1, sign)
    # X[k2*N1 + k1]: swap the two split axes, then flatten
    c = jnp.swapaxes(c, ax, ax + 1)
    return c.reshape(shape[:ax] + (N,) + shape[ax + 1:])


def _scaled(y, scale, dtype):
    return y if scale is None else y * np.asarray(scale, dtype=dtype)


def _axslice(ndim, ax, sl):
    s = [slice(None)] * ndim
    s[ax] = sl
    return tuple(s)


def fft1d_p(p, axis, forward=True, scale=None):
    """Planar c2c transform along ``axis`` of the complex array (axis
    counted WITHOUT the leading planar dim).  Unnormalized unless
    ``scale`` is given (fused by XLA into the output pass)."""
    nd = p.ndim - 1                 # complex rank
    axis = axis % nd
    if _use_xla():
        z = lax.complex(p[0], p[1])
        z = jnp.fft.fft(z, axis=axis) if forward else \
            jnp.fft.ifft(z, axis=axis, norm='forward')
        return _scaled(planar(z), scale, p.dtype)
    sign = -1 if forward else +1
    if axis == nd - 1:
        y = _fft_last_p(p, sign)
    elif _MID_AXIS == 'einsum':
        y = _fft_axis_einsum(p, axis, sign)
    else:
        p = jnp.moveaxis(p, 1 + axis, -1)
        y = jnp.moveaxis(_fft_last_p(p, sign), -1, 1 + axis)
    return _scaled(y, scale, p.dtype)


def fftn_p(p, axes, forward=True):
    if _use_xla():
        z = lax.complex(p[0], p[1])
        axes = tuple(a % z.ndim for a in axes)
        z = jnp.fft.fftn(z, axes=axes) if forward else \
            jnp.fft.ifftn(z, axes=axes, norm='forward')
        return planar(z)
    for a in axes:
        p = fft1d_p(p, a, forward)
    return p


def rfftn_p(x, axes, hext=None):
    """Real input -> planar half spectrum; axes[-1] halved to N//2+1
    (or zero-padded rows up to ``hext`` when given)."""
    a_last = axes[-1] % x.ndim
    N = x.shape[a_last]
    if _use_xla():
        z = jnp.fft.rfft(x, axis=a_last)
        rest = tuple(a % x.ndim for a in axes[:-1])
        if rest:
            z = jnp.fft.fftn(z, axes=rest)
        y = planar(z)
    else:
        p = jnp.stack([x, jnp.zeros_like(x)])
        y = fft1d_p(p, a_last, forward=True)
        y = y[_axslice(y.ndim, 1 + a_last, slice(0, N // 2 + 1))]
        for a in axes[:-1]:
            y = fft1d_p(y, a, forward=True)
    if hext is not None and hext > N // 2 + 1:
        pad = [(0, 0)] * y.ndim
        pad[1 + a_last] = (0, hext - (N // 2 + 1))
        y = jnp.pad(y, pad)
    return y


def irfftn_p(p, axes, last_size, scale=None):
    """Planar half spectrum -> real output of length ``last_size``.
    Input rows beyond N//2+1 along axes[-1] (shardable-extent padding)
    are ignored; ``scale`` is fused into the output."""
    nd = p.ndim - 1
    a_last = axes[-1] % nd
    N = int(last_size)
    p = p[_axslice(p.ndim, 1 + a_last, slice(0, N // 2 + 1))]
    if _use_xla():
        z = lax.complex(p[0], p[1])
        rest = tuple(a % nd for a in axes[:-1])
        if rest:
            z = jnp.fft.ifftn(z, axes=rest, norm='forward')
        y = jnp.fft.irfft(z, n=N, axis=a_last, norm='forward')
        return _scaled(y, scale, y.dtype)
    for a in axes[:-1]:
        p = fft1d_p(p, a, forward=False)
    H = jnp.moveaxis(p, 1 + a_last, -1)
    # Hermitian extension: X[N-k] = conj(X[k]), k = 1..ceil(N/2)-1
    tail_r = H[0][..., 1:(N + 1) // 2][..., ::-1]
    tail_i = -H[1][..., 1:(N + 1) // 2][..., ::-1]
    full = jnp.stack([jnp.concatenate([H[0], tail_r], axis=-1),
                      jnp.concatenate([H[1], tail_i], axis=-1)])
    y = _fft_last_p(full, +1)[0]    # real part of the inverse
    return jnp.moveaxis(_scaled(y, scale, y.dtype), -1, a_last)

# ---------------------------------------------------------------------------
# complex-dtype wrappers (boundary conversion; for complex-capable backends)
# ---------------------------------------------------------------------------

def _real_of(dtype):
    d = np.dtype(dtype)
    return np.dtype('float32') if d.itemsize == 8 or d == np.float32 \
        else np.dtype('float64')


def fft1d(x, axis, forward=True):
    """Unnormalized c2c transform along one axis (complex in/out)."""
    x = jnp.asarray(x)
    if x.dtype.kind != 'c':
        x = x.astype(np.dtype('complex64') if x.dtype.itemsize == 4
                     else np.dtype('complex128'))
    return unplanar(fft1d_p(planar(x), axis, forward), x.dtype)


def fftn(x, axes, forward=True):
    x = jnp.asarray(x)
    if x.dtype.kind != 'c':
        x = x.astype(np.dtype('complex64') if x.dtype.itemsize == 4
                     else np.dtype('complex128'))
    return unplanar(fftn_p(planar(x), axes, forward), x.dtype)


def rfftn(x, axes):
    cdtype = (np.dtype('complex64') if np.dtype(x.dtype).itemsize == 4
              else np.dtype('complex128'))
    return unplanar(rfftn_p(jnp.asarray(x), axes), cdtype)


def irfftn(x, axes, last_size):
    return irfftn_p(planar(jnp.asarray(x)), axes, last_size)
