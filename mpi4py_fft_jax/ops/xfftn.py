"""Planner functions for serial transforms (numpy-like API).

JAX re-implementation of the reference planner surface
(reference: mpi4py_fft/fftw/xfftn.py:38-837).  Each function returns a
planned :class:`.plan.FFT` object — it does not compute the transform.  The
kind/normalization conventions are FFTW's, verified against scipy in
tests/test_fftw.py.
"""
import numpy as np

from ..utils import aligned, aligned_like, get_alignment
from .plan import get_planned_FFT
from .kinds import (
    FFTW_FORWARD, FFTW_BACKWARD, R2C, C2R,
    FFTW_REDFT00, FFTW_REDFT01, FFTW_REDFT10, FFTW_REDFT11,
    FFTW_RODFT00, FFTW_RODFT01, FFTW_RODFT10, FFTW_RODFT11,
    FFTW_MEASURE, FFTW_PRESERVE_INPUT, flag_dict,
)

__all__ = ['fftn', 'ifftn', 'rfftn', 'irfftn', 'dctn', 'idctn',
           'dstn', 'idstn', 'hfftn', 'ihfftn', 'get_normalization',
           'inverse', 'dct_type', 'idct_type', 'dst_type', 'idst_type',
           'flag_dict']

# type -> FFTW kind maps (reference: fftw/xfftn.py:14-36)
dct_type = {1: FFTW_REDFT00, 2: FFTW_REDFT10, 3: FFTW_REDFT01, 4: FFTW_REDFT11}
idct_type = {1: FFTW_REDFT00, 2: FFTW_REDFT01, 3: FFTW_REDFT10, 4: FFTW_REDFT11}
dst_type = {1: FFTW_RODFT00, 2: FFTW_RODFT10, 3: FFTW_RODFT01, 4: FFTW_RODFT11}
idst_type = {1: FFTW_RODFT00, 2: FFTW_RODFT01, 3: FFTW_RODFT10, 4: FFTW_RODFT11}


def _norm_axes(axes, ndim):
    axes = (axes,) if isinstance(axes, (int, np.integer)) else tuple(axes)
    return tuple(a + ndim if a < 0 else a for a in axes)


def fftn(input_array, s=None, axes=(-1,), threads=1,
         flags=(FFTW_MEASURE,), output_array=None):
    """Plan a complex-to-complex forward transform
    (reference: fftw/xfftn.py:38-104)."""
    axes = _norm_axes(axes, input_array.ndim)
    assert input_array.dtype.char in 'FD'
    if output_array is None:
        n = get_alignment(input_array)
        output_array = aligned(input_array.shape, n, input_array.dtype.char.upper())
    else:
        assert input_array.shape == output_array.shape
        assert output_array.dtype.char == input_array.dtype.char.upper()
    M = np.prod(np.take(input_array.shape, axes))
    return get_planned_FFT(input_array, output_array, axes, FFTW_FORWARD,
                           threads, flags, 1.0 / M)


def ifftn(input_array, s=None, axes=(-1,), threads=1,
          flags=(FFTW_MEASURE,), output_array=None):
    """Plan a complex-to-complex inverse transform
    (reference: fftw/xfftn.py:106-171)."""
    axes = _norm_axes(axes, input_array.ndim)
    assert input_array.dtype.char in 'FD'
    if output_array is None:
        output_array = aligned_like(input_array)
    else:
        assert input_array.shape == output_array.shape
    M = np.prod(np.take(input_array.shape, axes))
    return get_planned_FFT(input_array, output_array, axes, FFTW_BACKWARD,
                           threads, flags, 1.0 / M)


def rfftn(input_array, s=None, axes=(-1,), threads=1,
          flags=(FFTW_MEASURE,), output_array=None):
    """Plan a real-to-complex transform; axes[-1] is halved to N//2+1
    (reference: fftw/xfftn.py:173-240)."""
    axes = _norm_axes(axes, input_array.ndim)
    assert input_array.dtype.char in 'fd'
    if output_array is None:
        sz = list(input_array.shape)
        sz[axes[-1]] = input_array.shape[axes[-1]] // 2 + 1
        n = get_alignment(input_array)
        output_array = aligned(sz, n=n,
                               dtype=np.dtype(input_array.dtype.char.upper()))
    else:
        assert input_array.shape[axes[-1]] // 2 + 1 == output_array.shape[axes[-1]]
    M = np.prod(np.take(input_array.shape, axes))
    return get_planned_FFT(input_array, output_array, axes, R2C,
                           threads, flags, 1.0 / M)


def irfftn(input_array, s=None, axes=(-1,), threads=1,
           flags=(FFTW_MEASURE,), output_array=None):
    """Plan an inverse complex-to-real transform.  ``s`` resolves the output
    length ambiguity along axes[-1]; default assumes even 2N-2
    (reference: fftw/xfftn.py:242-326)."""
    axes = _norm_axes(axes, input_array.ndim)
    assert input_array.dtype.char in 'FD'
    assert FFTW_PRESERVE_INPUT not in flags
    sz = list(input_array.shape)
    if s is not None:
        assert len(axes) == len(s)
        for q, axis in zip(s, axes):
            sz[axis] = q
    else:
        sz[axes[-1]] = 2 * sz[axes[-1]] - 2
    if output_array is None:
        n = get_alignment(input_array)
        output_array = aligned(sz, n=n,
                               dtype=np.dtype(input_array.dtype.char.lower()))
    else:
        assert list(output_array.shape) == sz
    assert sz[axes[-1]] // 2 + 1 == input_array.shape[axes[-1]]
    M = np.prod(np.take(output_array.shape, axes))
    return get_planned_FFT(input_array, output_array, axes, C2R,
                           threads, flags, 1.0 / M)


def _r2r_plan(input_array, axes, kind_map, type, threads, flags, output_array):
    axes = _norm_axes(axes, input_array.ndim)
    assert input_array.dtype.char in 'fd'
    if output_array is None:
        output_array = aligned_like(input_array)
    else:
        assert input_array.shape == output_array.shape
    kind = [kind_map[type]] * len(axes)
    M = get_normalization(kind, input_array.shape, axes)
    return get_planned_FFT(input_array, output_array, axes, kind,
                           threads, flags, M)


def dctn(input_array, s=None, axes=(-1,), type=2, threads=1,
         flags=(FFTW_MEASURE,), output_array=None):
    """Plan a discrete cosine transform of given type
    (reference: fftw/xfftn.py:328-398)."""
    return _r2r_plan(input_array, axes, dct_type, type, threads, flags,
                     output_array)


def idctn(input_array, s=None, axes=(-1,), type=2, threads=1,
          flags=(FFTW_MEASURE,), output_array=None):
    """Plan an inverse discrete cosine transform
    (reference: fftw/xfftn.py:400-470)."""
    return _r2r_plan(input_array, axes, idct_type, type, threads, flags,
                     output_array)


def dstn(input_array, s=None, axes=(-1,), type=2, threads=1,
         flags=(FFTW_MEASURE,), output_array=None):
    """Plan a discrete sine transform of given type
    (reference: fftw/xfftn.py:472-542)."""
    return _r2r_plan(input_array, axes, dst_type, type, threads, flags,
                     output_array)


def idstn(input_array, s=None, axes=(-1,), type=2, threads=1,
          flags=(FFTW_MEASURE,), output_array=None):
    """Plan an inverse discrete sine transform
    (reference: fftw/xfftn.py:544-614)."""
    return _r2r_plan(input_array, axes, idst_type, type, threads, flags,
                     output_array)


def ihfftn(input_array, s=None, axes=(-1,), threads=1,
           flags=(FFTW_MEASURE,), output_array=None):
    """Plan an inverse transform of an array with Hermitian symmetry:
    real input, halved complex output, normalization 1/N
    (reference: fftw/xfftn.py:616-682)."""
    axes = _norm_axes(axes, input_array.ndim)
    assert input_array.dtype.char in 'fd'
    if output_array is None:
        sz = list(input_array.shape)
        sz[axes[-1]] = input_array.shape[axes[-1]] // 2 + 1
        n = get_alignment(input_array)
        output_array = aligned(sz, n=n,
                               dtype=np.dtype(input_array.dtype.char.upper()))
    else:
        assert input_array.shape[axes[-1]] // 2 + 1 == output_array.shape[axes[-1]]
    M = get_normalization(R2C, input_array.shape, axes)
    return get_planned_FFT(input_array, output_array, axes, R2C,
                           threads, flags, M)


def hfftn(input_array, s=None, axes=(-1,), threads=1,
          flags=(FFTW_MEASURE,), output_array=None):
    """Plan a transform of an array with Hermitian symmetry: complex input,
    expanded real output (reference: fftw/xfftn.py:684-761)."""
    axes = _norm_axes(axes, input_array.ndim)
    assert input_array.dtype.char in 'FD'
    sz = list(input_array.shape)
    if s is not None:
        assert len(axes) == len(s)
        for q, axis in zip(s, axes):
            sz[axis] = q
    else:
        sz[axes[-1]] = 2 * sz[axes[-1]] - 2
    if output_array is None:
        n = get_alignment(input_array)
        output_array = aligned(sz, n=n,
                               dtype=np.dtype(input_array.dtype.char.lower()))
    else:
        assert list(output_array.shape) == sz
    assert sz[axes[-1]] // 2 + 1 == input_array.shape[axes[-1]]
    M = get_normalization(C2R, sz, axes)
    return get_planned_FFT(input_array, output_array, axes, C2R,
                           threads, flags, M)


def get_normalization(kind, shape, axes):
    """Inverse of the product of per-axis FFTW normalization factors
    (reference: fftw/xfftn.py:763-816):

        REDFT00 -> 2(N-1); RODFT00 -> 2(N+1); other r2r -> 2N; Fourier -> N.
    """
    kind = [kind] * len(axes) if isinstance(kind, (int, np.integer)) else kind
    assert len(kind) == len(axes)
    M = 1
    for knd, axis in zip(kind, axes):
        N = shape[axis]
        if knd == FFTW_RODFT00:
            M *= 2 * (N + 1)
        elif knd == FFTW_REDFT00:
            M *= 2 * (N - 1)
        elif knd in (FFTW_RODFT01, FFTW_RODFT10, FFTW_RODFT11,
                     FFTW_REDFT01, FFTW_REDFT10, FFTW_REDFT11):
            M *= 2 * N
        else:
            M *= N
    return 1. / M


#: forward <-> backward planner pairs (reference: fftw/xfftn.py:818-837)
inverse = {
    FFTW_RODFT11: FFTW_RODFT11,
    FFTW_REDFT11: FFTW_REDFT11,
    FFTW_RODFT01: FFTW_RODFT10,
    FFTW_RODFT10: FFTW_RODFT01,
    FFTW_REDFT01: FFTW_REDFT10,
    FFTW_REDFT10: FFTW_REDFT01,
    FFTW_RODFT00: FFTW_RODFT00,
    FFTW_REDFT00: FFTW_REDFT00,
}
inverse.update({
    rfftn: irfftn, irfftn: rfftn,
    fftn: ifftn, ifftn: fftn,
    dctn: idctn, idctn: dctn,
    dstn: idstn, idstn: dstn,
    hfftn: ihfftn, ihfftn: hfftn,
})
