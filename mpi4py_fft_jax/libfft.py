"""Serial transform abstraction with pluggable backends and dealiasing.

JAX re-implementation of the reference serial-FFT layer
(reference: mpi4py_fft/libfft.py).  The default backend is ``'jax'`` — the
XLA compute path of this framework; ``'numpy'`` and ``'scipy'`` are
host reference backends kept for cross-validation exactly like the
reference keeps numpy/scipy next to FFTW (reference: libfft.py:81-144).
``'fftw'``, ``'pyfftw'`` and ``'mkl_fft'`` are accepted as aliases so code
written against the reference keeps running.

The FFT class exposes, besides the reference's buffer-style
``forward``/``backward`` callables, *pure jittable* ``forward_fn`` /
``backward_fn`` used by the parallel layer to fuse all serial stages and
transposes into one XLA program.
"""
import numpy as np
import jax.numpy as jnp

from . import ops as fftw

__all__ = ['FFT', 'FFTBase']


def _take_slice(ndim, axis, sl):
    s = [slice(None)] * ndim
    s[axis] = sl
    return tuple(s)


# ---------------------------------------------------------------------------
# 3/2-rule truncation / zero-padding as pure functions
# (port of the semantics of reference libfft.py:263-311)
# ---------------------------------------------------------------------------

def truncate_spectral(padded, trunc_shape, axis, real_transform, xp=jnp):
    """Spectral truncation along ``axis`` (forward direction of dealiasing).

    Reference semantics: libfft.py:263-284 (_truncation_forward).
    """
    N = trunc_shape[axis]
    ndim = len(trunc_shape)
    if real_transform:
        trunc = padded[_take_slice(ndim, axis, slice(0, N))]
        if N % 2 == 0:
            sl = _take_slice(ndim, axis, slice(N - 1, N))
            last = trunc[sl]
            if xp is jnp:
                trunc = trunc.at[sl].set(2.0 * last.real.astype(trunc.dtype))
            else:
                trunc = trunc.copy()
                trunc[sl] = 2.0 * last.real
        return trunc
    head = padded[_take_slice(ndim, axis, slice(0, N // 2 + 1))]
    tail = padded[_take_slice(ndim, axis, slice(padded.shape[axis] - N // 2,
                                                padded.shape[axis]))]
    trunc = xp.zeros(trunc_shape, dtype=padded.dtype)
    if xp is jnp:
        trunc = trunc.at[_take_slice(ndim, axis, slice(0, N // 2 + 1))].set(head)
        trunc = trunc.at[_take_slice(ndim, axis, slice(N - N // 2, N))].add(tail)
    else:
        trunc[_take_slice(ndim, axis, slice(0, N // 2 + 1))] = head
        trunc[_take_slice(ndim, axis, slice(N - N // 2, N))] += tail
    return trunc


def pad_spectral(trunc, padded_shape, axis, real_transform, xp=jnp):
    """Spectral zero-padding along ``axis`` (backward direction of
    dealiasing), with the symmetric Fourier interpolator for even N.

    Reference semantics: libfft.py:286-311 (_padding_backward).
    """
    N = trunc.shape[axis]
    Np = padded_shape[axis]
    ndim = len(padded_shape)
    padded = xp.zeros(padded_shape, dtype=trunc.dtype)
    if real_transform:
        sl = _take_slice(ndim, axis, slice(0, N))
        if xp is jnp:
            padded = padded.at[sl].set(trunc)
            if N % 2 == 0:
                se = _take_slice(ndim, axis, slice(N - 1, N))
                padded = padded.at[se].set(
                    (0.5 * padded[se].real).astype(padded.dtype))
        else:
            padded[sl] = trunc
            if N % 2 == 0:
                se = _take_slice(ndim, axis, slice(N - 1, N))
                padded[se] = 0.5 * padded[se].real
        return padded
    s_head = _take_slice(ndim, axis, slice(0, N // 2 + 1))
    s_tail_t = _take_slice(ndim, axis, slice(N - N // 2, N))
    s_tail_p = _take_slice(ndim, axis, slice(Np - N // 2, Np))
    if xp is jnp:
        padded = padded.at[s_head].set(trunc[s_head])
        padded = padded.at[s_tail_p].set(trunc[s_tail_t])
        if N % 2 == 0:
            sm = _take_slice(ndim, axis, slice(N // 2, N // 2 + 1))
            sp = _take_slice(ndim, axis, slice(Np - N // 2, Np - N // 2 + 1))
            padded = padded.at[sm].mul(0.5)
            padded = padded.at[sp].mul(0.5)
    else:
        padded[s_head] = trunc[s_head]
        padded[s_tail_p] = trunc[s_tail_t]
        if N % 2 == 0:
            padded[_take_slice(ndim, axis, slice(N // 2, N // 2 + 1))] *= 0.5
            padded[_take_slice(ndim, axis, slice(Np - N // 2, Np - N // 2 + 1))] *= 0.5
    return padded


# ---------------------------------------------------------------------------
# planar (pipeline-form) truncation / zero-padding — the same 3/2-rule
# semantics on planar (2,)+S real data, used by the planar pipeline
# (reference semantics: libfft.py:263-311)
# ---------------------------------------------------------------------------

def _axslice(p, ax, sl):
    s = [slice(None)] * p.ndim
    s[ax] = sl
    return tuple(s)


def truncate_planar(p, ax, Nt, hermitian):
    """Planar spectral truncation along planar-coords axis ``ax`` to length
    ``Nt`` (semantics of reference libfft.py:263-284 on planar data)."""
    if hermitian:
        t = p[_axslice(p, ax, slice(0, Nt))]
        if Nt % 2 == 0:
            re = _axslice(t, ax, slice(Nt - 1, Nt))[1:]  # index within part
            t = t.at[(0,) + re].multiply(2.0)
            t = t.at[(1,) + re].set(0.0)
        return t
    Np = p.shape[ax]
    head = p[_axslice(p, ax, slice(0, Nt // 2 + 1))]
    tail = p[_axslice(p, ax, slice(Np - Nt // 2, Np))]
    sh = list(p.shape)
    sh[ax] = Nt
    t = jnp.zeros(sh, dtype=p.dtype)
    t = t.at[_axslice(t, ax, slice(0, Nt // 2 + 1))].set(head)
    t = t.at[_axslice(t, ax, slice(Nt - Nt // 2, Nt))].add(tail)
    return t


def pad_planar(p, ax, Np, hermitian):
    """Planar spectral zero-padding along planar-coords axis ``ax`` to
    length ``Np`` with the symmetric Fourier interpolator for even N
    (semantics of reference libfft.py:286-311 on planar data)."""
    Nt = p.shape[ax]
    sh = list(p.shape)
    sh[ax] = Np
    out = jnp.zeros(sh, dtype=p.dtype)
    if hermitian:
        out = out.at[_axslice(out, ax, slice(0, Nt))].set(p)
        if Nt % 2 == 0:
            e = _axslice(out, ax, slice(Nt - 1, Nt))[1:]
            out = out.at[(0,) + e].multiply(0.5)
            out = out.at[(1,) + e].set(0.0)
        return out
    out = out.at[_axslice(out, ax, slice(0, Nt // 2 + 1))].set(
        p[_axslice(p, ax, slice(0, Nt // 2 + 1))])
    out = out.at[_axslice(out, ax, slice(Np - Nt // 2, Np))].set(
        p[_axslice(p, ax, slice(Nt - Nt // 2, Nt))])
    if Nt % 2 == 0:
        out = out.at[_axslice(out, ax, slice(Nt // 2, Nt // 2 + 1))].multiply(0.5)
        out = out.at[_axslice(out, ax,
                              slice(Np - Nt // 2, Np - Nt // 2 + 1))].multiply(0.5)
    return out


# ---------------------------------------------------------------------------
# backend planners
# ---------------------------------------------------------------------------

def _plan_jax(shape, axes, dtype, transforms, options):
    """Plan forward+backward pair on the JAX/XLA path
    (role of reference libfft.py:48-79 _Xfftn_plan_fftw)."""
    transforms = {} if transforms is None else transforms
    if tuple(axes) in transforms:
        plan_fwd, plan_bck = transforms[tuple(axes)]
    else:
        if np.issubdtype(dtype, np.floating):
            plan_fwd, plan_bck = fftw.rfftn, fftw.irfftn
        else:
            plan_fwd, plan_bck = fftw.fftn, fftw.ifftn
    s = tuple(np.take(shape, axes))
    # NOTE: buffers are np.empty-backed and stay untouched (virtual pages)
    # unless the buffer-style serial API is used; the fused parallel path
    # goes through forward_fn/backward_fn and never materializes them.
    U = fftw.aligned(shape, dtype=dtype)
    xfftn_fwd = plan_fwd(U, s=s, axes=axes)
    V = xfftn_fwd.output_array
    xfftn_bck = plan_bck(V, s=s, axes=axes, output_array=U)
    return (xfftn_fwd, xfftn_bck)


class _Yfftn_wrap(object):
    """Wrap numpy/scipy host transforms to the FFTW call style
    (reference: libfft.py:146-185)."""

    def __init__(self, xfftn_obj, input_array, output_array, M, opt):
        self.xfftn = xfftn_obj
        self.opt = opt
        self.M = M
        self.input_array = input_array
        self.output_array = output_array

    def __call__(self, *args, **kwargs):
        self.opt.update(kwargs)
        self.output_array[...] = self.xfftn(self.input_array, **self.opt)
        if abs(self.M - 1) > 1e-8:
            self.output_array *= self.M
        return self.output_array

    def fn(self, x, normalize=False):
        # host fallback of the pure path (not jittable; used by the eager
        # parallel executor when a host backend is selected)
        y = np.asarray(self.xfftn(np.asarray(x), **self.opt))
        y = y.astype(np.asarray(self.output_array).dtype)
        if abs(self.M - 1) > 1e-8:
            y = y * self.M
        if normalize:
            raise AssertionError("normalize handled by FFT layer")
        return y


def _plan_numpy(shape, axes, dtype, transforms, options):
    """Reference: libfft.py:81-102 (_Xfftn_plan_numpy)."""
    transforms = {} if transforms is None else transforms
    if tuple(axes) in transforms:
        plan_fwd, plan_bck = transforms[tuple(axes)]
    else:
        if np.issubdtype(dtype, np.floating):
            plan_fwd, plan_bck = np.fft.rfftn, np.fft.irfftn
        else:
            plan_fwd, plan_bck = np.fft.fftn, np.fft.ifftn
    s = tuple(np.take(shape, axes))
    U = fftw.aligned(shape, dtype=dtype)
    V = plan_fwd(U, s=s, axes=axes).astype(np.dtype(dtype).char.upper())
    V = fftw.aligned_like(V)
    M = np.prod(s)
    # numpy: forward unscaled, backward scaled by 1/N -> undo with M
    return (_Yfftn_wrap(plan_fwd, U, V, 1, {'s': s, 'axes': axes}),
            _Yfftn_wrap(plan_bck, V, U, M, {'s': s, 'axes': axes}))


def _plan_scipy(shape, axes, dtype, transforms, options):
    """Reference: libfft.py:128-144 (_Xfftn_plan_scipy) — complex-only."""
    transforms = {} if transforms is None else transforms
    if tuple(axes) in transforms:
        plan_fwd, plan_bck = transforms[tuple(axes)]
    else:
        from scipy.fftpack import fftn, ifftn
        plan_fwd, plan_bck = fftn, ifftn
    s = tuple(np.take(shape, axes))
    U = fftw.aligned(shape, dtype=dtype)
    V = plan_fwd(U, shape=s, axes=axes)
    V = fftw.aligned_like(np.ascontiguousarray(V))
    M = np.prod(s)
    return (_Yfftn_wrap(plan_fwd, U, V, 1, {'shape': s, 'axes': axes}),
            _Yfftn_wrap(plan_bck, V, U, M, {'shape': s, 'axes': axes}))


def _plan_torch(shape, axes, dtype, transforms, options):
    """torch.fft (CPU) planner — a genuinely independent FFT
    implementation (pocketfft-derived C++ path through ATen) for
    backend cross-validation, the role the reference's distinct
    pyfftw/mkl_fft planners play (reference: libfft.py:5-46,104-126).
    Custom ``transforms`` entries are numpy-convention callables, as in
    the numpy backend."""
    import torch
    transforms = {} if transforms is None else transforms
    s = tuple(np.take(shape, axes))
    if tuple(axes) in transforms:
        plan_fwd, plan_bck = transforms[tuple(axes)]
        U = fftw.aligned(shape, dtype=dtype)
        V = plan_fwd(U, s=s, axes=axes).astype(np.dtype(dtype).char.upper())
        V = fftw.aligned_like(V)
        M = np.prod(s)
        return (_Yfftn_wrap(plan_fwd, U, V, 1, {'s': s, 'axes': axes}),
                _Yfftn_wrap(plan_bck, V, U, M, {'s': s, 'axes': axes}))
    real = np.issubdtype(dtype, np.floating)

    def _np(fn, norm):
        def run(u, s=None, axes=None):
            out = fn(torch.from_numpy(np.ascontiguousarray(u)),
                     s=tuple(int(x) for x in s), dim=tuple(axes),
                     norm=norm)
            return out.numpy()
        return run
    if real:
        plan_fwd = _np(torch.fft.rfftn, 'backward')   # unscaled fwd
        plan_bck = _np(torch.fft.irfftn, 'forward')   # unscaled bwd
    else:
        plan_fwd = _np(torch.fft.fftn, 'backward')
        plan_bck = _np(torch.fft.ifftn, 'forward')
    U = fftw.aligned(shape, dtype=dtype)
    V = plan_fwd(U, s=s, axes=axes).astype(np.dtype(dtype).char.upper())
    V = fftw.aligned_like(V)
    return (_Yfftn_wrap(plan_fwd, U, V, 1, {'s': s, 'axes': axes}),
            _Yfftn_wrap(plan_bck, V, U, 1, {'s': s, 'axes': axes}))


class _Xfftn_wrap(object):
    """Common buffer-style interface for serial transforms
    (reference: libfft.py:187-219)."""

    def __init__(self, xfftn_obj, input_array, output_array):
        self.xfftn = xfftn_obj
        self.input_array = input_array
        self.output_array = output_array

    def __call__(self, input_array=None, output_array=None, **options):
        if input_array is not None:
            self.input_array[...] = input_array
        self.xfftn(**options)
        if output_array is not None:
            output_array[...] = self.output_array
            return output_array
        return self.output_array


class FFTBase(object):
    """Base class for serial transforms (reference: libfft.py:221-311)."""

    def __init__(self, shape, axes=None, dtype=float, padding=False):
        shape = list(shape) if np.ndim(shape) else [shape]
        assert len(shape) > 0
        assert min(shape) > 0
        if axes is not None:
            axes = list(axes) if np.ndim(axes) else [axes]
            for i, axis in enumerate(axes):
                if axis < 0:
                    axes[i] = axis + len(shape)
        else:
            axes = list(range(len(shape)))
        assert min(axes) >= 0
        assert max(axes) < len(shape)
        assert 0 < len(axes) <= len(shape)
        assert sorted(axes) == sorted(set(axes))
        dtype = np.dtype(dtype)
        assert dtype.char in 'fdFD', \
            f"dtype {dtype} not a supported precision (f32/f64)"
        self.shape = shape
        self.axes = axes
        self.dtype = dtype
        self.padding = padding
        self.real_transform = np.issubdtype(dtype, np.floating)
        self.padding_factor = 1


class FFT(FFTBase):
    """Serial transform over a set of axes with optional dealiasing padding
    (reference: libfft.py:314-434).

    forward is normalized by default, backward is not — matching the
    reference's convention (libfft.py:408-422).
    """

    def __init__(self, shape, axes=None, dtype=float, padding=False,
                 backend='jax', transforms=None, **kw):
        FFTBase.__init__(self, shape, axes, dtype, padding)
        backend_map = {
            'jax': _plan_jax,
            'fftw': _plan_jax,       # alias: the native path of this package
            'pyfftw': _plan_jax,     # alias
            'numpy': _plan_numpy,
            'mkl_fft': _plan_numpy,  # host alias
            'scipy': _plan_scipy,
            'torch': _plan_torch,
        }
        plan = backend_map[backend]
        self.backend = backend
        self._host_backend = plan in (_plan_numpy, _plan_scipy,
                                      _plan_torch)
        self.fwd, self.bck = plan(self.shape, self.axes, self.dtype,
                                  transforms, kw)
        U, V = self.fwd.input_array, self.fwd.output_array
        if not self._host_backend:
            self.M = self.fwd.get_normalization()
        else:
            self.M = 1. / np.prod(np.take(self.shape, self.axes))
        if backend == 'scipy':
            self.real_transform = False  # complex-only backend
        self.padding_factor = 1.0
        if padding is not False:
            self.padding_factor = padding[self.axes[-1]] \
                if np.ndim(padding) else padding
        if abs(self.padding_factor - 1.0) > 1e-8:
            assert len(self.axes) == 1, \
                "padding is only supported for single (non-collapsed) axes"
            trunc_array = self._get_truncarray(shape, V.dtype)
            self.forward = _Xfftn_wrap(self._forward, U, trunc_array)
            self.backward = _Xfftn_wrap(self._backward, trunc_array, U)
        else:
            self.forward = _Xfftn_wrap(self._forward, U, V)
            self.backward = _Xfftn_wrap(self._backward, V, U)

    # ------------------------------------------------------------------
    # pure functional path (fused into the parallel XLA program)
    # ------------------------------------------------------------------
    def _stage_shape(self, data_shape, planned_shape, axis):
        """Target shape for truncation/padding along ``axis``: the data's
        own shape with the planned extent substituted — the stage functions
        are shape-generic along non-transformed (batch) axes so they can
        run per-shard inside shard_map (where batch extents are local)."""
        sh = list(data_shape)
        sh[axis] = planned_shape[axis]
        return tuple(sh)

    def forward_fn(self, x, normalize=True):
        """Pure forward stage: core transform, truncation, normalization."""
        xp = np if self._host_backend else jnp
        if self._host_backend:
            y = self.fwd.fn(x)
        else:
            y = self.fwd.fn(x, normalize=False)
        if abs(self.padding_factor - 1.0) > 1e-8:
            axis = self.axes[-1]
            y = truncate_spectral(
                y, self._stage_shape(np.shape(y),
                                     self.forward.output_array.shape, axis),
                axis, self.real_transform, xp=xp)
        if normalize:
            y = y * xp.asarray(self.M, dtype=np.asarray(y).real.dtype
                               if xp is np else y.real.dtype)
        return y

    def backward_fn(self, x, normalize=False):
        """Pure backward stage: zero-padding, core transform."""
        xp = np if self._host_backend else jnp
        if abs(self.padding_factor - 1.0) > 1e-8:
            axis = self.axes[-1]
            x = pad_spectral(
                x, self._stage_shape(np.shape(x),
                                     self.bck.input_array.shape, axis),
                axis, self.real_transform, xp=xp)
        if self._host_backend:
            y = self.bck.fn(x)
        else:
            y = self.bck.fn(x, normalize=False)
        if normalize:
            y = y * xp.asarray(self.M, dtype=np.asarray(y).real.dtype
                               if xp is np else y.real.dtype)
        return y

    # ------------------------------------------------------------------
    # planar (pipeline-form) pure path: logically complex stage data
    # travels as planar real (2,)+shape; this is what PFFT(backend='jax')
    # fuses into its XLA program.
    # ------------------------------------------------------------------
    @property
    def input_planar(self):
        """True if this stage's pipeline-form input is planar."""
        return not self._host_backend and self.fwd.input_planar

    @property
    def output_planar(self):
        """True if this stage's pipeline-form output is planar."""
        return not self._host_backend and self.fwd.output_planar

    def forward_fn_p(self, p, normalize=True):
        """Pure planar forward stage: transform, truncation, normalization
        (pipeline form of :meth:`forward_fn`)."""
        assert not self._host_backend
        y = self.fwd.fn_p(p, normalize=False)
        if abs(self.padding_factor - 1.0) > 1e-8:
            axis = self.axes[-1]
            Nt = self.forward.output_array.shape[axis]
            if self.output_planar:
                y = truncate_planar(y, 1 + axis, Nt,
                                    hermitian=self.real_transform)
            else:
                y = truncate_spectral(
                    y, self._stage_shape(y.shape,
                                         self.forward.output_array.shape,
                                         axis),
                    axis, self.real_transform, xp=jnp)
        if normalize:
            y = y * jnp.asarray(self.M, dtype=y.dtype)
        return y

    def backward_fn_p(self, p, normalize=False):
        """Pure planar backward stage: zero-padding, transform
        (pipeline form of :meth:`backward_fn`)."""
        assert not self._host_backend
        if abs(self.padding_factor - 1.0) > 1e-8:
            axis = self.axes[-1]
            Np = self.bck.input_array.shape[axis]
            if self.bck.input_planar:
                p = pad_planar(p, 1 + axis, Np,
                               hermitian=self.real_transform)
            else:
                p = pad_spectral(
                    p, self._stage_shape(p.shape,
                                         self.bck.input_array.shape, axis),
                    axis, self.real_transform, xp=jnp)
        y = self.bck.fn_p(p, normalize=False)
        if normalize:
            y = y * jnp.asarray(self.M, dtype=y.dtype)
        return y

    # ------------------------------------------------------------------
    # buffer-style path (serial user API, reference: libfft.py:408-422)
    # ------------------------------------------------------------------
    def _forward(self, **kw):
        normalize = kw.pop('normalize', True)
        y = self.forward_fn(self.forward.input_array, normalize=normalize)
        self.forward.output_array[...] = np.asarray(
            y, dtype=self.forward.output_array.dtype)
        return self.forward.output_array

    def _backward(self, **kw):
        normalize = kw.pop('normalize', False)
        y = self.backward_fn(self.backward.input_array, normalize=normalize)
        self.backward.output_array[...] = np.asarray(
            y, dtype=self.backward.output_array.dtype)
        return self.backward.output_array

    def _get_truncarray(self, shape, dtype):
        """Shape of the truncated spectral array
        (reference: libfft.py:424-434)."""
        axis = self.axes[-1]
        shape = list(shape)
        shape[axis] = int(np.round(shape[axis] / self.padding_factor))
        if self.real_transform:
            shape[axis] = shape[axis] // 2 + 1
        return fftw.aligned(shape, dtype=dtype)
