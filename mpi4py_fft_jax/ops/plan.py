"""Planned-transform objects and the compilation-cache ("wisdom") surface.

JAX replacement for the reference's Cython plan/execute wrapper
(reference: mpi4py_fft/fftw/fftw_xfftn.pyx:109-296) and planner dispatch
(reference: mpi4py_fft/fftw/factory.py:52-107).

A *plan* here is a cached, jitted XLA executable keyed on
(shape, dtype, axes, kind).  Planning cost is XLA trace+compile; re-planning
the same spec is free (JAX jit cache), and plans persist across processes via
the XLA persistent compilation cache — the XLA equivalent of FFTW wisdom
(reference: fftw/factory.py:109-163).

Precision tiers: float32 ('F') and float64 ('D') are supported.  XLA has no
long-double; the reference's 'G' tier is intentionally absent, so
``fftlib`` has keys 'F' and 'D' only (reference: fftw/factory.py:44-48).
"""
import functools
import os
import warnings

import numpy as np
import jax

from . import core
from .kinds import C2C_FORWARD, C2C_BACKWARD, R2C, C2R, R2R_KINDS

__all__ = ['FFT', 'get_planned_FFT', 'fftlib',
           'export_wisdom', 'import_wisdom', 'forget_wisdom',
           'use_compile_cache',
           'set_timelimit', 'cleanup']


@functools.partial(jax.jit,
                   static_argnames=('axes', 'kind', 'last_size', 'normalize'))
def _execute(x, M, axes, kind, last_size, normalize):
    """Single fused XLA program for any planned transform.

    kind: int for c2c/r2c/c2r dispatch, or tuple of r2r kinds.  Dispatch
    mirrors the reference guru planner (fftw/fftw_planxfftn.c:49-76):
    kind[0] in {-1,1} -> c2c, -2 -> r2c, 2 -> c2r, otherwise r2r.
    """
    if isinstance(kind, tuple):
        y = core.r2r(x, axes, kind)
    elif kind in (C2C_FORWARD, C2C_BACKWARD):
        y = core.c2c(x, axes, forward=(kind == C2C_FORWARD))
    elif kind == R2C:
        y = core.r2c(x, axes)
    elif kind == C2R:
        y = core.c2r(x, axes, last_size)
    else:
        raise ValueError(f"unknown transform kind {kind}")
    if normalize:
        y = y * M
    return y


class FFT(object):
    """A planned transform bound to host input/output buffers.

    Mirrors the execute semantics of the reference native plan object
    (reference: fftw/fftw_xfftn.pyx:159-296): calling the object runs the
    planned transform from ``input_array`` into ``output_array``; an
    ``input_array`` argument is first copied into the planned buffer, the
    result is copied into ``output_array`` (and any user-provided output).
    ``normalize`` multiplies by the plan's normalization constant
    (default False, exactly like FFTW).

    The pure device-side computation is exposed as :meth:`fn` so the
    distributed layer can fuse stages into one XLA program instead of
    round-tripping through host buffers.
    """

    def __init__(self, input_array, output_array, axes=(-1,),
                 kind=C2C_FORWARD, threads=1, flags=(0,), normalization=1.0):
        ndim = input_array.ndim
        axes = tuple(a + ndim if a < 0 else a for a in
                     ((axes,) if isinstance(axes, (int, np.integer)) else tuple(axes)))
        if isinstance(kind, (list, tuple, np.ndarray)):
            kind = [int(k) for k in kind]
            if kind[0] in (C2C_FORWARD, C2C_BACKWARD, R2C, C2R) and len(set(kind)) == 1:
                kind = kind[0]
            else:
                assert all(k in R2R_KINDS for k in kind), kind
                kind = tuple(kind)
        else:
            kind = int(kind)
        self.axes = axes
        self.kind = kind
        self.threads = threads          # accepted for API parity; XLA decides
        self.flags = tuple(flags) if np.ndim(flags) else (int(flags),)
        self.input_array = input_array
        self.output_array = output_array
        self.M = float(normalization)
        self._last_size = int(output_array.shape[axes[-1]]) if kind == C2R else 0
        # eagerly trace+compile ("plan") for the bound shapes
        self._compiled = {}

    # -- pure functional surface ------------------------------------------
    def fn(self, x, normalize=False):
        """Pure jittable application of this plan to a device array."""
        return _execute(x, np.asarray(self.M, dtype=_real_dtype(x.dtype)),
                        self.axes, self.kind, self._last_size, bool(normalize))

    # planar ("pipeline-form") surface: logically complex arrays are real
    # (2,)+shape planar arrays; real arrays are themselves.  This is the
    # path every PFFT stage lowers to (see ops/matfft.py module docs).
    @property
    def input_planar(self):
        """True if the pipeline form of this plan's input is planar."""
        return np.dtype(self.input_array.dtype).kind == 'c'

    @property
    def output_planar(self):
        """True if the pipeline form of this plan's output is planar."""
        return np.dtype(self.output_array.dtype).kind == 'c'

    def fn_p(self, p, normalize=False):
        """Pure planar application of this plan.

        ``p`` is the pipeline form of ``input_array`` (planar real
        (2,)+shape when the logical input is complex); the return value is
        the pipeline form of ``output_array``.  Kind dispatch mirrors
        :func:`_execute` (reference: fftw/fftw_planxfftn.c:49-76)."""
        from . import matfft
        if isinstance(self.kind, tuple):
            y = core.r2r(p, self.axes, self.kind)
        elif self.kind in (C2C_FORWARD, C2C_BACKWARD):
            y = matfft.fftn_p(p, self.axes,
                              forward=(self.kind == C2C_FORWARD))
        elif self.kind == R2C:
            y = matfft.rfftn_p(p, self.axes)
        elif self.kind == C2R:
            y = matfft.irfftn_p(p, self.axes, self._last_size)
        else:
            raise ValueError(f"unknown transform kind {self.kind}")
        if normalize:
            y = y * np.asarray(self.M, dtype=p.dtype)
        return y

    # -- FFTW-style buffer execute ----------------------------------------
    def __call__(self, input_array=None, output_array=None, normalize=False,
                 implicit=True, **kw):
        if input_array is not None:
            self.input_array[...] = input_array
        y = np.asarray(self.fn(self.input_array, normalize=normalize),
                       dtype=self.output_array.dtype)
        self.output_array[...] = y
        if output_array is not None:
            output_array[...] = self.output_array
            return output_array
        return self.output_array

    def get_normalization(self):
        """Return the plan's normalization constant
        (reference: fftw/fftw_xfftn.pyx get_normalization)."""
        return self.M

    def print_plan(self):
        """Print a description of the compiled XLA plan
        (reference: fftw/fftw_xfftn.pyx:173-175 print_plan)."""
        lowered = jax.jit(lambda x: self.fn(x)).lower(
            jax.ShapeDtypeStruct(self.input_array.shape,
                                 self.input_array.dtype))
        print(lowered.as_text())


def _real_dtype(dtype):
    return np.zeros(0, dtype=dtype).real.dtype


class _FFTLib(dict):
    """Precision-tier registry (reference: fftw/factory.py:44-48).

    Keys 'F' (float32) and 'D' (float64).  'G' (long double) does not exist
    in XLA and is deliberately absent; callers probe membership the same way
    they do against the reference.
    """


fftlib = _FFTLib()
fftlib['F'] = FFT
fftlib['D'] = FFT


def get_fftw_lib(dtype):
    """Return the transform implementation for a precision, or None
    (reference: fftw/factory.py:7-42).  'G' (long double) has no tier."""
    char = np.dtype(dtype).char.upper() if not isinstance(dtype, str) \
        else dtype.upper()
    if char in ('G',):
        return None
    return fftlib.get(char[:1] if char not in 'FD' else char)


def get_planned_FFT(input_array, output_array, axes=(-1,), kind=C2C_FORWARD,
                    threads=1, flags=(0,), normalization=1.0):
    """Return a planned :class:`FFT` instance
    (reference: fftw/factory.py:52-107)."""
    dtype = np.dtype(input_array.dtype).char
    assert dtype.upper() in fftlib, \
        f"unsupported precision {dtype!r}; supported tiers are f32/f64"
    cls = fftlib[dtype.upper()]
    return cls(input_array, output_array, axes, kind, threads, flags,
               normalization)


# ---------------------------------------------------------------------------
# wisdom == XLA persistent compilation cache
# ---------------------------------------------------------------------------

def _outside_cache_dir(filename):
    """The compile cache directory set from outside the program
    (``JAX_COMPILATION_CACHE_DIR``), or None.  When it is set, the
    program keeps its cache there and sets no other directory."""
    outside = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if outside:
        warnings.warn(f"JAX_COMPILATION_CACHE_DIR is set: plans stay in "
                      f"{outside!r}, not in the wisdom of {filename!r}",
                      stacklevel=3)
    return outside or None


def use_compile_cache(default_dir):
    """Turn on the persistent compilation cache and return its directory:
    ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself),
    else ``default_dir``, a fixed path so that later runs find the
    entries again."""
    outside = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if outside:
        return outside
    os.makedirs(default_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", default_dir)
    return default_dir


def export_wisdom(filename):
    """Enable the persistent compilation cache rooted at ``filename``.

    FFTW wisdom is a file of serialized plans (reference:
    fftw/factory.py:109-134).  The XLA equivalent is the persistent
    compilation cache directory: every jitted transform compiled from now on
    is stored there and reloaded by :func:`import_wisdom` in later runs.
    """
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    if _outside_cache_dir(filename):
        return
    cache_dir = _wisdom_dir(filename)
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)


def import_wisdom(filename):
    """Reuse plans previously exported with :func:`export_wisdom`
    (reference: fftw/factory.py:136-163)."""
    if _outside_cache_dir(filename):
        return
    cache_dir = _wisdom_dir(filename)
    if not os.path.isdir(cache_dir):
        raise AssertionError(f"Not able to import wisdom {filename}")
    jax.config.update("jax_compilation_cache_dir", cache_dir)


def _wisdom_dir(filename):
    base = str(filename)
    if base.endswith('.wisdom'):
        base = base[:-len('.wisdom')]
    return base + ".xla_cache"


def forget_wisdom():
    """Drop in-memory plans (reference: fftw/factory.py:165-167)."""
    jax.clear_caches()


_timelimit = [None]


def set_timelimit(limit):
    """Accepted for API parity (reference: fftw/factory.py:169-178).

    XLA compilation has no user-facing time budget; the value is recorded and
    a sub-second limit disables the more expensive autotuning passes on
    supported backends.
    """
    _timelimit[0] = limit


def cleanup():
    """Release accumulated plans (reference: fftw/factory.py:180-182)."""
    jax.clear_caches()
