"""Python surface of the native host-staging runtime.

Wraps the `_hoststage` C++ extension (native/hoststage.cpp): aligned host
buffers and the bit-exact block pack/unpack engine (the host-side
counterpart of the reference's MPI subarray datatypes,
reference: pencil.py:12-29).  Degrades gracefully to numpy when the
extension has not been built (`python setup.py build_ext --inplace`).
"""
import numpy as np

try:
    from mpi4py_fft_jax import _hoststage
    HAVE_NATIVE = True
except ImportError:
    _hoststage = None
    HAVE_NATIVE = False

__all__ = ['HAVE_NATIVE', 'aligned_native', 'pack_block', 'unpack_block']

_owners = {}


def aligned_native(shape, dtype=np.float64, alignment=128):
    """Aligned host ndarray backed by posix_memalign storage.

    Preferred over the numpy over-allocation trick
    (reference: fftw/utilities.pyx:54-84) when the extension is built:
    host->device DMA engines want page/lane-aligned sources.
    """
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    if not HAVE_NATIVE:
        from . import aligned
        return aligned(shape, n=min(alignment, 32), dtype=dtype)
    mv, owner = _hoststage.aligned_empty(nbytes, alignment)
    arr = np.frombuffer(mv, dtype=dtype).reshape(shape)
    _owners[id(arr)] = owner  # keep storage alive as long as arr may live
    return arr


def _check_bounds(shape, starts, subsizes):
    assert len(shape) == len(starts) == len(subsizes)
    for i, (n, s, c) in enumerate(zip(shape, starts, subsizes)):
        if s < 0 or c < 0 or s + c > n:
            raise ValueError(
                f"block [{s}:{s + c}] out of range for axis {i} (extent {n})")


def _writable_contig(a):
    """C-contiguous, writable view/copy (the extension's buffer parsing
    requires read-write byte buffers even for sources)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return a


def pack_block(full, starts, subsizes, out=None):
    """Pack the block ``full[starts:starts+subsizes]`` into a contiguous
    buffer, bit-exactly (pure memcpy of runs)."""
    full = _writable_contig(full)
    subsizes = tuple(int(s) for s in subsizes)
    starts = tuple(int(s) for s in starts)
    _check_bounds(full.shape, starts, subsizes)
    if out is None:
        out = np.empty(subsizes, dtype=full.dtype)
    if not HAVE_NATIVE:
        sl = tuple(slice(s, s + n) for s, n in zip(starts, subsizes))
        out[...] = full[sl]
        return out
    _hoststage.pack_blocks(
        full.view(np.uint8).reshape(-1), out.view(np.uint8).reshape(-1),
        full.itemsize, full.shape, full.strides, starts, subsizes)
    return out


def unpack_block(full, starts, subsizes, packed):
    """Inverse of :func:`pack_block`: scatter a contiguous block back."""
    assert full.flags['C_CONTIGUOUS']
    subsizes = tuple(int(s) for s in subsizes)
    starts = tuple(int(s) for s in starts)
    _check_bounds(full.shape, starts, subsizes)
    packed = _writable_contig(packed)
    if not HAVE_NATIVE:
        sl = tuple(slice(s, s + n) for s, n in zip(starts, subsizes))
        full[sl] = packed.reshape(subsizes)
        return full
    _hoststage.unpack_blocks(
        full.view(np.uint8).reshape(-1), packed.view(np.uint8).reshape(-1),
        full.itemsize, full.shape, full.strides, starts, subsizes)
    return full
