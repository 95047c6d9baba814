"""Buffer and layout utilities.

Counterpart of the reference's aligned-allocation helpers
(reference: mpi4py_fft/fftw/utilities.pyx:39-104).  The device-side layout
is chosen by XLA; host staging buffers are plain numpy arrays.  ``aligned`` keeps the reference's byte-alignment
semantics for the host side so code written against the reference API ports
over unchanged.
"""
import numpy as np

__all__ = ['aligned', 'aligned_like', 'get_alignment', 'compute_dims']


def get_alignment(array):
    """Return byte alignment of ``array`` (highest considered is 32).

    Reference: mpi4py_fft/fftw/utilities.pyx:39-52.
    """
    addr = array.__array_interface__['data'][0]
    for i in range(5, -1, -1):
        n = 1 << i
        if addr % n == 0:
            break
    return n


def aligned(shape, n=32, dtype=np.dtype('d'), fill=None):
    """Return a host array with ``n``-byte alignment.

    Reference: mpi4py_fft/fftw/utilities.pyx:54-84.  Alignment matters for the
    host staging path (DMA to device is fastest from aligned pages); device
    arrays are laid out by XLA.
    """
    dtype = np.dtype(dtype)
    from . import native
    if native.HAVE_NATIVE:
        # posix_memalign-backed storage (native/hoststage.cpp) — exact
        # alignment without the over-allocate-and-offset trick
        b = native.aligned_native(shape, dtype=dtype, alignment=max(n, 8))
    else:
        M = int(np.prod(shape)) * dtype.itemsize
        a = np.empty(M + n, dtype=np.uint8)
        offset = a.ctypes.data % n
        offset = 0 if offset == 0 else (n - offset)
        b = np.frombuffer(a[offset:(offset + M)].data,
                          dtype=dtype).reshape(shape)
    if fill is not None:
        assert isinstance(fill, int)
        b[...] = fill
    return b


def aligned_like(z, fill=None):
    """Return aligned host array with shape/dtype of ``z``.

    Reference: mpi4py_fft/fftw/utilities.pyx:86-104.
    """
    n = get_alignment(z) if isinstance(z, np.ndarray) else 32
    return aligned(z.shape, n=n, dtype=z.dtype, fill=fill)


def compute_dims(nnodes, dims):
    """Balanced factorization of ``nnodes`` over the wildcard entries of dims.

    Equivalent of ``MPI.Compute_dims`` as used by the reference Subcomm
    (reference: mpi4py_fft/pencil.py:79).  Entries > 0 are fixed; entries <= 0
    are wildcards filled with a balanced factorization, larger factors first.
    """
    dims = list(dims)
    fixed = 1
    free = []
    for i, d in enumerate(dims):
        if d > 0:
            fixed *= d
        else:
            free.append(i)
    if not free:
        # Fully specified grid: allow using a *subset* of the devices (a JAX
        # mesh need not span every device, unlike an MPI communicator).
        if fixed > nnodes:
            raise ValueError(
                f"grid {dims} needs {fixed} devices, only {nnodes} available")
        return dims
    if fixed <= 0 or nnodes % fixed != 0:
        raise ValueError(
            f"cannot factor {nnodes} devices over fixed dims {dims}")
    rem = nnodes // fixed
    # balanced factorization of rem into len(free) factors, decreasing
    nfree = len(free)
    factors = [1] * nfree
    # greedy: repeatedly strip the largest prime factor onto the smallest bin
    primes = []
    m = rem
    p = 2
    while p * p <= m:
        while m % p == 0:
            primes.append(p)
            m //= p
        p += 1
    if m > 1:
        primes.append(m)
    for p in sorted(primes, reverse=True):
        j = int(np.argmin(factors))
        factors[j] *= p
    factors.sort(reverse=True)
    for i, f in zip(free, factors):
        dims[i] = f
    return dims
