"""Pencil decomposition over a named device mesh.

JAX re-design of the reference's process-grid / pencil / transfer
machinery (reference: mpi4py_fft/pencil.py):

* ``Subcomm``      — tuple of per-axis device groups, realized as a single
                     ``jax.sharding.Mesh`` with one named mesh axis per
                     distributed array axis (reference: pencil.py:32-98).
* ``Pencil``       — assignment of array axes to mesh axes with one
                     *aligned* (undistributed) axis; yields a
                     ``NamedSharding`` (reference: pencil.py:212-354).
* ``Transfer``     — global redistribution between two pencils.  Where the
                     reference commits MPI subarray datatypes and calls
                     ``Alltoallw`` (pencil.py:12-29, 101-209), we reshard the
                     global array: eagerly with ``jax.device_put``, or inside
                     a jitted program with ``lax.with_sharding_constraint`` —
                     GSPMD lowers either into an XLA all-to-all.

Block distribution: shards follow XLA GSPMD's ceil-division rule
(shard i owns [i*ceil(N/p), min((i+1)*ceil(N/p), N))), which differs from the
reference's balanced ``_blockdist`` (pencil.py:5-9) when p does not divide N;
the difference is metadata-only and is what the hardware actually does, so
``local_slice`` reports it truthfully.
"""
import math

import numpy as np
import jax
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from ..utils import compute_dims
from .comm import DeviceComm, COMM_WORLD

__all__ = ['Subcomm', 'Pencil', 'Transfer', 'blockdist']


def blockdist(N, size, rank):
    """(count, start) of the block owned by ``rank`` under GSPMD ceil-div
    sharding (role of reference pencil.py:5-9)."""
    q = -(-N // size)  # ceil
    s = min(rank * q, N)
    n = min(q, N - s)
    return (max(n, 0), s)


class AxisComm(object):
    """One axis of a Subcomm: a named group of devices of given size.

    Size-1 axes play the role of MPI ``COMM_SELF`` entries
    (reference: pencil.py:288-289).
    """

    __slots__ = ('name', 'size')

    def __init__(self, name, size):
        self.name = name      # mesh axis name, or None when size == 1
        self.size = size

    def Get_size(self):
        return self.size

    def __eq__(self, other):
        return (isinstance(other, AxisComm) and other.name == self.name
                and other.size == self.size)

    def __hash__(self):
        return hash((self.name, self.size))

    def __repr__(self):
        return f"AxisComm({self.name!r}, {self.size})"


COMM_SELF = AxisComm(None, 1)


class Subcomm(tuple):
    """Tuple of per-axis device groups backed by one named mesh.

    Parameters mirror the reference (pencil.py:32-98): ``dims`` entries > 0
    are fixed sizes, entries <= 0 are wildcards balanced over the remaining
    device count (larger factors first, like ``MPI.Compute_dims``).

    The realized ``jax.sharding.Mesh`` has one axis per entry; axis ``i`` is
    named ``'p{i}'``.  Size-1 axes are kept in the mesh so that swapping two
    axes' groups (``Pencil.pencil``) never changes the mesh, only the
    PartitionSpec — exactly as the reference swaps subcommunicators without
    re-creating them (pencil.py:309-323).
    """

    def __new__(cls, comm=None, dims=None, reorder=True):
        if isinstance(comm, Subcomm):
            assert dims is None
            return comm
        if comm is None:
            comm = COMM_WORLD
        if isinstance(comm, (list, tuple)) and not isinstance(comm, Subcomm):
            comm = DeviceComm(comm)
        assert isinstance(comm, DeviceComm)
        nnodes = comm.Get_size()
        if dims is None:
            dims = [0]
        elif np.ndim(dims) > 0:
            assert len(dims) > 0
            dims = [max(0, int(d)) for d in dims]
        else:
            assert dims > 0
            dims = [0] * int(dims)
        sizes = compute_dims(nnodes, dims)
        axes = [AxisComm(f"p{i}" if s > 1 else None, s)
                for i, s in enumerate(sizes)]
        obj = super(Subcomm, cls).__new__(cls, axes)
        names = tuple(a.name if a.name is not None else f"_u{i}"
                      for i, a in enumerate(axes))
        nuse = int(np.prod(sizes))
        devs = np.asarray(comm.devices[:nuse], dtype=object).reshape(sizes)
        obj.mesh = Mesh(devs, names)
        obj.comm = comm
        return obj

    def destroy(self):
        """No device resources to free (mesh is metadata); parity no-op
        (reference: pencil.py:95-98)."""


def _pad_subcomm(subcomm, shape, axis):
    """Pad a short subcomm with size-1 axes and insert the aligned axis,
    mirroring reference pencil.py:285-289."""
    subcomm = list(subcomm)
    while len(subcomm) < len(shape) - 1:
        subcomm.append(COMM_SELF)
    subcomm.insert(axis, COMM_SELF)
    return subcomm


class Pencil(object):
    """Distribution descriptor: which mesh axis shards each array axis.

    Reference semantics: pencil.py:212-354.  ``axis`` is the aligned
    (complete, undistributed) axis; every distributed axis i is sharded over
    ``subcomm[i]``.
    """

    def __init__(self, subcomm, shape, axis=-1):
        assert len(shape) >= 2
        assert min(shape) >= 1
        assert -len(shape) <= axis < len(shape)
        assert 1 <= len(subcomm) <= len(shape)
        if axis < 0:
            axis += len(shape)
        self.mesh = getattr(subcomm, 'mesh', None) or getattr(
            subcomm[0], 'mesh', None)
        if isinstance(subcomm, Subcomm):
            self.mesh = subcomm.mesh
        if len(subcomm) < len(shape):
            subcomm = _pad_subcomm(subcomm, shape, axis)
        assert len(subcomm) == len(shape)
        assert subcomm[axis].Get_size() == 1
        for i, c in enumerate(subcomm):
            assert shape[i] >= c.Get_size(), \
                f"axis {i}: extent {shape[i]} < devices {c.Get_size()}"

        self.shape = tuple(shape)
        self.axis = axis
        self.subcomm = tuple(subcomm)

    # -- sharding ----------------------------------------------------------
    @property
    def spec(self):
        """PartitionSpec over the mesh (None entries = replicated/complete)."""
        return PartitionSpec(*[c.name for c in self.subcomm])

    def sharding(self, rank=0):
        """NamedSharding; ``rank`` leading tensor-component axes are
        replicated (reference keeps tensor indices undistributed,
        distarray.py:40-56).

        This is the *true* pencil layout — legal inside jitted programs via
        ``with_sharding_constraint`` for any extents (GSPMD pads internally).
        For materialized arrays (device_put / jit boundaries) use
        :meth:`boundary_sharding`, which JAX requires to divide evenly.
        """
        assert self.mesh is not None, "Pencil has no mesh (pass a Subcomm)"
        spec = PartitionSpec(*([None] * rank), *[c.name for c in self.subcomm])
        return NamedSharding(self.mesh, spec)

    def constrain(self, x, rank=0):
        """Constrain ``x`` to this pencil's layout.

        Inside a jitted trace the *true* sharding is applied (GSPMD pads
        uneven extents internally); eagerly, materialized arrays must divide
        evenly, so the divisibility-safe boundary sharding is used.
        """
        import jax.core as _core
        if isinstance(x, _core.Tracer):
            return lax.with_sharding_constraint(x, self.sharding(rank))
        return jax.device_put(x, self.boundary_sharding(rank))

    def boundary_sharding(self, rank=0):
        """Divisibility-safe sharding for materialized global arrays: axes
        whose extent is not a multiple of their device-group size are stored
        replicated (JAX jax.Array shards must be equal-sized).  For
        production power-of-two shapes this equals :meth:`sharding`.

        NOTE: for *truly distributed* storage of uneven extents use
        :meth:`padded_shape` + :meth:`sharding` on a zero-padded buffer —
        that is what :class:`~mpi4py_fft_jax.distarray.DistArray` does
        (reference block distribution: pencil.py:5-9)."""
        assert self.mesh is not None, "Pencil has no mesh (pass a Subcomm)"
        names = [c.name if (c.name is not None and n % c.size == 0) else None
                 for c, n in zip(self.subcomm, self.shape)]
        spec = PartitionSpec(*([None] * rank), *names)
        return NamedSharding(self.mesh, spec)

    # -- padded at-rest storage of uneven extents ---------------------------
    def padded_shape(self):
        """Global storage shape with every distributed axis rounded up to a
        multiple of its device-group size.  Shard ``r`` of the padded
        buffer then holds rows [r*q, (r+1)*q) with q = ceil(N/p); its
        *valid* rows are exactly the reference block distribution
        ``blockdist(N, p, r)`` (reference: pencil.py:5-9) and the rest are
        zero padding.  Equal to :attr:`shape` whenever every extent
        divides (all production shapes)."""
        return tuple(-(-n // c.size) * c.size
                     for n, c in zip(self.shape, self.subcomm))

    def needs_padding(self):
        """True if any distributed axis extent does not divide its group."""
        return self.padded_shape() != self.shape

    # -- per-device geometry ----------------------------------------------
    def _axis_coord(self, i, device_index):
        """Coordinate of flat device ``device_index`` along subcomm axis i."""
        if self.subcomm[i].name is None:
            return 0
        mesh_shape = self.mesh.devices.shape
        names = list(self.mesh.axis_names)
        coords = np.unravel_index(device_index, mesh_shape)
        return int(coords[names.index(self.subcomm[i].name)])

    def local_shape(self, device_index=0):
        """Shard shape on one device (role of reference ``subshape``,
        pencil.py:293-307)."""
        out = []
        for i in range(len(self.shape)):
            n, _ = blockdist(self.shape[i], self.subcomm[i].Get_size(),
                             self._axis_coord(i, device_index))
            out.append(n)
        return tuple(out)

    def local_start(self, device_index=0):
        """Shard start offsets on one device (role of ``substart``)."""
        out = []
        for i in range(len(self.shape)):
            _, s = blockdist(self.shape[i], self.subcomm[i].Get_size(),
                             self._axis_coord(i, device_index))
            out.append(s)
        return tuple(out)

    # reference-compatible names: metadata of the first device
    @property
    def subshape(self):
        return self.local_shape(0)

    @property
    def substart(self):
        return self.local_start(0)

    # -- construction of partner pencils -----------------------------------
    def pencil(self, axis):
        """Return the partner pencil aligned with ``axis`` — swaps the two
        axes' device groups, leaving every other axis distribution unchanged
        (reference: pencil.py:309-323)."""
        assert -len(self.shape) <= axis < len(self.shape)
        if axis < 0:
            axis += len(self.shape)
        i, j = self.axis, axis
        subcomm = list(self.subcomm)
        subcomm[j], subcomm[i] = subcomm[i], subcomm[j]
        p = Pencil(subcomm, self.shape, axis)
        p.mesh = self.mesh
        return p

    def transfer(self, pencil, dtype):
        """Return a :class:`Transfer` for redistribution into ``pencil``
        (reference: pencil.py:325-354)."""
        penA, penB = self, pencil
        assert penA.shape == penB.shape
        assert penA.axis != penB.axis
        for i in range(len(penA.shape)):
            if i != penA.axis and i != penB.axis:
                assert penA.subcomm[i] == penB.subcomm[i]
        assert penA.subcomm[penB.axis] == penB.subcomm[penA.axis]
        return Transfer(self.mesh, self.shape, dtype, penA, penB)


class Transfer(object):
    """Global redistribution between two pencils of one mesh.

    The reference executes a single ``Alltoallw`` with committed subarray
    datatypes per peer (pencil.py:101-209).  Here the redistribution is a
    sharding change on the global array; XLA GSPMD emits the equivalent
    all-to-all.  Both an eager path (``forward``/``backward``) and
    a pure traced path (``forward_fn``/``backward_fn``, for fusion into a
    jitted pipeline) are provided.
    """

    def __init__(self, mesh, shape, dtype, pencilA, pencilB):
        self.mesh = mesh
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.pencilA = pencilA
        self.pencilB = pencilB
        self.subshapeA, self.axisA = pencilA.subshape, pencilA.axis
        self.subshapeB, self.axisB = pencilB.subshape, pencilB.axis

    # pure (traced) path ---------------------------------------------------
    def forward_fn(self, x, rank=0):
        """``rank`` leading axes (e.g. the planar complex axis) are
        replicated, not part of the pencil geometry."""
        return self.pencilB.constrain(x, rank=rank)

    def backward_fn(self, x, rank=0):
        return self.pencilA.constrain(x, rank=rank)

    # eager path -----------------------------------------------------------
    def _reshard(self, array, dst_pencil, out=None):
        from ..distarray import DistArray  # local import to avoid cycle
        rank = getattr(array, 'rank', 0) or 0
        if isinstance(array, DistArray):
            y = array._reshard_data(dst_pencil)
        else:
            data = jax.numpy.asarray(array)
            y = jax.device_put(data, dst_pencil.boundary_sharding(rank))
        if out is not None:
            if isinstance(out, DistArray):
                if isinstance(array, DistArray):
                    out._data = y          # already padded-storage form
                else:
                    out._set_global(y)     # true-shape value: repad
                return out
            out[...] = np.asarray(y)
            return out
        return y

    def forward(self, arrayA, arrayB=None):
        """Redistribute from pencil A to pencil B
        (reference: pencil.py:168-183)."""
        return self._reshard(arrayA, self.pencilB, arrayB)

    def backward(self, arrayB, arrayA=None):
        """Redistribute from pencil B to pencil A
        (reference: pencil.py:185-201)."""
        return self._reshard(arrayB, self.pencilA, arrayA)

    def destroy(self):
        """Nothing to free (no committed datatypes); parity no-op
        (reference: pencil.py:203-209)."""
