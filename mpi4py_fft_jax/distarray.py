"""Global-view distributed array.

JAX re-design of the reference DistArray
(reference: mpi4py_fft/distarray.py).  The reference subclasses
``np.ndarray`` and each MPI rank holds only its local block; under JAX's
single-controller model a :class:`DistArray` wraps one *global*
``jax.Array`` whose shards live on the devices described by its pencil.
Consequences of the semantic shift (documented per method below):

* ``.shape`` is the *global* shape (the reference's ``.shape`` is local);
  per-device geometry is exposed via ``local_slice(device_index)``;
* ``.get(gslice)`` returns on every caller (no rank-0-only result);
* mutation (``u[...] = v``) is provided for API familiarity and is
  implemented copy-on-write over the immutable device buffer — hot loops
  should use the functional API instead.

Tensors of rank > 0 keep their first ``rank`` axes undistributed
(replicated), matching the reference (distarray.py:40-56).
"""
from numbers import Number, Integral

import numpy as np
import jax
import jax.numpy as jnp

from .parallel.pencil import Pencil, Subcomm, AxisComm, COMM_SELF
from .parallel.comm import COMM_WORLD

__all__ = ['DistArray', 'newDistArray', 'Function']


class DistArray(object):
    """Distributed global array with pencil metadata
    (reference: distarray.py:10-439)."""

    def __init__(self, global_shape, subcomm=None, val=None, dtype=float,
                 buffer=None, strides=None, alignment=None, rank=0,
                 mesh=None):
        global_shape = tuple(int(s) for s in global_shape)
        dtype = np.dtype(dtype)
        self._rank = rank
        self._global_shape = global_shape
        if len(global_shape[rank:]) < 2:
            # 1-D (or degenerate) case: undistributed, no pencil
            # (reference: distarray.py:60-66)
            self._p0 = None
            if buffer is not None:
                self._data = jax.device_put(
                    np.asarray(buffer, dtype=dtype))
            else:
                fill = val if isinstance(val, Number) else 0
                self._data = jax.device_put(
                    np.full(global_shape, fill, dtype=dtype))
            return

        p0 = None
        if isinstance(subcomm, Pencil):
            p0 = subcomm
        elif isinstance(subcomm, Subcomm):
            pass
        elif isinstance(subcomm, (tuple, list)):
            assert len(subcomm) == len(global_shape[rank:])
            if all(isinstance(s, AxisComm) for s in subcomm):
                pass  # already axis groups (from an existing pencil)
            else:
                subcomm = Subcomm(COMM_WORLD, list(subcomm))
        else:
            assert subcomm is None
            subcomm = [0] * len(global_shape[rank:])
            if alignment is not None:
                subcomm[alignment] = 1
            else:
                subcomm[-1] = 1
                alignment = len(subcomm) - 1
            subcomm = Subcomm(COMM_WORLD, subcomm)

        if p0 is None:
            sizes = [s.Get_size() for s in subcomm]
            if alignment is not None:
                assert isinstance(alignment, (int, np.integer))
                assert sizes[alignment] == 1
            else:
                alignment = int(np.flatnonzero(np.array(sizes) == 1)[-1])
            p0 = Pencil(subcomm, global_shape[rank:], axis=int(alignment))
            if p0.mesh is None:
                p0.mesh = mesh if mesh is not None else getattr(
                    subcomm, 'mesh', None)
        self._p0 = p0
        assert self._p0.mesh is not None, \
            "DistArray needs a meshed subcomm (Subcomm or mesh=...)"

        # At-rest storage is the pencil's PADDED global shape: every
        # distributed axis is rounded up to a multiple of its device-group
        # size (equal to the true shape for all production extents), with
        # zeros in the trailing pad rows.  jax.Array shards must be
        # equal-sized, so this is the only way a 13-extent axis can be
        # *actually distributed* over 4 devices; shard r's valid rows are
        # then exactly the reference block distribution
        # (reference _blockdist: pencil.py:5-9).
        if buffer is not None:
            if isinstance(buffer, DistArray):
                buffer = np.asarray(buffer)
            data = np.asarray(buffer, dtype=dtype)
            assert data.shape == global_shape
            self._data = jax.device_put(self._embed(data),
                                        self._storage_sharding())
        else:
            fill = val if isinstance(val, Number) else 0
            host = np.zeros(self._storage_shape(), dtype=dtype)
            if fill != 0:
                host[self._valid_region()] = fill
            self._data = jax.device_put(host, self._storage_sharding())

    # -- padded-storage helpers ---------------------------------------------
    @property
    def padded(self):
        """True when the at-rest buffer carries zero pad rows (some axis
        extent does not divide its device-group size)."""
        return self._p0 is not None and self._p0.needs_padding()

    def _storage_shape(self):
        if self._p0 is None:
            return self._global_shape
        return self._global_shape[:self._rank] + self._p0.padded_shape()

    def _storage_sharding(self, p0=None):
        p0 = self._p0 if p0 is None else p0
        return p0.sharding(self._rank)

    def _valid_region(self):
        """Host-side index of the true data inside the padded buffer (the
        contiguous leading corner: pad rows are all at the high end)."""
        return tuple([slice(None)] * self._rank +
                     [slice(0, n) for n in self._global_shape[self._rank:]])

    def _embed(self, host):
        """True-shape host array -> padded-storage host array (native
        memcpy-run scatter when the _hoststage extension is built — the
        host-side counterpart of the reference's MPI subarray datatype
        pack engine, reference: pencil.py:12-29)."""
        from .utils import native
        sshape = self._storage_shape()
        if sshape == host.shape:
            return np.ascontiguousarray(host)
        out = np.zeros(sshape, dtype=host.dtype)
        native.unpack_block(out, (0,) * out.ndim, host.shape,
                            np.ascontiguousarray(host))
        return out

    def _set_global(self, y):
        """Adopt ``y`` (device or host array of the TRUE global shape) as
        this array's contents, repadding into at-rest storage as needed."""
        if self._p0 is None or not self.padded:
            if isinstance(y, np.ndarray):
                y = jax.device_put(y, self._sharding_for_rank())
            self._data = y
            return
        from .parallel.mpifft import _host_value
        self._data = jax.device_put(self._embed(_host_value(y)),
                                    self._storage_sharding())

    # -- basic array protocol ---------------------------------------------
    @property
    def shape(self):
        """Global shape.  NOTE: the reference's .shape is the local block
        shape (distarray.py docstring); here arrays are global-view."""
        return self._global_shape

    @property
    def dtype(self):
        return np.dtype(self._data.dtype)

    @property
    def ndim(self):
        return self._data.ndim

    def __len__(self):
        return self.shape[0]

    def __array__(self, dtype=None, copy=None):
        if self._data.is_fully_addressable:
            a = np.asarray(self._data)
        else:
            # multi-process: gather the global value on every process
            # (role of the reference's temp-parallel-HDF5 gather,
            # distarray.py:214-241)
            from jax.experimental import multihost_utils
            a = np.asarray(
                multihost_utils.process_allgather(self._data, tiled=True))
        if a.shape != self._global_shape:      # strip storage padding
            a = a[self._valid_region()]
        return a.astype(dtype) if dtype is not None else a

    def addressable_blocks(self):
        """Yield ``(global_slice, block)`` for every shard this process
        owns — the valid (unpadded) part of each addressable shard with
        its true-coordinate global position.  This is the per-rank
        hyperslab view the reference IO writers use
        (reference: io/h5py_file.py:147-152)."""
        if self._p0 is None:
            yield (tuple(slice(0, n) for n in self._global_shape),
                   np.asarray(self._data))
            return
        devlist = list(self._p0.mesh.devices.flat)
        seen = set()
        for shard in self._data.addressable_shards:
            d = devlist.index(shard.device)
            sl = self.local_slice(d)
            if sl in seen:          # replicated axes: write once
                continue
            seen.add(sl)
            data = np.asarray(shard.data)
            # shard may carry padding rows (padded storage) or full extents
            # (replicated axes of boundary-sharded data): keep valid rows.
            # Extracted with the native pack engine (memcpy runs) when the
            # _hoststage extension is built.
            starts = [0] * self._rank
            subsizes = list(data.shape[:self._rank])
            for i, s in enumerate(sl[self._rank:]):
                n = s.stop - s.start
                if data.shape[self._rank + i] == self._global_shape[
                        self._rank + i]:
                    starts.append(s.start)      # replicated: full extent
                else:
                    starts.append(0)            # padded block: valid head
                subsizes.append(n)
            from .utils import native
            yield sl, native.pack_block(data, starts, subsizes)

    def __repr__(self):
        return (f"DistArray(shape={self.shape}, dtype={self.dtype}, "
                f"rank={self.rank}, alignment={self._p0.axis if self._p0 else None})")

    # -- metadata (reference: distarray.py:109-180) ------------------------
    @property
    def alignment(self):
        return self._p0.axis

    @property
    def global_shape(self):
        return self.shape

    @property
    def substart(self):
        return (0,) * self.rank + self._p0.substart

    @property
    def subcomm(self):
        return (COMM_SELF,) * self.rank + self._p0.subcomm

    @property
    def subcomm_tuple(self):
        """Axis groups of the distributed part only (used by PFFT darray
        construction, reference: mpifft.py:293)."""
        return self._p0.subcomm

    @property
    def commsizes(self):
        return [s.Get_size() for s in self.subcomm]

    @property
    def pencil(self):
        return self._p0

    @property
    def rank(self):
        return self._rank

    @property
    def dimensions(self):
        return len(self._p0.shape)

    @property
    def sharding(self):
        return self._data.sharding

    @property
    def v(self):
        """The underlying global jax.Array (the reference's ``.v`` is the
        local ndarray view, distarray.py:177-180).  NOTE: for uneven
        extents this is the PADDED at-rest buffer (see :attr:`padded`);
        use ``np.asarray(self)`` for the true-shape values."""
        return self._data

    # -- indexing (reference: distarray.py:155-175) ------------------------
    def __getitem__(self, i):
        if self.ndim == 1:
            return self.__array__()[i]
        if isinstance(i, (Integral, slice)) and self.rank > 0:
            return self._component(i)
        if isinstance(i, (Integral, slice)) and self.rank == 0:
            return self.__array__()[i]
        if isinstance(i, tuple) and len(i) <= self.rank:
            return self._component(i)
        return self.__array__()[i]

    def _component(self, i):
        data = self._data[i]
        new_rank = self.rank - (self.ndim - data.ndim)
        assert new_rank >= 0
        out = DistArray.__new__(DistArray)
        out._p0 = self._p0
        out._rank = new_rank
        out._data = data
        # only the first ``rank`` (undistributed) axes can be consumed or
        # sliced here; the distributed trailing axes keep their extents
        out._global_shape = (tuple(data.shape[:new_rank])
                             + self._global_shape[self.rank:])
        return out

    def __setitem__(self, i, value):
        if isinstance(value, DistArray):
            value = np.asarray(value)
        if i is Ellipsis or (isinstance(i, slice) and i == slice(None)):
            data = np.ascontiguousarray(np.broadcast_to(
                np.asarray(value, dtype=self.dtype), self.shape))
            self._set_global(data)
        else:
            # indices are in TRUE coordinates; the padded buffer stores
            # data at identical offsets (pad rows are all at the high
            # end), so an in-bounds .at[] update needs no translation
            self._data = self._data.at[i].set(jnp.asarray(value))
            self._data = jax.device_put(self._data, self._sharding_for_rank())

    def _sharding_for_rank(self):
        if self._p0 is None:
            return self._data.sharding
        return self._storage_sharding()

    # -- arithmetic (elementwise ops preserve sharding) --------------------
    def _wrap(self, data):
        out = DistArray.__new__(DistArray)
        out._p0 = self._p0
        out._rank = self._rank
        out._data = data
        out._global_shape = self._global_shape
        return out

    def _other(self, other):
        if isinstance(other, DistArray):
            return other._data
        if (self.padded and np.ndim(other) > 0
                and tuple(np.shape(other)) == self._global_shape):
            # true-shaped operand against padded storage: embed host-side
            return jnp.asarray(self._embed(np.asarray(other)))
        return other

    def __add__(self, o): return self._wrap(self._data + self._other(o))
    def __radd__(self, o): return self._wrap(self._other(o) + self._data)
    def __sub__(self, o): return self._wrap(self._data - self._other(o))
    def __rsub__(self, o): return self._wrap(self._other(o) - self._data)
    def __mul__(self, o): return self._wrap(self._data * self._other(o))
    def __rmul__(self, o): return self._wrap(self._other(o) * self._data)
    def __truediv__(self, o): return self._wrap(self._data / self._other(o))
    def __pow__(self, o): return self._wrap(self._data ** self._other(o))
    def __neg__(self): return self._wrap(-self._data)

    def astype(self, dtype):
        return self._wrap(self._data.astype(dtype))

    def fill(self, val):
        self[...] = val

    def copy(self):
        return self._wrap(self._data)

    # -- global access (reference: distarray.py:182-278) -------------------
    def get(self, gslice):
        """Return a global slice.  The reference gathers through a temporary
        parallel-HDF5 file and returns on rank 0 only
        (distarray.py:214-241); the global-view model makes this a direct
        device→host slice, returned on every caller."""
        return self.__array__()[tuple(gslice)]

    def local_slice(self, device_index=None):
        """View of one device's shard into the global array
        (reference: distarray.py:243-278).  Without ``device_index`` the
        first device's slice is returned (the reference returns the calling
        rank's)."""
        d = 0 if device_index is None else device_index
        v = [slice(start, start + n) for start, n in
             zip(self._p0.local_start(d), self._p0.local_shape(d))]
        return tuple([slice(0, s) for s in self.shape[:self.rank]] + v)

    # -- redistribution (reference: distarray.py:280-363) ------------------
    def get_pencil_and_transfer(self, axis):
        """Reference: distarray.py:280-296."""
        p1 = self._p0.pencil(axis)
        return p1, self._p0.transfer(p1, self.dtype)

    def redistribute(self, axis=None, out=None):
        """Global redistribution (reference: distarray.py:298-363).

        A single sharding change redistributes all tensor components at
        once — no per-component loop is needed (the reference loops,
        distarray.py:354-360, because MPI datatypes are per-block)."""
        if axis == self.alignment:
            return self

        if axis is not None and isinstance(out, DistArray):
            assert axis == out.alignment

        if axis is not None:
            if self.commsizes[self.rank + axis] == 1:
                # both axes undivided: metadata-only realignment
                self._p0 = self._p0.pencil(axis)
                return self

        if out is not None:
            assert isinstance(out, DistArray)
            assert self.global_shape == out.global_shape
            axis = out.alignment
            if self.commsizes == out.commsizes:
                out._data = jax.device_put(self._data,
                                           out._sharding_for_rank())
                return out
            for i in range(len(self._p0.shape)):
                if i not in (self.alignment, out.alignment):
                    assert self.pencil.subcomm[i] == out.pencil.subcomm[i]

        p1, transfer = self.get_pencil_and_transfer(axis)
        if out is None:
            out = DistArray(self.global_shape,
                            subcomm=p1,
                            dtype=self.dtype,
                            alignment=axis,
                            rank=self.rank)
        out._data = self._reshard_data(p1)
        transfer.destroy()
        return out

    def _reshard_data(self, p1):
        """Move this array's padded-storage data into pencil ``p1``'s
        padded storage (the role of the reference's Alltoallw transfer,
        pencil.py:101-209).  Evenly-divisible shapes are a pure sharding
        change (one XLA all-to-all); uneven shapes additionally unpad and
        repad inside one jitted program."""
        rank = self.rank
        dst = p1.sharding(rank)
        if not (self.padded or p1.needs_padding()):
            return jax.device_put(self._data, dst)
        true_trail = self._global_shape[rank:]
        pad1 = p1.padded_shape()

        def f(x):
            x = x[(slice(None),) * rank +
                  tuple(slice(0, n) for n in true_trail)]
            widths = [(0, 0)] * rank + [(0, pn - n)
                                        for pn, n in zip(pad1, true_trail)]
            return jnp.pad(x, widths)
        return jax.jit(f, out_shardings=dst)(self._data)

    # -- IO (reference: distarray.py:365-439) ------------------------------
    def write(self, filename, name='darray', step=0, global_slice=None,
              domain=None, as_scalar=False):
        """Write snapshot to HDF5/NetCDF file (reference: distarray.py:365-404)."""
        from .io import HDF5File, NCFile, FileBase
        if isinstance(filename, str):
            writer = HDF5File if filename.endswith('.h5') else NCFile
            f = writer(filename, domain=domain, mode='a')
        else:
            assert isinstance(filename, FileBase)
            f = filename
        field = [self] if global_slice is None else [(self, global_slice)]
        f.write(step, {name: field}, as_scalar=as_scalar)

    def read(self, filename, name='darray', step=0):
        """Read snapshot into self (reference: distarray.py:406-439).
        Reader decomposition may differ from the writer's — data is
        resharded on load."""
        from .io import HDF5File, NCFile, FileBase
        if isinstance(filename, str):
            reader = HDF5File if filename.endswith('.h5') else NCFile
            f = reader(filename, mode='r')
        else:
            assert isinstance(filename, FileBase)
            f = filename
        f.read(self, name, step=step)


def newDistArray(pfft, forward_output=True, val=0, rank=0, view=False):
    """New DistArray matching a PFFT's input/output spec
    (reference: distarray.py:442-485)."""
    global_shape = pfft.global_shape(forward_output)
    p0 = pfft.pencil[forward_output]
    dtype = pfft.dtype(forward_output)
    global_shape = (len(global_shape),) * rank + global_shape
    z = DistArray(global_shape, subcomm=p0.subcomm, val=val, dtype=dtype,
                  alignment=p0.axis, rank=rank, mesh=p0.mesh)
    return z.v if view else z


def Function(*args, **kwargs):  # pragma: no cover
    """Deprecated alias (reference: distarray.py:487-493)."""
    import warnings
    warnings.warn("Function() is deprecated; use newDistArray().",
                  FutureWarning)
    if 'tensor' in kwargs:
        kwargs['rank'] = 1
        del kwargs['tensor']
    return newDistArray(*args, **kwargs)
