"""HDF5 snapshot backend.

Reference semantics: mpi4py_fft/io/h5py_file.py.  The reference opens the
file with the MPI-IO driver and every rank writes its hyperslab
simultaneously (io/h5py_file.py:33, 147-152).  Multi-process writes here
are concurrent too, by one of two mechanisms (``MPI4PY_FFT_JAX_H5_MODE``):

  ``vds`` (default) — every process streams its shards into its own
      sidecar file ``<name>.p<rank>.h5`` in parallel (separate files:
      no locking, no coordination), then process 0 stitches an HDF5
      Virtual Dataset into the main file mapping each shard source to
      its global hyperslab.  Readers (h5py, xdmf tools) see the same
      ``name/{ndim}D/{step}`` schema; the sidecars must travel with the
      main file.
  ``serial`` — the round-3 behavior: processes take turns on the main
      file under a global-device barrier (O(#processes) wall clock;
      kept as a fallback that produces a single self-contained file).

``HDF5File(..., repack=True)`` (or ``MPI4PY_FFT_JAX_H5_REPACK=1``) keeps
the parallel sidecar streaming of ``vds`` mode but has process 0 copy the
shards into ordinary contiguous datasets at stitch time instead of
virtual ones, then deletes the drained sidecars — one portable
self-contained file, matching the reference's mpio artifact
(reference: io/h5py_file.py:33, 72) at the cost of one serial copy pass.

File schema (identical to the reference):

    name/{ndim}D/{step}                  whole snapshots
    name/{ndim}D/{slicename}/{step}      global-slice snapshots
    name/domain/x{i} | name/mesh/x{i}    domain metadata
"""
import os

import numpy as np

from .file_base import FileBase

__all__ = ('HDF5File',)

# Multi-process access coordinates through our own global-device barriers
# (phases of :meth:`HDF5File.write`); HDF5's advisory file locking would
# deadlock that turn-taking (every process opens the main file at least
# once), so it is disabled for this process — the role of the reference's
# MPI-IO driver coordination (reference: io/h5py_file.py:33).
os.environ.setdefault('HDF5_USE_FILE_LOCKING', 'FALSE')


def _h5_mode():
    return os.environ.get('MPI4PY_FFT_JAX_H5_MODE', 'vds')


class HDF5File(FileBase):
    """Read/write snapshots in the reference HDF5 schema
    (reference: io/h5py_file.py:9-152)."""

    def __init__(self, h5name, domain=None, mode='a', **kw):
        FileBase.__init__(self, h5name, domain=domain)
        import h5py
        import jax
        self._phase = None            # None | 'blocks' | 'stitch'
        self._sidecar = None
        self._repack = bool(kw.pop(
            'repack',
            os.environ.get('MPI4PY_FFT_JAX_H5_REPACK', '0')
            not in ('0', 'false', 'False')))
        self._blk_groups = set()      # sidecar groups streamed this write
        self._src_cache = {}          # open sidecar handles during stitch
        if jax.process_count() == 1 or jax.process_index() == 0:
            self.f = h5py.File(h5name, mode, **kw)
            self.close()
        if jax.process_count() > 1:
            # other processes wait for the file to exist
            from jax.experimental import multihost_utils
            multihost_utils.sync_global_devices("h5open")

    def _check_domain(self, group, field):
        """Store domain/mesh metadata + shape/rank attrs
        (reference: io/h5py_file.py:36-64)."""
        if self._phase == 'blocks':
            return                    # sidecar holds raw shards only
        if self.domain is None:
            self.domain = ((0, 2 * np.pi),) * field.dimensions
        assert len(self.domain) == field.dimensions
        self.f.require_group(group)
        if "shape" not in self.f[group].attrs:
            self.f[group].attrs.create("shape", field.pencil.shape)
        if "rank" not in self.f[group].attrs:
            self.f[group].attrs.create("rank", field.rank)
        assert field.rank == self.f[group].attrs["rank"]
        assert np.all(field.pencil.shape == self.f[group].attrs["shape"])
        subgroup = "mesh" if isinstance(self.domain[0], np.ndarray) else "domain"
        self.f[group].require_group(subgroup)
        for i in range(field.dimensions):
            d = self.domain[i]
            if isinstance(d, np.ndarray):
                d0 = np.squeeze(d)
            else:
                d0 = np.array([d[0], d[1]])
            self.f[group][subgroup].require_dataset(
                f"x{i}", shape=d0.shape, dtype=d0.dtype, data=d0)

    @staticmethod
    def backend():
        return 'hdf5'

    def open(self, mode='r+'):
        import h5py
        self.f = h5py.File(self.filename, mode)

    # -- concurrent (VDS) machinery ------------------------------------
    @staticmethod
    def _blk_key(sl):
        """Sidecar dataset name for one global hyperslab."""
        return 'blk_' + '_'.join(f"{s.start}-{s.stop}" for s in sl)

    def _sidecar_name(self, p):
        return f"{self.filename}.p{p}.h5"

    @staticmethod
    def _owned_slabs(field):
        """Yield ``(process_index, global_slice)`` for every distinct
        shard of ``field`` across ALL processes — static pencil metadata,
        computable everywhere without touching remote data.  Mirrors the
        dedup rule of ``DistArray.addressable_blocks`` (first device
        owning a replicated slab writes it)."""
        if field._p0 is None:
            yield 0, tuple(slice(0, n) for n in field.global_shape)
            return
        seen = set()
        for d, dev in enumerate(field._p0.mesh.devices.flat):
            sl = field.local_slice(d)
            if sl in seen:
                continue
            seen.add(sl)
            yield dev.process_index, sl

    def write(self, step, fields, **kw):
        """Write snapshot ``step`` (reference: io/h5py_file.py:74-119).

        Each process writes only the hyperslabs of the shards it can
        address (the reference's per-rank mpio writes,
        io/h5py_file.py:147-152).  Multi-process: concurrent sidecar
        streams + VDS stitch by default; ``serial`` mode takes turns."""
        import jax
        if jax.process_count() == 1:
            self.open()
            FileBase.write(self, step, fields, **kw)
            self.close()
            return
        from jax.experimental import multihost_utils
        if _h5_mode() == 'serial':
            for p in range(jax.process_count()):
                if jax.process_index() == p:
                    self.open()
                    FileBase.write(self, step, fields, **kw)
                    self.close()
                multihost_utils.sync_global_devices(f"h5w{p}")
            return
        # ---- phase 1: every process streams its shards, in parallel ----
        import h5py
        self._phase = 'blocks'
        self._blk_groups = set()
        try:
            self._sidecar = h5py.File(
                self._sidecar_name(jax.process_index()), 'a')
            FileBase.write(self, step, fields, **kw)
            self._sidecar.close()
        finally:
            self._sidecar = None
            self._phase = None
        multihost_utils.sync_global_devices("h5w_blocks")
        # ---- phase 2: process 0 stitches the main file -----------------
        # (virtual datasets pointing at the sidecars, or — with
        # repack=True — contiguous copies drained from them)
        if jax.process_index() == 0:
            self._phase = 'stitch'
            try:
                self.open()
                FileBase.write(self, step, fields, **kw)
                self.close()
            finally:
                self._phase = None
                for f in self._src_cache.values():
                    f.close()
                self._src_cache = {}
        multihost_utils.sync_global_devices("h5w_stitch")
        if self._repack:
            # the main file is now self-contained; every process drains
            # the groups it streamed this call from its own sidecar and
            # unlinks the file once nothing is left in it
            side = self._sidecar_name(jax.process_index())
            if self._blk_groups and os.path.exists(side):
                with h5py.File(side, 'a') as sf:
                    for grp in self._blk_groups:
                        if grp in sf:
                            del sf[grp]
                        # prune now-empty ancestor groups too
                        parts = grp.split('/')
                        for i in range(len(parts) - 1, 0, -1):
                            anc = '/'.join(parts[:i])
                            if anc in sf and len(sf[anc]) == 0:
                                del sf[anc]
                    empty = len(sf) == 0
                if empty:
                    os.remove(side)
            multihost_utils.sync_global_devices("h5w_repack")

    def read(self, u, name, **kw):
        """Read whole snapshot into DistArray ``u``; data is resharded to
        ``u``'s decomposition on assignment — reader decomposition may
        differ from the writer's (reference: io/h5py_file.py:121-127 and
        docs/io.rst:61-62)."""
        step = kw.get('step', 0)
        self.open('r')
        dset = "/".join((name, f"{u.dimensions}D", str(step)))
        u[...] = np.asarray(self.f[dset])
        self.close()

    def _write_slice_step(self, name, step, slices, field, **kw):
        """Write a global slice of the array
        (reference: io/h5py_file.py:129-145)."""
        if self._phase == 'blocks':
            return                    # slices are emitted at stitch time
        rank = field.rank
        slices = list((slice(None),) * rank + tuple(slices))
        ndims = slices[rank:].count(slice(None))
        slname = self._get_slice_name(slices[rank:])
        sp = self._slice_spec(slices)
        group = "/".join((name, f"{ndims}D", slname))
        self.f.require_group(group)
        N = field.global_shape
        self.f[group].require_dataset(
            str(step), shape=tuple(np.take(N, sp)), dtype=field.dtype)
        import jax
        if jax.process_index() == 0:
            # global-slice writes gather the slice (cheap, lower-dim) and
            # are emitted once (the reference writes from owning ranks,
            # io/h5py_file.py:129-145)
            self.f["/".join((group, str(step)))][...] = \
                np.asarray(field)[tuple(slices)]

    def _write_group(self, name, u, step, **kw):
        """Write the whole global array.

        Single process: per-shard hyperslabs straight into the dataset.
        Multi-process 'blocks' phase: this process's shards into its
        sidecar.  'stitch' phase: a virtual dataset mapping every
        process's shard sources onto the global extent
        (reference mpio analogue: io/h5py_file.py:147-152)."""
        group = "/".join((name, f"{u.dimensions}D"))
        if self._phase == 'blocks':
            gpath = "/".join((group, str(step)))
            sgrp = self._sidecar.require_group(gpath)
            self._blk_groups.add(gpath)
            for sl, block in u.addressable_blocks():
                key = self._blk_key(sl)
                if key in sgrp:
                    sgrp[key][...] = block
                else:
                    sgrp.create_dataset(key, data=block)
            return
        if self._phase == 'stitch':
            import h5py
            if self._repack:
                # contiguous single-artifact form: copy every process's
                # shards out of the sidecars (one serial pass on process
                # 0; the parallel part already happened in phase 1)
                g = self.f.require_group(group)
                dset = g.require_dataset(str(step), shape=u.global_shape,
                                         dtype=u.dtype)
                for p, sl in self._owned_slabs(u):
                    if p not in self._src_cache:
                        self._src_cache[p] = h5py.File(
                            self._sidecar_name(p), 'r')
                    blk = self._src_cache[p][
                        "/".join((group, str(step), self._blk_key(sl)))]
                    dset[sl] = np.asarray(blk)
                return
            layout = h5py.VirtualLayout(shape=u.global_shape,
                                        dtype=u.dtype)
            for p, sl in self._owned_slabs(u):
                shape = tuple(s.stop - s.start for s in sl)
                # sidecars sit next to the main file: relative source
                # paths keep the file set relocatable as a unit
                src = h5py.VirtualSource(
                    os.path.basename(self._sidecar_name(p)),
                    "/".join((group, str(step), self._blk_key(sl))),
                    shape=shape, dtype=u.dtype)
                layout[sl] = src
            g = self.f.require_group(group)
            if str(step) in g:
                del g[str(step)]
            g.create_virtual_dataset(str(step), layout)
            return
        self.f.require_group(group)
        self.f[group].require_dataset(str(step), shape=u.global_shape,
                                      dtype=u.dtype)
        dset = self.f["/".join((group, str(step)))]
        if hasattr(u, 'addressable_blocks'):
            for sl, block in u.addressable_blocks():
                dset[sl] = block
        else:
            dset[...] = np.asarray(u)
