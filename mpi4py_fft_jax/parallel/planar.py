"""Planar-complex parallel FFT.

The same fused transform→transpose→transform pipeline as
:class:`.mpifft.PFFT` for the c2c and r2c/c2r subset, with every array
real-typed: a complex field of global shape S is carried as a real array
of shape (2,) + S (leading planar axis; see ops/matfft.py).  Local stages
run ops/matfft.py (``jnp.fft`` by default); the pencil transposes are
XLA all-to-alls on real buffers.

API sketch::

    pfft = PlanarPFFT(None, (1024, 1024, 1024), dtype='f')   # r2c
    u = jnp.zeros(pfft.global_shape(False))                  # real input
    u_hat = pfft.forward(u)      # planar (2, 1024, 1024, 513) real
    u2 = pfft.backward(u_hat)
"""
import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec

from ..ops import matfft
from .pencil import Pencil, Subcomm

__all__ = ['PlanarPFFT']

# planar 3/2-rule truncation / zero-padding live with the other dealiasing
# helpers in libfft (reference semantics: libfft.py:263-311)
from ..libfft import _axslice, truncate_planar, pad_planar  # noqa: E402


class PlanarPFFT(object):
    """Pencil/slab-decomposed FFT in planar-complex form.

    Parameters mirror :class:`.mpifft.PFFT` for the supported subset:
    c2c (complex input as planar (2,)+S) and r2c/c2r (real input).
    ``axes`` must be a flat axis sequence (one axis per stage; collapse is
    applied automatically to aligned trailing groups).
    """

    def __init__(self, comm=None, shape=None, axes=None, dtype='f',
                 grid=None, donate=False, padding=False, pad_spectrum=False,
                 executor='auto', a2a_chunks=None):
        from . import overlap as _ov
        self._a2a_cfg = _ov.chunk_count(a2a_chunks)
        shape = list(int(s) for s in shape)
        ndim = len(shape)
        if axes is None:
            axes = tuple(range(ndim))
        axes = tuple(a % ndim for a in axes)
        dtype = np.dtype(dtype)
        assert dtype.char in 'fdFD'
        self.real_transform = dtype.char in 'fd'
        self.rdtype = np.dtype('float32') if dtype.char in 'fF' \
            else np.dtype('float64')

        # dealiasing: inflate physical shape, re-derive exact factors
        # (reference: mpifft.py:247-253)
        self._pad = [1.0] * ndim
        if padding is not False and padding is not None:
            padding = [padding] * ndim if np.ndim(padding) == 0 else list(padding)
            assert len(padding) == ndim
            for ax in axes:
                if padding[ax] > 1.0 + 1e-6:
                    old = float(shape[ax])
                    shape[ax] = int(np.floor(shape[ax] * padding[ax]))
                    self._pad[ax] = shape[ax] / old
        shape = tuple(shape)

        if grid is not None:
            dims = list(grid) + [1] * (ndim - len(grid))
        else:
            dims = [0] * ndim
            dims[axes[-1]] = 1
        self.subcomm = Subcomm(comm, dims)
        assert self.subcomm[axes[-1]].Get_size() == 1

        self.axes = axes
        self._input_shape = shape

        # truncated spectral extents per axis (== padded extent when no
        # dealiasing); r2c halves the first-transformed axis
        self._trunc = {ax: int(np.round(shape[ax] / self._pad[ax]))
                       for ax in axes}
        out_shape = list(shape)
        for ax in axes:
            out_shape[ax] = self._trunc[ax]
        if self.real_transform:
            out_shape[axes[-1]] = self._trunc[axes[-1]] // 2 + 1
        self._output_shape = tuple(out_shape)

        # pencil chain over the spectral shape, first-transformed axis last
        # (mirrors reference mpifft.py:308-338 plan construction)
        self.pencils = []
        pencil = Pencil(self.subcomm, out_shape, axes[-1])
        self.pencils.append(pencil)
        for ax in reversed(axes[:-1]):
            pencil = pencil.pencil(ax)
            self.pencils.append(pencil)
        self.pencil = [Pencil(self.subcomm, list(shape), axes[-1]),
                       self.pencils[-1]]

        # r2c: the halved axis (extent N//2+1, usually odd) is transformed
        # first and never again, but is resharded by every later transpose;
        # an odd extent makes GSPMD fall back to all-gather+slice.  Pad it
        # with zero rows to the lcm of every group size that shards it, and
        # slice back at the pipeline boundary — transposes then move evenly
        # divisible extents and stay pure all-to-alls.
        # pad_spectrum=True keeps the r2c spectrum at the padded extent
        # (trailing zero rows) so no boundary slice — and therefore no
        # GSPMD all-gather — is ever emitted; pointwise spectral algebra
        # and the backward transform are exact on the padded form.
        self._pad_spectrum = bool(pad_spectrum)
        self._hpad_ext = None
        if self.real_transform:
            hax = axes[-1]
            q = 1
            for pen in self.pencils:
                q = int(np.lcm(q, pen.subcomm[hax].Get_size()))
            nh = self._output_shape[hax]
            if q > 1 and nh % q:
                self._hpad_ext = (-(-nh // q)) * q

        Mtot = float(np.prod([shape[a] for a in axes]))
        self._norm = 1.0 / Mtot

        # per-axis padded extents for the shard_map executor: each axis is
        # rounded up to the lcm of every group size that shards it anywhere
        # in the pencil chain, so uniform per-shard programs and pure tiled
        # all_to_all transposes cover non-divisible (reference 12/13-style)
        # extents too.  Pad rows are exact zeros at the tail of the axis;
        # every local transform slices its axis back to the true extent
        # first, so the math is exact.  Equal to the true extents for all
        # production (power-of-two) shapes.
        ndim_ = len(shape)
        qs = [1] * ndim_
        for pen in [self.pencil[0]] + list(self.pencils):
            for i, c in enumerate(pen.subcomm):
                qs[i] = int(np.lcm(qs[i], c.Get_size()))
        self._axis_lcm = tuple(qs)
        self._phys_pad_shape = tuple(-(-shape[i] // qs[i]) * qs[i]
                                     for i in range(ndim_))
        spec = list(self._output_shape)
        if self._hpad_ext is not None:
            spec[axes[-1]] = self._hpad_ext
        self._spec_pad_shape = tuple(-(-spec[i] // qs[i]) * qs[i]
                                     for i in range(ndim_))

        # -- executor: 'gspmd' traces one global program and lets GSPMD
        # infer the collectives from sharding constraints; 'shard_map'
        # writes the per-shard program with explicit lax.all_to_all
        # transposes, which gives deterministic collective placement.
        # 'auto' uses shard_map whenever the mesh is multi-device (uneven
        # extents ride the padded form above).
        assert executor in ('auto', 'gspmd', 'shard_map')
        nmesh = int(np.prod(self.subcomm.mesh.devices.shape))
        shmap_ok = nmesh > 1
        if executor == 'auto':
            import os as _os
            pref = _os.environ.get('MPI4PY_FFT_JAX_EXECUTOR', 'shard_map')
            executor = pref if (pref == 'shard_map' and shmap_ok) \
                else 'gspmd'
        elif executor == 'shard_map':
            assert shmap_ok, "shard_map executor needs a multi-device mesh"
        self.executor = executor
        self._nmesh = nmesh

        # donate=True reuses the input buffer's device memory for
        # intermediates (in-place semantics like FFTW_DESTROY_INPUT) —
        # halves the footprint for card-filling transforms; the caller's
        # input array is invalidated after the call.
        dn = (0,) if donate else ()
        fwd = self._forward_shmap if executor == 'shard_map' \
            else self._forward_impl
        bwd = self._backward_shmap if executor == 'shard_map' \
            else self._backward_impl
        self._jit_forward = jax.jit(fwd, static_argnums=(1,),
                                    donate_argnums=dn)
        self._jit_backward = jax.jit(bwd, static_argnums=(1,),
                                     donate_argnums=dn)

    # ------------------------------------------------------------------
    def _padded(self, ax):
        return self._pad[ax] > 1.0 + 1e-8

    @staticmethod
    def _slice_ax(p, ax, n):
        """Slice axis ``ax`` down to extent ``n`` (no-op when equal)."""
        if p.shape[ax] > n:
            return p[_axslice(p, ax, slice(0, n))]
        return p

    @staticmethod
    def _pad_ax(p, ax, n):
        """Zero-pad axis ``ax`` up to extent ``n`` (no-op when equal)."""
        if n > p.shape[ax]:
            pad = [(0, 0)] * p.ndim
            pad[ax] = (0, n - p.shape[ax])
            return jnp.pad(p, pad)
        return p

    def _pad_axes(self, p, target, off):
        for i, n in enumerate(target):
            p = self._pad_ax(p, off + i, n)
        return p

    def _slice_axes(self, p, target, off):
        for i, n in enumerate(target):
            p = self._slice_ax(p, off + i, n)
        return p

    # -- shard_map executor --------------------------------------------
    def _transpose_lax(self, p, i, forward=True):
        """Explicit pencil transpose pencils[i] <-> pencils[i+1]: one
        tiled lax.all_to_all over the single participating group (role of
        reference Transfer.forward/backward, pencil.py:168-201)."""
        pa, pb = self.pencils[i], self.pencils[i + 1]
        axA, axB = pa.axis, pb.axis
        g = pa.subcomm[axB]
        if g.name is None:
            return p
        if forward:
            return lax.all_to_all(p, g.name, split_axis=1 + axA,
                                  concat_axis=1 + axB, tiled=True)
        return lax.all_to_all(p, g.name, split_axis=1 + axB,
                              concat_axis=1 + axA, tiled=True)

    def _forward_local(self, x, normalize):
        """Per-shard forward program (runs under shard_map).

        Axes arrive at their *padded* extents (``_phys_pad_shape``, exact
        zero tail rows); each is sliced back to its true extent when it is
        aligned for its transform, and the spectral result is re-padded to
        ``_spec_pad_shape`` so every tiled all_to_all moves evenly
        divisible extents."""
        axes = self.axes
        ax0 = axes[-1]
        spad0 = self._spec_pad_shape[ax0]
        if self.real_transform:
            x = self._slice_ax(x, ax0, self._input_shape[ax0])
            if self._padded(ax0):
                p = matfft.rfftn_p(x, (ax0,))
                p = truncate_planar(p, 1 + ax0, self._trunc[ax0] // 2 + 1,
                                    hermitian=True)
                p = self._pad_ax(p, 1 + ax0, spad0)
            else:
                p = matfft.rfftn_p(x, (ax0,),
                                   hext=spad0 if spad0 > x.shape[ax0] // 2 + 1
                                   else None)
        else:
            x = self._slice_ax(x, 1 + ax0, self._input_shape[ax0])
            p = matfft.fft1d_p(x, ax0, True)
            if self._padded(ax0):
                p = truncate_planar(p, 1 + ax0, self._trunc[ax0],
                                    hermitian=False)
            p = self._pad_ax(p, 1 + ax0, spad0)
        nmid = len(axes) - 1
        folded = False
        for i, ax in enumerate(reversed(axes[:-1])):
            sc = self._norm if (normalize and i == nmid - 1) else None
            folded = folded or sc is not None

            def chain(pc, i=i, ax=ax, sc=sc):
                pc = self._transpose_lax(pc, i, True)
                pc = self._slice_ax(pc, 1 + ax, self._input_shape[ax])
                pc = matfft.fft1d_p(pc, ax, True, scale=sc)
                if self._padded(ax):
                    pc = truncate_planar(pc, 1 + ax, self._trunc[ax],
                                         hermitian=False)
                return self._pad_ax(pc, 1 + ax, self._spec_pad_shape[ax])
            p = self._overlapped_step(p, i, ax, chain)
        if normalize and not folded:
            p = p * np.asarray(self._norm, dtype=self.rdtype)
        return p

    def _overlapped_step(self, p, i, ax, chain):
        """Run one transpose+transform pipeline step, chunked along an
        uninvolved axis so chunk k's transform stage overlaps chunk k+1's
        all_to_all (see parallel/overlap.py; the reference's hot loop is
        strictly sequential, mpifft.py:68-72)."""
        from . import overlap as _ov
        pa, pb = self.pencils[i], self.pencils[i + 1]
        if pa.subcomm[pb.axis].name is None:       # no comm: nothing to hide
            return chain(p)
        used = {pa.axis, pb.axis, ax}
        cands = [c for c in range(len(self._input_shape)) if c not in used]
        if not cands:
            return chain(p)
        c = max(cands, key=lambda c: p.shape[1 + c])
        n = _ov.resolve(self._a2a_cfg, p.size * p.dtype.itemsize,
                        p.shape[1 + c])
        return _ov.overlapped(p, 1 + c, n, chain)

    def _backward_local(self, p, normalize):
        """Per-shard backward program (runs under shard_map); axes arrive
        at ``_spec_pad_shape`` extents and leave at ``_phys_pad_shape``."""
        axes = self.axes
        for i, ax in enumerate(axes[:-1]):

            def chain(pc, i=i, ax=ax):
                pc = self._slice_ax(pc, 1 + ax, self._trunc[ax])
                if self._padded(ax):
                    pc = pad_planar(pc, 1 + ax, self._input_shape[ax],
                                    hermitian=False)
                pc = matfft.fft1d_p(pc, ax, False)
                pc = self._pad_ax(pc, 1 + ax, self._phys_pad_shape[ax])
                return self._transpose_lax(pc, len(axes) - 2 - i, False)
            p = self._overlapped_step(p, len(axes) - 2 - i, ax, chain)
        ax0 = axes[-1]
        p = self._slice_ax(p, 1 + ax0, self._output_shape[ax0])
        sc = self._norm if normalize else None
        if self.real_transform:
            N0 = self._input_shape[ax0]
            if self._padded(ax0):
                p = pad_planar(p, 1 + ax0, N0 // 2 + 1, hermitian=True)
            y = matfft.irfftn_p(p, (ax0,), N0, scale=sc)
            y = self._pad_ax(y, ax0, self._phys_pad_shape[ax0])
        else:
            if self._padded(ax0):
                p = pad_planar(p, 1 + ax0, self._input_shape[ax0],
                               hermitian=False)
            y = matfft.fft1d_p(p, ax0, False, scale=sc)
            y = self._pad_ax(y, 1 + ax0, self._phys_pad_shape[ax0])
        return y

    def _phys_spec(self):
        names = [c.name for c in self.pencil[0].subcomm]
        if self.real_transform:
            return PartitionSpec(*names)
        return PartitionSpec(None, *names)

    def _spec_spec(self):
        return PartitionSpec(None, *[c.name for c in
                                     self.pencils[-1].subcomm])

    def _spec_contract_shape(self):
        """User-facing spectral extents: true extents, except the r2c axis
        which stays padded under the ``pad_spectrum`` contract."""
        sh = list(self._output_shape)
        if self._pad_spectrum and self._hpad_ext is not None:
            sh[self.axes[-1]] = self._hpad_ext
        return tuple(sh)

    def _forward_shmap(self, x, normalize):
        off = 0 if self.real_transform else 1
        x = self._pad_axes(x, self._phys_pad_shape, off)
        f = jax.shard_map(lambda q: self._forward_local(q, normalize),
                          mesh=self.subcomm.mesh,
                          in_specs=(self._phys_spec(),),
                          out_specs=self._spec_spec())
        p = f(x)
        # boundary slice back to the user contract (no-op for production
        # shapes; for uneven extents GSPMD pays one gather here, never in
        # the pipeline's transposes)
        return self._slice_axes(p, self._spec_contract_shape(), 1)

    def _backward_shmap(self, p, normalize):
        p = self._pad_axes(p, self._spec_pad_shape, 1)
        f = jax.shard_map(lambda q: self._backward_local(q, normalize),
                          mesh=self.subcomm.mesh,
                          in_specs=(self._spec_spec(),),
                          out_specs=self._phys_spec())
        y = f(p)
        off = 0 if self.real_transform else 1
        return self._slice_axes(y, self._input_shape, off)

    def _forward_impl(self, x, normalize):
        axes = self.axes
        ax0 = axes[-1]
        if self.real_transform:
            x = self.pencil[0].constrain(x)
            with jax.named_scope("planar_stage0_r2c"):
                p = matfft.rfftn_p(x, (ax0,))
                if self._padded(ax0):
                    p = truncate_planar(p, 1 + ax0,
                                        self._trunc[ax0] // 2 + 1,
                                        hermitian=True)
                if self._hpad_ext is not None:
                    pad = [(0, 0)] * p.ndim
                    pad[1 + ax0] = (0, self._hpad_ext - p.shape[1 + ax0])
                    p = jnp.pad(p, pad)
                p = self.pencils[0].constrain(p, rank=1)
        else:
            # x: planar (2,)+S
            x = self.pencil[0].constrain(x, rank=1)
            with jax.named_scope("planar_stage0"):
                p = matfft.fft1d_p(x, ax0, True)
                if self._padded(ax0):
                    p = truncate_planar(p, 1 + ax0, self._trunc[ax0],
                                        hermitian=False)
                p = self.pencils[0].constrain(p, rank=1)
        nmid = len(axes) - 1
        folded = False
        for i, ax in enumerate(reversed(axes[:-1])):
            pen = self.pencils[i + 1]
            last = (i == nmid - 1)
            sc = self._norm if (normalize and last) else None
            folded = folded or sc is not None
            with jax.named_scope(f"planar_transpose{i}"):
                p = pen.constrain(p, rank=1)
            with jax.named_scope(f"planar_stage{i + 1}"):
                p = matfft.fft1d_p(p, ax, True, scale=sc)
                if self._padded(ax):
                    p = truncate_planar(p, 1 + ax, self._trunc[ax],
                                        hermitian=False)
                p = pen.constrain(p, rank=1)
        if self._hpad_ext is not None and not self._pad_spectrum:
            p = p[_axslice(p, 1 + ax0, slice(0, self._output_shape[ax0]))]
            p = self.pencils[-1].constrain(p, rank=1)
        if normalize and not folded:
            p = p * np.asarray(self._norm, dtype=self.rdtype)
        return p

    def _backward_impl(self, p, normalize):
        axes = self.axes
        if self._hpad_ext is not None:
            hax = axes[-1]
            pad = [(0, 0)] * p.ndim
            pad[1 + hax] = (0, self._hpad_ext - p.shape[1 + hax])
            p = jnp.pad(p, pad)
        p = self.pencils[-1].constrain(p, rank=1)
        for i, ax in enumerate(axes[:-1]):
            pen = self.pencils[len(axes) - 1 - i]
            p = pen.constrain(p, rank=1)
            with jax.named_scope(f"planar_bstage{i}"):
                if self._padded(ax):
                    p = pad_planar(p, 1 + ax, self._input_shape[ax],
                                   hermitian=False)
                p = matfft.fft1d_p(p, ax, False)
                p = pen.constrain(p, rank=1)
        p = self.pencils[0].constrain(p, rank=1)
        ax0 = axes[-1]
        if self._hpad_ext is not None:
            p = p[_axslice(p, 1 + ax0, slice(0, self._output_shape[ax0]))]
        with jax.named_scope("planar_bstage_last"):
            if self.real_transform:
                if self._padded(ax0):
                    p = pad_planar(p, 1 + ax0,
                                   self._input_shape[ax0] // 2 + 1,
                                   hermitian=True)
                y = matfft.irfftn_p(p, (ax0,), self._input_shape[ax0],
                                    scale=self._norm if normalize else None)
                y = self.pencil[0].constrain(y)
            else:
                if self._padded(ax0):
                    p = pad_planar(p, 1 + ax0, self._input_shape[ax0],
                                   hermitian=False)
                y = matfft.fft1d_p(p, ax0, False,
                                   scale=self._norm if normalize else None)
                y = self.pencil[0].constrain(y, rank=1)
        return y

    # ------------------------------------------------------------------
    def _check_shape(self, x, forward_output):
        want = tuple(self.global_shape(forward_output))
        got = tuple(x.shape)
        if forward_output and self._hpad_ext is not None:
            # the spectrum is accepted in both the padded (shardable
            # extent) and the unpadded N//2+1 form — backward repads
            alt = list(want)
            alt[1 + self.axes[-1]] = self._hpad_ext \
                if want[1 + self.axes[-1]] != self._hpad_ext \
                else self._output_shape[self.axes[-1]]
            if got == tuple(alt):
                return
        assert got == want, \
            f"array shape {got} does not match the planned shape {want}"

    def forward(self, x, normalize=True):
        """Forward transform; real input (r2c) or planar input (c2c)."""
        self._check_shape(x, False)
        return self._jit_forward(x, bool(normalize))

    def backward(self, p, normalize=False):
        """Backward transform; planar input, real (c2r) or planar output."""
        self._check_shape(p, True)
        return self._jit_backward(p, bool(normalize))

    # pure path for composition under user jit (shapes are static under
    # tracing, so the same plan-shape validation as forward/backward is
    # free here too)
    def forward_fn(self, x, normalize=True):
        self._check_shape(x, False)
        if self.executor == 'shard_map':
            return self._forward_shmap(x, normalize)
        return self._forward_impl(x, normalize)

    def backward_fn(self, p, normalize=False):
        self._check_shape(p, True)
        if self.executor == 'shard_map':
            return self._backward_shmap(p, normalize)
        return self._backward_impl(p, normalize)

    def global_shape(self, forward_output=False):
        if forward_output:
            if self._pad_spectrum and self._hpad_ext is not None:
                sh = list(self._output_shape)
                sh[self.axes[-1]] = self._hpad_ext
                return (2,) + tuple(sh)
            return (2,) + self._output_shape
        if self.real_transform:
            return self._input_shape
        return (2,) + self._input_shape
