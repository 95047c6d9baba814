"""Parallel FFT orchestration: plan construction and the fused pipeline.

JAX re-design of the reference orchestrator
(reference: mpi4py_fft/mpifft.py).  The *plan construction* algorithm is the
same — walk the axes groups last→first, planning a serial transform per
group and a pencil rotation between groups, with r2c/padding global-shape
fixups (reference: mpifft.py:213-338).  The *executor* is different: instead
of a Python loop alternating buffer FFTs and Alltoallw calls
(reference: mpifft.py:46-79), the whole chain

    transform -> reshard -> transform -> ... -> reshard -> transform

is traced into ONE jitted XLA program; each reshard becomes an XLA
all-to-all (NCCL over NVLink between GPUs) that the scheduler can overlap
with the local transform stages.
"""
import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec

from ..libfft import FFT
from .pencil import Pencil, Subcomm
from .comm import DeviceComm, COMM_WORLD

__all__ = ['PFFT', 'Transform']


def _slice_ax(p, ax, n):
    """Slice axis ``ax`` down to extent ``n`` (no-op when equal)."""
    if p.shape[ax] > n:
        sl = [slice(None)] * p.ndim
        sl[ax] = slice(0, n)
        return p[tuple(sl)]
    return p


def _pad_ax(p, ax, n):
    """Zero-pad axis ``ax`` up to extent ``n`` (no-op when equal)."""
    if n > p.shape[ax]:
        pad = [(0, 0)] * p.ndim
        pad[ax] = (0, n - p.shape[ax])
        return jnp.pad(p, pad)
    return p


def _host_value(y):
    """Global host value of a (possibly non-addressable) device array —
    multi-process safe (role of the reference's implicit local views)."""
    if isinstance(y, jax.Array) and not y.is_fully_addressable:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(y, tiled=True))
    return np.asarray(y)


class Transform(object):
    """One direction of a parallel transform (reference: mpifft.py:8-79).

    ``stages`` are pure per-group functions, ``reshards`` the pure pencil
    rotations applied *before* stages[1:].  The object is callable with the
    reference's buffer semantics and also exposes :meth:`fn` — the pure
    function used for fusing into larger jitted programs (e.g. a full DNS
    time step).
    """

    def __init__(self, pfft, stages, reshards, pencils, in_shape, in_dtype,
                 out_shape, out_dtype, default_normalize, host_mode,
                 stage_pencils=None, planars=None, executor='gspmd',
                 shmap_plan=None):
        assert len(stages) == len(reshards) + 1 and len(pencils) == 2
        assert executor in ('gspmd', 'shard_map')
        assert executor == 'gspmd' or shmap_plan is not None
        self._pfft = pfft
        self._executor = executor
        self._shmap_plan = shmap_plan
        self._stages = tuple(stages)
        self._reshards = tuple(reshards)
        self._pencil = tuple(pencils)
        # the pencil each stage computes in; stage outputs are pinned to it
        # so GSPMD's backward sharding propagation cannot re-layout a
        # transform onto its own (sharded) transform axis — that would turn
        # the pencil transpose into an all-gather instead of an all-to-all
        self._stage_pencils = tuple(stage_pencils) if stage_pencils else \
            (pencils[0],) * len(stages)
        self._in_shape = tuple(in_shape)
        self._in_dtype = np.dtype(in_dtype)
        self._out_shape = tuple(out_shape)
        self._out_dtype = np.dtype(out_dtype)
        self._default_normalize = default_normalize
        self._host_mode = host_mode
        # planar pipeline: ``planars[i]`` says whether the data *entering*
        # stage i is planar ((2,)+shape real carrying a logical complex
        # array); planars[-1] describes the output.  Logically complex
        # arrays are converted to and from the planar form inside the
        # jitted program (:meth:`fn`).
        if planars is None:
            planars = (False,) * (len(stages) + 1)
        assert len(planars) == len(stages) + 1
        self._planars = tuple(bool(b) for b in planars)
        self._input_buffer = None
        self._output_buffer = None
        if host_mode:
            self._jit = self._jit_io = None
        else:
            self._jit = jax.jit(self._impl, static_argnums=(1,))
            self._jit_io = jax.jit(
                self.fn, static_argnums=(1,),
                out_shardings=self._pencil[1].boundary_sharding())

    # -- pure pipeline (pipeline form: complex data is planar) -------------
    def _impl(self, x, normalize):
        """Executor dispatch: 'shard_map' is the multi-device production
        path (explicit lax.all_to_all transposes + per-shard stages, the
        single-production-path property of reference mpifft.py:308-347);
        'gspmd' traces one global program with sharding constraints."""
        if self._executor == 'shard_map':
            return self._impl_shmap(x, normalize)
        return self._impl_gspmd(x, normalize)

    def _impl_shmap(self, x, normalize):
        """Per-shard executor.  Every axis travels at a *padded* extent
        (per-axis lcm of every device-group size that shards it anywhere in
        the pencil chain, exact zero tail rows); each stage slices its
        aligned transform axes back to the true extent, transforms, and
        re-pads — so every tiled all_to_all moves evenly divisible extents
        and the local stages see uniform per-shard shapes.  Same
        construction as PlanarPFFT's executor (parallel/planar.py), here
        generalized to the full PFFT feature matrix (collapse groups, r2r
        dicts, dealiasing padding, r2c fixups)."""
        plan = self._shmap_plan
        pl = self._planars
        r0, rN = int(pl[0]), int(pl[-1])
        for i, npad in enumerate(plan['in_pad']):
            x = _pad_ax(x, r0 + i, npad)
        in_spec = PartitionSpec(*([None] * r0),
                                *[c.name for c in self._pencil[0].subcomm])
        out_spec = PartitionSpec(*([None] * rN),
                                 *[c.name for c in self._pencil[1].subcomm])
        f = jax.shard_map(lambda q: self._shmap_local(q, normalize),
                          mesh=plan['mesh'], in_specs=(in_spec,),
                          out_specs=out_spec)
        y = f(x)
        # boundary slice back to the user contract (no-op for production
        # shapes; uneven extents pay one gather here, never in the
        # pipeline's transposes)
        for i, ntrue in enumerate(plan['out_true']):
            y = _slice_ax(y, rN + i, ntrue)
        return y

    def _shmap_local(self, q, normalize):
        """The per-shard program (body of the shard_map executor).

        Each transpose+stage pipeline step is chunked along an axis
        uninvolved in both (parallel/overlap.py), emitting independent
        ``all_to_all -> stage`` chains per chunk so the latency-hiding
        scheduler overlaps chunk k's transforms with chunk k+1's
        collective traffic.  The reference's hot loop (mpifft.py:68-72)
        runs these strictly back to back."""
        from . import overlap as _ov
        plan = self._shmap_plan
        pl = self._planars
        cfg = getattr(self._pfft, '_a2a_cfg', 1)

        def step(q, i, stage, g, rin):
            if g is not None:
                _, axA, axB = plan['a2a'][i - 1][:3]
                with jax.named_scope(f"pfft_a2a{i - 1}"):
                    q = lax.all_to_all(q, g, split_axis=rin + axA,
                                       concat_axis=rin + axB, tiled=True)
            with jax.named_scope(f"pfft_stage{i}"):
                for ax, n in plan['slices'][i]:
                    q = _slice_ax(q, rin + ax, n)
                q = stage(q, normalize)
                rout = int(pl[i + 1])
                for ax, n in plan['pads'][i]:
                    q = _pad_ax(q, rout + ax, n)
            return q

        for i, stage in enumerate(self._stages):
            rin = int(pl[i])
            g = cands = None
            if i > 0:
                g, _axA, _axB, cands = plan['a2a'][i - 1]
            chain = (lambda qc, i=i, stage=stage, g=g, rin=rin:
                     step(qc, i, stage, g, rin))
            if g is None or not cands:
                q = chain(q)
                continue
            c = max(cands, key=lambda c: q.shape[rin + c])
            n = _ov.resolve(cfg, q.size * q.dtype.itemsize,
                            q.shape[rin + c])
            q = _ov.overlapped(q, rin + c, n, chain,
                               out_axis=int(pl[i + 1]) + c)
        return q

    def _impl_gspmd(self, x, normalize):
        pl = self._planars
        x = self._pencil[0].constrain(x, rank=int(pl[0]))
        with jax.named_scope("pfft_stage0"):
            x = self._stages[0](x, normalize)
            x = self._stage_pencils[0].constrain(x, rank=int(pl[1]))
        for i, (stage, reshard) in enumerate(
                zip(self._stages[1:], self._reshards)):
            with jax.named_scope(f"pfft_transpose{i}"):
                x = reshard(x, rank=int(pl[i + 1]))
            with jax.named_scope(f"pfft_stage{i + 1}"):
                x = stage(x, normalize)
                x = self._stage_pencils[i + 1].constrain(x,
                                                         rank=int(pl[i + 2]))
        x = self._pencil[1].constrain(x, rank=int(pl[-1]))
        return x

    # -- pipeline-form boundary conversion ----------------------------------
    @staticmethod
    def _to_planar(z):
        """Complex (traced or concrete) -> planar real."""
        return jnp.stack([jnp.real(z), jnp.imag(z)])

    def _from_planar(self, p):
        return lax.complex(p[0], p[1]).astype(self._out_dtype)

    def fn_p(self, x, normalize=None):
        """Pure jittable application in pipeline form: logically complex
        input/output travels as planar real (2,)+shape."""
        normalize = self._default_normalize if normalize is None else normalize
        return self._impl(x, normalize)

    def fn(self, x, normalize=None):
        """Pure jittable application (compose freely under jax.jit).

        Complex arrays are accepted and converted to and from the planar
        pipeline form inside the traced program."""
        normalize = self._default_normalize if normalize is None else normalize
        if self._host_mode:
            return self._impl_host(np.asarray(x), normalize)
        was_complex = jnp.asarray(x).dtype.kind == 'c'
        if self._planars[0] and was_complex:
            x = self._to_planar(x)
        y = self._impl(x, normalize)
        if self._planars[-1] and (was_complex or not self._planars[0]):
            y = self._from_planar(y)
        return y

    def _impl_host(self, y, normalize):
        y = self._stages[0](y, normalize)
        for stage in self._stages[1:]:
            y = stage(y, normalize)
        return y

    # -- reference-style properties ---------------------------------------
    @property
    def input_pencil(self):
        return self._pencil[0]

    @property
    def output_pencil(self):
        return self._pencil[1]

    @property
    def input_array(self):
        """Persistent input DistArray (reference: mpifft.py:26-29)."""
        if self._input_buffer is None:
            from ..distarray import DistArray
            self._input_buffer = DistArray(
                self._in_shape, subcomm=self._pencil[0].subcomm, val=0,
                dtype=self._in_dtype, alignment=self._pencil[0].axis,
                mesh=self._pencil[0].mesh)
        return self._input_buffer

    @property
    def output_array(self):
        """Persistent output DistArray (reference: mpifft.py:31-34)."""
        if self._output_buffer is None:
            from ..distarray import DistArray
            self._output_buffer = DistArray(
                self._out_shape, subcomm=self._pencil[1].subcomm, val=0,
                dtype=self._out_dtype, alignment=self._pencil[1].axis,
                mesh=self._pencil[1].mesh)
        return self._output_buffer

    # -- execution ---------------------------------------------------------
    def __call__(self, input_array=None, output_array=None, **kw):
        """Execute the transform (reference: mpifft.py:46-79).

        Unlike the reference there is no per-rank local view: input and
        output are *global* arrays (DistArray, numpy or jax).
        """
        from ..distarray import DistArray
        normalize = kw.pop('normalize', self._default_normalize)
        # planar=True: logically complex arrays travel as planar
        # (2,)+shape real JAX arrays on BOTH sides (the pipeline form of
        # :meth:`fn_p`).  Also taken automatically when the caller hands a
        # planar-shaped real array in.
        planar = kw.pop('planar', None)
        assert not (planar and self._host_mode), \
            "planar=True needs a device backend; host-mode plans " \
            "(numpy/scipy) take complex arrays directly"
        if input_array is not None and not self._host_mode:
            in_planar_shape = (2,) + self._in_shape if self._planars[0] \
                else self._in_shape
            if planar is None and self._planars[0] and \
                    tuple(np.shape(input_array)) == in_planar_shape and \
                    np.dtype(getattr(input_array, 'dtype',
                                     np.float64)).kind == 'f':
                planar = True
            if planar:
                assert tuple(np.shape(input_array)) == in_planar_shape, \
                    f"planar path expects shape {in_planar_shape}"
                x = input_array
                if not isinstance(x, jax.Array):
                    ind = np.dtype(self._in_dtype)
                    rdt = ind if ind.kind == 'f' else np.dtype(
                        'float32' if ind.itemsize == 8 else 'float64')
                    x = jnp.asarray(np.ascontiguousarray(
                        np.asarray(x, dtype=rdt)))
                x = jax.device_put(
                    x, self._pencil[0].boundary_sharding(
                        int(self._planars[0])))
                y = self._jit(x, bool(normalize))
                if output_array is None:
                    return y
                # a complex-typed output buffer gets the logical complex
                # values; a planar-shaped one the raw form
                if self._planars[-1] and \
                        tuple(np.shape(output_array)) != \
                        (2,) + self._out_shape:
                    y = self._from_planar(y)
                if isinstance(output_array, DistArray):
                    output_array._set_global(y)
                else:
                    output_array[...] = _host_value(y)
                return output_array
        if input_array is None:
            input_array = self.input_array
        if isinstance(input_array, DistArray):
            # padded at-rest storage (uneven extents) needs the true-shape
            # values (DistArray.__array__ is multi-process aware); evenly
            # sharded arrays, complex ones included, stay on the device
            x = np.asarray(input_array) \
                if (input_array.padded or self._host_mode) \
                else input_array._data
        else:
            x = np.asarray(input_array) if (
                self._host_mode or not hasattr(input_array, 'shape')) \
                else input_array
        assert tuple(x.shape) == self._in_shape, \
            f"input shape {tuple(x.shape)} != planned {self._in_shape}"

        if self._host_mode:
            y = np.asarray(x)
            y = self._impl_host(y, normalize)
            y = jnp.asarray(np.ascontiguousarray(y))
            y = jax.device_put(y, self._pencil[1].boundary_sharding())
        else:
            if isinstance(x, jax.Array):
                x = x if x.dtype == self._in_dtype \
                    else x.astype(self._in_dtype)
            else:
                x = np.asarray(x, dtype=self._in_dtype)
            x = jax.device_put(x, self._pencil[0].boundary_sharding())
            y = self._jit_io(x, bool(normalize))

        out = self.output_array
        out._set_global(y)
        if output_array is not None:
            if isinstance(output_array, DistArray):
                output_array._set_global(y)
            else:
                output_array[...] = _host_value(y)
            return output_array
        return out


def _axis_stage_list(axes, ndim, darray=None):
    """Turn the user's ``axes`` argument into the stage list the planner
    walks: a list of axis groups, one serial-transform stage each.

    Accepted spellings: ``None`` (every array axis, one stage per axis —
    when planning from a ``darray``, rotated so the array's aligned axis
    is transformed first), a bare int, a flat sequence of ints, or a
    nested sequence where an inner tuple keeps several axes together in
    one stage.  Negative indices wrap; duplicates within a group are
    rejected.  (Semantics of reference mpifft.py:213-240.)
    """
    if axes is None:
        order = list(range(ndim))
        if darray is not None:
            # transform the already-aligned axis in the first stage
            shift = ndim - 1 - darray.alignment
            order = order[-shift:] + order[:-shift] if shift else order
        return [[a] for a in order]
    entries = [axes] if isinstance(axes, int) else list(axes)
    stages = []
    for entry in entries:
        if isinstance(entry, (int, np.integer)):
            group = [int(entry)]
        else:
            if not isinstance(entry, (tuple, list)):
                raise AssertionError(
                    f"axes entry {entry!r}: expected an int or a "
                    "tuple/list of ints")
            group = [int(a) for a in entry]
        group = [a + ndim if a < 0 else a for a in group]
        for a in group:
            assert 0 <= a < ndim, f"axis {a} out of range for {ndim}-D data"
        assert 0 < len(group) <= ndim, f"bad axes group size {len(group)}"
        assert len(set(group)) == len(group), \
            f"axes group {group} repeats an axis"
        stages.append(group)
    return stages


class PFFT(object):
    """Parallel transform over a device mesh (reference: mpifft.py:82-419).

    Parameters follow the reference PFFT.  ``comm`` may be ``None`` (all
    devices), a :class:`DeviceComm`, a device list, or a prebuilt
    :class:`Subcomm`.  ``backend='jax'`` (default) fuses the whole pipeline
    into one XLA program; ``'numpy'``/``'scipy'`` run the same plan on host
    arrays for cross-validation.
    """

    def __init__(self, comm=None, shape=None, axes=None, dtype=float,
                 grid=None, padding=False, collapse=False, backend='jax',
                 transforms=None, darray=None, **kw):
        self._executor_req = kw.pop('executor', None)
        from . import overlap as _ov
        self._a2a_cfg = _ov.chunk_count(kw.pop('a2a_chunks', None))
        if shape is None:
            assert darray is not None
            shape = darray.pencil.shape

        axes = _axis_stage_list(axes, len(shape), darray)
        self.axes = axes
        shape = list(shape)

        if darray is None:
            dtype = np.dtype(dtype)
            assert dtype.char in 'fdFD', \
                f"dtype {dtype}: supported precisions are f32/f64 " \
                "(no long double)"

            # Dealiasing inflation: a padding factor > 1 on a single-axis
            # stage grows that axis of the PHYSICAL grid now, and the
            # factor is re-derived from the rounded extent so the 3/2-rule
            # truncation downstream is exact (reference: mpifft.py:247-253).
            if padding is not False:
                assert len(padding) == len(shape), \
                    "padding needs one factor per array axis"
                padding = list(padding)
                for group in axes:
                    if len(group) != 1:
                        continue
                    (a,) = group
                    if padding[a] > 1.0 + 1e-6:
                        unpadded = shape[a]
                        shape[a] = int(shape[a] * padding[a])  # floor
                        padding[a] = shape[a] / float(unpadded)

            self._input_shape = tuple(shape)
            assert shape and min(shape) > 0, f"bad global shape {shape}"

            slab = kw.pop('slab', False)

            # Device-grid selection (reference: mpifft.py:259-290).  The
            # mesh must leave every axis of the FIRST stage (= axes[-1],
            # transformed before any transpose) on a trivial device group.
            if grid is not None:
                assert not isinstance(comm, Subcomm), \
                    "grid= conflicts with a prebuilt Subcomm"
                assert slab is False, "grid= conflicts with slab="
                assert len(grid) <= len(shape)
                comm = Subcomm(comm, tuple(grid)
                               + (1,) * (len(shape) - len(grid)))

            if isinstance(comm, Subcomm):
                assert slab is False, "slab= conflicts with a Subcomm"
                assert len(comm) == len(shape)
                for a in axes[-1]:
                    assert comm[a].Get_size() == 1, \
                        f"Subcomm distributes axis {a}, which the plan " \
                        "transforms before any transpose"
                self.subcomm = comm
            else:
                if slab is False or slab is None:
                    # pencil default: wildcard everywhere except the
                    # first-stage axes, which get trivial groups
                    dims = [0 if i not in axes[-1] else 1
                            for i in range(len(shape))]
                else:
                    # slab: all devices on one chosen axis
                    if slab is True:
                        slab = (axes[-1][-1] + 1) % len(shape)
                    elif slab < 0:
                        slab += len(shape)
                    assert 0 <= slab < len(shape), f"bad slab axis {slab}"
                    dims = [1] * len(shape)
                    dims[slab] = 0
                self.subcomm = Subcomm(comm, dims)
        else:
            # plan derived from an existing DistArray: its decomposition
            # and dtype are authoritative (reference: mpifft.py:209-219)
            dtype = darray.dtype
            self.subcomm = darray.subcomm_tuple
            self._input_shape = tuple(shape)
            for a in axes[-1]:
                assert darray.commsizes[a] == 1, \
                    f"darray distributes axis {a}; pick axes= so the " \
                    "first-transformed group lies on its aligned axes"
            padding = False

        self._mesh = getattr(self.subcomm, 'mesh', None)
        if self._mesh is None and darray is not None:
            self._mesh = darray.pencil.mesh

        # Stage merging ("collapse"): walking back-to-front, any stage
        # whose axes all sit on trivial device groups needs no transpose
        # of its own — fold its axes onto the front of the stage that
        # follows it, so one serial transform covers both.  (Semantics of
        # reference mpifft.py:298-306.)
        self.collapse = collapse
        if collapse is True:
            merged = []
            for group in reversed(axes):
                free = all(self.subcomm[a].Get_size() == 1 for a in group)
                if free and merged:
                    merged[0][:0] = group
                else:
                    merged.insert(0, list(group))
            axes = [g for g in merged if g]

        self.axes = tuple(map(tuple, axes))
        self.xfftn = []
        self.transfer = []
        self.pencil = [None, None]
        self.backend = backend

        # Build the stage chain back-to-front (reference: mpifft.py:308-338):
        # the LAST axes group is transformed first (it is already aligned);
        # every earlier group costs one pencil rotation + one serial FFT.
        def serial_fft(cur_shape, group):
            return FFT(cur_shape, group, dtype, padding, backend=backend,
                       transforms=transforms, **kw)

        def spectral_fixup(xfftn, group, subcomm):
            """After a stage whose serial transform changes the global
            geometry (r2c halving, dealiasing truncation), the chain
            continues on the TRANSFORMED extents and dtype; returns the
            pencil the next rotation starts from, or None if nothing
            changed.  (Role of reference mpifft.py:319-322/332-335.)"""
            nonlocal shape, dtype
            out = xfftn.forward.output_array
            if shape[group[-1]] == out.shape[group[-1]]:
                return None
            dtype = out.dtype
            shape = list(out.shape)
            fixed = Pencil(subcomm, shape, group[-1])
            fixed.mesh = self._mesh
            return fixed

        first = self.axes[-1]
        cursor = Pencil(self.subcomm, shape, first[-1])
        cursor.mesh = self._mesh
        self.pencil[0] = cursor
        stage_in_pencils = [cursor]
        xfftn = serial_fft(shape, first)
        self.xfftn.append(xfftn)
        cursor = spectral_fixup(xfftn, first, self.subcomm) or cursor

        for group in reversed(self.axes[:-1]):
            rotated = cursor.pencil(group[-1])
            self.transfer.append(cursor.transfer(rotated, dtype))
            stage_in_pencils.append(rotated)
            xfftn = serial_fft(shape, group)
            self.xfftn.append(xfftn)
            cursor = spectral_fixup(xfftn, group, rotated.subcomm) or rotated

        self.pencil[1] = cursor
        self._output_shape = tuple(shape)
        self._stage_in_pencils = stage_in_pencils

        host_mode = backend in ('numpy', 'scipy', 'mkl_fft')
        in_dtype = self.xfftn[0].forward.input_array.dtype
        out_dtype = self.xfftn[-1].forward.output_array.dtype

        # ---- executor selection (multi-device production path) ----------
        # 'shard_map' writes the per-shard program with explicit tiled
        # lax.all_to_all transposes (deterministic collective placement);
        # 'gspmd' traces one global program and lets
        # GSPMD infer collectives from sharding constraints.  'auto' uses
        # shard_map whenever the mesh is multi-device, matching the single
        # production path of the reference (mpifft.py:308-347).
        executor = self._executor_req
        if executor is None:
            import os as _os
            executor = _os.environ.get('MPI4PY_FFT_JAX_EXECUTOR', 'auto')
        assert executor in ('auto', 'gspmd', 'shard_map'), executor
        nmesh = 1 if self._mesh is None else \
            int(np.prod(self._mesh.devices.shape))
        shmap_ok = (not host_mode) and nmesh > 1
        if executor == 'auto':
            executor = 'shard_map' if shmap_ok else 'gspmd'
        elif executor == 'shard_map' and not shmap_ok:
            executor = 'gspmd'
        self.executor = executor
        fwd_plan = bwd_plan = None
        if executor == 'shard_map':
            fwd_plan, bwd_plan = self._build_shmap_plans()

        if host_mode:
            fwd_stages = [o.forward_fn for o in self.xfftn]
            bck_stages = [o.backward_fn for o in self.xfftn[::-1]]
            fwd_planars = bck_planars = None
        else:
            # the jax backend fuses the PLANAR stage functions: logically
            # complex stage data is real (2,)+shape between stages
            fwd_stages = [o.forward_fn_p for o in self.xfftn]
            bck_stages = [o.backward_fn_p for o in self.xfftn[::-1]]
            fwd_planars = [self.xfftn[0].input_planar] + \
                [o.output_planar for o in self.xfftn]
            bck_planars = [self.xfftn[-1].output_planar] + \
                [o.input_planar for o in self.xfftn[::-1]]
        fwd_reshards = [t.forward_fn for t in self.transfer]
        self.forward = Transform(
            self, fwd_stages, fwd_reshards, self.pencil,
            self._input_shape, in_dtype, self._output_shape, out_dtype,
            default_normalize=True, host_mode=host_mode,
            planars=fwd_planars, executor=executor, shmap_plan=fwd_plan)

        # backward reshards: undo each forward rotation, in reverse order
        bck_reshards = [t.backward_fn for t in self.transfer[::-1]]
        self.backward = Transform(
            self, bck_stages, bck_reshards, self.pencil[::-1],
            self._output_shape, out_dtype, self._input_shape, in_dtype,
            default_normalize=False, host_mode=host_mode,
            planars=bck_planars, executor=executor, shmap_plan=bwd_plan)

    # ---- shard_map executor plan ----------------------------------------
    def _build_shmap_plans(self):
        """Static per-shard execution plans for both directions.

        Per-axis padded extents: every axis is rounded up to the lcm of
        every device-group size that shards it anywhere in the pencil
        chain, so uniform per-shard programs and pure tiled all_to_all
        transposes cover non-divisible (reference 12/13-style) extents
        too.  Pad rows are exact zeros at the tail; each stage slices its
        aligned transform axes back to the true extent first, so the math
        is exact.  Equal to the true extents for all production
        (power-of-two) shapes."""
        ndim = len(self._input_shape)
        qs = [1] * ndim
        pens = list(self.pencil) + list(self._stage_in_pencils)
        for t in self.transfer:
            pens += [t.pencilA, t.pencilB]
        for pen in pens:
            for j, c in enumerate(pen.subcomm):
                qs[j] = int(np.lcm(qs[j], c.Get_size()))
        self._axis_lcm = tuple(qs)

        def padded(shape):
            return tuple(-(-int(n) // q) * q for n, q in zip(shape, qs))

        def stage_plan(objs, attr):
            slices, pads = [], []
            for o in objs:
                wrap = getattr(o, attr)       # .forward or .backward
                tin = tuple(wrap.input_array.shape)
                tout = tuple(wrap.output_array.shape)
                pin, pout = padded(tin), padded(tout)
                slices.append(tuple((ax, tin[ax]) for ax in o.axes
                                    if pin[ax] != tin[ax]))
                pads.append(tuple((ax, pout[ax]) for ax in o.axes
                                  if pout[ax] != tout[ax]))
            return slices, pads

        fwd_slices, fwd_pads = stage_plan(self.xfftn, 'forward')
        bck_slices, bck_pads = stage_plan(self.xfftn[::-1], 'backward')

        def with_chunk_axes(a2a, objs):
            # chunk-axis candidates for the overlapped transpose: axes
            # that participate in neither the all_to_all nor the stage
            # that consumes it (parallel/overlap.py)
            out = []
            for i, (g, axA, axB) in enumerate(a2a):
                used = {axA, axB} | set(objs[i + 1].axes)
                cands = tuple(c for c in range(ndim) if c not in used)
                out.append((g, axA, axB, cands))
            return out

        fwd_a2a = [(t.pencilA.subcomm[t.pencilB.axis].name,
                    t.pencilA.axis, t.pencilB.axis) for t in self.transfer]
        bwd_a2a = [(g, axB, axA) for (g, axA, axB) in reversed(fwd_a2a)]
        fwd_a2a = with_chunk_axes(fwd_a2a, self.xfftn)
        bwd_a2a = with_chunk_axes(bwd_a2a, self.xfftn[::-1])
        fwd_plan = dict(mesh=self._mesh,
                        in_pad=padded(self._input_shape),
                        out_true=self._output_shape,
                        slices=fwd_slices, pads=fwd_pads, a2a=fwd_a2a)
        bwd_plan = dict(mesh=self._mesh,
                        in_pad=padded(self._output_shape),
                        out_true=self._input_shape,
                        slices=bck_slices, pads=bck_pads, a2a=bwd_a2a)
        return fwd_plan, bwd_plan

    # ---- reference API (reference: mpifft.py:349-419) -------------------
    def destroy(self):
        if isinstance(self.subcomm, Subcomm):
            self.subcomm.destroy()
        for trans in self.transfer:
            trans.destroy()

    def shape(self, forward_output=True):
        """Global shape of the transform data.

        Note: the reference returns the *per-rank local* shape
        (mpifft.py:355-366); under the single-controller global-view model
        users allocate global arrays, so the global shape is returned.  Use
        :meth:`local_shape` for per-device shard shapes.
        """
        if forward_output is not True:
            return self._input_shape
        return self._output_shape

    def local_shape(self, forward_output=True, device_index=0):
        """Per-device shard shape (the reference's ``shape``)."""
        p = self.pencil[1] if forward_output else self.pencil[0]
        return p.local_shape(device_index)

    def local_slice(self, forward_output=True, device_index=0):
        """The view of one device's shard into the global array
        (reference: mpifft.py:368-386)."""
        ip = self.pencil[1] if forward_output else self.pencil[0]
        return tuple(slice(start, start + n) for start, n in
                     zip(ip.local_start(device_index),
                         ip.local_shape(device_index)))

    def global_shape(self, forward_output=False):
        """Reference: mpifft.py:388-400."""
        if forward_output:
            return self._output_shape
        return self._input_shape

    @property
    def dimensions(self):
        """Reference: mpifft.py:402-405."""
        return len(self._input_shape)

    def dtype(self, forward_output=False):
        """Reference: mpifft.py:407-419."""
        if forward_output:
            return self.xfftn[-1].forward.output_array.dtype
        return self.xfftn[0].forward.input_array.dtype
