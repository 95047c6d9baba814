"""DistArray tests.

Port of the reference L4 strategy (reference: tests/test_darray.py):
construction for rank 0/1/2 tensors over subcomm variants, properties,
global-slice access, redistribution round-trips conserving the global L2
norm, and newDistArray view/rank matrix with PFFT-from-darray.
"""
import numpy as np
import jax

from mpi4py_fft_jax import DistArray, newDistArray, PFFT
from mpi4py_fft_jax.parallel import Subcomm

NDEV = None


def setup_module(module):
    global NDEV
    NDEV = len(jax.devices())


def test_1Darray():
    N = (8,)
    z = DistArray(N, val=2)
    assert z[0] == 2
    assert z.shape == N


def test_2Darray():
    N = (8, 8)
    for subcomm in ((0, 1), (1, 0), None, Subcomm(None, (0, 1))):
        for rank in (0, 1, 2):
            M = (2,) * rank + N
            alignment = None
            if subcomm is None and rank == 1:
                alignment = 1
            a = DistArray(M, subcomm=subcomm, val=1, rank=rank,
                          alignment=alignment)
            assert a.rank == rank
            assert a.global_shape == M
            _ = a.substart
            z = a.commsizes
            _ = a.pencil
            assert np.prod(np.array(z)) == NDEV
            if rank > 0:
                a0 = a[0]
                assert isinstance(a0, DistArray)
                assert a0.rank == rank - 1
            aa = a.v
            assert isinstance(aa, jax.Array)

            k = a.get((0,) * rank + (0, slice(None)))
            assert len(k) == N[1]
            assert np.sum(k) == N[1]
            k = a.get((0,) * rank + (slice(None), 0))
            assert len(k) == N[0]
            assert np.sum(k) == N[0]

            _ = a.local_slice()
            newaxis = (a.alignment + 1) % 2
            _, t = a.get_pencil_and_transfer(newaxis)
            a[:] = 3.0
            b = a.redistribute(newaxis)
            a = b.redistribute(out=a)
            a = b.redistribute(a.alignment, out=a)
            s0 = np.linalg.norm(np.asarray(a)) ** 2
            s1 = np.linalg.norm(np.asarray(b)) ** 2
            assert abs(s0 - s1) < 1e-1
            c = a.redistribute(a.alignment)
            assert c is a
            t.destroy()


def test_3Darray():
    N = (8, 8, 8)
    for subcomm in ((0, 0, 1), (0, 1, 0), (1, 0, 0), (0, 1, 1),
                    (1, 0, 1), (1, 1, 0), None, Subcomm(None, (0, 0, 1))):
        for rank in (0, 1, 2):
            M = (3,) * rank + N
            alignment = None
            if subcomm is None and rank == 1:
                alignment = 2
            a = DistArray(M, subcomm=subcomm, val=1, rank=rank,
                          alignment=alignment)
            assert a.rank == rank
            assert a.global_shape == M
            _ = a.substart
            z = a.commsizes
            assert np.prod(np.array(z)) == NDEV
            if rank > 0:
                a0 = a[0]
                assert isinstance(a0, DistArray)
                assert a0.rank == rank - 1
            if rank == 2:
                a0 = a[0, 1]
                assert isinstance(a0, DistArray)
                assert a0.rank == 0
            aa = a.v
            assert isinstance(aa, jax.Array)

            k = a.get((0,) * rank + (0, 0, slice(None)))
            assert len(k) == N[2]
            assert np.sum(k) == N[2]

            _ = a.local_slice()
            newaxis = (a.alignment + 1) % 3
            _, t = a.get_pencil_and_transfer(newaxis)
            a[:] = 2.0
            b = a.redistribute(newaxis)
            a = b.redistribute(out=a)
            s0 = np.linalg.norm(np.asarray(a)) ** 2
            s1 = np.linalg.norm(np.asarray(b)) ** 2
            assert abs(s0 - s1) < 1e-1
            t.destroy()


def test_redistribute_values():
    """Redistribution must preserve values element-for-element, and the
    output must really be sharded along the new alignment."""
    rng = np.random.default_rng(0)
    a = DistArray((8, 12, 16), alignment=0, dtype='d')
    X = rng.random(a.shape)
    a[:] = X
    for ax in (1, 2, 0):
        a = a.redistribute(ax)
        assert a.alignment == ax
        assert np.allclose(np.asarray(a), X)


def _assert_truly_distributed(a, X):
    """Every device must hold EXACTLY its reference block of ``X``
    (blockdist semantics, reference pencil.py:5-9) — uneven extents are
    padded at rest, never silently replicated."""
    from mpi4py_fft_jax.parallel.pencil import blockdist
    p = a.pencil
    devlist = list(p.mesh.devices.flat)
    rank = a.rank
    for shard in a.v.addressable_shards:
        d = devlist.index(shard.device)
        # physical storage: the padded ceil-div block — per-axis extent
        # must be the padded quotient, NOT the full (replicated) extent
        got = np.asarray(shard.data)
        for i, c in enumerate(p.subcomm):
            q = -(-p.shape[i] // c.size)  # ceil
            assert got.shape[rank + i] == q, \
                (i, got.shape, q, "axis replicated instead of distributed")
        # valid part == the reference block of the true global array
        sl = [slice(None)] * rank
        for i in range(len(p.shape)):
            n, s = blockdist(p.shape[i], p.subcomm[i].size,
                             p._axis_coord(i, d))
            q = -(-p.shape[i] // p.subcomm[i].size)
            sl.append(slice(0, n))
        want = X[tuple([slice(None)] * rank) +
                 tuple(a.local_slice(d)[rank:])]
        assert np.array_equal(got[tuple(sl)], want)


def test_uneven_extents_distributed():
    """DistArray((12,13,14)) on 8 devices must actually distribute the
    13-extent axis (the reference distributes any N over any p,
    pencil.py:5-9); metadata (local_slice/local_shape) must agree with
    the real storage."""
    rng = np.random.default_rng(4)
    for rank in (0, 1):
        shape = (2,) * rank + (12, 13, 14)
        a = DistArray(shape, alignment=0, dtype='d', rank=rank)
        X = rng.random(shape)
        a[...] = X
        assert np.allclose(np.asarray(a), X)
        _assert_truly_distributed(a, X)
        # local_shape sums to the true extent along each distributed axis
        p = a.pencil
        for i, c in enumerate(p.subcomm):
            if c.size > 1:
                tot = 0
                seen = set()
                for d in range(len(list(p.mesh.devices.flat))):
                    r = p._axis_coord(i, d)
                    if r not in seen:
                        seen.add(r)
                        tot += p.local_shape(d)[i]
                assert tot == p.shape[i]


def test_uneven_redistribute_moves_data():
    """Redistribution of an unevenly-extent array must land every block on
    its new owner (content-checked per device)."""
    rng = np.random.default_rng(5)
    a = DistArray((12, 13, 14), alignment=0, dtype='d')
    X = rng.random((12, 13, 14))
    a[...] = X
    for ax in (1, 2, 0):
        a = a.redistribute(ax)
        assert a.alignment == ax
        assert np.allclose(np.asarray(a), X)
        _assert_truly_distributed(a, X)


def test_newDistArray():
    N = (8, 8, 8)
    pfft = PFFT(None, N)
    for forward_output in (True, False):
        for view in (True, False):
            for rank in (0, 1, 2):
                a = newDistArray(pfft, forward_output=forward_output,
                                 rank=rank, view=view)
                if view is False:
                    assert isinstance(a, DistArray)
                    assert a.rank == rank
                    if rank == 0:
                        qfft = PFFT(None, darray=a)
                    elif rank == 1:
                        qfft = PFFT(None, darray=a[0])
                    else:
                        qfft = PFFT(None, darray=a[0, 0])
                    qfft.destroy()
                else:
                    assert isinstance(a, jax.Array)
    pfft.destroy()


def test_setitem_getitem():
    a = DistArray((8, 8), alignment=0, dtype='d', val=0)
    a[2, 3] = 5.0
    assert np.asarray(a)[2, 3] == 5.0
    a[...] = 1.0
    assert np.all(np.asarray(a) == 1.0)
    row = a[2]
    assert row.shape == (8,)


def test_arithmetic():
    a = DistArray((8, 8), alignment=0, dtype='d', val=2)
    b = DistArray((8, 8), alignment=0, dtype='d', val=3)
    c = a + b
    assert isinstance(c, DistArray)
    assert np.all(np.asarray(c) == 5)
    d = 2 * a - b / 3 + a ** 2
    assert np.allclose(np.asarray(d), 4 - 1 + 4)
