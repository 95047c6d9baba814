"""PFFT integration sweep.

Port of the reference L3 strategy (reference: tests/test_mpifft.py):
dims 2-4 x shapes {12,13}^d x dtypes x slab/pencil grids x collapse x many
axes specs including collapsed groups; structural invariants; round-trips
with per-dtype tolerances; padding round-trips in spectral space; mixed
DCT/DST r2r transform.
"""
import functools
from itertools import product

import numpy as np
import pytest

from mpi4py_fft_jax import PFFT, newDistArray, fftw
from mpi4py_fft_jax.parallel import Subcomm

abstol = dict(f=0.1, d=2e-10)


def allclose(a, b):
    atol = abstol[np.dtype(a.dtype).char.lower()]
    return np.allclose(a, b, rtol=0, atol=atol)


def _roundtrip(fft, seed=0):
    rng = np.random.default_rng(seed)
    u = newDistArray(fft, forward_output=False)
    shape = u.shape
    if np.dtype(u.dtype).kind == 'c':
        u[:] = (rng.random(shape) + 1j * rng.random(shape)).astype(u.dtype)
    else:
        u[:] = rng.random(shape).astype(u.dtype)
    X = np.asarray(u).copy()
    u_hat = fft.forward(u)
    uj = newDistArray(fft, forward_output=False)
    uj = fft.backward(u_hat, uj)
    assert allclose(np.asarray(uj), X), \
        np.abs(np.asarray(uj) - X).max()
    return u, u_hat


@pytest.mark.parametrize("typecode", 'fdFD')
@pytest.mark.parametrize("dim", (2, 3))
def test_mpifft_roundtrip(typecode, dim):
    # real 2-D transforms need the halved axis N//2+1 >= 8 devices after the
    # slab transpose (constraint shape[i] >= group size, reference
    # pencil.py:298 — the reference CI runs at most 4 ranks)
    sizes = (18, 19) if (dim == 2 and typecode in 'fd') else (12, 13)
    for shape in product(*([sizes] * dim)):
        for axes in [None, tuple(range(dim)), tuple(reversed(range(dim)))]:
            fft = PFFT(None, shape, axes=axes, dtype=typecode)
            _roundtrip(fft)
            fft.destroy()


def test_mpifft_4d_collapse():
    shape = (12, 13, 12, 13)
    fft = PFFT(None, shape, dtype='d', grid=(2, 4), collapse=True)
    assert len(fft.axes) < 4  # collapsing happened
    _roundtrip(fft)
    fft.destroy()


# the reference dim-4 axes window (reference: tests/test_mpifft.py:93-96)
_AXES_4D = [None,
            ((0,), (1,), (2,), (3,)),
            ((0,), (1, 2, 3)),
            ((0,), (1,), (2, 3))]


@pytest.mark.parametrize("typecode", 'dD')
@pytest.mark.parametrize("axes", _AXES_4D,
                         ids=['none', 'g1111', 'g13', 'g112'])
def test_mpifft_4d_sweep(typecode, axes):
    """Dim-4 sweep with collapsed-group axes specs over {12,13}^4 shapes,
    slab and pencil grids, collapse on/off (reference breadth:
    tests/test_mpifft.py:53-137).  The slab grid is complex-only on the
    8-device mesh: an r2c-halved {12,13} axis (extent 7) cannot carry an
    8-device group (constraint shape[i] >= group size, the reference caps
    its own sweep below 8 ranks for the same reason,
    reference tests/test_mpifft.py:60)."""
    grids = [None] if typecode == 'd' else [None, (-1,)]
    if typecode == 'd' and axes == ((0,), (1, 2, 3)):
        # two groups -> all 8 devices in one group, which the pencil
        # rotation swaps onto the r2c-halved extent-7 axis: same
        # geometric limit as the slab case above
        pytest.skip("halved axis cannot carry an 8-device group")
    for shape in [(12, 13, 12, 13), (13, 12, 13, 12)]:
        for grid in grids:
            for collapse in (False, True):
                fft = PFFT(None, shape, axes=axes, dtype=typecode,
                           grid=grid, collapse=collapse)
                _roundtrip(fft)
                fft.destroy()


def test_mpifft_4d_r2r_transforms():
    """4-D with custom r2r transforms dicts on trailing groups
    (reference: tests/test_mpifft.py:98-110 DCT-III cases)."""
    dctn = functools.partial(fftw.dctn, type=3)
    idctn = functools.partial(fftw.idctn, type=3)
    shape = (12, 13, 12, 13)
    for axes, tkey in [(((0,), (1,), (2,), (3,)), (3,)),
                       (((0,), (1,), (2, 3)), (2, 3)),
                       (((0,), (1, 2, 3)), (1, 2, 3))]:
        transforms = {tkey: (dctn, idctn)}
        fft = PFFT(None, shape, axes=axes, dtype='d',
                   transforms=transforms)
        _roundtrip(fft)
        fft.destroy()


@pytest.mark.parametrize("grid", [(-1,), (2, 2), (1, -1), (2, 2, 1)])
def test_mpifft_grids(grid):
    # extents chosen so every pencil in the chain satisfies extent >=
    # device-group size on 8 devices (incl. the halved r2c axis)
    shape = (16, 18, 16)
    fft = PFFT(None, shape, grid=grid, dtype='d')
    u, u_hat = _roundtrip(fft)
    ref = np.fft.rfftn(np.asarray(u)) / np.prod(shape)
    assert allclose(np.asarray(u_hat), ref.astype(u_hat.dtype))
    fft.destroy()


def test_mpifft_vs_numpy():
    """Forward output matches the numpy reference bit-for-tolerance
    (reference checks structural invariants + roundtrips; we additionally
    anchor against numpy since the global array is directly comparable)."""
    shape = (12, 13, 15)
    fft = PFFT(None, shape, dtype='D')
    rng = np.random.default_rng(5)
    u = newDistArray(fft, False)
    u[:] = rng.random(shape) + 1j * rng.random(shape)
    u_hat = fft.forward(u)
    ref = np.fft.fftn(np.asarray(u)) / np.prod(shape)
    assert allclose(np.asarray(u_hat), ref)


def test_mpifft_structural():
    """Structural invariants (reference: tests/test_mpifft.py:144-164)."""
    shape = (17, 16, 15)
    fft = PFFT(None, shape, dtype='d')
    # aligned axis of the first (input) pencil is the first transformed axis
    assert fft.pencil[0].axis == fft.axes[-1][-1]
    # output pencil aligned with last transformed group's axis
    assert fft.pencil[1].axis == fft.axes[0][-1]
    # substart of aligned axes is 0 on every device
    ndev_in = int(np.prod([c.Get_size() for c in fft.pencil[0].subcomm]))
    for d in range(ndev_in):
        assert fft.pencil[0].local_start(d)[fft.pencil[0].axis] == 0
        assert fft.pencil[1].local_start(d)[fft.pencil[1].axis] == 0
    # shapes
    assert fft.global_shape(False) == shape
    out = fft.global_shape(True)
    assert out[fft.axes[-1][-1]] == shape[fft.axes[-1][-1]] // 2 + 1
    assert fft.dimensions == 3
    assert fft.dtype(False) == np.dtype('d')
    assert fft.dtype(True) == np.dtype('D')
    # local slices tile the global domain exactly once
    ndev = np.prod([c.Get_size() for c in fft.pencil[0].subcomm])
    cover = np.zeros(shape, dtype=int)
    for dev in range(int(ndev)):
        sl = fft.local_slice(False, device_index=dev)
        cover[sl] += 1
    assert np.all(cover == 1)


def test_mpifft_slab_kw():
    fft = PFFT(None, (16, 16, 16), slab=True, dtype='d')
    _roundtrip(fft)
    fft.destroy()


def test_mpifft_subcomm_input():
    sub = Subcomm(None, [0, 0, 1])
    fft = PFFT(sub, (16, 14, 12), dtype='d')
    _roundtrip(fft)


@pytest.mark.parametrize("typecode", 'fd')
def test_mpifft_padding(typecode):
    """Padding round-trip in spectral space
    (reference: tests/test_mpifft.py:181-253)."""
    rng = np.random.default_rng(9)
    shape = (16, 16, 16)
    for pad in (1.5, 2.0):
        fft = PFFT(None, shape, padding=[pad] * 3, dtype=typecode)
        u_hat = newDistArray(fft, forward_output=True)
        sh = u_hat.shape
        u_hat[:] = (rng.random(sh) + 1j * rng.random(sh)).astype(u_hat.dtype)
        up = fft.backward(u_hat)
        u_hat2 = fft.forward(up)
        up2 = fft.backward(u_hat2)
        u_hat3 = fft.forward(up2)
        assert allclose(np.asarray(u_hat3), np.asarray(u_hat2))
        fft.destroy()


def test_mpifft_r2r():
    """Mixed DCT/DST parallel transform via transforms dict
    (reference: tests/test_mpifft.py:35-51 test_r2r).  r2r groups run
    before the (default rfftn) group, exactly like the reference config;
    extents scaled so the slab axis holds 8 devices."""
    N = (9, 10, 11, 12, 13)
    dctn = functools.partial(fftw.dctn, type=3)
    idctn = functools.partial(fftw.idctn, type=3)
    dstn = functools.partial(fftw.dstn, type=3)
    idstn = functools.partial(fftw.idstn, type=3)
    r2r = PFFT(None, N, axes=((0,), (1, 2), (3, 4)), grid=(-1,),
               transforms={(1, 2): (dctn, idctn), (3, 4): (dstn, idstn)})
    u = newDistArray(r2r, False)
    rng = np.random.default_rng(13)
    u[:] = rng.random(u.shape)
    X = np.asarray(u).copy()
    u_hat = r2r.forward(u)
    uj = r2r.backward(u_hat)
    assert np.allclose(np.asarray(uj), X, atol=1e-10)
    r2r.destroy()


def _assert_complex_free(fft):
    """Lower both pipeline directions and assert no complex-typed HLO
    (property of the matmul engine, which computes every stage in planar
    real arithmetic — see ops/matfft.py)."""
    import jax
    for tr in (fft.forward, fft.backward):
        rdtype = np.zeros(0, dtype=tr._in_dtype).real.dtype
        shape = ((2,) + tr._in_shape) if tr._planars[0] else tr._in_shape
        x = jax.ShapeDtypeStruct(shape, rdtype)
        txt = jax.jit(lambda v, tr=tr: tr.fn_p(v)).lower(x).as_text()
        assert 'complex<' not in txt, "complex HLO leaked into the pipeline"


def test_mpifft_complex_free_hlo(matmul_engine):
    """On the matmul engine every API feature of PFFT(backend='jax') —
    c2c, r2c, grids, collapse groups, padding, custom r2r transforms —
    lowers to complex-free HLO (role of the reference's single FFTW
    executor, mpifft.py:202-347)."""
    dctn = functools.partial(fftw.dctn, type=3)
    idctn = functools.partial(fftw.idctn, type=3)
    configs = [
        dict(shape=(12, 13, 15), dtype='D'),                     # c2c
        dict(shape=(16, 18, 16), dtype='d', grid=(2, 2)),        # r2c pencil
        dict(shape=(12, 13, 12, 13), dtype='d', grid=(2, 4),
             collapse=True),                                     # collapse
        dict(shape=(16, 16, 16), dtype='f', padding=[1.5] * 3),  # dealias
        dict(shape=(9, 10, 11, 12, 13), dtype='d', grid=(-1,),
             axes=((0,), (1, 2), (3, 4)),
             transforms={(1, 2): (dctn, idctn),
                         (3, 4): (dctn, idctn)}),                # r2r dict
    ]
    for cfg in configs:
        shape = cfg.pop('shape')
        fft = PFFT(None, shape, **cfg)
        _assert_complex_free(fft)
        fft.destroy()


def test_mpifft_fn_p_matches_call():
    """The pure pipeline-form path produces the same numbers as the
    buffer-style call (planar carrying the logical complex data)."""
    import jax
    shape = (12, 14, 16)
    fft = PFFT(None, shape, dtype='d')
    rng = np.random.default_rng(3)
    u = rng.random(shape)
    u_hat = np.asarray(fft.forward(u))
    p_hat = np.asarray(jax.jit(fft.forward.fn_p)(u))
    assert allclose(p_hat[0] + 1j * p_hat[1], u_hat)
    # backward from planar form
    back = np.asarray(jax.jit(fft.backward.fn_p)(p_hat))
    assert allclose(back, u)


def test_mpifft_normalize_kw():
    shape = (8, 8)
    fft = PFFT(None, shape, dtype='D')
    rng = np.random.default_rng(17)
    u = newDistArray(fft, False)
    u[:] = rng.random(shape) + 0j
    un = fft.forward(u, normalize=False)
    ref = np.fft.fftn(np.asarray(u))
    assert allclose(np.asarray(un), ref)


def test_mpifft_planar_device_path():
    """Transform.__call__(planar=True) — and auto-detected planar-shaped
    input — skip the host round-trip and match the classic complex
    buffer path (role of the reference's zero-copy planned buffers,
    fftw_xfftn.pyx:237-249)."""
    import jax
    import jax.numpy as jnp
    shape = (16, 16, 16)
    fft = PFFT(None, shape, dtype='D')
    rng = np.random.default_rng(23)
    z = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype('complex128')
    ref = np.asarray(fft.forward(z))
    zp = jnp.asarray(np.stack([z.real, z.imag]))
    y = fft.forward(zp, planar=True)
    assert isinstance(y, jax.Array)              # no host conversion
    yh = np.asarray(y)
    assert allclose(yh[0] + 1j * yh[1], ref)
    # auto-detection: a (2,)+shape array takes the planar path too
    y2 = fft.forward(np.stack([z.real, z.imag]))
    y2h = np.asarray(y2)
    assert allclose(y2h[0] + 1j * y2h[1], ref)
    # and backward accepts the planar spectrum directly
    b = fft.backward(y, planar=True)
    bh = np.asarray(b)
    assert allclose(bh[0] + 1j * bh[1], z)
