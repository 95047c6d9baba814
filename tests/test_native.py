"""Native host-staging engine (_hoststage C++ extension).

The native pack/unpack engine is the host-side counterpart of the
reference's MPI subarray datatypes (reference: pencil.py:12-29); it is
wired into DistArray._embed / addressable_blocks and utils.aligned.
These tests assert the native path is BIT-EXACT against the numpy
fallback on the same inputs.
"""
import numpy as np
import pytest

from mpi4py_fft_jax import DistArray
from mpi4py_fft_jax.utils import aligned, get_alignment
from mpi4py_fft_jax.utils import native


requires_native = pytest.mark.skipif(
    not native.HAVE_NATIVE, reason="_hoststage extension not built")


@requires_native
@pytest.mark.parametrize("dtype", ['f', 'd', 'i8', 'c16'])
def test_pack_unpack_bit_exact(dtype):
    rng = np.random.default_rng(0)
    for shape, starts, subsizes in [
            ((5, 7, 9), (1, 2, 3), (3, 4, 5)),
            ((8, 8), (0, 0), (8, 8)),
            ((13,), (5,), (7,)),
            ((4, 6, 2, 3), (1, 0, 1, 0), (2, 6, 1, 3))]:
        if np.dtype(dtype).kind == 'c':
            full = (rng.random(shape) + 1j * rng.random(shape)).astype(dtype)
        else:
            full = (rng.random(shape) * 100).astype(dtype)
        sl = tuple(slice(s, s + n) for s, n in zip(starts, subsizes))
        got = native.pack_block(full, starts, subsizes)
        ref = full[sl]
        assert got.dtype == ref.dtype
        assert np.array_equal(
            got.view(np.uint8), np.ascontiguousarray(ref).view(np.uint8))
        # unpack scatters back bit-exactly
        dst = np.zeros_like(full)
        native.unpack_block(dst, starts, subsizes, got)
        ref2 = np.zeros_like(full)
        ref2[sl] = ref
        assert np.array_equal(dst.view(np.uint8), ref2.view(np.uint8))


@requires_native
def test_pack_block_bounds():
    full = np.zeros((4, 5))
    with pytest.raises(ValueError):
        native.pack_block(full, (2, 0), (3, 5))     # 2+3 > 4
    with pytest.raises(ValueError):
        native.pack_block(full, (-1, 0), (1, 5))


@requires_native
def test_aligned_native_alignment():
    for align in (64, 128, 256):
        a = native.aligned_native((7, 11), dtype='d', alignment=align)
        assert a.__array_interface__['data'][0] % align == 0
        a[...] = 3.0
        assert np.all(a == 3.0)
    # the public aligned() rides the native allocator when built
    b = aligned((5, 6), n=32, dtype='f', fill=2)
    assert get_alignment(b) == 32
    assert np.all(b == 2)


@requires_native
def test_native_vs_numpy_paths_agree(monkeypatch):
    """DistArray staging through the native engine equals the numpy
    fallback bit-for-bit (padded at-rest storage + hyperslab blocks)."""
    rng = np.random.default_rng(1)
    val = rng.random((12, 13, 14))

    def snapshot():
        u = DistArray((12, 13, 14), dtype='d', alignment=0)
        u[:] = val
        blocks = [(sl, np.asarray(b).copy())
                  for sl, b in u.addressable_blocks()]
        return np.asarray(u).copy(), blocks

    arr_nat, blocks_nat = snapshot()
    monkeypatch.setattr(native, 'HAVE_NATIVE', False)
    arr_np, blocks_np = snapshot()

    assert np.array_equal(arr_nat.view(np.uint8), arr_np.view(np.uint8))
    assert len(blocks_nat) == len(blocks_np)
    for (sa, ba), (sb, bb) in zip(blocks_nat, blocks_np):
        assert sa == sb
        assert np.array_equal(np.ascontiguousarray(ba).view(np.uint8),
                              np.ascontiguousarray(bb).view(np.uint8))
