/* Host staging runtime: aligned allocation + bit-exact block pack/unpack.
 *
 * Native counterpart of two pieces of the reference stack:
 *  - the SIMD-aligned allocator in mpi4py_fft/fftw/utilities.pyx:54-84
 *    (here: posix_memalign-backed, so host->device DMA starts from aligned
 *    pages), and
 *  - the MPI subarray-datatype pack/unpack engine used by
 *    mpi4py_fft/pencil.py:12-29 via Alltoallw (here: an explicit strided
 *    block copier used for host-side staging of pencil blocks in IO and
 *    checkpoint paths; the device-side transpose runs as an XLA collective and
 *    never touches this code).
 *
 * Exposed as the `_hoststage` CPython extension:
 *    aligned_empty(nbytes, alignment) -> memoryview (over aligned storage)
 *    pack_blocks(src, dst, itemsize, shape, strides, starts, subsizes)
 *    unpack_blocks(dst, src, itemsize, shape, strides, starts, subsizes)
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <vector>

namespace {

struct AlignedBuf {
    void *ptr;
    Py_ssize_t size;
};

void aligned_capsule_destructor(PyObject *capsule) {
    void *p = PyCapsule_GetPointer(capsule, "hoststage.aligned");
    if (p) std::free(p);
}

PyObject *aligned_empty(PyObject *, PyObject *args) {
    Py_ssize_t nbytes;
    Py_ssize_t alignment = 128;  /* 32 f32 elements */
    if (!PyArg_ParseTuple(args, "n|n", &nbytes, &alignment)) return nullptr;
    if (alignment < 8 || (alignment & (alignment - 1))) {
        PyErr_SetString(PyExc_ValueError, "alignment must be a power of two >= 8");
        return nullptr;
    }
    void *p = nullptr;
    if (posix_memalign(&p, (size_t)alignment, (size_t)(nbytes > 0 ? nbytes : 1))) {
        return PyErr_NoMemory();
    }
    PyObject *cap = PyCapsule_New(p, "hoststage.aligned",
                                  aligned_capsule_destructor);
    if (!cap) { std::free(p); return nullptr; }
    PyObject *mv = PyMemoryView_FromMemory((char *)p, nbytes, PyBUF_WRITE);
    if (!mv) { Py_DECREF(cap); return nullptr; }
    PyObject *out = PyTuple_Pack(2, mv, cap);
    Py_DECREF(mv);
    Py_DECREF(cap);
    return out;
}

/* Copy one n-d subarray block between a strided source view and a packed
 * contiguous destination (pack=true) or back (pack=false).  Innermost
 * contiguous runs go through memcpy. */
void copy_block(char *full, char *packed, int ndim, Py_ssize_t itemsize,
                const Py_ssize_t *shape, const Py_ssize_t *strides,
                const Py_ssize_t *starts, const Py_ssize_t *subsizes,
                bool pack) {
    (void)shape;
    /* compute the innermost contiguous run length */
    Py_ssize_t run = subsizes[ndim - 1] * itemsize;
    bool inner_contig = (strides[ndim - 1] == itemsize);
    if (!inner_contig) run = itemsize;

    std::vector<Py_ssize_t> idx(ndim, 0);
    const int last = inner_contig ? ndim - 1 : ndim;
    for (;;) {
        /* source offset of the current run */
        Py_ssize_t off = 0;
        for (int d = 0; d < ndim; ++d)
            off += (starts[d] + idx[d]) * strides[d];
        if (pack) std::memcpy(packed, full + off, (size_t)run);
        else      std::memcpy(full + off, packed, (size_t)run);
        packed += run;
        /* odometer over the non-run dimensions */
        int d = last - 1;
        for (; d >= 0; --d) {
            if (++idx[d] < subsizes[d]) break;
            idx[d] = 0;
        }
        if (d < 0) break;
    }
}

PyObject *blocks_impl(PyObject *args, bool pack) {
    Py_buffer full, packed;
    Py_ssize_t itemsize;
    PyObject *shape_o, *strides_o, *starts_o, *subsizes_o;
    if (!PyArg_ParseTuple(args, "w*w*nOOOO", &full, &packed, &itemsize,
                          &shape_o, &strides_o, &starts_o, &subsizes_o))
        return nullptr;

    auto to_vec = [](PyObject *o, std::vector<Py_ssize_t> &v) -> bool {
        PyObject *seq = PySequence_Fast(o, "expected a sequence");
        if (!seq) return false;
        Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
        v.resize(n);
        for (Py_ssize_t i = 0; i < n; ++i)
            v[i] = PyLong_AsSsize_t(PySequence_Fast_GET_ITEM(seq, i));
        Py_DECREF(seq);
        return !PyErr_Occurred();
    };

    std::vector<Py_ssize_t> shape, strides, starts, subsizes;
    bool ok = to_vec(shape_o, shape) && to_vec(strides_o, strides) &&
              to_vec(starts_o, starts) && to_vec(subsizes_o, subsizes);
    if (ok) {
        int ndim = (int)shape.size();
        Py_ssize_t total = itemsize;
        for (int d = 0; d < ndim; ++d) total *= subsizes[d];
        if (total > packed.len) {
            PyErr_SetString(PyExc_ValueError, "packed buffer too small");
            ok = false;
        } else {
            Py_BEGIN_ALLOW_THREADS
            copy_block((char *)full.buf, (char *)packed.buf, ndim, itemsize,
                       shape.data(), strides.data(), starts.data(),
                       subsizes.data(), pack);
            Py_END_ALLOW_THREADS
        }
    }
    PyBuffer_Release(&full);
    PyBuffer_Release(&packed);
    if (!ok) return nullptr;
    Py_RETURN_NONE;
}

PyObject *pack_blocks(PyObject *, PyObject *args) {
    return blocks_impl(args, true);
}

PyObject *unpack_blocks(PyObject *, PyObject *args) {
    return blocks_impl(args, false);
}

PyMethodDef methods[] = {
    {"aligned_empty", aligned_empty, METH_VARARGS,
     "aligned_empty(nbytes, alignment=128) -> (memoryview, owner_capsule)"},
    {"pack_blocks", pack_blocks, METH_VARARGS,
     "pack a strided n-d subarray block into a contiguous buffer"},
    {"unpack_blocks", unpack_blocks, METH_VARARGS,
     "unpack a contiguous buffer into a strided n-d subarray block"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_hoststage",
    "Aligned host staging + bit-exact block pack/unpack", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__hoststage(void) {
    return PyModule_Create(&moduledef);
}
