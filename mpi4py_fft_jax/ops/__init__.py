"""Serial transform layer (the JAX 'fftw' module).

Replaces the reference's ``mpi4py_fft.fftw`` package (reference:
mpi4py_fft/fftw/__init__.py): planner functions, kind/flag enums, aligned
buffers, planned-FFT factory and the wisdom (compilation cache) surface.
"""
from ..utils import aligned, aligned_like, get_alignment
from .kinds import *          # noqa: F401,F403  enums + flag_dict
from .kinds import flag_dict  # noqa: F401
from .plan import (FFT, get_planned_FFT, fftlib, get_fftw_lib,   # noqa: F401
                   export_wisdom, import_wisdom, forget_wisdom,
                   set_timelimit, cleanup)
from .xfftn import (fftn, ifftn, rfftn, irfftn, dctn, idctn, dstn,  # noqa: F401
                    idstn, hfftn, ihfftn, get_normalization, inverse,
                    dct_type, idct_type, dst_type, idst_type)
from . import core  # noqa: F401

# Reference-compatible submodule names (mpi4py_fft/fftw/{factory,utilities}).
# These must be real attributes so ``import mpi4py_fft_jax.fftw.factory as f``
# resolves (the ``as`` form binds via getattr on the parent module).
from . import plan as factory      # noqa: F401
from .. import utils as utilities  # noqa: F401
