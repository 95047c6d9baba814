"""mpi4py_fft_jax — a distributed FFT framework in JAX.

A from-scratch re-design of the capabilities of mpi4py-fft (reference at
mpi4py_fft/__init__.py:19-26) for accelerators driven by JAX (one NVIDIA
GPU, or several in one host):

* serial transforms (c2c, r2c/c2r, DCT/DST I-IV, DHT, Hermitian) as pure
  JAX/XLA programs with FFTW's exact conventions (``.fftw`` / ``.ops``);
* slab/pencil/higher-order domain decomposition expressed as
  ``jax.sharding`` specs over a device mesh (``.parallel``), with the MPI
  ``Alltoallw`` transpose replaced by XLA all-to-all collectives;
* a fused transform→transpose→transform parallel FFT pipeline (``PFFT``)
  compiled to a single XLA program;
* a global-view distributed array (``DistArray``/``newDistArray``);
* parallel-IO-equivalent HDF5/NetCDF snapshots + XDMF generation (``.io``).

Default precision is float64 ('d'), like the reference; set environment
variable ``MPI4PY_FFT_JAX_X64=0`` before import to keep JAX in 32-bit mode.
"""
import os

__version__ = '0.1.0'

import jax as _jax

if os.environ.get('MPI4PY_FFT_JAX_X64', '1') not in ('0', 'false', 'False'):
    _jax.config.update('jax_enable_x64', True)

import sys as _sys

from . import ops
from . import ops as fftw
# reference-compatible module aliases (reference package layout:
# mpi4py_fft/fftw/{__init__,xfftn,factory,utilities})
_sys.modules[__name__ + '.fftw'] = ops
from .ops import xfftn as _xfftn_mod, plan as _plan_mod
from . import utils as _utils_mod
_sys.modules[__name__ + '.fftw.xfftn'] = _xfftn_mod
_sys.modules[__name__ + '.fftw.factory'] = _plan_mod
_sys.modules[__name__ + '.fftw.utilities'] = _utils_mod
from .ops.plan import fftlib                   # noqa: F401
from .parallel.pencil import Subcomm, Pencil, Transfer  # noqa: F401
from .parallel.mpifft import PFFT, Transform   # noqa: F401
from .parallel.planar import PlanarPFFT        # noqa: F401
from .distarray import DistArray, newDistArray, Function  # noqa: F401
from .io import HDF5File, NCFile, generate_xdmf  # noqa: F401

__all__ = ['DistArray', 'newDistArray', 'Function', 'PFFT', 'Transform',
           'PlanarPFFT',
           'fftw', 'ops', 'fftlib', 'Subcomm', 'Pencil', 'Transfer',
           'HDF5File', 'NCFile', 'generate_xdmf']
