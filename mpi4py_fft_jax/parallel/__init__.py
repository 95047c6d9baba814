"""Distribution layer: device-mesh decomposition and global transposes.

JAX replacement for the reference's MPI layer
(reference: mpi4py_fft/pencil.py, mpifft.py): slab/pencil/higher-order
decompositions are expressed as ``jax.sharding`` specs over a named device
mesh, and the Alltoallw global transpose becomes an XLA all-to-all
resharding (NCCL between GPUs).
"""
from .comm import COMM_WORLD, DeviceComm, comm_world  # noqa: F401
from .pencil import Subcomm, Pencil, Transfer  # noqa: F401
from .mpifft import PFFT, Transform  # noqa: F401
