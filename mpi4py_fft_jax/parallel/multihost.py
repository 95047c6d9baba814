"""Multi-host execution support.

The reference scales across nodes transparently through MPI: the same
per-rank program runs everywhere and `MPI.COMM_WORLD` spans the cluster.
The JAX counterpart is `jax.distributed`: every process runs the same
single-controller program, `jax.devices()` spans every process's devices,
and the meshes built by :class:`.pencil.Subcomm` automatically include
them all — XLA routes the collectives between them (NCCL between GPUs).

Usage (one call before any other mpi4py_fft_jax use, in every process)::

    from mpi4py_fft_jax.parallel import multihost
    multihost.initialize('localhost:12345', num_processes=2, process_id=0)
    # ... identical program as single-process ...

Without a cluster manager that configures it, `jax.distributed` needs
``coordinator_address``, ``num_processes`` and ``process_id``.
"""
import jax

__all__ = ['initialize', 'finalize', 'is_multihost', 'process_count',
           'process_index', 'sync_global_devices']

_initialized = [False]


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, **kw):
    """Bring up the cross-host runtime (idempotent)."""
    if _initialized[0]:
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs['coordinator_address'] = coordinator_address
    if num_processes is not None:
        kwargs['num_processes'] = num_processes
    if process_id is not None:
        kwargs['process_id'] = process_id
    kwargs.update(kw)
    jax.distributed.initialize(**kwargs)
    _initialized[0] = True


def finalize():
    if _initialized[0]:
        jax.distributed.shutdown()
        _initialized[0] = False


def is_multihost():
    return jax.process_count() > 1


def process_count():
    return jax.process_count()


def process_index():
    return jax.process_index()


def sync_global_devices(name='sync'):
    """Barrier across all hosts (role of a global MPI barrier)."""
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices(name)
