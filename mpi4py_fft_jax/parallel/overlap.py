"""Compute/communication overlap for the pencil transposes.

The reference's hot loop alternates serial FFT stages with blocking MPI
``Alltoallw`` calls (reference: mpifft.py:68-72 + pencil.py:182-183) —
transform and network never overlap.  Here the transpose is a tiled
``lax.all_to_all`` (NCCL over NVLink between GPUs); XLA's latency-hiding
scheduler turns
collectives into async start/done pairs and hoists starts across
independent computation.  To give it that freedom, the executors here
CHUNK each transpose along an axis that participates in neither the
all_to_all nor the adjacent transform stage, and emit one independent
``a2a -> transform`` chain per chunk: shard k's transform stage can then
run while shard k+1's all_to_all is in flight.

Chunking is a pure reassociation — each element's compute path is
unchanged, so results are bit-identical to the unchunked executor (the
data-movement path stays bit-exact, BASELINE.json).

Knobs: ``MPI4PY_FFT_JAX_A2A_CHUNKS`` = ``auto`` (default) | int.
``auto`` picks 4-way chunking when the per-shard block is large enough
that per-chunk transfers still amortize collective launch overhead
(>= 4 MB/chunk), else leaves the transpose whole.  Constructor kwarg
``a2a_chunks`` on PFFT/PlanarPFFT overrides the env.

Multi-GPU A/B measurement protocol (chunking is a *bet* on the
latency-hiding scheduler — it can lose to 4x collective launches, and a
single-card environment cannot settle it):  on a >=4-GPU mesh run

    for C in 1 2 4 8:  MPI4PY_FFT_JAX_A2A_CHUNKS=$C \
        python scripts/bench_milestones.py m3

(any PFFT/PlanarPFFT forward at production size works; milestone #3's
512^3 dealiased r2c is the representative two-transpose pipeline) and
compare wall/step.  Keep the best C as the deployment default; if C=1
wins at every size, set ``MPI4PY_FFT_JAX_A2A_CHUNKS=1`` and this module
reduces to the unchunked executor.  The chunked and unchunked programs
are bit-identical in output, so the sweep needs no correctness gate.
"""
import os

import jax.numpy as jnp

__all__ = ['chunk_count', 'resolve', 'overlapped']

# per-chunk transfer should stay >= ~4 MB so the launch overhead of the
# extra collectives is amortized: a guess, not measured over NVLink
# (see the A/B protocol above)
_MIN_CHUNK_BYTES = 4 * 2 ** 20


def chunk_count(override=None):
    """Resolve the configured chunk count (0 = auto)."""
    if override is not None:
        return int(override)
    v = os.environ.get('MPI4PY_FFT_JAX_A2A_CHUNKS', 'auto')
    return 0 if v == 'auto' else int(v)


def resolve(cfg, nbytes, ext):
    """Concrete chunk count for one transpose: ``cfg`` (0 = auto), the
    per-shard buffer size, and the extent of the chunk axis."""
    if cfg == 0:                             # auto
        cfg = 4 if nbytes >= 4 * _MIN_CHUNK_BYTES else 1
    c = max(1, min(int(cfg), ext))
    while c > 1 and ext % c:                 # chunks must tile the axis
        c -= 1
    return c


def overlapped(p, axis_c, nchunks, chain, out_axis=None):
    """Apply ``chain`` (the fused a2a+stage program of one pipeline step)
    over ``nchunks`` independent slices of ``p`` along ``axis_c`` and
    re-concatenate (along ``out_axis`` when the stage changes the planar
    rank).  With nchunks == 1 this is exactly ``chain(p)``."""
    if nchunks <= 1 or p.shape[axis_c] % nchunks:
        return chain(p)
    parts = jnp.split(p, nchunks, axis=axis_c)
    done = [chain(c) for c in parts]
    return jnp.concatenate(done, axis=axis_c if out_axis is None
                           else out_axis)
