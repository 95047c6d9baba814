"""Test harness configuration.

Multi-device semantics are tested on a virtual 8-device CPU mesh — the
single-controller analogue of the reference's oversubscribed
``mpiexec -n 2/4`` runs (reference: tests/runtests.sh:14-37).  The CPU is
pinned only when ``JAX_PLATFORMS`` is unset; the 8 virtual devices are
added whenever the platform is the CPU.  This must run before the first
jax import.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and take the
``gpu`` fixture, which skips them when JAX finds no GPU.  Run them on a
GPU host with::

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -p no:xdist
"""
import contextlib
import os

import pytest

if os.environ.setdefault("JAX_PLATFORMS", "cpu") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere); run with "
        "JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -p no:xdist")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda ... -m gpu)")
    return dev


@contextlib.contextmanager
def _engine(name):
    from mpi4py_fft_jax.ops import core
    prev = core.get_fft_impl()
    core.set_fft_impl(name)
    try:
        yield name
    finally:
        core.set_fft_impl(prev)


@pytest.fixture(params=["xla", "matmul"])
def fft_engine(request):
    """Run the test once per local-transform engine (ops/core.py
    set_fft_impl), restoring the previous engine afterwards."""
    with _engine(request.param) as name:
        yield name


@pytest.fixture
def matmul_engine():
    """Run the test on the dense-DFT matmul engine only."""
    with _engine("matmul") as name:
        yield name
