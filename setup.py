"""Build script.

Replaces the reference's FFTW-discovery + tri-precision codegen build
(reference: setup.py:29-206) with a single native extension: the transform
engine is JAX/XLA (no codegen needed — precision tiers are dtypes), and the
native runtime piece is the host staging module (native/hoststage.cpp).
"""
from setuptools import setup, Extension, find_packages

ext = Extension(
    "mpi4py_fft_jax._hoststage",
    sources=["native/hoststage.cpp"],
    extra_compile_args=["-O3", "-std=c++17"],
    language="c++",
)

setup(
    name="mpi4py_fft_jax",
    version="0.1.0",
    description="Distributed FFT framework "
                "(capabilities of mpi4py-fft on JAX/XLA)",
    packages=find_packages(include=["mpi4py_fft_jax", "mpi4py_fft_jax.*"]),
    ext_modules=[ext],
    python_requires=">=3.10",
)
