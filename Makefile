# Build / test driver (role of the reference Makefile + tests/runtests.sh)

PYTHON ?= python

.PHONY: all build test bench clean

all: build

build:
	$(PYTHON) setup.py build_ext --inplace

test: build
	$(PYTHON) -m pytest tests/ -q

# quick subset used as a smoke gate
smoke: build
	$(PYTHON) -m pytest tests/test_planar.py tests/test_pencil.py -q

bench:
	$(PYTHON) bench.py

clean:
	rm -rf build mpi4py_fft_jax/_hoststage*.so
	find . -name __pycache__ -type d -exec rm -rf {} +
