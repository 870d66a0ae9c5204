"""Optional native builds.

`python setup.py build_ext --inplace` compiles the C extensions ahead of
time; without it the package builds them on demand at first import
(shortseq_tpu/native_build.py, shortseq_tpu/io/native.py) and falls back
to pure Python when no compiler is available.

Both extensions are marked optional: a host without a C++ toolchain can
still `pip install` the package and run on the pure-Python/numpy
fallbacks.  _fastq_index has no Python init - it is a plain C-ABI shared
object the package binds with ctypes (io/native.py), compiled here so
installed wheels keep the native IO path without shipping csrc/.

ISA flags: setup.py-built artifacts may be WHEELS that travel to other
machines, so -march=native is OFF by default here (a wheel built on an
AVX-512 CI box would SIGILL on an older CPU).  Opt in with
SHORTSEQ_TPU_MARCH_NATIVE=1 for build-where-you-run installs.  The
on-demand JIT build (native_build.py) always compiles on the host that
runs it and keeps -march=native unconditionally.
"""

import os

from setuptools import Extension, setup

_cflags = ["-O3", "-std=c++17"]
if os.environ.get("SHORTSEQ_TPU_MARCH_NATIVE") == "1":
    _cflags.append("-march=native")

setup(
    ext_modules=[
        Extension(
            "shortseq_tpu._native",
            sources=["csrc/shortseq_native.cpp"],
            extra_compile_args=list(_cflags),
            language="c++",
            optional=True,
        ),
        Extension(
            "shortseq_tpu._fastq_index",
            sources=["csrc/fastq_index.cpp"],
            extra_compile_args=_cflags + ["-pthread"],
            extra_link_args=["-pthread"],
            language="c++",
            optional=True,
        ),
    ],
)
