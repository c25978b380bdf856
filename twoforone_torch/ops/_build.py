"""Build and load the port's CUDA kernels.

Each kernel source ``ops/csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` into its own shared library, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v [-split-compile 0] \
         -o <build dir>/<name>-<hash>.so ops/csrc/<name>.cu

The build directory is chosen at first use by :func:`build_dir`, with the
JAX package's rule for its compile cache: ``$TFO_KERNEL_CACHE`` when it is
set, else ``twoforone_torch/_build/`` beside the package's modules (listed in
``.gitignore``) when that can be written, else
``$XDG_CACHE_HOME/twoforone_torch_kernels`` (``~/.cache/...`` by default), so
that an installed copy in a read-only site-packages builds too. A library is
named by a hash of its source, of every header under ``ops/csrc`` (``*.cuh``,
which the sources include) and of the flags, so an edited source or header is
rebuilt on first use and an unchanged one is reused.
Nothing is compiled when a module is imported: :func:`load` builds on first
call.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
PACKAGE_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Lets nvcc optimise the kernels of one source side by side on all cores (the
# whole-force sources hold five tile sizes each: 43 s become 18 on 8 cores).
SPLIT_COMPILE = ["-split-compile", "0"]

_loaded: dict = {}
# Compiler output of each library compiled by this process (``-Xptxas -v``
# prints each kernel's registers, shared memory and spills), and the seconds
# each compilation took.
logs: dict = {}
seconds: dict = {}


def writable(path: str) -> bool:
    """Whether ``path`` can be made and written, found by trying: the
    directory is made and a file opened and removed in it (mode bits say
    nothing for root)."""
    try:
        os.makedirs(path, exist_ok=True)
        fd, probe = tempfile.mkstemp(dir=path, prefix=".probe-")
        os.close(fd)
        os.remove(probe)
    except OSError:
        return False
    return True


def build_dir() -> str:
    """Where the libraries are built: ``$TFO_KERNEL_CACHE`` when it is set,
    else the package's ``_build/`` when it can be written, else
    ``$XDG_CACHE_HOME/twoforone_torch_kernels`` (``~/.cache`` when that
    variable is unset). A directory that cannot be made fails the build."""
    if os.environ.get("TFO_KERNEL_CACHE"):
        return os.environ["TFO_KERNEL_CACHE"]
    if writable(PACKAGE_BUILD_DIR):
        return PACKAGE_BUILD_DIR
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(cache, "twoforone_torch_kernels")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


@functools.lru_cache(maxsize=None)
def _flags() -> tuple:
    """``NVCC_FLAGS``, with ``SPLIT_COMPILE`` where this nvcc knows it (CUDA
    12.3 on). It changes how long a build takes, not what is built, so the
    library's name does not depend on it."""
    text = subprocess.run([_nvcc(), "--help"], stdout=subprocess.PIPE, text=True).stdout
    return (*NVCC_FLAGS, *(SPLIT_COMPILE if "--split-compile" in text else ()))


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(_CSRC, f"{name}.cu"), *sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(build_dir(), f"{name}-{digest.hexdigest()[:16]}.so")


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, compiled on first use. Raises with the
    compiler's output if ``nvcc`` fails."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    so = library_path(name)
    if not os.path.exists(so):
        os.makedirs(os.path.dirname(so), exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *_flags(), "-o", tmp, os.path.join(_CSRC, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        seconds[name] = time.perf_counter() - t0
        logs[name] = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
        os.replace(tmp, so)
    lib = _loaded[name] = ctypes.CDLL(so)
    return lib
