"""Build and load the port's CUDA kernels.

The sources under ``gpyreg_tpu_torch/csrc/`` are compiled at first use
with ``nvcc`` into a shared library with a plain C interface, written to
``gpyreg_tpu_torch/build/`` (listed in ``.gitignore``), and loaded with
``ctypes``.  The library's file name carries a hash of its source, so an
edited kernel is rebuilt and a stale build is never loaded.  Nothing here
runs at import: the CPU-only test environment has no ``nvcc``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # Registers, shared memory and spills per kernel, kept in the log.
    "-Xptxas", "-v",
)


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on a machine with "
            "the CUDA toolkit (PATH or /usr/local/cuda/bin)."
        )
    return path


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` into ``build/lib<name>-<hash>.so`` unless
    that file exists; return its path.  The compiler's output (including
    ``-Xptxas -v``) is kept beside it as ``lib<name>-<hash>.log``."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = f"lib{name}-{digest.hexdigest()[:12]}"
    lib = os.path.join(BUILD_DIR, stem + ".so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Compile to a private name and rename: a process building at the
    # same time never loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            capture_output=True,
            text=True,
        )
        with open(os.path.join(BUILD_DIR, stem + ".log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n"
                + proc.stderr[-4000:]
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.cache
def kernel_tile_lib():
    """The loaded kernel-tile library with its C signatures declared."""
    lib = ctypes.CDLL(build("kernel_tile"))
    p = ctypes.c_void_p
    lib.kernel_tile_launch.argtypes = [
        ctypes.c_int,  # profile
        p, p, p, p,  # xs, zs, params, out
        ctypes.c_longlong,  # n
        ctypes.c_longlong,  # m
        ctypes.c_int,  # d
        ctypes.c_int,  # zero_diag
        p,  # stream
    ]
    lib.kernel_tile_launch.restype = ctypes.c_int
    lib.kernel_tile_max_rows.argtypes = []
    lib.kernel_tile_max_rows.restype = ctypes.c_longlong
    return lib
