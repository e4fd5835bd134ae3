"""Build and load the port's CUDA kernels.

Each source ``gpyreg_tpu_torch/csrc/<name>.cu`` is compiled at first use
with ``nvcc`` into its own shared library with a plain C interface,
written to ``gpyreg_tpu_torch/build/`` (listed in ``.gitignore``), and
loaded with ``ctypes``: ``kernel_tile`` (the forward tile) and
``kernel_vjp`` (its one-pass gradient); both include the shared header
``csrc/tile_common.cuh``.  A library's file name carries a hash of its
source and of the headers, so an edited kernel is rebuilt and a stale
build is never loaded.  :func:`build_all` starts one ``nvcc`` per source, all at
once.  Nothing here runs at import: the CPU-only test environment has no
``nvcc``.
"""

import concurrent.futures
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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC_DIR, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
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


SOURCES = ("kernel_tile", "kernel_vjp")


def build_all():
    """Build every library at once, one ``nvcc`` per source; returns
    ``{name: path}``."""
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(build, SOURCES)))


@functools.cache
def kernel_tile_lib():
    """The loaded kernel-tile library with its C signatures declared."""
    lib = ctypes.CDLL(build("kernel_tile"))
    p = ctypes.c_void_p
    lib.kernel_tile_launch.argtypes = [
        ctypes.c_int,  # profile
        ctypes.c_int,  # tma
        p, p, p, p, p,  # xs, zs, sf2, alpha, out
        ctypes.c_longlong,  # n
        ctypes.c_longlong,  # m
        ctypes.c_int,  # d
        ctypes.c_int,  # zero_diag
        p,  # stream
    ]
    lib.kernel_tile_launch.restype = ctypes.c_int
    lib.kernel_tile_smem_bytes.argtypes = []
    lib.kernel_tile_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.cache
def kernel_vjp_lib():
    """The loaded gradient-tile library with its C signatures declared."""
    lib = ctypes.CDLL(build("kernel_vjp"))
    p = ctypes.c_void_p
    lib.kernel_vjp_launch.argtypes = [
        ctypes.c_int,  # profile
        ctypes.c_int,  # iso
        ctypes.c_int,  # tma
        p, p, p, p, p, p,  # xs, gbar, sf2, alpha, partials, out
        ctypes.c_longlong,  # n
        ctypes.c_int,  # d
        ctypes.c_longlong,  # blocks
        p,  # stream
    ]
    lib.kernel_vjp_launch.restype = ctypes.c_int
    lib.kernel_vjp_tile.argtypes = []
    lib.kernel_vjp_tile.restype = ctypes.c_int
    lib.kernel_vjp_grid.argtypes = [ctypes.c_longlong]
    lib.kernel_vjp_grid.restype = ctypes.c_longlong
    lib.kernel_vjp_width.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.kernel_vjp_width.restype = ctypes.c_int
    lib.kernel_vjp_smem_bytes.argtypes = [ctypes.c_int]
    lib.kernel_vjp_smem_bytes.restype = ctypes.c_longlong
    return lib
