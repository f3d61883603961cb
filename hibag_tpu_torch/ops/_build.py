"""Builds the port's CUDA sources (``hibag_tpu_torch/csrc/*.cu``) with nvcc at
first use and loads the shared library with ctypes.

The library goes to ``build/hibag_tpu_torch/`` at the root of the checkout,
named by a hash of the sources and flags, so an edited source builds anew
and an unchanged one loads the library already there. A missing nvcc or a
failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "hibag_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path() -> str:
    """Where the library for the current sources lives."""
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libhibag_tpu_torch_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu into one shared library unless it exists; returns
    its path. Compiles to a per-process name and renames it into place, so
    processes building at once never load a half-written file."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with every entry point's ctypes signature set."""
    lib = ctypes.CDLL(build())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hibag_ens_acc.argtypes = [p] * 10 + [i] * 5 + [p]
    lib.hibag_ens_acc.restype = i
    lib.hibag_cuda_error_string.argtypes = [i]
    lib.hibag_cuda_error_string.restype = ctypes.c_char_p
    return lib
