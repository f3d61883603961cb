"""Builds the port's CUDA sources (``hibag_tpu_torch/csrc/*.cu``, which include
``csrc/*.cuh``) with nvcc at first use and loads the shared library with
ctypes.

Each source compiles to an object file in its own nvcc process, all started
together, and one more nvcc links them. The library goes to
``build/hibag_tpu_torch/`` at the root of the checkout, named by a hash of
the sources, headers and flags, so an edited source or header builds anew and an unchanged one
loads the library already there. A missing nvcc or a failed build raises.

``SOURCE_FLAGS`` adds flags for one source alone: the candidate evaluation
(``eval_cand.cu``) compiles with ``-ftz=true``, so its float32 arithmetic
flushes denormals to zero as XLA's does for hibag_tpu; the other kernels
keep denormals.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "hibag_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]
#: extra nvcc flags of single sources, by file name
SOURCE_FLAGS = {"eval_cand.cu": ["-ftz=true"]}


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
    """Where the library for the current sources and headers lives."""
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(os.path.basename(s).encode())
        h.update(" ".join(SOURCE_FLAGS.get(os.path.basename(s), [])).encode())
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
    nvcc = find_nvcc()
    tmp = f"{out}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(os.path.basename(s), []),
             "-Xptxas", "-v", "-c", "-o", o, s]
            for s, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{log}")
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    with open(os.path.join(BUILD_DIR, "ptxas.log"), "w") as f:
        f.write("\n".join(logs))
    for o in objs:
        os.remove(o)
    os.replace(tmp, out)
    return out


_LOAD_LOCK = threading.Lock()


def load() -> ctypes.CDLL:
    """The built library with every entry point's ctypes signature set;
    built once per process, also when mesh shards ask for it from several
    threads at once."""
    with _LOAD_LOCK:
        return _load()


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hibag_ens_acc.argtypes = [p] * 10 + [i] * 5 + [p]
    lib.hibag_ens_acc.restype = i
    lib.hibag_em_estep.argtypes = [p] * 10 + [i] * 5 + [ctypes.c_float, p]
    lib.hibag_em_estep.restype = i
    lib.hibag_em_packed.argtypes = [p] * 11 + [i] * 8 + [ctypes.c_float, p]
    lib.hibag_em_packed.restype = i
    lib.hibag_em_packed_smem.argtypes = [i] * 4
    lib.hibag_em_packed_smem.restype = ctypes.c_longlong
    lib.hibag_eval_cand.argtypes = [p] * 16 + [i] * 8 + [p]
    lib.hibag_eval_cand.restype = i
    lib.hibag_post_scores.argtypes = [p] * 11 + [i] * 5 + [p]
    lib.hibag_post_scores.restype = i
    lib.hibag_post_scores_smem.argtypes = [i] * 3
    lib.hibag_post_scores_smem.restype = ctypes.c_longlong
    lib.hibag_post_scores_scratch.argtypes = [i]
    lib.hibag_post_scores_scratch.restype = ctypes.c_longlong
    lib.hibag_eval_smem.argtypes = [i] * 4
    lib.hibag_eval_smem.restype = ctypes.c_longlong
    lib.hibag_cuda_error_string.argtypes = [i]
    lib.hibag_cuda_error_string.restype = ctypes.c_char_p
    return lib
