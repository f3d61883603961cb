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

`launch` is the one path from a wrapper in ``ops/`` to a kernel: it enters
the device, records the launch (utils/trace.py), passes the stream and the
launch marks, raises on the library's error code and counts the launch.
`same_device`, `cuda_only` and `pen_table` are the wrappers' shared
checks and penalty table.
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

import torch

from ..constants import LOG_MIN_RARE_FREQ, MAXNUM_SNP
from ..utils import trace

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
    # each launcher ends with its stream and two launch marks
    # (csrc/launch_marks.cuh)
    lib.hibag_ens_acc.argtypes = [p] * 10 + [i] * 5 + [p] * 3
    lib.hibag_ens_acc.restype = i
    lib.hibag_em_estep.argtypes = [p] * 10 + [i] * 5 + [ctypes.c_float,
                                                        p, p, p]
    lib.hibag_em_estep.restype = i
    lib.hibag_em_packed.argtypes = [p] * 11 + [i] * 8 + [ctypes.c_float,
                                                         p, p, p]
    lib.hibag_em_packed.restype = i
    lib.hibag_em_packed_smem.argtypes = [i] * 4
    lib.hibag_em_packed_smem.restype = ctypes.c_longlong
    lib.hibag_eval_cand.argtypes = [p] * 16 + [i] * 8 + [p] * 3
    lib.hibag_eval_cand.restype = i
    lib.hibag_post_scores.argtypes = [p] * 11 + [i] * 5 + [p] * 3
    lib.hibag_post_scores.restype = i
    lib.hibag_post_scores_smem.argtypes = [i] * 3
    lib.hibag_post_scores_smem.restype = ctypes.c_longlong
    lib.hibag_post_scores_fold.argtypes = [p] * 12 + [i] * 5 + [p] * 3
    lib.hibag_post_scores_fold.restype = i
    lib.hibag_post_scores_fold_smem.argtypes = [i] * 3
    lib.hibag_post_scores_fold_smem.restype = ctypes.c_longlong
    lib.hibag_post_scores_fold_scratch.argtypes = [i]
    lib.hibag_post_scores_fold_scratch.restype = ctypes.c_longlong
    lib.hibag_post_scores_blocks_per_sm.argtypes = [i] * 4
    lib.hibag_post_scores_blocks_per_sm.restype = i
    lib.hibag_post_scores_scratch.argtypes = [i]
    lib.hibag_post_scores_scratch.restype = ctypes.c_longlong
    lib.hibag_match_pairs.argtypes = [p] * 7 + [i] * 6 + [p] * 3
    lib.hibag_match_pairs.restype = i
    lib.hibag_eval_smem.argtypes = [i] * 4
    lib.hibag_eval_smem.restype = ctypes.c_longlong
    lib.hibag_cuda_error_string.argtypes = [i]
    lib.hibag_cuda_error_string.restype = ctypes.c_char_p
    return lib


_COUNT_LOCK = threading.Lock()


def count(tally) -> None:
    """One launch more in tally = (dict, key), under the one lock of every
    kernel's counter: a mesh's shards launch from several threads."""
    counter, key = tally
    with _COUNT_LOCK:
        counter[key] += 1


def launch(entry: str, name: str, dims: dict, device, *args, tally,
           counts=None) -> None:
    """Launches the library's `entry` on `device`'s current stream with
    `args` (a tensor as its data pointer, None as a null pointer), the
    stream and the marks of ``trace.launch(name, dims, counts, device)``.
    Raises RuntimeError naming `name` when the launcher returns an error
    code; else `count`s the launch in `tally`. `args` keeps every tensor
    alive until the kernel is on the stream: one made in the caller's call
    expression has no other owner, and its memory must not go back to the
    caching allocator before then."""
    lib = load()
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device), trace.launch(name, dims, counts,
                                                 device) as rec:
        err = getattr(lib, entry)(
            *ptrs, torch.cuda.current_stream(device).cuda_stream, *rec.marks)
    if err != 0:
        msg = lib.hibag_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
    count(tally)


def same_device(*xs) -> None:
    """ValueError unless the tensors xs are contiguous and on one CPU or
    CUDA device."""
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError("all inputs must be on one device")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("all inputs must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def cuda_only(what: str, plain: str, *xs) -> None:
    """`same_device` for a wrapper that takes CUDA tensors only; on the CPU
    ValueError naming `what` and its plain version `plain`."""
    same_device(*xs)
    if xs[0].device.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors only; the plain version "
                         f"is {plain}")


def pen_table(device) -> torch.Tensor:
    """float32 [257]: exp(log(1e-5) * d), made on `device` by the same
    float32 exp as the plain versions' penalties (so the evaluation and
    scoring kernels' penalty for a distance is bitwise the plain
    versions')."""
    d = torch.arange(2 * MAXNUM_SNP + 1, dtype=torch.float32, device=device)
    return torch.exp(LOG_MIN_RARE_FREQ * d)
