"""ctypes bindings to the native C++ data-preparation runtime.

Loads ``native/libhibag_native.so`` when present (``make -C native``); every
entry point has a NumPy fallback so the package works without the build.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _find_lib() -> Optional[str]:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for cand in (
        os.environ.get("HIBAG_NATIVE_LIB", ""),
        os.path.join(here, "native", "libhibag_native.so"),
        os.path.join(os.path.dirname(__file__), "libhibag_native.so"),
    ):
        if cand and os.path.exists(cand):
            return cand
    # fresh checkout: build the library once if the source tree and a
    # compiler are available (on failure the NumPy fallbacks stay in use).
    # Concurrency-safe: compile to a per-process temp name and os.rename
    # atomically, so two processes racing (e.g. jax.distributed workers)
    # never dlopen a half-written .so.  A failed build leaves a marker file
    # so later processes skip the (up to 180 s) rebuild attempt until the
    # source changes.
    src_dir = os.path.join(here, "native")
    src = os.path.join(src_dir, "hibag_native.cpp")
    if os.path.exists(src):
        import subprocess
        import warnings
        built = os.path.join(src_dir, "libhibag_native.so")
        marker = os.path.join(src_dir, ".build_failed")
        try:
            if (os.path.exists(marker)
                    and os.path.getmtime(marker) >= os.path.getmtime(src)):
                return None
        except OSError:
            pass
        tmp_name = f"libhibag_native.{os.getpid()}.so"
        tmp = os.path.join(src_dir, tmp_name)
        try:
            subprocess.run(["make", "-C", src_dir, f"OUT={tmp_name}"],
                           capture_output=True, timeout=180, check=True)
            os.rename(tmp, built)
            try:
                os.unlink(marker)
            except OSError:
                pass
            return built
        except Exception as exc:
            err = getattr(exc, "stderr", b"") or b""
            tail = err.decode("utf-8", "replace").strip()[-400:]
            warnings.warn(
                "native library auto-build failed (NumPy fallbacks in "
                f"use; delete {marker} to retry after fixing the "
                f"toolchain): {exc}" + (f"\n{tail}" if tail else ""))
            try:
                with open(marker, "w") as fh:
                    fh.write(str(exc))
            except OSError:
                pass
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.hibag_align_codes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def align_codes(geno: np.ndarray, src_idx: np.ndarray, flip: np.ndarray,
                n_threads: int = 0) -> np.ndarray:
    """Gather+flip target codes [P_t, N] into model space → [N, P_m]."""
    lib = get_lib()
    src_idx = np.ascontiguousarray(src_idx, dtype=np.int64)
    flip = np.ascontiguousarray(flip, dtype=np.uint8)
    P_t, N = geno.shape
    P_m = len(src_idx)
    if lib is not None:
        geno = np.ascontiguousarray(geno, dtype=np.int8)
        out = np.empty((N, P_m), dtype=np.int8)
        lib.hibag_align_codes(_ptr(geno), P_t, N, _ptr(src_idx), _ptr(flip),
                              P_m, _ptr(out), n_threads)
        return out
    safe = np.maximum(src_idx, 0)
    g = geno[safe].astype(np.int8)                  # [P_m, N]
    g = np.where(g > 2, 3, g)
    flipped = np.where((g <= 2) & flip[:, None].astype(bool), 2 - g, g)
    flipped[src_idx < 0] = 3
    return np.ascontiguousarray(flipped.T)
