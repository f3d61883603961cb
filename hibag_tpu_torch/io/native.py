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
    # atomically, so two processes racing (e.g. the workers of a distributed
    # run) never dlopen a half-written .so.  A failed build leaves a marker
    # file so later processes skip the (up to 180 s) rebuild attempt until
    # the source changes.
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
        lib.hibag_bed_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
        lib.hibag_align_codes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int]
        lib.hibag_snp_stats.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.hibag_vcf_gt_codes.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int64]
        lib.hibag_vcf_gt_codes.restype = ctypes.c_int64
        if hasattr(lib, "hibag_ordered_step"):
            lib.hibag_ordered_step.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_double, ctypes.c_double, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int]
            lib.hibag_ordered_step.restype = None
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def bed_decode(raw: np.ndarray, n_snp: int, n_samp: int,
               keep_idx: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """Decode SNP-major PLINK BED bytes → int8 codes [n_keep, n_samp]."""
    lib = get_lib()
    keep_idx = np.ascontiguousarray(keep_idx, dtype=np.int64)
    # validate before the (unchecked) C++ kernel: a truncated .bed or a
    # .bim/.fam mismatch must raise here, not read out of bounds
    stride = (n_samp + 3) // 4
    if len(raw) < stride * n_snp:
        raise ValueError(
            f"BED payload too short: {len(raw)} bytes < {stride * n_snp} "
            f"({n_snp} SNPs x {n_samp} samples) — truncated .bed or "
            "mismatched .bim/.fam?")
    if len(keep_idx) and (keep_idx.min() < 0 or keep_idx.max() >= n_snp):
        raise ValueError("keep_idx out of range for n_snp")
    if lib is not None:
        raw = np.ascontiguousarray(raw, dtype=np.uint8)
        out = np.empty((len(keep_idx), n_samp), dtype=np.int8)
        lib.hibag_bed_decode(_ptr(raw), n_snp, n_samp, _ptr(keep_idx),
                             len(keep_idx), _ptr(out), n_threads)
        return out
    # NumPy fallback (same LUT approach)
    from .bed import _LUT
    rows = raw[:stride * n_snp].reshape(n_snp, stride)[keep_idx]
    return _LUT[rows].reshape(len(keep_idx), -1)[:, :n_samp].astype(np.int8)


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


def snp_stats(geno: np.ndarray, n_threads: int = 0):
    """(allele_freq [P], missing_rate [P]) over int8 codes [P, N]."""
    lib = get_lib()
    P, N = geno.shape
    if lib is not None:
        geno = np.ascontiguousarray(geno, dtype=np.int8)
        freq = np.empty(P)
        miss = np.empty(P)
        lib.hibag_snp_stats(_ptr(geno), P, N, _ptr(freq), _ptr(miss),
                            n_threads)
        return freq, miss
    g = geno.astype(np.int64)
    valid = g <= 2
    cnt = np.where(valid, g, 0).sum(1)
    nv = valid.sum(1)
    with np.errstate(invalid="ignore"):
        freq = np.where(nv > 0, cnt / (2.0 * nv), 0.0)
    return freq, 1.0 - nv / N


def ordered_step(bits: np.ndarray, freq: np.ndarray, allele: np.ndarray,
                 g_cand: np.ndarray, geno_sel: np.ndarray,
                 a1: np.ndarray, a2: np.ndarray, is_oob: np.ndarray,
                 B: np.ndarray, n_alleles: int, total_n: float,
                 rare_prob: float, n_threads: int = 0):
    """One full greedy-step candidate pass — doubled-list EM, rare erase,
    OOB/log-lik evaluation — with the reference's exact serial summation
    orders (hibag_ordered_step; see native/hibag_native.cpp for the
    algorithm and reference citations).  bits [H, n_snp] uint8 current
    list; freq [H] f64; allele [H] i32 nondecreasing; g_cand [C, N] i8;
    geno_sel [N, L] i8; a1/a2 [N] i32; is_oob [N] bool; B [N] f64.
    Returns (ok [C] bool, fA [C, H] f64, fB [C, H] f64, acc [C] i32,
    loss [C] f64), or None when the native lib is unavailable (this
    parity-only path has no NumPy fallback)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "hibag_ordered_step"):
        return None
    H_, N_ = bits.shape[0], g_cand.shape[1]
    if N_ * H_ * H_ * 2 > 4 << 30:
        raise MemoryError(
            f"ordered parity mode materializes an [N, H, H] uint16 "
            f"distance table ({N_}x{H_}x{H_} = "
            f"{N_ * H_ * H_ * 2 / 2**30:.1f} GiB) — it is meant for "
            "reference-panel scales, not cohort training")
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    freq = np.ascontiguousarray(freq, dtype=np.float64)
    allele = np.ascontiguousarray(allele, dtype=np.int32)
    g_cand = np.ascontiguousarray(g_cand, dtype=np.int8)
    geno_sel = np.ascontiguousarray(geno_sel, dtype=np.int8)
    a1 = np.ascontiguousarray(a1, dtype=np.int32)
    a2 = np.ascontiguousarray(a2, dtype=np.int32)
    is_oob = np.ascontiguousarray(is_oob, dtype=np.uint8)
    B = np.ascontiguousarray(B, dtype=np.float64)
    H, n_snp = bits.shape
    C, N = g_cand.shape
    L = geno_sel.shape[1]
    if not (geno_sel.shape[0] == N and len(a1) == N and len(a2) == N
            and len(is_oob) == N and len(B) == N):
        raise ValueError("geno_sel, a1, a2, is_oob and B need N rows")
    if len(freq) != H or len(allele) != H:
        raise ValueError("freq and allele need H entries")
    ok = np.empty(C, dtype=np.int32)
    fA = np.empty((C, H), dtype=np.float64)
    fB = np.empty((C, H), dtype=np.float64)
    acc = np.empty(C, dtype=np.int32)
    loss = np.empty(C, dtype=np.float64)
    lib.hibag_ordered_step(
        _ptr(bits), _ptr(freq), _ptr(allele), H, n_snp, _ptr(g_cand), C,
        _ptr(geno_sel), L, _ptr(a1), _ptr(a2), _ptr(is_oob), _ptr(B), N,
        n_alleles, float(total_n), float(rare_prob),
        _ptr(ok), _ptr(fA), _ptr(fB), _ptr(acc), _ptr(loss), n_threads)
    return ok.astype(bool), fA, fB, acc, loss


def vcf_gt_codes(cells: bytes, gt_index: int, n_samples: int):
    """Native GT-field parse of one VCF data line's sample region into
    REF-allele-count codes (3 = missing); None when the native lib is
    absent (callers fall back to the Python loop)."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(n_samples, dtype=np.uint8)
    n = lib.hibag_vcf_gt_codes(cells, len(cells), gt_index,
                               _ptr(out), n_samples)
    if n != n_samples:
        return None
    return out
