"""Pair matching on the card: the wrapper of csrc/match_pairs.cu.

`match_pairs_kernel` writes the EM's matched-pair mask of K classifiers over
a range of samples in one launch: int8 [K, n, H, H] (what
ops/train_step.py::em_estep reads) or bit-packed uint8 [K, n, H, H // 8]
in models/em.py::_pack_mask's layout (what em_estep_packed reads). Its plain
version is models/em.py::match_pairs / match_pairs_packed with
engine="torch", which models/em.py routes to this wrapper under
engine="cuda"; the masks are booleans of exact integer comparisons, so the
two are equal bitwise. The kernel replaces no TPU kernel: hibag_tpu matches
pairs in jnp (hibag_tpu/models/em.py:88).

The wrapper takes CUDA tensors only and raises ValueError on anything the
kernel does not take.
"""

from __future__ import annotations

import torch

from ..constants import MAXNUM_SNP
from ._build import cuda_only, launch

#: the kernel's limits: H a multiple of MATCH_H_MULTIPLE up to MATCH_MAX_H
#: (a sample's two slot bitmaps sit in shared memory), K up to MATCH_MAX_K
#: (a grid dimension)
MATCH_H_MULTIPLE = 32
MATCH_MAX_H = 65536
MATCH_MAX_K = 65535

#: kernel launches, by output mode; with tracing on each launch is also
#: recorded under the same name (utils/trace.py::launch)
LAUNCHES = {"match_pairs": 0, "match_pairs_packed": 0}


def _check(hb, valid, allele, geno_sel, a1, a2, lo, hi):
    if hb.dtype != torch.int32 or hb.dim() != 3 or hb.shape[2] != 4:
        raise ValueError(f"hb must be int32 [K, H, 4] (pack_bits), got "
                         f"{hb.dtype} {tuple(hb.shape)}")
    K, H = hb.shape[:2]
    if H % MATCH_H_MULTIPLE or not 0 < H <= MATCH_MAX_H:
        raise ValueError(f"H={H}: the matching kernel takes multiples of "
                         f"MATCH_H_MULTIPLE={MATCH_H_MULTIPLE} up to "
                         f"MATCH_MAX_H={MATCH_MAX_H}")
    if not 0 < K <= MATCH_MAX_K:
        raise ValueError(f"K={K}: the matching kernel takes 1..MATCH_MAX_K="
                         f"{MATCH_MAX_K} classifiers")
    if valid.dtype != torch.bool or tuple(valid.shape) != (K, H):
        raise ValueError(f"valid must be bool [{K}, {H}]")
    if allele.dtype != torch.int32 or tuple(allele.shape) != (K, H):
        raise ValueError(f"allele must be int32 [{K}, {H}]")
    if geno_sel.dtype != torch.int8 or geno_sel.dim() != 3 \
            or geno_sel.shape[0] != K or geno_sel.shape[2] != MAXNUM_SNP:
        raise ValueError(f"geno_sel must be int8 [{K}, S, {MAXNUM_SNP}]")
    S = geno_sel.shape[1]
    if a1.dtype != torch.int32 or a2.dtype != torch.int32 \
            or tuple(a1.shape) != (S,) or tuple(a2.shape) != (S,):
        raise ValueError(f"a1 and a2 must be int32 [{S}]")
    if not 0 <= lo <= hi <= S:
        raise ValueError(f"samples {lo}..{hi} outside 0..{S}")
    cuda_only("match_pairs_kernel",
              "models/em.py::match_pairs(engine='torch')", hb, valid, allele,
              geno_sel, a1, a2)
    if hb.data_ptr() % 16:
        raise ValueError("hb must be 16-byte aligned")
    return K, S, H


def match_pairs_kernel(hb, valid, allele, geno_sel, a1, a2, lo=0, hi=None,
                       packed=False):
    """The matched-pair mask of samples lo..hi of K classifiers: hb int32
    [K, H, 4] the slots' bits (ops/train_step.py::pack_bits), valid bool
    [K, H], allele int32 [K, H], geno_sel int8 [K, S, 128] the selected
    codes, a1/a2 int32 [S] (a1 <= a2). Returns int8 [K, hi - lo, H, H] in
    {0, 1}, or with `packed` uint8 [K, hi - lo, H, H // 8] (bit b of byte
    i is column 8i + b)."""
    hi = geno_sel.shape[1] if hi is None else hi
    K, S, H = _check(hb, valid, allele, geno_sel, a1, a2, lo, hi)
    n = hi - lo
    dev = hb.device
    shape = (K, n, H, H // 8) if packed else (K, n, H, H)
    out = torch.empty(shape, dtype=torch.uint8 if packed else torch.int8,
                      device=dev)
    if n == 0:
        return out
    name = "match_pairs_packed" if packed else "match_pairs"
    launch("hibag_match_pairs", name,
           {"K": K, "n": n, "Hp": H, "mode": "packed" if packed else "int8"},
           dev, hb, valid, allele, geno_sel, a1, a2, out, K, S, H, lo, n,
           int(packed), tally=(LAUNCHES, name))
    return out
