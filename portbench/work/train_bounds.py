"""Bytes and operations of one launch of the training step's kernels, from
the launch's own inputs alone, whatever implements them.

Frozen from ``chip_smoke.py`` (``_train_bound``, ``_pairs``,
``_pair_popc``), written over the shapes and counts that the program's
launch records carry (``hibag_tpu_torch/utils/trace.py``; the counts of
``ops/train_step.py::eval_counts``):

* the EM step (``em_estep``, int8 mask; ``em_estep_packed``, one bit a
  pair): the mask, the candidates' frequencies fA and fB in and dfA and
  dfB out (float32 [K, C, H] each), the candidates' codes (int8 [K, C, S]),
  the bootstrap counts (float32 [K, S]) and the log-likelihoods out
  (float32 [K, C]). Only this bytes term is used: the operations depend on
  the mask's set entries, which no record carries;
* the candidate evaluation (``evaluate_candidates_kernel``): bits (float32
  [K, H, 128]), alleles (int32 [K, H]), fA and fB, the candidates' codes
  (int8 [K, C, N]), the selected codes (int8 [K, N, 128]), the true
  alleles (int32 [N] twice), the OOB flags (1 byte [K, N]), the bootstrap
  counts and the outputs (int32 and float32 [K, C]) in bytes; a popcount
  per unordered pair of a classifier's m ok slots (m(m+1)/2) and 32-slot
  word of a sample's selected codes holding a heterozygous code; and 4
  float operations, per candidate, for each pair and sample and for each
  sample and row cell (an ok slot and an allele at or after its own that
  holds ok slots).
"""

from __future__ import annotations

import numpy as np

from .peaks import least_seconds

#: SNP slots of a classifier (HIBAG's MAXNUM_SNP)
SLOTS = 128
EM_KERNELS = ("em_estep", "em_estep_packed")
EVAL_KERNEL = "evaluate_candidates_kernel"


def pairs(nh, n) -> float:
    """Unordered pairs of valid haplotypes, n * sum over classifiers of
    m(m+1)/2 for m = nh[c]: the pair distances a scoring function needs."""
    m = np.asarray(nh, dtype=np.float64)
    return n * float((m * (m + 1) / 2).sum())


def pair_popc(nh, het) -> float:
    """Popcounts the pair distances need: for classifier c, one per
    unordered pair of its nh[c] valid haplotypes and 32-slot word of a
    sample's codes holding a heterozygous code, het[c] such words summed
    over the samples."""
    m = np.asarray(nh, dtype=np.float64)
    return float((m * (m + 1) / 2 * np.asarray(het, np.float64)).sum())


def em_bytes(K, S, H, C, packed: bool) -> float:
    """Bytes in and out of one EM step of K classifiers, S samples, H slots
    and C candidates."""
    mask = K * S * H * H // (8 if packed else 1)
    return float(mask + 4 * 4 * K * C * H + K * C * S + 4 * K * S
                 + 4 * K * C)


def eval_work(K, N, H, C, nok, het, row_cells) -> dict:
    """Bytes, popcounts and float operations of one evaluation of K
    classifiers, N samples, H slots and C candidates; nok [K] ok slots,
    het [K] heterozygous words summed over the samples and row_cells [K]
    (``ops/train_step.py::eval_counts``)."""
    nbytes = (4 * K * H * SLOTS + 4 * K * H + 8 * K * C * H + K * C * N
              + K * N * SLOTS + 8 * N + K * N + 4 * K * N + 8 * K * C)
    cells = float(np.sum(np.asarray(row_cells, dtype=np.float64)))
    return {"bytes": float(nbytes), "popc": pair_popc(nok, het),
            "flops": 4.0 * C * (pairs(nok, N) + N * cells)}


def launch_seconds(rec, popc_rate) -> float:
    """The least time the card needs for the launch record `rec` (a dict
    of name, dims and counts, as ``trace.snapshot()`` gives it)."""
    d = rec["dims"]
    if rec["name"] in EM_KERNELS:
        nbytes = em_bytes(d["K"], d["S"], d["H"], d["C"],
                          rec["name"] == "em_estep_packed")
        return least_seconds(nbytes, 0.0, 0.0, popc_rate)
    nok, het, cells = rec["counts"]
    w = eval_work(d["K"], d["N"], d["H"], d["C"], nok, het, cells)
    return least_seconds(w["bytes"], w["popc"], w["flops"], popc_rate)
