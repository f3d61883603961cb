"""Operations and bytes that a prediction or a training needs, counted from
its inputs alone, whatever implements it.

Frozen from ``chip_smoke.py`` (``_pairs``, ``_pair_popc``, ``_bound``,
``_scores_bound``, with ``_hap_bytes`` counted over the valid haplotypes
instead of a padded layout). For a classifier with m valid haplotypes and
a sample, the scoring needs one distance per unordered pair of them,
m(m+1)/2, each a popcount per 32-SNP word of the classifier's slots that
holds a heterozygous code (a word without one adds nothing), and one
multiply-add (2 float operations) per pair to fold the pair's penalty into
its allele cell.
"""

from __future__ import annotations

import numpy as np

#: SNP slots of a classifier (HIBAG's MAXNUM_SNP), as 4 words of 32
SLOTS = 128
WORD = 32


def pairs(nh) -> np.ndarray:
    """Unordered pairs m(m+1)/2 of each classifier's m = nh valid
    haplotypes, float64 [C]."""
    m = np.asarray(nh, dtype=np.float64)
    return m * (m + 1) / 2


def het_words(codes, snp_index):
    """[C, N] float64: for classifier c and sample n, the 32-slot words of
    c's SNP slots that hold a heterozygous code. codes: torch uint8 [N, P]
    (codes {0,1,2,3}); snp_index: torch int64 [C, SLOTS] (-1 past c's
    SNPs). Runs on the tensors' device, a few classifiers at a time."""
    import torch

    C = snp_index.shape[0]
    out = torch.empty((C, codes.shape[0]), dtype=torch.float64,
                      device=codes.device)
    het = codes == 1
    for c0 in range(0, C, 8):
        si = snp_index[c0:c0 + 8]
        g = het[:, si.clamp_min(0)] & (si >= 0)[None]        # [N, c, SLOTS]
        words = g.reshape(g.shape[0], g.shape[1], SLOTS // WORD, WORD)
        out[c0:c0 + 8] = words.any(-1).sum(-1).T.to(torch.float64)
    return out


def hap_bytes(nh, n_classifiers: int) -> float:
    """Bytes of the haplotypes: 16 of bits (128 slots), 4 of frequency and
    4 of allele for each valid haplotype, and a count per classifier."""
    return 24.0 * float(np.sum(nh)) + 4.0 * n_classifiers


def scoring_work(nh, hw, n_alleles: int, ensemble: bool) -> dict:
    """Bytes, popcounts and float operations of scoring one block of N
    samples against C classifiers: nh [C] valid haplotypes, hw [C, N]
    `het_words`. Inputs: the haplotypes and the codes gathered to the
    classifiers' slots (1 byte a slot); outputs: the ensemble posterior
    [N, A, A] and per classifier and sample its dmin and total
    (``ensemble``, the ensemble kernel, which also reads a weight per
    classifier and sample), or each classifier's scores [C, N, A, A] and
    its dmin and total (the scan engine's scoring kernel)."""
    C, N = hw.shape
    A = n_alleles
    pr = pairs(nh)
    nbytes = hap_bytes(nh, C) + C * N * SLOTS + 8.0 * C * N
    nbytes += (4.0 * C * N + 4.0 * N * A * A) if ensemble \
        else 4.0 * C * N * A * A
    return {"bytes": nbytes, "popc": float((pr[:, None] * hw).sum()),
            "flops": 2.0 * N * float(pr.sum())}


def predict_call_work(nh, hw, n_alleles: int, n_snp: int) -> dict:
    """The whole predict() call: the ensemble's scoring work, plus the
    cohort's codes in (1 byte a sample and model SNP) and the outputs out
    (the best guess, its probability, the matching and A dosages, 4 bytes
    each, per sample)."""
    w = scoring_work(nh, hw, n_alleles, ensemble=True)
    N = hw.shape[1]
    w["bytes"] += float(N) * n_snp + 4.0 * N * (n_alleles + 5)
    return w


def train_popc(classifiers, mtry: int, n_samples: int) -> float:
    """Popcounts of the pair distances a trained classifier's greedy path
    implies, summed over `classifiers` (each a pair (hap_allele [h],
    hap_bits [h, s]) of its final haplotypes in the order its SNPs were
    taken): at each step j = 1..s, mtry candidates, each costing the
    unordered pairs of the distinct (allele, first j bits) projections of
    the final haplotypes, times the samples, times ceil(j / 32) words. The
    list a step holds projects onto at least these, so the count is a lower
    bound."""
    total = 0.0
    for allele, bits in classifiers:
        bits = np.asarray(bits, dtype=np.uint8)
        allele = np.asarray(allele, dtype=np.int64)
        for j in range(1, bits.shape[1] + 1):
            key = np.concatenate([allele[:, None], bits[:, :j]], 1)
            m = float(len(np.unique(key, axis=0)))
            total += mtry * m * (m + 1) / 2 * n_samples * -(-j // WORD)
    return total
