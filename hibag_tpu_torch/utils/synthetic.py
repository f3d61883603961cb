"""Seeded synthetic HLA models and cohorts at the width of a published HIBAG
model, for runs where no trained model or reference panel is at hand.

A pool of full-length haplotypes over the model's SNPs is drawn first: one
random founder haplotype per HLA allele, and a few variants of it that
differ at a small fraction of the SNPs. Allele frequencies fall off as
1/rank, as allele spectra at HLA loci do. Each classifier is the pool
projected onto a random subset of SNPs: identical projections merge with
their frequencies summed, and the most frequent ones are kept, grouped by
allele as the reference's haplotype lists are. A sample is a pair of pool
haplotypes drawn by frequency, so its true alleles are known.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import GENO_MISSING
from ..data.geno import SNPGenoData
from ..models.model import AttrBagModel, Classifier


@dataclass
class HaplotypePool:
    """Full-length haplotypes the model and the cohort are drawn from."""

    bits: np.ndarray     # uint8 [K, P] {0,1}
    allele: np.ndarray   # int64 [K] allele index
    freq: np.ndarray     # float64 [K], sums to 1


def synthetic_model(seed: int, n_classifiers: int = 100, n_snp: int = 1000,
                    n_alleles: int = 48, snp_range=(15, 60),
                    hap_range=(30, 120), max_variants: int = 5,
                    mutation: float = 0.02):
    """(AttrBagModel, HaplotypePool) drawn from `seed`.

    Each classifier takes between snp_range SNPs and keeps between
    hap_range haplotypes (fewer when the projections merge below that).
    """
    rng = np.random.default_rng(seed)
    P, A = n_snp, n_alleles
    afreq = 1.0 / np.arange(1, A + 1)
    afreq /= afreq.sum()
    founders = rng.integers(0, 2, (A, P), dtype=np.uint8)
    nvar = rng.integers(1, max_variants + 1, A)
    allele = np.repeat(np.arange(A), nvar)
    bits = founders[allele] ^ (rng.random((len(allele), P)) < mutation)
    share = np.concatenate([rng.dirichlet(np.ones(k)) for k in nvar])
    pool = HaplotypePool(bits=bits.astype(np.uint8), allele=allele,
                         freq=afreq[allele] * share)

    classifiers = []
    for _ in range(n_classifiers):
        ns = int(rng.integers(snp_range[0], snp_range[1] + 1))
        snps = np.sort(rng.choice(P, ns, replace=False))
        key = np.concatenate([pool.allele[:, None], pool.bits[:, snps]], 1)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        f = np.bincount(inv.ravel(), weights=pool.freq)
        nh = min(len(uniq), int(rng.integers(hap_range[0], hap_range[1] + 1)))
        top = np.argsort(-f, kind="stable")[:nh]
        top = top[np.argsort(uniq[top, 0], kind="stable")]
        classifiers.append(Classifier(
            snp_index=snps.astype(np.int32),
            hap_bits=uniq[top, 1:].astype(np.uint8),
            hap_freq=f[top] / f[top].sum(),
            hap_allele=uniq[top, 0].astype(np.int32)))

    pos = np.sort(rng.choice(np.arange(29_400_000, 30_400_000), P,
                             replace=False)).astype(np.int64)
    model = AttrBagModel(
        locus="A",
        snp_id=np.array([f"rs{i}" for i in range(P)], dtype=object),
        snp_position=pos,
        snp_allele=np.array(["A/G"] * P, dtype=object),
        hla_alleles=[f"{a + 1:02d}:01" for a in range(A)],
        classifiers=classifiers,
        snp_allele_freq=pool.freq @ pool.bits,
        hla_freq=afreq,
        assembly="hg19")
    return model, pool


def synthetic_cohort(model: AttrBagModel, pool: HaplotypePool,
                     n_samples: int, seed: int, missing: float = 0.02):
    """(SNPGenoData, true allele1, true allele2) for `n_samples` samples,
    each a pair of pool haplotypes drawn by frequency, with a `missing`
    fraction of genotype codes set to missing."""
    rng = np.random.default_rng(seed)
    i1 = rng.choice(len(pool.freq), n_samples, p=pool.freq)
    i2 = rng.choice(len(pool.freq), n_samples, p=pool.freq)
    geno = (pool.bits[i1] + pool.bits[i2]).T                  # [P, N]
    geno[rng.random(geno.shape) < missing] = GENO_MISSING
    names = np.asarray(model.hla_alleles, dtype=object)
    data = SNPGenoData(
        genotype=geno.astype(np.uint8),
        sample_id=np.array([f"s{i}" for i in range(n_samples)], dtype=object),
        snp_id=model.snp_id, snp_position=model.snp_position,
        snp_allele=model.snp_allele, assembly=model.assembly)
    return data, names[pool.allele[i1]], names[pool.allele[i2]]
