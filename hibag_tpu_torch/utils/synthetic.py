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


#: mosaic switches per megabase of the training cells' panels (chip_smoke.py
#: phases 5 and 6, portbench's hla_a-train cell): on the 1,000-sample x 266-SNP
#: cell it gives classifiers of about 230-390 haplotypes, around the cell's
#: hcap=256 (an H100 run of the port; 0 gives 15-19)
PANEL_RECOMBINATION = 0.5


@dataclass
class HaplotypePool:
    """Full-length haplotypes the model and the cohort are drawn from."""

    bits: np.ndarray     # uint8 [K, P] {0,1}
    allele: np.ndarray   # int64 [K] allele index
    freq: np.ndarray     # float64 [K], sums to 1


def _haplotype_pool(rng, n_snp, n_alleles, max_variants, mutation):
    """One founder haplotype per allele over n_snp SNPs and 1..max_variants
    variants of it, each SNP flipped with probability `mutation`; allele
    frequencies fall off as 1/rank."""
    afreq = 1.0 / np.arange(1, n_alleles + 1)
    afreq /= afreq.sum()
    founders = rng.integers(0, 2, (n_alleles, n_snp), dtype=np.uint8)
    nvar = rng.integers(1, max_variants + 1, n_alleles)
    allele = np.repeat(np.arange(n_alleles), nvar)
    bits = founders[allele] ^ (rng.random((len(allele), n_snp)) < mutation)
    share = np.concatenate([rng.dirichlet(np.ones(k)) for k in nvar])
    return HaplotypePool(bits=bits.astype(np.uint8), allele=allele,
                         freq=afreq[allele] * share)


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
    pool = _haplotype_pool(rng, P, A, max_variants, mutation)
    afreq = 1.0 / np.arange(1, A + 1)
    afreq /= afreq.sum()

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


def _mosaic(rng, pool, idx, p_switch):
    """bits uint8 [n, P] of the pool haplotypes `idx` [n] made mosaics away
    from the middle SNP: walking outward from it, at SNP j a haplotype
    switches with probability p_switch[j] (a scalar or [P]) to copying
    another pool haplotype drawn by frequency. SNPs near the middle keep
    tagging the haplotype's allele, and linkage decays with distance."""
    n, P = len(idx), pool.bits.shape[1]
    mid = P // 2
    sw = rng.random((n, P)) < p_switch
    sw[:, mid] = False
    right = np.cumsum(sw[:, mid:], axis=1)
    left = np.cumsum(sw[:, :mid][:, ::-1], axis=1)[:, ::-1]
    n_right = int(right.max(initial=0)) + 1
    seg = np.concatenate([np.where(left > 0, left + n_right - 1, 0), right],
                         axis=1)
    donors = rng.choice(len(pool.freq), (n, int(seg.max()) + 1),
                        p=pool.freq / pool.freq.sum())
    donors[:, 0] = idx
    return pool.bits[np.take_along_axis(donors, seg, 1), np.arange(P)]


def _switch_prob(pos, per_mb):
    """[P] switch probability at each SNP for `_mosaic`: 1 - exp(-per_mb *
    gap / 1 Mb), gap the distance to the neighbouring SNP on the middle's
    side (0 at the middle SNP)."""
    mid = len(pos) // 2
    d = np.diff(pos).astype(np.float64)
    gap = np.zeros(len(pos))
    gap[mid + 1:] = d[mid:]
    gap[:mid] = d[:mid]
    return -np.expm1(-per_mb * gap / 1e6)


def synthetic_panel(seed: int, n_samples: int, n_snp: int, n_alleles: int,
                    n_held_out: int = 0, max_variants: int = 5,
                    mutation: float = 0.02, missing: float = 0.02,
                    recombination: float = 0.0):
    """A typed reference panel drawn from a seeded HaplotypePool, so that
    its alleles can be tagged by SNPs: (HLATypeTable, SNPGenoData) for
    `n_samples` samples, and the same for `n_held_out` more samples of the
    same pool (None when 0). Each sample is a pair of pool haplotypes drawn
    by frequency, with a `missing` fraction of codes set to missing.

    With ``recombination`` > 0 each haplotype is a mosaic of pool haplotypes
    away from the middle SNP (`_mosaic`), switching ``recombination`` times
    per megabase on average: the panel then holds many distinct haplotypes
    per allele, as a real one does, instead of at most `max_variants`; the
    same rate gives panels of different SNP density the same linkage over
    distance."""
    from ..data.allele import HLATypeTable

    rng = np.random.default_rng(seed)
    pool = _haplotype_pool(rng, n_snp, n_alleles, max_variants, mutation)
    pos = np.sort(rng.choice(np.arange(29_400_000, 30_400_000), n_snp,
                             replace=False)).astype(np.int64)
    names = np.array([f"{a + 1:02d}:01" for a in range(n_alleles)],
                     dtype=object)

    def haplotypes(idx):
        if recombination > 0:
            return _mosaic(rng, pool, idx, _switch_prob(pos, recombination))
        return pool.bits[idx]

    def draw(n, first):
        i1 = rng.choice(len(pool.freq), n, p=pool.freq / pool.freq.sum())
        i2 = rng.choice(len(pool.freq), n, p=pool.freq / pool.freq.sum())
        geno = (haplotypes(i1) + haplotypes(i2)).T                # [P, n]
        geno[rng.random(geno.shape) < missing] = GENO_MISSING
        ids = np.array([f"s{first + i}" for i in range(n)], dtype=object)
        table = HLATypeTable.from_alleles(
            ids, names[pool.allele[i1]], names[pool.allele[i2]], locus="A")
        data = SNPGenoData(
            genotype=geno.astype(np.uint8), sample_id=ids,
            snp_id=np.array([f"rs{i}" for i in range(n_snp)], dtype=object),
            snp_position=pos,
            snp_allele=np.array(["A/G"] * n_snp, dtype=object),
            assembly="hg19")
        return table, data

    train = draw(n_samples, 0)
    held = draw(n_held_out, n_samples) if n_held_out else None
    return train, held


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
