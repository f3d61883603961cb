"""Seeded synthetic HLA models, cohorts and typed panels as plain arrays.

A frozen copy of the generators of ``hibag_tpu_torch/utils/synthetic.py``
(``_haplotype_pool``, ``synthetic_model``, ``synthetic_cohort``,
``synthetic_panel`` with its mosaic haplotypes), so that a change to the
program never changes the benchmark's inputs. It returns numpy arrays and
imports nothing of the program; the harness builds the program's objects
from them, and the reference reads the same arrays.

One change from the copy: a model's sizes (SNPs and haplotypes of each
classifier) are drawn from a fixed ``shape_seed`` and only their order and
contents from the run's seed, so every seed has the same amount of work. A
classifier whose projected pool holds fewer distinct haplotypes than its
size is filled up with rare one-SNP variants of its most frequent ones.
"""

from __future__ import annotations

import numpy as np

#: genotype code of a missing call
GENO_MISSING = 3


def allele_names(n_alleles: int) -> list:
    """The allele names of a locus with `n_alleles` alleles: "01:01",
    "02:01", ... in their field-wise sort order."""
    return [f"{a + 1:02d}:01" for a in range(n_alleles)]


def haplotype_pool(rng, n_snp, n_alleles, max_variants, mutation):
    """(bits uint8 [K, P], allele int64 [K], freq float64 [K]): one founder
    haplotype per allele over n_snp SNPs and 1..max_variants variants of
    it, each SNP flipped with probability `mutation`; allele frequencies
    fall off as 1/rank."""
    afreq = 1.0 / np.arange(1, n_alleles + 1)
    afreq /= afreq.sum()
    founders = rng.integers(0, 2, (n_alleles, n_snp), dtype=np.uint8)
    nvar = rng.integers(1, max_variants + 1, n_alleles)
    allele = np.repeat(np.arange(n_alleles), nvar)
    bits = founders[allele] ^ (rng.random((len(allele), n_snp)) < mutation)
    share = np.concatenate([rng.dirichlet(np.ones(k)) for k in nvar])
    return bits.astype(np.uint8), allele, afreq[allele] * share


def model_shapes(shape_seed, n_classifiers, snp_range, hap_range):
    """(n_snp [C], n_hap [C]) of each classifier, from `shape_seed` alone."""
    rng = np.random.default_rng(shape_seed)
    ns = rng.integers(snp_range[0], snp_range[1] + 1, n_classifiers)
    nh = rng.integers(hap_range[0], hap_range[1] + 1, n_classifiers)
    return ns, nh


def _fill(rng, key, f, nh):
    """key [u, 1 + s] (allele, bits) and f [u] with rare one-SNP variants of
    the most frequent rows appended until `nh` distinct rows exist."""
    seen = {r.tobytes() for r in key}
    extra_k, extra_f = [], []
    order = np.argsort(-f, kind="stable")
    i = 0
    while len(seen) < nh:
        parent = order[i % len(order)]
        i += 1
        row = key[parent].copy()
        j = 1 + int(rng.integers(0, key.shape[1] - 1))
        row[j] ^= 1
        b = row.tobytes()
        if b in seen:
            continue
        seen.add(b)
        extra_k.append(row)
        extra_f.append(f[parent] * 1e-3)
    if not extra_k:
        return key, f
    return (np.concatenate([key, np.stack(extra_k)]),
            np.concatenate([f, np.asarray(extra_f)]))


def synthetic_model(seed: int, n_classifiers: int, n_snp: int,
                    n_alleles: int, snp_range, hap_range,
                    max_variants: int, mutation: float, shape_seed: int):
    """A model drawn from `seed` with sizes fixed by `shape_seed`.

    Returns (model, pool): model a dict with ``classifiers`` (a list of dicts
    of snp_index int32 [s], hap_bits uint8 [h, s], hap_freq float64 [h]
    summing to 1, hap_allele int32 [h], grouped by allele), ``snp_position``
    int64 [P], ``alleles`` (names), ``snp_allele_freq`` [P] and
    ``hla_freq`` [A]; pool the (bits, allele, freq) the cohort is drawn
    from."""
    rng = np.random.default_rng(seed)
    P, A = n_snp, n_alleles
    bits, allele, freq = haplotype_pool(rng, P, A, max_variants, mutation)
    ns_all, nh_all = model_shapes(shape_seed, n_classifiers, snp_range,
                                  hap_range)
    order = rng.permutation(n_classifiers)
    classifiers = []
    for c in order:
        ns, nh = int(ns_all[c]), int(nh_all[c])
        snps = np.sort(rng.choice(P, ns, replace=False))
        key = np.concatenate([allele[:, None], bits[:, snps]], 1)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        f = np.bincount(inv.ravel(), weights=freq)
        if len(uniq) < nh:
            uniq, f = _fill(rng, uniq, f, nh)
        top = np.argsort(-f, kind="stable")[:nh]
        top = top[np.argsort(uniq[top, 0], kind="stable")]
        classifiers.append(dict(
            snp_index=snps.astype(np.int32),
            hap_bits=uniq[top, 1:].astype(np.uint8),
            hap_freq=f[top] / f[top].sum(),
            hap_allele=uniq[top, 0].astype(np.int32)))
    afreq = 1.0 / np.arange(1, A + 1)
    afreq /= afreq.sum()
    pos = np.sort(rng.choice(np.arange(29_400_000, 30_400_000), P,
                             replace=False)).astype(np.int64)
    model = dict(classifiers=classifiers, snp_position=pos,
                 alleles=allele_names(A), snp_allele_freq=freq @ bits,
                 hla_freq=afreq)
    return model, (bits, allele, freq)


def synthetic_cohort(pool, n_samples: int, seed: int, missing: float):
    """(geno uint8 [P, N] with codes {0,1,2,3}, true allele indices t1, t2
    [N]): each sample a pair of pool haplotypes drawn by frequency, a
    `missing` fraction of codes set to missing."""
    bits, allele, freq = pool
    rng = np.random.default_rng(seed)
    i1 = rng.choice(len(freq), n_samples, p=freq)
    i2 = rng.choice(len(freq), n_samples, p=freq)
    geno = (bits[i1] + bits[i2]).T
    geno[rng.random(geno.shape) < missing] = GENO_MISSING
    return geno.astype(np.uint8), allele[i1], allele[i2]


def _mosaic(rng, bits, freq, idx, p_switch):
    """bits uint8 [n, P] of the pool haplotypes `idx` [n] made mosaics away
    from the middle SNP: walking outward from it, at SNP j a haplotype
    switches with probability p_switch[j] to copying another pool haplotype
    drawn by frequency."""
    n, P = len(idx), bits.shape[1]
    mid = P // 2
    sw = rng.random((n, P)) < p_switch
    sw[:, mid] = False
    right = np.cumsum(sw[:, mid:], axis=1)
    left = np.cumsum(sw[:, :mid][:, ::-1], axis=1)[:, ::-1]
    n_right = int(right.max(initial=0)) + 1
    seg = np.concatenate([np.where(left > 0, left + n_right - 1, 0), right],
                         axis=1)
    donors = rng.choice(len(freq), (n, int(seg.max()) + 1),
                        p=freq / freq.sum())
    donors[:, 0] = idx
    return bits[np.take_along_axis(donors, seg, 1), np.arange(P)]


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
                    max_variants: int, mutation: float, missing: float,
                    recombination: float):
    """A typed reference panel: dict of geno uint8 [P, N], a1 and a2 int64
    [N] (allele indices of the two haplotypes, in drawing order),
    snp_position int64 [P] and alleles (names). With ``recombination`` > 0
    each haplotype is a mosaic of pool haplotypes away from the middle SNP,
    switching ``recombination`` times per megabase on average."""
    rng = np.random.default_rng(seed)
    bits, allele, freq = haplotype_pool(rng, n_snp, n_alleles, max_variants,
                                        mutation)
    pos = np.sort(rng.choice(np.arange(29_400_000, 30_400_000), n_snp,
                             replace=False)).astype(np.int64)

    def haplotypes(idx):
        if recombination > 0:
            return _mosaic(rng, bits, freq, idx,
                           _switch_prob(pos, recombination))
        return bits[idx]

    p = freq / freq.sum()
    i1 = rng.choice(len(freq), n_samples, p=p)
    i2 = rng.choice(len(freq), n_samples, p=p)
    geno = (haplotypes(i1) + haplotypes(i2)).T
    geno[rng.random(geno.shape) < missing] = GENO_MISSING
    return dict(geno=geno.astype(np.uint8), a1=allele[i1], a2=allele[i2],
                snp_position=pos, alleles=allele_names(n_alleles))
