"""Model introspection: per-classifier summary, allele distance, LD
(counterpart of hibag_tpu/models/introspect.py).

Equivalents of summary.hlaAttrBagObj (reference R/HIBAG.R:1185-1268),
hlaDistance (R/HIBAG.R:1545-1571 + HIBAG_Distance, src/HIBAG.cpp:1284-1332)
and hlaGenoLD (R/HIBAG.R:1399-1446).
"""

from __future__ import annotations

import numpy as np

from ..constants import GENO_MISSING
from .model import AttrBagModel


def summarize(model: AttrBagModel) -> dict:
    """Per-classifier statistics + SNP usage histogram."""
    num_snp = np.array([c.n_snp for c in model.classifiers])
    num_haplo = np.array([c.n_haplo for c in model.classifiers])
    acc = np.array([c.oob_accuracy for c in model.classifiers]) * 100
    snp_hist = np.zeros(model.n_snp, dtype=np.int64)
    used = set()
    for c in model.classifiers:
        snp_hist[c.snp_index] += 1
        used.update(int(i) for i in c.snp_index)

    def stats(x):
        return {"Mean": float(np.mean(x)), "SD": float(np.std(x, ddof=1)),
                "Min": float(np.min(x)), "Max": float(np.max(x)),
                "Median": float(np.median(x))}

    return {
        "num.classifier": model.n_classifiers,
        "num.snp": len(used),
        "snp.id": model.snp_id,
        "snp.position": model.snp_position,
        "snp.hist": snp_hist,
        "info": {"num.snp": stats(num_snp), "num.haplo": stats(num_haplo),
                 "accuracy": stats(acc)},
    }


def allele_distance(model: AttrBagModel) -> np.ndarray:
    """Frequency-weighted Hamming distance matrix between HLA alleles,
    averaged over classifiers (hlaDistance)."""
    m = model.n_alleles
    dist_acc = np.zeros((m, m))
    count = np.zeros((m, m), dtype=np.int64)
    for c in model.classifiers:
        fsum = np.zeros((m, m))
        dsum = np.zeros((m, m))
        bits = c.hap_bits.astype(np.int16)
        # pairwise haplotype Hamming distances
        d = (bits[:, None, :] != bits[None, :, :]).sum(-1)
        f = np.outer(c.hap_freq, c.hap_freq)
        ai = c.hap_allele
        n = len(ai)
        iu, ju = np.triu_indices(n)
        np.add.at(fsum, (ai[iu], ai[ju]), f[iu, ju])
        np.add.at(dsum, (ai[iu], ai[ju]), f[iu, ju] * d[iu, ju])
        with np.errstate(invalid="ignore", divide="ignore"):
            dm = dsum / fsum
        # symmetrize from the upper triangle
        up = np.triu(np.ones((m, m), bool))
        full = np.where(up, dm, dm.T)
        ok = np.isfinite(full)
        count += ok
        dist_acc += np.where(ok, full, 0.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        return dist_acc / count


def geno_ld(hla_table, geno) -> np.ndarray:
    """Mean r^2 between each SNP and HLA-allele dosage indicators
    (hlaGenoLD)."""
    from ..data.geno import SNPGenoData
    if isinstance(geno, SNPGenoData):
        pos = {s: i for i, s in enumerate(hla_table.sample_id)}
        sel = np.array([pos[s] for s in geno.sample_id])
        a1 = hla_table.allele1[sel]
        a2 = hla_table.allele2[sel]
        g = geno.genotype.astype(np.float64)
        g[g >= GENO_MISSING] = np.nan
    else:
        g = np.asarray(geno, dtype=np.float64)
        if g.ndim == 1:
            g = g[None, :]
        a1, a2 = hla_table.allele1, hla_table.allele2

    alleles = sorted(set(a1) | set(a2))
    amat = np.stack([(a1 == a).astype(float) + (a2 == a).astype(float)
                     for a in alleles], axis=1)  # [N, A]

    out = np.empty(g.shape[0])
    for i in range(g.shape[0]):
        x = g[i]
        ok = np.isfinite(x)
        r2 = []
        for j in range(amat.shape[1]):
            xv, yv = x[ok], amat[ok, j]
            if xv.std() == 0 or yv.std() == 0 or len(xv) < 2:
                continue
            r = np.corrcoef(xv, yv)[0, 1]
            if np.isfinite(r):
                r2.append(r * r)
        out[i] = np.mean(r2) if r2 else np.nan
    return out


def ld_matrix(geno, maf: float = 0.01) -> np.ndarray:
    """Pairwise SNP r^2 matrix (hlaLDMatrix core computation)."""
    g = geno.genotype.astype(np.float64)
    g[g >= GENO_MISSING] = np.nan
    keep = np.nan_to_num(geno.maf()) >= maf
    g = g[keep]
    # pairwise correlation with NaN handling
    with np.errstate(invalid="ignore"):
        masked = np.ma.masked_invalid(g)
        r = np.ma.corrcoef(masked)
    return np.asarray(r.filled(np.nan)) ** 2
