"""Small data utilities: allele/SNP validity checks, summaries
(counterpart of hibag_tpu/data/misc.py).

Equivalents of hlaCheckAllele (reference R/DataUtilities.R:1871 +
HIBAG_AlleleStrand2, src/HIBAG.cpp:345-398), hlaCheckSNPs
(R/DataUtilities.R:1883), hlaSampleAllele (R/DataUtilities.R:1640), and the
summary/print S3 methods.
"""

from __future__ import annotations

import numpy as np

from .allele import allele_digit

_COMP = {"A": "T", "T": "A", "C": "G", "G": "C"}


def check_allele(allele1, allele2) -> np.ndarray:
    """Per-pair validity: both 'X/Y' with A/T/G/C letters, equal as a pair
    directly, swapped, or under strand complement (hlaCheckAllele)."""
    out = np.zeros(len(allele1), dtype=bool)
    for i, (a, b) in enumerate(zip(allele1, allele2)):
        try:
            s1, s2 = str(a).split("/")[:2]
            p1, p2 = str(b).split("/")[:2]
        except ValueError:
            continue
        if not all(x in _COMP for x in (s1, s2, p1, p2)):
            continue
        out[i] = ((s1, s2) == (p1, p2) or (s1, s2) == (p2, p1)
                  or (s1, s2) == (_COMP[p1], _COMP[p2])
                  or (s1, s2) == (_COMP[p2], _COMP[p1]))
    return out


def check_snps(model, target, match_type: str = "Position") -> dict:
    """Per-classifier counts of SNP predictors present in the target
    (hlaCheckSNPs). `target` may be SNPGenoData or a key array."""
    from .geno import SNPGenoData, _model_keys
    src_keys = _model_keys(model, match_type)
    if isinstance(target, SNPGenoData):
        tgt = set(target.snp_key(match_type).tolist())
    else:
        tgt = set(str(x) for x in target)
    n_valid, n_snp = [], []
    for c in model.classifiers:
        keys = src_keys[c.snp_index]
        n_snp.append(len(keys))
        n_valid.append(sum(1 for k in keys if k in tgt))
    n_valid = np.asarray(n_valid)
    n_snp = np.asarray(n_snp)
    return {"NumOfValidSNP": n_valid, "NumOfSNP": n_snp,
            "fraction": n_valid / np.maximum(n_snp, 1)}


def sample_alleles(table, allele_limit=None, max_resolution: str = ""):
    """Sample IDs whose both alleles are non-missing and (optionally) within
    the allele set of a model / list (hlaSampleAllele)."""
    a1 = np.asarray(table.allele1, dtype=object)
    a2 = np.asarray(table.allele2, dtype=object)
    flag = np.array([x is not None and y is not None
                     for x, y in zip(a1, a2)])
    if max_resolution not in ("", "full"):
        a1 = allele_digit(a1, max_resolution)
        a2 = allele_digit(a2, max_resolution)
    if allele_limit is not None:
        if hasattr(allele_limit, "hla_alleles"):
            allowed = set(allele_limit.hla_alleles)
        else:
            allowed = set(str(x) for x in allele_limit)
        if max_resolution not in ("", "full"):
            allowed = set(allele_digit(np.array(sorted(allowed), dtype=object),
                                       max_resolution))
        ok = np.array([(x in allowed) and (y in allowed)
                       for x, y in zip(a1, a2)])
        flag = flag & ok
    return np.asarray(table.sample_id)[flag]


def summary_geno(g) -> str:
    """summary.hlaSNPGenoClass-style text."""
    maf = g.maf()
    mr_snp = g.missing_rate_snp()
    mr_samp = g.missing_rate_samp()
    lines = [
        f"SNP genotypes: {g.n_samp} samples X {g.n_snp} SNPs",
        f"SNPs range from {g.snp_position.min()}bp "
        f"to {g.snp_position.max()}bp on {g.assembly}",
        f"Missing rate per SNP: mean {np.nanmean(mr_snp):.4f}, "
        f"median {np.nanmedian(mr_snp):.4f}, max {np.nanmax(mr_snp):.4f}",
        f"Missing rate per sample: mean {np.nanmean(mr_samp):.4f}, "
        f"median {np.nanmedian(mr_samp):.4f}, max {np.nanmax(mr_samp):.4f}",
        f"MAF: mean {np.nanmean(maf):.4f}, median {np.nanmedian(maf):.4f}, "
        f"min {np.nanmin(maf):.4f}",
    ]
    return "\n".join(lines)


def summary_table(t) -> str:
    """summary.hlaAlleleClass-style text with allele counts/frequencies."""
    counts = t.allele_counts()
    total = sum(counts.values())
    lines = [f"Gene: {t.locus}",
             f"Range: [{t.pos_start}bp, {t.pos_end}bp] on {t.assembly}",
             f"# of samples: {t.n_samp}",
             f"# of unique HLA alleles: {len(counts)}",
             "allele     count  freq"]
    for a, c in counts.items():
        lines.append(f"{a:<10} {c:>5}  {c / total:.4f}")
    return "\n".join(lines)


def summary_model(model) -> str:
    """summary.hlaAttrBagObj-style text."""
    from ..models.introspect import summarize
    s = summarize(model)
    i = s["info"]
    lines = [
        f"Gene: {model.locus}",
        f"Training dataset: {0 if model.sample_id is None else len(model.sample_id)}"
        f" samples X {model.n_snp} SNPs",
        f"    # of HLA alleles: {model.n_alleles}",
        f"    # of individual classifiers: {s['num.classifier']}",
        f"    total # of SNPs used: {s['num.snp']}",
        f"    avg. # of SNPs in an individual classifier: "
        f"{i['num.snp']['Mean']:.2f} (sd {i['num.snp']['SD']:.2f})",
        f"    avg. # of haplotypes in an individual classifier: "
        f"{i['num.haplo']['Mean']:.2f} (sd {i['num.haplo']['SD']:.2f})",
        f"    avg. out-of-bag accuracy: {i['accuracy']['Mean']:.2f}% "
        f"(sd {i['accuracy']['SD']:.2f}%)",
        f"Genome assembly: {model.assembly}",
    ]
    return "\n".join(lines)
