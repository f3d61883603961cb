"""Dosage-VCF export of imputed HLA types.

Equivalent of hlaAlleleToVCF (reference R/DataUtilities.R:2581-2745): each
HLA allele becomes one VCF record with per-sample GT (carrier status of the
allele) and DS (expected dosage), with an optional posterior-probability
cutoff masking low-confidence calls. `.gz` output is true BGZF (io/bgzf.py)
— tabix-indexable like the reference's Rsamtools bgzip connection
(src/samtools_ext.c:1-97), and readable by any plain gzip reader.

The port's copy of hibag_tpu/io/vcf.py, so that the port imports nothing
of that package.
"""

from __future__ import annotations

import time
from typing import Sequence, Union

import numpy as np

from ..data.allele import loci_info, unique_alleles

_CONTIG = {"hg38": "##contig=<ID=6,length=170805979>"}
_DEFAULT_CONTIG = "##contig=<ID=6,length=171115067>"


def _gene_prefix(locus: str) -> str:
    return locus if locus.startswith(("KIR", "HLA")) else f"HLA-{locus}"


def write_vcf(results, out_fn: str, ds: bool = True,
              allele_list: Union[bool, Sequence[str]] = False,
              prob_cutoff: float = float("nan"),
              assembly: str = "hg19") -> None:
    """Write one or more prediction results / HLA tables to a dosage VCF."""
    if not isinstance(results, (list, tuple)):
        results = [results]
    sample_id = np.asarray(results[0].sample_id)
    for r in results:
        if not np.array_equal(np.asarray(r.sample_id), sample_id):
            raise ValueError("sample IDs differ between objects")

    if out_fn.endswith(".gz"):
        from .bgzf import BgzfWriter
        opener = BgzfWriter
    else:
        opener = open
    with opener(out_fn, "wt") as f:
        has_ds = ds and any(getattr(r, "dosage", None) is not None
                            for r in results)
        header = [
            "##fileformat=VCFv4.0",
            f"##fileDate={time.strftime('%Y%m%d')}",
            "##source=hibag_tpu",
            f"##reference={assembly}",
            _CONTIG.get(assembly, _DEFAULT_CONTIG),
            '##FILTER=<ID=PASS,Description="All filters passed">',
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        ]
        if has_ds:
            header.append('##FORMAT=<ID=DS,Number=1,Type=Float,'
                          'Description="Dosage of HLA allele">')
        header.append("\t".join(["#CHROM", "POS", "ID", "REF", "ALT", "QUAL",
                                 "FILTER", "INFO", "FORMAT"]
                                + [str(s) for s in sample_id]))
        f.write("\n".join(header) + "\n")

        for r in results:
            if allele_list is True and getattr(r, "dosage", None) is not None \
                    and getattr(r, "hla_alleles", None):
                alleles = unique_alleles(r.hla_alleles)
            elif isinstance(allele_list, (list, tuple, np.ndarray)):
                alleles = [a for a in dict.fromkeys(allele_list) if a]
            else:
                alleles = unique_alleles(
                    np.concatenate([np.asarray(r.allele1, dtype=object),
                                    np.asarray(r.allele2, dtype=object)]))

            locus = getattr(r, "locus", "any")
            info = loci_info(assembly)
            if locus in info:
                _, s, e, _ = info[locus]
                pos = str(round((s + e) / 2))
            else:
                pos = "0"

            na_sel = np.zeros(len(sample_id), dtype=bool)
            prob = getattr(r, "prob", None)
            if np.isfinite(prob_cutoff) and prob is not None:
                na_sel = np.asarray(prob) < prob_cutoff
                na_sel[~np.isfinite(np.asarray(prob))] = False

            r_ds = getattr(r, "dosage", None) if ds else None
            names = list(getattr(r, "hla_alleles", []) or [])
            a1 = np.asarray(r.allele1, dtype=object)
            a2 = np.asarray(r.allele2, dtype=object)
            for h in alleles:
                import re
                alt = "P_" + re.sub(r"[^a-zA-Z0-9]", "", h)
                fmt = "GT:DS" if (r_ds is not None) else "GT"
                row = ["6", pos, f"{_gene_prefix(locus)}*{h}", "A", alt,
                       ".", "PASS", ".", fmt]
                cells = []
                if r_ds is not None and h in names:
                    dvec = np.asarray(r_ds)[names.index(h)]
                else:
                    dvec = None
                for i in range(len(sample_id)):
                    g1 = "." if a1[i] is None else str(int(a1[i] == h))
                    g2 = "." if a2[i] is None else str(int(a2[i] == h))
                    gt = "./." if na_sel[i] else f"{g1}/{g2}"
                    if r_ds is not None:
                        if dvec is None or na_sel[i] or not np.isfinite(dvec[i]):
                            cells.append(f"{gt}:.")
                        else:
                            cells.append(f"{gt}:{dvec[i]:.5g}")
                    else:
                        cells.append(gt)
                f.write("\t".join(row + cells) + "\n")
