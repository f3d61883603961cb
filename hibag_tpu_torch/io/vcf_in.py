"""VCF genotype import.

Python-ecosystem complement to the reference's GDS importer (hlaGDS2Geno,
R/DataUtilities.R:787): SNPRelate/SeqArray GDS files export losslessly to
VCF, and VCF is the standard interchange for the imputed-GWAS cohorts the
prediction configs target. Reads biallelic SNP records' GT fields into
SNPGenoData (genotype = count of the REF allele, matching the "A allele"
convention of snp.allele "REF/ALT").

The port's copy of hibag_tpu/io/vcf_in.py, so that the port imports nothing
of that package.
"""

from __future__ import annotations

import gzip
from typing import Optional

import numpy as np

from ..constants import GENO_MISSING
from ..data.geno import SNPGenoData


def read_vcf(path: str, import_chr: str = "xMHC", assembly: str = "hg19",
             max_records: Optional[int] = None) -> SNPGenoData:
    """Read biallelic SNP genotypes from a VCF(.gz) file."""
    from .bed import select_region

    from .native import vcf_gt_codes

    opener = gzip.open if path.endswith(".gz") else open
    sample_id: Optional[list] = None
    snp_id, pos, chrom, allele, rows = [], [], [], [], []
    with opener(path, "rt") as f:
        for ln in f:
            if ln.startswith("##"):
                continue
            if ln.startswith("#CHROM"):
                sample_id = ln.rstrip("\n").split("\t")[9:]
                continue
            if sample_id is None:
                raise ValueError("VCF has no #CHROM header line")
            # split only the 9 fixed columns; the (possibly huge) sample
            # region stays one string for the native parser
            parts = ln.rstrip("\n").split("\t", 9)
            if len(parts) < 10:
                continue
            c, p, vid, ref, alt = (parts[0], parts[1], parts[2], parts[3],
                                   parts[4])
            if "," in alt:        # multi-allelic: skip (biallelic SNPs only)
                continue
            if len(ref) != 1 or len(alt) != 1 or ref == "." or alt == ".":
                continue
            fmt = parts[8].split(":")
            try:
                gt_i = fmt.index("GT")
            except ValueError:
                continue
            g = vcf_gt_codes(parts[9].encode(), gt_i, len(sample_id))
            if g is None:
                # Python fallback (no native lib)
                g = np.full(len(sample_id), GENO_MISSING, dtype=np.uint8)
                for j, cell in enumerate(parts[9].split("\t")):
                    gt = cell.split(":")[gt_i] if cell not in (".", "") \
                        else "."
                    gt = gt.replace("|", "/")
                    if gt in (".", "./."):
                        continue
                    try:
                        a_alleles = [int(x) for x in gt.split("/")
                                     if x != "."]
                    except ValueError:
                        continue
                    if not a_alleles:
                        continue
                    # count REF (allele 0) copies, capped at diploid
                    g[j] = min(sum(1 for x in a_alleles if x == 0), 2)
            chrom.append(c.removeprefix("chr"))
            pos.append(int(p))
            snp_id.append(vid if vid not in (".", "") else f"{c}:{p}")
            allele.append(f"{ref}/{alt}")
            rows.append(g)
            if max_records and len(rows) >= max_records:
                break
    if not rows:
        raise ValueError("no biallelic SNP records found")
    chrom = np.asarray(chrom, dtype=object)
    pos_a = np.asarray(pos, dtype=np.int64)
    keep = select_region(chrom, pos_a, import_chr, assembly)
    if keep.sum() == 0:
        raise ValueError("no SNP records in the requested region")
    return SNPGenoData(
        genotype=np.stack(rows)[keep],
        sample_id=np.asarray(sample_id, dtype=object),
        snp_id=np.asarray(snp_id, dtype=object)[keep],
        snp_position=pos_a[keep],
        snp_allele=np.asarray(allele, dtype=object)[keep],
        assembly=assembly)
