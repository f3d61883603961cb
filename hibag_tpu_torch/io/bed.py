"""PLINK BED/BIM/FAM import and PED export.

Equivalent of the reference's native BED reader + R wrapper
(HIBAG_BEDFlag / HIBAG_ConvBED, src/HIBAG.cpp:1068-1191; hlaBED2Geno,
R/DataUtilities.R:703-780) and hlaGeno2PED (R/DataUtilities.R:572).
Decoding is a vectorized 256-entry byte LUT over the packed 2-bit codes
(00→2 copies of allele1, 01→missing, 10→1, 11→0).

The port's copy of hibag_tpu/io/bed.py, so that the port imports nothing
of that package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..constants import GENO_MISSING
from ..data.geno import SNPGenoData


def _byte_lut() -> np.ndarray:
    """[256, 4] uint8: per-byte decode of four 2-bit genotypes."""
    cvt = np.array([2, GENO_MISSING, 1, 0], dtype=np.uint8)
    b = np.arange(256, dtype=np.uint16)
    out = np.empty((256, 4), dtype=np.uint8)
    for k in range(4):
        out[:, k] = cvt[(b >> (2 * k)) & 0x03]
    return out


_LUT = _byte_lut()


def read_bed(bed_fn: str, fam_fn: Optional[str] = None,
             bim_fn: Optional[str] = None, import_chr: str = "xMHC",
             assembly: str = "hg19", verbose: bool = False) -> SNPGenoData:
    """Read a PLINK binary fileset into SNPGenoData (hlaBED2Geno)."""
    if fam_fn is None:
        fam_fn = bed_fn[:-4] + ".fam" if bed_fn.endswith(".bed") else bed_fn + ".fam"
    if bim_fn is None:
        bim_fn = bed_fn[:-4] + ".bim" if bed_fn.endswith(".bed") else bed_fn + ".bim"

    fam = [ln.split() for ln in open(fam_fn) if ln.strip()]
    inv_ids = [f[1] for f in fam]
    if len(set(inv_ids)) == len(inv_ids):
        sample_id = inv_ids
    else:
        sample_id = [f"{f[0]}-{f[1]}" for f in fam]
        if len(set(sample_id)) != len(sample_id):
            raise ValueError("IDs in PLINK bed are not unique")
    n_samp = len(sample_id)

    bim = [ln.split() for ln in open(bim_fn) if ln.strip()]
    chrom = np.array([b[0] for b in bim], dtype=object)
    snp_id = np.array([b[1] for b in bim], dtype=object)
    pos = np.array([int(float(b[3])) if b[3] not in ("", "NA") else 0
                    for b in bim], dtype=np.int64)
    allele = np.array([f"{b[4]}/{b[5]}" for b in bim], dtype=object)
    n_snp = len(bim)
    if len(set(snp_id)) != n_snp:
        raise ValueError("SNP IDs in the PLINK file must be unique")

    snp_flag = select_region(chrom, pos, import_chr, assembly)
    if snp_flag.sum() == 0:
        raise ValueError("no SNP imported")

    with open(bed_fn, "rb") as f:
        magic = f.read(3)
        if magic[:2] != b"\x6c\x1b":
            raise ValueError("invalid PLINK BED prefix")
        mode = magic[2]
        raw = np.frombuffer(f.read(), dtype=np.uint8)

    if mode == 1:  # SNP-major
        from .native import bed_decode
        keep_idx = np.nonzero(snp_flag)[0]
        geno = bed_decode(raw, n_snp, n_samp, keep_idx).view(np.uint8)
    else:  # individual-major
        stride = (n_snp + 3) // 4
        raw = raw[:stride * n_samp].reshape(n_samp, stride)
        g = _LUT[raw].reshape(n_samp, -1)[:, :n_snp]
        geno = g[:, snp_flag].T.copy()

    return SNPGenoData(
        genotype=np.ascontiguousarray(geno, dtype=np.uint8),
        sample_id=np.asarray(sample_id, dtype=object),
        snp_id=snp_id[snp_flag],
        snp_position=pos[snp_flag],
        snp_allele=allele[snp_flag],
        assembly=assembly,
    )


def select_region(chrom, pos, import_chr: str = "xMHC",
                  assembly: str = "hg19") -> np.ndarray:
    """SNP selection mask (.snp_selection, R/DataUtilities.R:645-700):
    'xMHC' keeps chr6 SNPs within ±1 Mb of the extended MHC gene cluster;
    '' keeps everything; otherwise a chromosome name list."""
    chrom = np.asarray(chrom, dtype=object)
    pos = np.asarray(pos)
    if import_chr == "":
        return np.ones(len(pos), dtype=bool)
    if import_chr == "xMHC":
        from ..data.allele import loci_info
        info = loci_info(assembly)
        genes = [(s, e) for (c, s, e, _) in info.values()
                 if c == "6" and s is not None]
        mhc_start, mhc_end = info["MHC"][1], info["MHC"][2]
        inmhc = [(s, e) for (s, e) in genes
                 if (mhc_start - 1_000_000 <= s) and (e <= mhc_end + 1_000_000)]
        outmhc = [(s, e) for (s, e) in genes if (s, e) not in inmhc]
        is6 = chrom.astype(str) == "6"
        st = min(s for s, _ in inmhc) - 1_000_000
        ed = max(e for _, e in inmhc) + 1_000_000
        flag = is6 & (pos >= st) & (pos <= ed)
        for s, e in outmhc:
            flag |= is6 & (pos >= s - 1_000_000) & (pos <= e + 1_000_000)
        return flag
    chrs = import_chr if isinstance(import_chr, (list, tuple)) else [import_chr]
    return np.isin(chrom.astype(str), [str(c) for c in chrs]) & (pos > 0)


def write_ped(geno: SNPGenoData, out_prefix: str) -> None:
    """Export to PLINK text PED/MAP (hlaGeno2PED, R/DataUtilities.R:572)."""
    with open(out_prefix + ".map", "w") as f:
        for i in range(geno.n_snp):
            f.write(f"6\t{geno.snp_id[i]}\t0\t{geno.snp_position[i]}\n")
    alleles = [str(a).split("/") for a in geno.snp_allele]
    with open(out_prefix + ".ped", "w") as f:
        for j, sid in enumerate(geno.sample_id):
            fields = [str(sid), str(sid), "0", "0", "0", "-9"]
            g = geno.genotype[:, j]
            for i in range(geno.n_snp):
                a, b = alleles[i][0], alleles[i][-1]
                v = g[i]
                if v == 2:
                    fields += [a, a]
                elif v == 1:
                    fields += [a, b]
                elif v == 0:
                    fields += [b, b]
                else:
                    fields += ["0", "0"]
            f.write(" ".join(fields) + "\n")
