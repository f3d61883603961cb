"""Shared benchmark and profile dataset constructions: the port's copy of
hibag_tpu/utils/bench_data.py, on hibag_tpu_torch's containers.

A bench of the port and hibag_tpu's bench.py must time exactly the same
workloads, so these build them as hibag_tpu's do, from the same inputs:
`headline_1000snp` and `midscale_1000x266` take their data as arguments
and equal hibag_tpu's on the same data (tests/test_torch_bench_data.py).

`load_ceu` reads the data files bundled with the HIBAG reference package
(its ``data`` directory: HLA_Type_Table.rdata and HapMap_CEU_Geno.rdata),
which the repository does not hold: pass ``data_dir`` or set
HIBAG_REF_DATA to that directory.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

#: names the reference package's data directory for `load_ceu`
REF_DATA_ENV = "HIBAG_REF_DATA"


def load_ceu(locus: str = "A", data_dir: Optional[str] = None):
    """(HLATypeTable, SNPGenoData) for the reference package's HapMap CEU
    panel, read from `data_dir` (default: $HIBAG_REF_DATA)."""
    from ..data.allele import HLATypeTable
    from ..data.geno import SNPGenoData
    from ..io.rdata import r_to_py, read_rdata

    data_dir = data_dir or os.environ.get(REF_DATA_ENV)
    if not data_dir:
        raise FileNotFoundError(
            f"load_ceu needs the HIBAG package's data directory: pass "
            f"data_dir= or set {REF_DATA_ENV}")
    ht = r_to_py(read_rdata(
        f"{data_dir}/HLA_Type_Table.rdata")["HLA_Type_Table"])
    geno = SNPGenoData.from_hibag_r(r_to_py(read_rdata(
        f"{data_dir}/HapMap_CEU_Geno.rdata")["HapMap_CEU_Geno"]))
    hla = HLATypeTable.from_alleles(
        ht["sample.id"], ht[f"{locus}.1"], ht[f"{locus}.2"], locus=locus,
        assembly="hg19")
    return hla, geno


def headline_1000snp(geno):
    """config[0] genotypes: the ~1000 SNPs nearest the HLA-A locus."""
    from ..data.allele import loci_info

    _, start, end, _ = loci_info("hg19")["A"]
    mid = (start + end) // 2
    order = np.argsort(np.abs(geno.snp_position - mid))[:1000]
    return geno.subset(snp_mask=np.sort(order))


def midscale_1000x266(hla=None, geno=None, n_samples: int = 1000,
                      seed: int = 0):
    """The matched mid-scale training shape: 1,000 CEU-resampled samples x
    266 HLA-A-flanking SNPs (the config BASELINE.md measured the reference
    kernel at). Returns (hla_table, geno_data); without `hla` and `geno`
    they come from `load_ceu`."""
    from ..data.allele import HLATypeTable, flanking_snps
    from ..data.geno import SNPGenoData

    if hla is None or geno is None:
        hla, geno = load_ceu()
    ids = flanking_snps(geno.snp_id, geno.snp_position, "A", 500_000,
                        "hg19")
    f266 = geno.subset(snp_mask=np.isin(geno.snp_id.astype(str),
                                        ids.astype(str)))
    rng = np.random.default_rng(seed)
    tmap = {s: i for i, s in enumerate(hla.sample_id)}
    keep = np.asarray([i for i, s in enumerate(f266.sample_id)
                       if s in tmap])
    f266 = f266.subset(samp_mask=keep)
    cols = rng.integers(0, f266.n_samp, n_samples)
    sid = np.array([f"m{i}" for i in range(n_samples)], dtype=object)
    ti = np.array([tmap[s] for s in f266.sample_id])[cols]
    g_mid = SNPGenoData(
        genotype=f266.genotype[:, cols], sample_id=sid,
        snp_id=f266.snp_id, snp_position=f266.snp_position,
        snp_allele=f266.snp_allele, assembly=f266.assembly)
    hla_mid = HLATypeTable.from_alleles(
        sid, hla.allele1[ti], hla.allele2[ti], locus="A", assembly="hg19")
    return hla_mid, g_mid
