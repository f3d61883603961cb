"""HLA allele nomenclature utilities and the typed-sample table.

Equivalents of the reference's allele layer: field-wise allele ordering
(HIBAG_SortAlleleStr, src/HIBAG.cpp:81-179), resolution truncation
(hlaAlleleDigit, R/DataUtilities.R:1078), hlaAllele/hlaAlleleSubset/
hlaCombineAllele (R/DataUtilities.R:1176-1326), stratified train/validation
splitting (hlaSplitAllele, R/DataUtilities.R:1688), and flanking-SNP
selection (hlaFlankingSNP, R/DataUtilities.R:1732).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .loci_info import LOCI_INFO

_INT_MAX = 2**31 - 1

_RESOLUTION_FIELDS = {
    "2-digit": 1, "1-field": 1, "4-digit": 2, "2-field": 2,
    "6-digit": 3, "3-field": 3, "8-digit": 4, "4-field": 4,
    "allele": 1, "protein": 2,
    "2": 1, "4": 2, "6": 3, "8": 4,
}


def allele_sort_key(allele: str):
    """Sort key replicating the reference's field-wise ordering: numeric
    prefix of each ':'-separated field, then its non-numeric suffix; shorter
    field lists order first on ties."""
    fields = []
    for f in str(allele).split(":"):
        m = re.match(r"(\d*)(.*)", f)
        num = int(m.group(1)) if m.group(1) else _INT_MAX
        fields.append((num, m.group(2)))
    return (fields, len(fields))


def sort_alleles(alleles) -> list:
    """Stable field-wise sort of allele strings (hlaUniqueAllele order)."""
    return sorted((str(a) for a in alleles), key=allele_sort_key)


def unique_alleles(alleles) -> list:
    """Sorted unique allele strings, NA dropped (hlaUniqueAllele)."""
    seen, out = set(), []
    for a in alleles:
        if a is None or (isinstance(a, float) and np.isnan(a)):
            continue
        a = str(a)
        if a not in seen:
            seen.add(a)
            out.append(a)
    return sort_alleles(out)


def allele_digit(allele, max_resolution: str = "", rm_suffix: bool = False):
    """Truncate allele(s) to at most N fields (hlaAlleleDigit)."""
    if max_resolution in ("", "full", "none", None):
        return allele
    nf = _RESOLUTION_FIELDS.get(str(max_resolution))
    if nf is None:
        raise ValueError(f"unknown max.resolution {max_resolution!r}")

    def one(a):
        if a is None:
            return None
        s = str(a).split(":")[:nf]
        if rm_suffix:
            s[-1] = re.sub(r"\D+$", "", s[-1])
        return ":".join(s)

    if isinstance(allele, (list, tuple, np.ndarray)):
        return np.array([one(a) for a in allele], dtype=object)
    return one(allele)


def loci_info(assembly: str = "hg19") -> dict:
    """locus → (chrom, start, end, suggest_pos) for the assembly."""
    if assembly in ("auto", "auto-silent"):
        assembly = "hg19"
    if assembly not in LOCI_INFO:
        raise ValueError(f"unknown assembly {assembly!r}")
    return LOCI_INFO[assembly]


def flanking_snps(snp_id, position, locus: str, flank_bp: int = 500_000,
                  assembly: str = "hg19", pos_mid: Optional[int] = None):
    """SNP ids within ±flank_bp of the locus (hlaFlankingSNP)."""
    snp_id = np.asarray(snp_id)
    position = np.asarray(position, dtype=np.int64)
    if locus != "any":
        info = loci_info(assembly)
        if locus not in info:
            raise ValueError(f"locus {locus!r} not in assembly {assembly}")
        _, start, end, _ = info[locus]
        lo, hi = start - flank_bp, end + flank_bp
    else:
        if pos_mid is None:
            raise ValueError("pos_mid required when locus='any'")
        lo, hi = pos_mid - flank_bp, pos_mid + flank_bp
    mask = (position >= lo) & (position <= hi)
    return snp_id[mask]


@dataclass
class HLATypeTable:
    """Typed samples for one locus (hlaAlleleClass equivalent)."""

    locus: str
    sample_id: np.ndarray          # object [N]
    allele1: np.ndarray            # object [N]
    allele2: np.ndarray            # object [N]
    prob: Optional[np.ndarray] = None
    matching: Optional[np.ndarray] = None
    assembly: str = "hg19"
    pos_start: Optional[int] = None
    pos_end: Optional[int] = None
    dosage: Optional[np.ndarray] = None     # [A, N]
    postprob: Optional[np.ndarray] = None   # [A(A+1)/2, N]
    allele_names: Optional[list] = None

    @classmethod
    def from_alleles(cls, sample_id, H1, H2, locus="any", assembly="hg19",
                     max_resolution="", prob=None, na_rm=True,
                     pos_start=None, pos_end=None) -> "HLATypeTable":
        sample_id = np.asarray(sample_id, dtype=object)
        H1 = np.array([None if (h is None or h == "") else str(h) for h in H1],
                      dtype=object)
        H2 = np.array([None if (h is None or h == "") else str(h) for h in H2],
                      dtype=object)
        H1 = allele_digit(H1, max_resolution)
        H2 = allele_digit(H2, max_resolution)
        if locus != "any" and pos_start is None:
            info = loci_info(assembly)
            if locus in info:
                _, pos_start, pos_end, _ = info[locus]
        if na_rm:
            keep = np.array([a is not None and b is not None
                             for a, b in zip(H1, H2)])
        else:
            keep = np.ones(len(sample_id), dtype=bool)
        return cls(locus=locus, sample_id=sample_id[keep],
                   allele1=H1[keep], allele2=H2[keep],
                   prob=None if prob is None else np.asarray(prob)[keep],
                   assembly=assembly, pos_start=pos_start, pos_end=pos_end)

    @property
    def n_samp(self) -> int:
        return int(len(self.sample_id))

    def unique_alleles(self) -> list:
        return unique_alleles(np.concatenate([self.allele1, self.allele2]))

    def allele_counts(self) -> dict:
        """allele → count over both chromosomes (summary.hlaAlleleClass)."""
        counts: dict = {}
        for a in np.concatenate([self.allele1, self.allele2]):
            if a is not None:
                counts[a] = counts.get(a, 0) + 1
        return {a: counts[a] for a in sort_alleles(counts)}

    def subset(self, mask) -> "HLATypeTable":
        mask = np.asarray(mask)
        return HLATypeTable(
            locus=self.locus, sample_id=self.sample_id[mask],
            allele1=self.allele1[mask], allele2=self.allele2[mask],
            prob=None if self.prob is None else self.prob[mask],
            matching=None if self.matching is None else self.matching[mask],
            assembly=self.assembly, pos_start=self.pos_start,
            pos_end=self.pos_end,
            dosage=None if self.dosage is None else self.dosage[:, mask],
            postprob=None if self.postprob is None else self.postprob[:, mask],
            allele_names=self.allele_names)

    def subset_by_samples(self, sample_ids) -> "HLATypeTable":
        pos = {s: i for i, s in enumerate(self.sample_id)}
        idx = np.array([pos[s] for s in sample_ids if s in pos], dtype=np.int64)
        return self.subset(idx)

    def combine(self, other: "HLATypeTable") -> "HLATypeTable":
        """Concatenate disjoint sample sets (hlaCombineAllele)."""
        if set(self.sample_id) & set(other.sample_id):
            raise ValueError("sample sets overlap")
        if self.locus != other.locus:
            raise ValueError("loci differ")
        return HLATypeTable(
            locus=self.locus,
            sample_id=np.concatenate([self.sample_id, other.sample_id]),
            allele1=np.concatenate([self.allele1, other.allele1]),
            allele2=np.concatenate([self.allele2, other.allele2]),
            prob=(np.concatenate([self.prob, other.prob])
                  if self.prob is not None and other.prob is not None else None),
            assembly=self.assembly, pos_start=self.pos_start,
            pos_end=self.pos_end)


def split_alleles(table: HLATypeTable, train_prop: float = 0.5,
                  rng: Optional[np.random.Generator] = None):
    """Stratified training/validation split, rarest allele first
    (hlaSplitAllele, R/DataUtilities.R:1688-1726).

    Iteratively: find the rarest remaining allele, take all samples carrying
    it, put ceil(n·train_prop) of them (random) into training, remove them,
    repeat. Returns (training, validation) HLATypeTables.
    """
    if rng is None:
        rng = np.random.default_rng()
    remaining = table
    train_ids: list = []
    while remaining.n_samp > 0:
        counts = remaining.allele_counts()
        # rarest allele; stable order for ties (sorted allele order)
        allele = min(counts, key=lambda a: counts[a])
        carry = np.array([(a1 == allele) or (a2 == allele)
                          for a1, a2 in zip(remaining.allele1, remaining.allele2)])
        samp = remaining.sample_id[carry]
        n_train = int(np.ceil(len(samp) * train_prop))
        chosen = rng.choice(len(samp), size=n_train, replace=False)
        train_ids.extend(samp[chosen])
        remaining = remaining.subset(~carry)
    train_ids = sorted(train_ids)
    val_ids = sorted(set(table.sample_id) - set(train_ids))
    return table.subset_by_samples(train_ids), table.subset_by_samples(val_ids)
