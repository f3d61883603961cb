"""SNP genotype container and model↔data SNP alignment.

Equivalent of the reference's ``hlaSNPGenoClass`` (R/DataUtilities.R:228-1035):
a genotype matrix over biallelic SNPs with per-SNP metadata (id, position,
"A/B" allele string), where genotype values count copies of allele A
(0/1/2, NA = missing). Internally missing is code 3 so the device arrays are
small unsigned ints.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..constants import GENO_MISSING

_COMPLEMENT = {"A": "T", "T": "A", "C": "G", "G": "C"}


def _flip_str(allele: str) -> str:
    return "/".join(_COMPLEMENT.get(x, x) for x in allele.split("/"))


@dataclass
class SNPGenoData:
    """Genotype matrix [n_snp, n_samp] with codes {0,1,2,3=missing}."""

    genotype: np.ndarray          # uint8 [P, N]
    sample_id: np.ndarray         # object [N]
    snp_id: np.ndarray            # object [P]
    snp_position: np.ndarray      # int64 [P]
    snp_allele: np.ndarray        # object [P], "A/B"
    assembly: str = "auto"

    def __post_init__(self):
        self.genotype = np.asarray(self.genotype)
        if self.genotype.dtype != np.uint8:
            g = np.asarray(self.genotype, dtype=np.float64)
            out = np.full(g.shape, GENO_MISSING, dtype=np.uint8)
            ok = np.isfinite(g) & (g >= 0) & (g <= 2)
            out[ok] = g[ok].astype(np.uint8)
            self.genotype = out
        self.sample_id = np.asarray(self.sample_id, dtype=object)
        self.snp_id = np.asarray(self.snp_id, dtype=object)
        self.snp_position = np.asarray(self.snp_position, dtype=np.int64)
        self.snp_allele = np.asarray(self.snp_allele, dtype=object)

    @property
    def n_snp(self) -> int:
        return int(self.genotype.shape[0])

    @property
    def n_samp(self) -> int:
        return int(self.genotype.shape[1])

    # --- QC helpers (hlaGenoAFreq/MFreq/etc., R/DataUtilities.R:993-1035) --

    def allele_freq(self) -> np.ndarray:
        """Frequency of allele A per SNP (ignoring missing)."""
        g = self.genotype.astype(np.float64)
        miss = g >= GENO_MISSING
        g = np.where(miss, 0.0, g)
        denom = 2.0 * (~miss).sum(axis=1)
        with np.errstate(invalid="ignore"):
            return np.where(denom > 0, g.sum(axis=1) / denom, np.nan)

    def maf(self) -> np.ndarray:
        f = self.allele_freq()
        return np.minimum(f, 1.0 - f)

    def missing_rate_snp(self) -> np.ndarray:
        return (self.genotype >= GENO_MISSING).mean(axis=1)

    def missing_rate_samp(self) -> np.ndarray:
        return (self.genotype >= GENO_MISSING).mean(axis=0)

    # --- subsetting (hlaGenoSubset, R/DataUtilities.R:304) -----------------

    def subset(self, snp_mask=None, samp_mask=None) -> "SNPGenoData":
        snp_mask = slice(None) if snp_mask is None else snp_mask
        samp_mask = slice(None) if samp_mask is None else samp_mask
        return SNPGenoData(
            genotype=self.genotype[snp_mask][:, samp_mask],
            sample_id=self.sample_id[samp_mask],
            snp_id=self.snp_id[snp_mask],
            snp_position=self.snp_position[snp_mask],
            snp_allele=self.snp_allele[snp_mask],
            assembly=self.assembly,
        )

    def subset_by_samples(self, sample_ids) -> "SNPGenoData":
        pos = {s: i for i, s in enumerate(self.sample_id)}
        idx = np.array([pos[s] for s in sample_ids], dtype=np.int64)
        return self.subset(samp_mask=idx)

    def snp_key(self, match_type: str = "Position") -> np.ndarray:
        """Match keys, mirroring hlaSNPID (R/DataUtilities.R:512)."""
        if match_type == "Position":
            return self.snp_position.astype("U")
        if match_type == "RefSNP":
            return self.snp_id.astype("U")
        if match_type == "RefSNP+Position":
            return np.char.add(np.char.add(self.snp_id.astype("U"), "-"),
                               self.snp_position.astype("U"))
        if match_type == "Pos+Allele":
            return np.char.add(np.char.add(self.snp_position.astype("U"), "-"),
                               self.snp_allele.astype("U"))
        raise ValueError(f"unknown match.type {match_type!r}")

    @classmethod
    def from_hibag_r(cls, robj_dict: dict) -> "SNPGenoData":
        """Build from a decoded hlaSNPGenoClass (r_to_py dict)."""
        d = robj_dict
        return cls(
            genotype=np.asarray(d["genotype"]),
            sample_id=d["sample.id"],
            snp_id=d["snp.id"],
            snp_position=np.asarray(d["snp.position"], dtype=np.int64),
            snp_allele=d["snp.allele"],
            assembly=str(np.asarray(d.get("assembly", ["auto"])).ravel()[0]),
        )



def allele_switch(model_allele: str, target_allele: str,
                  model_freq: Optional[float] = None,
                  target_freq: Optional[float] = None,
                  same_strand: bool = False):
    """Decide how to map target genotype coding onto model allele coding.

    Returns (flip, category) with category in {"match", "amb", "mismatch",
    "swap_strand"}; flip=True means genotype := 2 - genotype. Replicates
    HIBAG_AlleleStrand exactly (reference src/HIBAG.cpp:221-342): direct /
    swapped / strand-complement orientations resolve structurally;
    strand-ambiguous (A/T, C/G) and allele-mismatched SNPs fall back to a
    minor-allele-side comparison of the frequencies. No SNP is rejected.
    """
    def minor(f):
        return 0 if f <= 0.5 else 1

    parts_m = str(model_allele).upper().split("/")
    parts_t = str(target_allele).upper().split("/")
    s1, s2 = parts_m[0], (parts_m[1] if len(parts_m) > 1 else "")
    p1, p2 = parts_t[0], (parts_t[1] if len(parts_t) > 1 else "")
    check_strand = not same_strand
    atgc = all(x in _COMPLEMENT for x in (s1, s2, p1, p2))
    comp = _COMPLEMENT
    flip = False
    detect = 0           # 1 = strand ambiguity, 2 = mismatching alleles
    category = "match"

    if atgc:
        if (s1, s2) == (p1, p2):
            if check_strand and s1 == comp[p2]:
                detect = 1
        elif (s1, s2) == (p2, p1):
            if check_strand and s1 == comp[p1]:
                detect = 1
            else:
                flip = True
        else:
            if check_strand:
                if s1 == comp[p1] and s2 == comp[p2]:
                    if s1 == p2:
                        detect = 1
                    else:
                        category = "swap_strand"
                elif s1 == comp[p2] and s2 == comp[p1]:
                    flip = True
                    category = "swap_strand"
                else:
                    detect = 2
            else:
                detect = 2
    else:
        if (s1, s2) == (p1, p2):
            if s1 == s2:
                detect = 1
        elif (s1, s2) == (p2, p1):
            if s1 == s2:
                detect = 1
            else:
                flip = True
        else:
            detect = 2

    if detect:
        category = "amb" if detect == 1 else "mismatch"
        if (model_freq is not None and target_freq is not None
                and np.isfinite(model_freq) and np.isfinite(target_freq)):
            flip = minor(model_freq) != minor(target_freq)
        else:
            flip = False
    return bool(flip), category


def align_to_model(model, data: SNPGenoData, match_type: str = "Position",
                   same_strand: bool = False):
    """Reorder/flip target genotypes into the model's SNP space.

    Returns (codes [N, P_model] uint8 with 3=missing, info dict).
    Mirrors hlaPredict's SNP matching + hlaGenoSwitchStrand
    (reference R/HIBAG.R:585-679, R/DataUtilities.R:415-505).
    """
    from ..io.native import align_codes

    model_keys = {}
    mk = _model_keys(model, match_type)
    for i, k in enumerate(mk):
        model_keys.setdefault(k, i)
    tk = data.snp_key(match_type)
    P = len(mk)
    mfreq = model.snp_allele_freq
    geno_t = data.genotype
    freq_cache: dict = {}

    def col_freq(j: int) -> float:
        # target allele frequency, computed lazily per matched ambiguous /
        # mismatching column (a full-matrix allele_freq() pass costs more
        # than the rest of the alignment at cohort scale)
        f = freq_cache.get(j)
        if f is None:
            col = geno_t[j]
            ok = col < GENO_MISSING
            n = int(ok.sum())
            f = float(col[ok].sum()) / (2.0 * n) if n else float("nan")
            freq_cache[j] = f
        return f

    src_idx = np.full(P, -1, dtype=np.int64)
    flip_arr = np.zeros(P, dtype=np.uint8)
    n_flip = n_amb = n_mismatch = n_swap = 0
    for j, k in enumerate(tk):
        i = model_keys.get(k)
        if i is None or src_idx[i] >= 0:   # first target occurrence wins
            continue
        m_str = str(model.snp_allele[i]).upper()
        t_str = str(data.snp_allele[j]).upper()
        if m_str == t_str:
            p = m_str.split("/")
            if (len(p) == 2 and p[0] != p[1]
                    and _COMPLEMENT.get(p[0]) != p[1]):
                # identical non-ambiguous "X/Y": structurally a direct match
                # (allele_switch fast path — the overwhelmingly common case)
                src_idx[i] = j
                continue
        flip, category = allele_switch(
            m_str, t_str,
            None if mfreq is None else float(mfreq[i]),
            col_freq(j), same_strand=same_strand)
        src_idx[i] = j
        flip_arr[i] = 1 if flip else 0
        n_flip += int(flip)
        n_amb += category == "amb"
        n_mismatch += category == "mismatch"
        n_swap += category == "swap_strand"
    n_match = int((src_idx >= 0).sum())
    # bulk gather + flip through the native runtime (NumPy fallback inside)
    codes = align_codes(data.genotype.view(np.int8), src_idx, flip_arr)
    codes = codes.view(np.uint8)
    info = {"n_model_snp": P, "n_matched": n_match, "n_flipped": n_flip,
            "n_strand_ambiguity": n_amb, "n_mismatch": n_mismatch,
            "n_swap_strand": n_swap,
            "missing_fraction": 1.0 - n_match / max(P, 1)}
    return codes, info


def _model_keys(model, match_type: str) -> np.ndarray:
    pos = model.snp_position.astype("U")
    sid = np.asarray(model.snp_id, dtype="U")
    allele = np.asarray(model.snp_allele, dtype="U")
    if match_type == "Position":
        return pos
    if match_type == "RefSNP":
        return sid
    if match_type == "RefSNP+Position":
        return np.char.add(np.char.add(sid, "-"), pos)
    if match_type == "Pos+Allele":
        return np.char.add(np.char.add(pos, "-"), allele)
    raise ValueError(f"unknown match.type {match_type!r}")
