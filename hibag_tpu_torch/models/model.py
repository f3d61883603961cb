"""Model data structures: individual classifiers and the bagging ensemble.

Host-side representation mirrors the reference's serialized model schema
(``hlaAttrBagObj``: reference R/HIBAG.R:1041-1178, src/HIBAG.cpp:881-958) —
a model is fully determined by, per classifier: SNP indices, haplotype bit
strings, haplotype frequencies, HLA allele labels, bootstrap counts and OOB
accuracy. Device-side, classifiers are packed into fixed-shape arrays
(padded to a haplotype bucket) so the whole ensemble is one pytree suitable
for ``lax.scan`` / ``shard_map`` over classifiers.
"""

from __future__ import annotations

import json
import weakref
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..constants import MAXNUM_SNP

class IdCache:
    """Per-instance memo keyed by object identity with weakref eviction —
    a side-table replacement for instance attributes (which would leak into
    ``Cls(**obj.__dict__)`` copy paths) that also works for unhashable
    dataclasses."""

    def __init__(self):
        self._d = {}

    def get(self, obj):
        entry = self._d.get(id(obj))
        return entry[1] if entry is not None else None

    def set(self, obj, value):
        key = id(obj)
        try:
            ref = weakref.ref(obj,
                              lambda _r, k=key, d=self._d: d.pop(k, None))
        except TypeError:
            return  # object doesn't support weakrefs: skip memoization
        self._d[key] = (ref, value)


#: PackedEnsemble memo per model instance
_PACK_CACHE = IdCache()


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class Classifier:
    """One attribute-bagging classifier (host side)."""

    snp_index: np.ndarray          # int32 [n_snp], 0-based into model SNP set
    hap_bits: np.ndarray           # uint8 [n_haplo, n_snp], values {0,1}
    hap_freq: np.ndarray           # float64 [n_haplo]
    hap_allele: np.ndarray         # int32 [n_haplo], index into model alleles
    bootstrap_count: Optional[np.ndarray] = None   # int32 [n_samp] or None
    oob_accuracy: float = float("nan")

    @property
    def n_snp(self) -> int:
        return int(len(self.snp_index))

    @property
    def n_haplo(self) -> int:
        return int(len(self.hap_freq))

    def haplo_strings(self) -> list[str]:
        return ["".join("1" if b else "0" for b in row) for row in self.hap_bits]


@dataclass
class AttrBagModel:
    """Ensemble model for one HLA locus (hlaAttrBagClass equivalent)."""

    locus: str
    snp_id: np.ndarray             # object [P]
    snp_position: np.ndarray       # int64 [P]
    snp_allele: np.ndarray         # object [P], "A/B"
    hla_alleles: list              # allele strings, training order
    classifiers: list = field(default_factory=list)
    snp_allele_freq: Optional[np.ndarray] = None
    hla_freq: Optional[np.ndarray] = None
    assembly: str = "auto"
    sample_id: Optional[np.ndarray] = None
    appendix: dict = field(default_factory=dict)
    matching: Optional[np.ndarray] = None  # training matching proportions

    @property
    def n_snp(self) -> int:
        return int(len(self.snp_id))

    @property
    def n_alleles(self) -> int:
        return int(len(self.hla_alleles))

    @property
    def n_classifiers(self) -> int:
        return len(self.classifiers)

    # --- HIBAG interchange ------------------------------------------------

    @classmethod
    def from_hibag_obj(cls, obj: dict, locus: Optional[str] = None) -> "AttrBagModel":
        """Build from a decoded ``hlaAttrBagObj`` R list (dict from r_to_py)."""
        alleles = [str(a) for a in obj["hla.allele"]]
        aidx = {a: i for i, a in enumerate(alleles)}
        classifiers = []
        for c in obj["classifiers"]:
            haplos = c["haplos"]
            freq = np.asarray(haplos["freq"], dtype=np.float64)
            hla = np.array([aidx[str(a)] for a in haplos["hla"]], dtype=np.int32)
            strs = haplos["haplo"]
            n_snp = len(strs[0]) if len(strs) else 0
            bits = np.zeros((len(strs), n_snp), dtype=np.uint8)
            for i, s in enumerate(strs):
                bits[i] = np.frombuffer(str(s).encode(), dtype=np.uint8) - ord("0")
            # group haplotypes by allele (stable) to mirror CHaplotypeList's
            # allele-block layout (reference src/LibHLA.h:85-140)
            order = np.argsort(hla, kind="stable")
            snpidx = np.asarray(c["snpidx"], dtype=np.int32) - 1
            bc = c.get("samp.num")
            bc = None if bc is None else np.asarray(bc, dtype=np.int32)
            oob = c.get("outofbag.acc")
            oob = float(np.asarray(oob).ravel()[0]) if oob is not None else float("nan")
            classifiers.append(Classifier(
                snp_index=snpidx,
                hap_bits=bits[order],
                hap_freq=freq[order],
                hap_allele=hla[order],
                bootstrap_count=bc,
                oob_accuracy=oob,
            ))
        def _scalar(x):
            a = np.asarray(x).ravel()
            return a[0] if len(a) else None
        return cls(
            locus=str(locus or _scalar(obj.get("hla.locus"))),
            snp_id=np.asarray(obj["snp.id"], dtype=object),
            snp_position=np.asarray(obj["snp.position"], dtype=np.int64),
            snp_allele=np.asarray(obj["snp.allele"], dtype=object),
            snp_allele_freq=(np.asarray(obj["snp.allele.freq"], dtype=np.float64)
                             if obj.get("snp.allele.freq") is not None else None),
            hla_alleles=alleles,
            hla_freq=(np.asarray(obj["hla.freq"], dtype=np.float64)
                      if obj.get("hla.freq") is not None else None),
            assembly=str(_scalar(obj.get("assembly")) or "auto"),
            sample_id=(np.asarray(obj["sample.id"], dtype=object)
                       if obj.get("sample.id") is not None else None),
            classifiers=classifiers,
        )

    def to_hibag_obj(self) -> dict:
        """Export to the hlaAttrBagObj schema (dict of plain arrays/lists)."""
        cl = []
        for c in self.classifiers:
            cl.append({
                "samp.num": None if c.bootstrap_count is None else c.bootstrap_count.copy(),
                "haplos": {
                    "freq": c.hap_freq.copy(),
                    "hla": np.array([self.hla_alleles[i] for i in c.hap_allele], dtype=object),
                    "haplo": np.array(c.haplo_strings(), dtype=object),
                },
                "snpidx": c.snp_index + 1,
                "outofbag.acc": c.oob_accuracy,
            })
        return {
            "n.samp": 0 if self.sample_id is None else len(self.sample_id),
            "n.snp": self.n_snp,
            "sample.id": self.sample_id,
            "snp.id": self.snp_id,
            "snp.position": self.snp_position,
            "snp.allele": self.snp_allele,
            "snp.allele.freq": self.snp_allele_freq,
            "hla.locus": self.locus,
            "hla.allele": np.asarray(self.hla_alleles, dtype=object),
            "hla.freq": self.hla_freq,
            "assembly": self.assembly,
            "classifiers": cl,
        }

    # --- native (JSON + NPZ) serialization --------------------------------

    def save(self, path: str) -> None:
        """Save as a .npz with a JSON header (the checkpoint format).

        Equivalent role to the reference's .rda/.rds model files
        (R/DataUtilities.R:89-117).
        """
        header = {
            "format": "hibag-tpu-model-v1",
            "locus": self.locus,
            "assembly": self.assembly,
            "hla_alleles": list(map(str, self.hla_alleles)),
            "n_classifiers": self.n_classifiers,
            "appendix": self.appendix,
        }
        arrays = {
            "snp_id": np.asarray(self.snp_id, dtype="U"),
            "snp_position": self.snp_position,
            "snp_allele": np.asarray(self.snp_allele, dtype="U"),
        }
        if self.snp_allele_freq is not None:
            arrays["snp_allele_freq"] = self.snp_allele_freq
        if self.hla_freq is not None:
            arrays["hla_freq"] = self.hla_freq
        if self.sample_id is not None:
            arrays["sample_id"] = np.asarray(self.sample_id, dtype="U")
        if self.matching is not None:
            arrays["matching"] = self.matching
        for i, c in enumerate(self.classifiers):
            arrays[f"c{i}_snpidx"] = c.snp_index
            arrays[f"c{i}_bits"] = np.packbits(c.hap_bits, axis=1)
            arrays[f"c{i}_nsnp"] = np.array([c.n_snp], dtype=np.int32)
            arrays[f"c{i}_freq"] = c.hap_freq
            arrays[f"c{i}_allele"] = c.hap_allele
            arrays[f"c{i}_oob"] = np.array([c.oob_accuracy])
            if c.bootstrap_count is not None:
                arrays[f"c{i}_bc"] = c.bootstrap_count
        arrays["__header__"] = np.frombuffer(
            json.dumps(header).encode(), dtype=np.uint8)
        # write through a file handle: np.savez_compressed appends ".npz"
        # to bare string paths, which would break save(p)/load(p) pairs
        # for extension-less checkpoint paths
        with open(path, "wb") as f:
            np.savez_compressed(f, **arrays)

    @classmethod
    def load(cls, path: str) -> "AttrBagModel":
        z = np.load(path, allow_pickle=False)
        header = json.loads(bytes(z["__header__"]).decode())
        if header.get("format") != "hibag-tpu-model-v1":
            raise ValueError(f"not a hibag-tpu model file: {path}")
        classifiers = []
        for i in range(header["n_classifiers"]):
            nsnp = int(z[f"c{i}_nsnp"][0])
            bits = np.unpackbits(z[f"c{i}_bits"], axis=1)[:, :nsnp]
            classifiers.append(Classifier(
                snp_index=z[f"c{i}_snpidx"],
                hap_bits=bits.astype(np.uint8),
                hap_freq=z[f"c{i}_freq"],
                hap_allele=z[f"c{i}_allele"],
                bootstrap_count=z[f"c{i}_bc"] if f"c{i}_bc" in z else None,
                oob_accuracy=float(z[f"c{i}_oob"][0]),
            ))
        return cls(
            locus=header["locus"],
            snp_id=z["snp_id"].astype(object),
            snp_position=z["snp_position"],
            snp_allele=z["snp_allele"].astype(object),
            snp_allele_freq=z.get("snp_allele_freq"),
            hla_alleles=header["hla_alleles"],
            hla_freq=z.get("hla_freq"),
            assembly=header["assembly"],
            sample_id=z["sample_id"].astype(object) if "sample_id" in z else None,
            matching=z.get("matching"),
            appendix=header.get("appendix", {}),
            classifiers=classifiers,
        )

    # --- ensemble manipulation (hlaCombineModelObj / hlaSubModelObj) ------

    def combine(self, other: "AttrBagModel") -> "AttrBagModel":
        """Concatenate classifier lists (reference R/HIBAG.R:1069)."""
        if list(self.snp_id) != list(other.snp_id):
            raise ValueError("models must share the same SNP set")
        if list(self.hla_alleles) != list(other.hla_alleles):
            raise ValueError("models must share the same allele set")
        out = AttrBagModel(**{**self.__dict__})
        out.classifiers = list(self.classifiers) + list(other.classifiers)
        return out

    def subset_classifiers(self, n: int) -> "AttrBagModel":
        """First n classifiers (reference hlaSubModelObj, R/HIBAG.R:1121)."""
        out = AttrBagModel(**{**self.__dict__})
        out.classifiers = list(self.classifiers)[:n]
        return out

    # --- packing for device ------------------------------------------------

    def pack(self, hap_bucket: int = 64, dtype=np.float32) -> "PackedEnsemble":
        """Padded device layout; memoized per (hap_bucket, dtype, #cls) so
        repeated predict() calls skip the per-classifier packing loop.
        The memo lives in a weak side-table (not __dict__) so model
        copy/reconstruction paths stay unaffected."""
        # identity fingerprint invalidates the memo when classifiers are
        # replaced in place, not only when the count changes; the memo
        # holds strong references to the fingerprinted classifiers so a
        # GC'd classifier can never alias a recycled id() into a false hit
        key = (hap_bucket, np.dtype(dtype).str)
        objs = tuple(self.classifiers)
        cache = _PACK_CACHE.get(self)
        if (cache is not None and cache[0] == key
                and len(cache[1]) == len(objs)
                and all(a is b for a, b in zip(cache[1], objs))):
            return cache[2]
        packed = PackedEnsemble.from_model(self, hap_bucket=hap_bucket,
                                           dtype=dtype)
        _PACK_CACHE.set(self, (key, objs, packed))
        return packed


@dataclass
class PackedEnsemble:
    """Fixed-shape (padded) device layout of an ensemble.

    The analogue of the reference's SoA auxiliary layout ``SetHaploAux``
    (src/LibHLA.cpp:517-560) — but laid out for MXU matmuls: haplotype bits
    as a dense {0,1} matrix per classifier, frequencies/alleles as flat
    vectors, classifier-major so scans/shard_maps stride over axis 0.
    """

    hap_bits: np.ndarray      # [C, Hmax, L] float {0,1}
    hap_freq: np.ndarray      # [C, Hmax] float, 0 = padded slot
    hap_allele: np.ndarray    # [C, Hmax] int32
    snp_index: np.ndarray     # [C, L] int32, -1 = padded slot
    n_snp: np.ndarray         # [C] int32
    n_haplo: np.ndarray       # [C] int32
    snp_weight: np.ndarray    # [P] int32: #classifiers using each model SNP
    n_alleles: int
    n_snp_model: int

    @classmethod
    def from_model(cls, model: AttrBagModel, hap_bucket: int = 64,
                   dtype=np.float32) -> "PackedEnsemble":
        C = model.n_classifiers
        if C == 0:
            raise ValueError("model has no classifiers")
        L = MAXNUM_SNP
        Hmax = _round_up(max(c.n_haplo for c in model.classifiers), hap_bucket)
        hap_bits = np.zeros((C, Hmax, L), dtype=dtype)
        hap_freq = np.zeros((C, Hmax), dtype=dtype)
        hap_allele = np.zeros((C, Hmax), dtype=np.int32)
        snp_index = np.full((C, L), -1, dtype=np.int32)
        n_snp = np.zeros(C, dtype=np.int32)
        n_haplo = np.zeros(C, dtype=np.int32)
        snp_weight = np.zeros(model.n_snp, dtype=np.int32)
        for i, c in enumerate(model.classifiers):
            h, s = c.n_haplo, c.n_snp
            hap_bits[i, :h, :s] = c.hap_bits
            hap_freq[i, :h] = c.hap_freq
            hap_allele[i, :h] = c.hap_allele
            snp_index[i, :s] = c.snp_index
            n_snp[i] = s
            n_haplo[i] = h
            snp_weight[c.snp_index] += 1
        return cls(hap_bits=hap_bits, hap_freq=hap_freq, hap_allele=hap_allele,
                   snp_index=snp_index, n_snp=n_snp, n_haplo=n_haplo,
                   snp_weight=snp_weight, n_alleles=model.n_alleles,
                   n_snp_model=model.n_snp)
