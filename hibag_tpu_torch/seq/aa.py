"""HLA allele → amino-acid sequence conversion (IMGT/HLA alignments): the
port's numpy copy of hibag_tpu/seq/aa.py, which needs nothing of hibag_tpu.

Equivalent of hlaConvSequence / summary.hlaAASeqClass (reference
R/SeqFormat.R) with the native consensus/dot helpers (HIBAG_SeqMerge /
HIBAG_SeqRmDot, src/HIBAG.cpp:1197-1278).

The IMGT/HLA alignment data is licensed third-party data (IPD-IMGT/HLA,
CC BY-ND — redistributable with citation, no modified redistribution)
and is NOT bundled here.  Two ways to provide it, in resolution order
(``default_data_dir``):

1. point ``data_dir=`` (or the ``HIBAG_TPU_IMGT_DIR`` env var, which
   hibag_tpu reads too) at a release directory laid out like the HIBAG
   package's ``inst/extdata/v3.22.0`` (SeqAlign/<locus>_prot.txt[.xz],
   hla_nom_p.txt[.xz], hla_nom_g.txt[.xz], FeatureInfo.txt);
2. a previously fetched copy under ``~/.cache/hibag_tpu/imgt/v<release>``
   (see ``fetch_imgt``, which downloads a release from the official
   ANHIG/IMGTHLA distribution and converts it to that layout; hibag_tpu
   shares the cache).

Sequence pattern conventions (IMGT): '-' = identical to reference,
letter = substitution, '.' = indel, '*' = unknown.
"""

from __future__ import annotations

import lzma
import os
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Sequence

import numpy as np

HLA_LOCI = ("A", "B", "C", "DRB1", "DQA1", "DQB1", "DPB1", "DPA1")

def default_data_dir(release: str = "3.22.0") -> str:
    """Resolve the IMGT/HLA release directory (see module docstring for
    the search order).  Raises FileNotFoundError with download
    instructions when nothing is found."""
    probe = [os.environ.get("HIBAG_TPU_IMGT_DIR", "")]
    probe.append(os.path.expanduser(f"~/.cache/hibag_tpu/imgt/v{release}"))
    for d in probe:
        if d and os.path.isdir(os.path.join(d, "SeqAlign")):
            return d
    raise FileNotFoundError(
        f"No IMGT/HLA v{release} data directory found (searched "
        f"{[p for p in probe if p]}). Run "
        f"hibag_tpu_torch.seq.aa.fetch_imgt('{release}') to download one "
        "from the official ANHIG/IMGTHLA distribution, or set "
        "HIBAG_TPU_IMGT_DIR.")


def fetch_imgt(release: str = "3.22.0", dest: str | None = None,
               loci: Sequence[str] = HLA_LOCI) -> str:
    """Download an IPD-IMGT/HLA release from the official ANHIG/IMGTHLA
    GitHub distribution and convert it to the layout ``conv_sequence``
    expects; returns the created directory (cached — a complete existing
    copy is returned as-is).

    Downloads per release tag (e.g. v3.22.0 → tag "3.22.0" / branch
    "3220"): ``alignments/<Locus>_prot.txt`` for each locus,
    ``wmda/hla_nom_p.txt``, ``wmda/hla_nom_g.txt``, and ``xml/hla.xml.zip``
    from which the per-locus feature table (FeatureInfo.txt: UTR/exon/
    intron spans) is extracted — the same source the reference's bundled
    table cites (inst/extdata/v3.22.0/FeatureInfo.txt header).

    The data is CC BY-ND licensed by the HLA Informatics Group: cite
    Robinson et al., Nucleic Acids Research 2015 43:D423-431 when
    publishing results derived from it.
    """
    import urllib.request

    dest = dest or os.path.expanduser(f"~/.cache/hibag_tpu/imgt/v{release}")
    align_dir = os.path.join(dest, "SeqAlign")
    done = (os.path.isdir(align_dir)
            and os.path.exists(os.path.join(dest, "hla_nom_p.txt"))
            and os.path.exists(os.path.join(dest, "FeatureInfo.txt"))
            and all(os.path.exists(os.path.join(
                align_dir, f"{loc.lower()}_prot.txt")) for loc in loci))
    if done:
        return dest
    os.makedirs(align_dir, exist_ok=True)
    branch = release.replace(".", "")
    base = f"https://raw.githubusercontent.com/ANHIG/IMGTHLA/{branch}"

    def get(rel_url: str, out_path: str) -> None:
        if os.path.exists(out_path):
            return
        with urllib.request.urlopen(f"{base}/{rel_url}", timeout=120) as r:
            data = r.read()
        with open(out_path + ".part", "wb") as f:
            f.write(data)
        os.rename(out_path + ".part", out_path)

    for loc in loci:
        get(f"alignments/{loc}_prot.txt",
            os.path.join(align_dir, f"{loc.lower()}_prot.txt"))
    get("wmda/hla_nom_p.txt", os.path.join(dest, "hla_nom_p.txt"))
    get("wmda/hla_nom_g.txt", os.path.join(dest, "hla_nom_g.txt"))
    xml_zip = os.path.join(dest, "hla.xml.zip")
    get("xml/hla.xml.zip", xml_zip)
    # the reference's bundled FeatureInfo.txt describes each locus's
    # REFERENCE allele (the alignment's first row), so extract exactly
    # those alleles' feature spans from hla.xml
    refs = {loc: _alignment_reference_allele(
        os.path.join(align_dir, f"{loc.lower()}_prot.txt"), loc)
        for loc in loci}
    _feature_info_from_xml(xml_zip, os.path.join(dest, "FeatureInfo.txt"),
                           release, loci, refs)
    return dest


def _alignment_reference_allele(path: str, locus: str) -> Optional[str]:
    """First allele row of a <locus>_prot.txt alignment — the IMGT
    reference allele the bundled FeatureInfo table is built from."""
    try:
        for ln in _read_lines(path):
            if ln.startswith(f" {locus}*"):
                return ln[1:].split()[0]
    except (OSError, FileNotFoundError):
        pass
    return None


def _feature_info_from_xml(xml_zip: str, out_path: str, release: str,
                           loci: Sequence[str],
                           ref_alleles: Optional[dict] = None) -> None:
    """Extract per-locus UTR/exon/intron spans from the release's hla.xml
    into the tab-separated FeatureInfo.txt layout the reference bundles.

    ``ref_alleles`` maps locus → the locus REFERENCE allele name (the
    protein alignment's first row, e.g. "A*01:01:01:01") whose spans are
    extracted — matching how the bundled table is built.  Loci without a
    resolvable reference allele fall back to the first allele encountered
    with features, which can differ from the bundled table's spans (the
    table is only used for coarse region bounds like E2/E2+E3)."""
    import xml.etree.ElementTree as ET
    import zipfile

    ref_alleles = ref_alleles or {}
    want = {f"HLA-{loc}": loc for loc in loci}

    def _is_ref(locus: str, aname: str) -> bool:
        ref = ref_alleles.get(locus)
        if not ref:
            return True  # no reference row known: first-encountered
        return aname == f"HLA-{ref}" or aname.startswith(f"HLA-{ref}:")

    def _feats(el) -> list:
        feats = []
        for fe in el.iter():
            if fe.tag.rsplit("}", 1)[-1] != "feature":
                continue
            ftype = fe.get("featuretype", "")
            if ftype not in ("UTR", "Exon", "Intron"):
                continue
            coord = next(
                (c for c in fe.iter()
                 if c.tag.rsplit("}", 1)[-1] == "SequenceCoordinates"),
                None)
            if coord is None:
                continue
            feats.append((fe.get("name", ftype),
                          int(coord.get("start")), int(coord.get("end"))))
        return feats

    rows: dict[str, list] = {}
    fallback: dict[str, list] = {}  # first allele with features per locus
    with zipfile.ZipFile(xml_zip) as z:
        name = z.namelist()[0]
        with z.open(name) as f:
            for _, el in ET.iterparse(f):
                tag = el.tag.rsplit("}", 1)[-1]
                if tag != "allele":
                    continue
                aname = el.get("name", "")
                locus = want.get(aname.split("*", 1)[0])
                if locus is not None and locus not in rows:
                    feats = None
                    if _is_ref(locus, aname):
                        feats = _feats(el)
                        if feats:
                            rows[locus] = feats
                    if locus not in fallback:
                        feats = _feats(el) if feats is None else feats
                        if feats:
                            fallback[locus] = feats
                el.clear()
                if len(rows) == len(loci):
                    break
    with open(out_path + ".part", "w") as f:
        f.write("# extracted from the IPD-IMGT/HLA release hla.xml\n")
        f.write(f"# IPD-IMGT/HLA {release} database\n")
        f.write("id\tname\tstart\tend\n")
        for loc in loci:
            for name, start, end in rows.get(loc, fallback.get(loc, [])):
                f.write(f"{loc}\t{name}\t{start}\t{end}\n")
    os.rename(out_path + ".part", out_path)


def _read_lines(path: str) -> list[str]:
    for p in (path, path + ".xz"):
        if os.path.exists(p):
            op = lzma.open if p.endswith(".xz") else open
            with op(p, "rt") as f:
                return f.read().splitlines()
    raise FileNotFoundError(path)


@lru_cache(maxsize=32)
def _codes(data_dir: str, kind: str) -> dict:
    """P-code/G-code table: code string → list of member alleles."""
    lines = _read_lines(os.path.join(data_dir, f"hla_nom_{kind}.txt"))
    out = {}
    for ln in lines:
        if ln.startswith("#") or not ln.strip():
            continue
        parts = ln.split(";")
        a1, a2 = parts[0], parts[1]
        a3 = parts[2] if len(parts) > 2 and parts[2] else a2
        out[a1 + a3] = a2.split("/")
    return out


@lru_cache(maxsize=32)
def _feature(data_dir: str):
    lines = _read_lines(os.path.join(data_dir, "FeatureInfo.txt"))
    rows = []
    hdr = None
    for ln in lines:
        if ln.startswith("#") or not ln.strip():
            continue
        if hdr is None:
            hdr = ln.split("\t")
            continue
        rows.append(dict(zip(hdr, ln.split("\t"))))
    return rows


def protein_alignment(locus: str, data_dir: Optional[str] = None) -> dict:
    """Parse a <locus>_prot.txt alignment (reference .protein,
    R/SeqFormat.R:102-170). Returns dict with reference sequence, start
    offset of position 1, allele names, per-allele pattern strings, and
    exon features in amino-acid coordinates.

    ``data_dir=None`` is resolved to :func:`default_data_dir` HERE (not in
    the cached body) so env-var changes or a freshly fetched release are
    picked up by later calls instead of being frozen into the cache key."""
    if data_dir is None:
        data_dir = default_data_dir()
    return _protein_alignment_cached(locus, data_dir)


@lru_cache(maxsize=16)
def _protein_alignment_cached(locus: str, data_dir: str) -> dict:
    lines = _read_lines(os.path.join(data_dir, "SeqAlign",
                                     f"{locus.lower()}_prot.txt"))
    s1 = lines[6].rstrip()
    s2 = lines[7].rstrip()
    if not s1.endswith("1"):
        raise ValueError("unexpected alignment header format")
    first = lines[8]
    tok = first.split()[0]
    ss = first.replace(tok, " " * len(tok), 1)[:len(s2)]
    start = len(ss.replace(" ", ""))

    head = f" {locus}*"
    chunks: dict[str, list[str]] = {}
    order: list[str] = []
    for ln in lines:
        if not ln.startswith(head):
            continue
        v = ln[1:].split()
        name, seq = v[0], "".join(v[1:])
        if name not in chunks:
            chunks[name] = []
            order.append(name)
        chunks[name].append(seq)

    alleles = order
    seqs = ["".join(chunks[a]) for a in alleles]
    reference = seqs[0]
    seqs[0] = "-" * len(reference)

    # remove reference-deletion columns (except DQB1, whose reference has
    # genuine deletions — reference behavior, R/SeqFormat.R:141-146)
    if locus != "DQB1" and "." in reference:
        keep = [i for i, ch in enumerate(reference) if ch != "."]
        seqs = ["".join(s[i] for i in keep if i < len(s)) for s in seqs]
        reference = "".join(reference[i] for i in keep)

    # exon features in AA coordinates (cumulative nucleotide → codon)
    fea = [f for f in _feature(data_dir) if f["id"] == locus
           and f["name"].startswith("Exon ")]
    lens = [int(f["end"]) - int(f["start"]) + 1 for f in fea]
    cum = np.cumsum(lens)
    ends = (cum // 3) + (cum % 3)
    starts = np.concatenate([[1], cum[:-1] + 1])
    starts = (starts + 2) // 3
    features = [{"id": f["name"], "start": int(st), "end": int(en)}
                for f, st, en in zip(fea, starts, ends)]
    # strip allele names to the part after '*'
    names = [a.split("*", 1)[1] for a in alleles]
    return {"reference": reference, "start": start, "allele": names,
            "sequence": seqs, "feature": features}


def seq_merge(seqs: Sequence[str]) -> Optional[str]:
    """Consensus with '*' at disagreeing/short positions (HIBAG_SeqMerge)."""
    if not seqs:
        return None
    nmax = max(len(s) for s in seqs)
    out = list(seqs[0]) + ["*"] * (nmax - len(seqs[0]))
    for s in seqs[1:]:
        for j in range(nmax):
            if j >= len(s) or (j < len(s) and s[j] != out[j]):
                out[j] = "*"
    return "".join(out)


def _region_bounds(locus: str, region: str, prot: dict):
    if region in ("P.code", "G.code"):
        fea = prot["feature"]
        if locus in ("A", "B", "C"):
            return fea[1]["start"], fea[2]["end"]
        return fea[1]["start"], fea[1]["end"]
    return None


def conv_sequence(alleles, locus: str, data_dir: Optional[str] = None,
                  code: str = "exact", region: str = "auto",
                  replace: Optional[dict] = None):
    """Map allele strings to amino-acid pattern strings (hlaConvSequence).

    code: 'exact' | 'P.code' | 'G.code' | 'P.code.merge' | 'G.code.merge'.
    Returns a list parallel to `alleles`: a string (exact/merged), a dict of
    {member: seq} for ambiguous unmerged codes, or None if unmatched.
    """
    if locus not in HLA_LOCI:
        raise ValueError(f"locus must be one of {HLA_LOCI}")
    if data_dir is None:
        data_dir = default_data_dir()
    if region == "auto":
        region = {"exact": "all", "P.code": "P.code",
                  "P.code.merge": "P.code", "G.code": "G.code",
                  "G.code.merge": "G.code"}[code]
    prot = protein_alignment(locus, data_dir)
    seq_by_allele = dict(zip(prot["allele"], prot["sequence"]))

    def lookup(h):
        if replace and h in replace:
            h = replace[h]
        s = seq_by_allele.get(h)
        if s is not None:
            return {h: s}
        if code in ("P.code", "P.code.merge", "G.code", "G.code.merge"):
            kind = "p" if code.startswith("P") else "g"
            table = _codes(data_dir, kind)
            suffix = "P" if kind == "p" else "G"
            key = f"{locus}*{h}"
            members = table.get(key) or table.get(key + suffix)
            if members:
                got = {m: seq_by_allele[m] for m in members
                       if m in seq_by_allele}
                if got:
                    return got
        return None

    bounds = _region_bounds(locus, region, prot)
    out = []
    for h in alleles:
        if h is None:
            out.append(None)
            continue
        m = lookup(str(h))
        if m is None:
            out.append(None)
            continue
        if bounds:
            m = {k: v[bounds[0] - 1:bounds[1]] for k, v in m.items()}
        if code in ("exact", "P.code.merge", "G.code.merge"):
            out.append(seq_merge(list(m.values())))
        else:
            out.append(m if len(m) > 1 else next(iter(m.values())))
    return out


@dataclass
class AASeqTable:
    """Per-sample amino-acid sequences (hlaAASeqClass equivalent)."""

    locus: str
    sample_id: np.ndarray
    allele1: np.ndarray     # object [N] of pattern strings (or None)
    allele2: np.ndarray
    start_position: int
    reference: str
    prob: Optional[np.ndarray] = None

    def residue_table(self, poly_only: bool = True) -> dict:
        """Per-position residue counts (summary.hlaAASeqClass)."""
        seqs = [s for s in np.concatenate([self.allele1, self.allele2])
                if s is not None]
        if not seqs:
            return {"pos": np.zeros(0, int)}
        n = max(len(s) for s in seqs)
        mat = np.full((len(seqs), n), "", dtype="U1")
        for i, s in enumerate(seqs):
            mat[i, :len(s)] = list(s)
        chars = sorted({c for c in mat.ravel() if c})
        counts = {c: (mat == c).sum(0) for c in chars}
        num = (mat != "").sum(0)
        pos = np.arange(1, n + 1) - self.start_position + 1
        keep = np.ones(n, dtype=bool)
        if poly_only and "-" in counts:
            keep = num != counts["-"]
        return {"pos": pos[keep], "num": num[keep],
                **{c: v[keep] for c, v in counts.items()}}


def format_residue_table(table: dict, head: int = 0) -> str:
    """Render a residue_table as the reference's per-position summary
    (summary.hlaAASeqClass, R/SeqFormat.R:404-456): counts per residue per
    position, zeros printed as '.'."""
    keys = [k for k in table if k not in ("pos", "num")]
    cols = ["Pos", "Num"] + keys
    rows = []
    n = len(table["pos"])
    limit = n if head < 1 else min(head, n)
    for i in range(limit):
        row = [str(int(table["pos"][i])), str(int(table["num"][i]))]
        for k in keys:
            v = int(table[k][i])
            row.append("." if v == 0 else str(v))
        rows.append(row)
    widths = [max(len(c), *(len(r[j]) for r in rows)) if rows else len(c)
              for j, c in enumerate(cols)]
    out = [" ".join(c.rjust(w) for c, w in zip(cols, widths))]
    out += [" ".join(x.rjust(w) for x, w in zip(r, widths)) for r in rows]
    if limit < n:
        out.append("......")
    return "\n".join(out)


def convert_table(hla_table, data_dir: Optional[str] = None,
                  code: str = "exact",
                  region: str = "auto",
                  replace: Optional[dict] = None) -> AASeqTable:
    """hlaConvSequence on an HLATypeTable → AASeqTable."""
    if code in ("P.code", "G.code"):
        raise ValueError("use 'exact', 'P.code.merge' or 'G.code.merge' "
                         "for table conversion")
    locus = hla_table.locus
    prot = protein_alignment(locus, data_dir)
    n = hla_table.n_samp
    both = conv_sequence(
        list(hla_table.allele1) + list(hla_table.allele2), locus, data_dir,
        code=code, region=region, replace=replace)
    if region == "auto":
        region = "all" if code == "exact" else \
            ("P.code" if "P" in code else "G.code")
    bounds = _region_bounds(locus, region, prot)
    if bounds is None:
        start = prot["start"]
        ref = prot["reference"]
    else:
        start = prot["start"] - bounds[0] + 1
        ref = prot["reference"][bounds[0] - 1:bounds[1]]
    return AASeqTable(
        locus=locus, sample_id=hla_table.sample_id,
        allele1=np.array(both[:n], dtype=object),
        allele2=np.array(both[n:], dtype=object),
        start_position=start, reference=ref,
        prob=hla_table.prob)
