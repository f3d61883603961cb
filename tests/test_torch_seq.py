"""The port's amino-acid conversion (hibag_tpu_torch.seq.aa, the
hlaConvSequence surface) held against hibag_tpu.seq.aa on the same files.

The IMGT/HLA release that tests/test_seq.py reads is absent, so each test
writes a small synthetic release in the IMGT layout (a protein alignment
in blocks, the P- and G-code tables, the feature table, and an hla.xml as
tests/test_seq.py builds it) and runs both packages on it (the `pkg`
parameter), as tests/test_torch_{io,cli,eval}.py do. fetch_imgt downloads
a release and is never run here."""

import importlib
import os
import zipfile

import numpy as np
import pytest

import hibag_tpu
import hibag_tpu_torch

PKGS = ("hibag_tpu", "hibag_tpu_torch")

#: the reference allele's residues: 4 before position 1, one indel column
#: ('.') that the parser removes, then the mature protein
REF = "MAVM" + "GSHSM" + "." + "RYFFTSVSRPGRGEPRFIAVGYVDDTQFVRFDSDAASQRMEPRA"
#: allele -> pattern against REF ('-' same, letter substitution, '.' indel,
#: '*' unknown); written in alignment blocks of 20 columns
PATTERNS = {
    "01:01:01:01": REF,
    "01:01:01:02N": "-" * len(REF),
    "01:02": "-" * 12 + "K" + "-" * (len(REF) - 13),
    "02:01:01:01": "-" * 6 + "-" + "-" * 8 + "D" + "-" * 20 + "R"
                   + "-" * (len(REF) - 37),
    "02:01:02": "-" * 6 + "-" + "-" * 8 + "D" + "-" * 20 + "W"
                + "-" * (len(REF) - 37),
    "03:01:01": "-" * 9 + "." + "-" * 20 + "*" * 5 + "-" * (len(REF) - 35),
    "24:02": "-" * 3 + "L" + "-" * 16 + "E" + "-" * 13 + "A"
             + "-" * (len(REF) - 35),
}
#: P and G groups (hla_nom_p.txt, hla_nom_g.txt): members and code names
P_GROUPS = [("01:01:01:01/01:01:01:02N", "01:01P"),
            ("02:01:01:01/02:01:02", "02:01P"), ("03:01:01", "")]
G_GROUPS = [("01:01:01:01/01:01:01:02N/01:02", "01:01:01G"),
            ("02:01:01:01/02:01:02", "02:01:01G")]


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for k in list(os.environ):
        if k.startswith("HIBAG_TPU_"):
            monkeypatch.delenv(k)


def _mod(pkg, name="seq.aa"):
    return importlib.import_module(f"{pkg}.{name}")


def _alignment(locus="A", width=20):
    """<locus>_prot.txt in the IMGT layout: six header lines, then blocks
    of a ruler, a bar line and one row per allele (the reference first),
    each block's residues in groups of 10."""
    names = list(PATTERNS)
    pad = max(len(f"{locus}*{n}") for n in names) + 2
    lines = ["# file: synthetic", "# date: 2024-01-01",
             "# version: IPD-IMGT/HLA 3.22.0", "# origin: tests",
             "# repository: none", "# author: tests"]
    pre = REF.index("G")                       # residues before position 1
    for b0 in range(0, len(REF), width):
        if b0 == 0:
            lines.append(" Prot".ljust(pad + 1) + "-" + str(pre)
                         + " " * (pre - len(str(pre))) + "1")
            lines.append(" " * (pad + 1) + "|" + " " * (pre - 1) + "|")
        else:
            lines.append(" Prot".ljust(pad + 1) + str(b0 - pre + 1))
            lines.append(" " * (pad + 1) + "|")
        for n in names:
            chunk = PATTERNS[n][b0:b0 + width]
            groups = " ".join(chunk[i:i + 10] for i in range(0, len(chunk),
                                                             10))
            lines.append(f" {locus}*{n}".ljust(pad + 1) + groups)
        lines.append("")
    return "\n".join(lines) + "\n"


def _release(tmp_path):
    """A synthetic IMGT/HLA release directory for locus A."""
    d = tmp_path / "v3.22.0"
    (d / "SeqAlign").mkdir(parents=True)
    (d / "SeqAlign" / "a_prot.txt").write_text(_alignment())
    (d / "hla_nom_p.txt").write_text(
        "# synthetic P groups\n"
        + "".join(f"A*;{m};{c}\n" for m, c in P_GROUPS))
    (d / "hla_nom_g.txt").write_text(
        "# synthetic G groups\n"
        + "".join(f"A*;{m};{c}\n" for m, c in G_GROUPS))
    (d / "FeatureInfo.txt").write_text(
        "# synthetic feature table\n# IPD-IMGT/HLA 3.22.0 database\n"
        "id\tname\tstart\tend\n"
        "A\t5' UTR\t1\t30\nA\tExon 1\t31\t42\nA\tIntron 1\t43\t60\n"
        "A\tExon 2\t61\t105\nA\tIntron 2\t106\t130\nA\tExon 3\t131\t160\n"
        "A\tIntron 3\t161\t170\nA\tExon 4\t171\t200\n")
    return str(d)


def _table(pkg, n=40, seed=0):
    """A typed table over the alleles the release holds, a few it lacks."""
    rng = np.random.default_rng(seed)
    names = ["01:01", "01:02", "02:01", "03:01", "24:02", "01:01:01:02N",
             "02:01:02", "11:01"]
    a1, a2 = rng.choice(names, n), rng.choice(names, n)
    t = _mod(pkg, "data.allele").HLATypeTable.from_alleles(
        [f"s{i}" for i in range(n)], a1, a2, locus="A")
    t.prob = rng.uniform(0.2, 1.0, n)
    return t


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype
        if a.dtype == object:
            assert list(a.ravel()) == list(np.asarray(b).ravel())
        else:
            np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("pkg", PKGS)
def test_protein_alignment_parse(pkg, tmp_path):
    """tests/test_seq.py's checks on the synthetic alignment, and both
    packages' parses equal."""
    data = _release(tmp_path)
    p = _mod(pkg).protein_alignment("A", data)
    assert p["allele"][0] == "01:01:01:01"
    assert p["start"] == 5              # position 1 is the fifth residue
    assert set(p["sequence"][0]) == {"-"}
    assert "." not in p["reference"]
    assert p["reference"] == REF.replace(".", "")
    assert [f["id"] for f in p["feature"]] == [f"Exon {i}"
                                              for i in range(1, 5)]
    _same(p, _mod("hibag_tpu").protein_alignment("A", data))
    assert _mod(pkg)._alignment_reference_allele(
        os.path.join(data, "SeqAlign", "a_prot.txt"), "A") == "A*01:01:01:01"


@pytest.mark.parametrize("pkg", PKGS)
def test_seq_merge(pkg):
    seq_merge = _mod(pkg).seq_merge
    assert seq_merge(["ABC", "ABC"]) == "ABC"
    assert seq_merge(["ABC", "ABD"]) == "AB*"
    assert seq_merge(["AB", "ABC"]) == "AB*"
    assert seq_merge([]) is None


@pytest.mark.parametrize("code", ["exact", "P.code", "P.code.merge",
                                  "G.code", "G.code.merge"])
@pytest.mark.parametrize("region", ["auto", "all"])
def test_conv_sequence_matches(code, region, tmp_path):
    """Each code and region: the port's sequences (strings, dicts of
    members for unmerged codes, None where unmatched) equal hibag_tpu's."""
    data = _release(tmp_path)
    alleles = ["01:01:01:01", "01:01", "01:01:01", "01:02", "02:01",
               "02:01:02", "03:01", "03:01:01", "24:02", "11:01", None]
    got = _mod("hibag_tpu_torch").conv_sequence(alleles, "A", data, code,
                                                region)
    want = _mod("hibag_tpu").conv_sequence(alleles, "A", data, code, region)
    _same(got, want)
    assert got[0] is not None and got[-2] is None and got[-1] is None
    if code != "exact":                    # resolved through its group
        assert got[1 if code.startswith("P") else 2] is not None
    replaced = _mod("hibag_tpu_torch").conv_sequence(
        ["11:01"], "A", data, code, region, replace={"11:01": "24:02"})
    _same(replaced, _mod("hibag_tpu").conv_sequence(
        ["11:01"], "A", data, code, region, replace={"11:01": "24:02"}))
    with pytest.raises(ValueError, match="locus"):
        _mod("hibag_tpu_torch").conv_sequence(alleles, "X", data)


@pytest.mark.parametrize("code", ["exact", "P.code.merge", "G.code.merge"])
def test_convert_table_matches(code, tmp_path):
    """convert_table (hlaConvSequence) on each package's own table: the
    AASeqTable's fields, residue tables and their formatted summaries
    equal; P.code and G.code are refused alike."""
    data = _release(tmp_path)
    out = {pkg: _mod(pkg).convert_table(_table(pkg), data, code=code)
           for pkg in PKGS}
    a, b = out["hibag_tpu_torch"], out["hibag_tpu"]
    assert isinstance(a, hibag_tpu_torch.AASeqTable)
    for f in ("locus", "sample_id", "allele1", "allele2", "start_position",
              "reference", "prob"):
        _same(getattr(a, f), getattr(b, f))
    assert sum(s is not None for s in a.allele1) > 0
    for poly in (True, False):
        ra, rb = a.residue_table(poly), b.residue_table(poly)
        _same(ra, rb)
        for head in (0, 3):
            assert (hibag_tpu_torch.format_residue_table(ra, head)
                    == hibag_tpu.format_residue_table(rb, head))
    for bad in ("P.code", "G.code"):
        for pkg in PKGS:
            with pytest.raises(ValueError, match="merge"):
                _mod(pkg).convert_table(_table(pkg), data, code=bad)


def test_hla_conv_sequence_to_aa_assoc_test(tmp_path):
    """hlaConvSequence -> hlaAssocTest (the per-position tests of
    aa_assoc_test) end to end in the port, equal to hibag_tpu's rows."""
    from test_torch_eval import _same as same_rows

    data = _release(tmp_path)
    assert hibag_tpu_torch.hlaConvSequence is hibag_tpu_torch.convert_table
    y = np.random.default_rng(5).integers(0, 2, 40)
    aa = hibag_tpu_torch.hlaConvSequence(_table("hibag_tpu_torch"), data)
    aa_ref = hibag_tpu.hlaConvSequence(_table("hibag_tpu"), data)
    rows = hibag_tpu_torch.hlaAssocTest(aa, y)
    assert len(rows) >= 3
    same_rows(rows, hibag_tpu.hlaAssocTest(aa_ref, y))
    same_rows(hibag_tpu_torch.aa_assoc_test(aa, y, prob_threshold=0.5),
              hibag_tpu.aa_assoc_test(aa_ref, y, prob_threshold=0.5))


def test_default_data_dir_resolution(monkeypatch, tmp_path):
    """data_dir=None resolves through HIBAG_TPU_IMGT_DIR, then the fetched
    copy under ~/.cache/hibag_tpu/imgt, as in hibag_tpu; with neither the
    port raises FileNotFoundError naming fetch_imgt."""
    aa = _mod("hibag_tpu_torch")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    with pytest.raises(FileNotFoundError, match="fetch_imgt"):
        aa.default_data_dir()
    data = _release(tmp_path)
    monkeypatch.setenv("HIBAG_TPU_IMGT_DIR", data)
    assert aa.default_data_dir() == data
    assert aa.default_data_dir() == _mod("hibag_tpu").default_data_dir()
    _same(aa.conv_sequence(["01:02"], "A"),
          _mod("hibag_tpu").conv_sequence(["01:02"], "A"))
    monkeypatch.delenv("HIBAG_TPU_IMGT_DIR")
    cache = tmp_path / "home" / ".cache" / "hibag_tpu" / "imgt" / "v3.22.0"
    (cache / "SeqAlign").mkdir(parents=True)
    assert aa.default_data_dir() == str(cache)


@pytest.mark.parametrize("pkg", PKGS)
def test_feature_info_from_xml(pkg, tmp_path):
    """fetch_imgt's FeatureInfo converter (tests/test_seq.py's XML, with a
    second allele after the reference): UTR/exon/intron spans of the
    reference allele, the same file from both packages."""
    xml = """<?xml version="1.0"?>
<alleles xmlns="http://hla.alleles.org/xml">
 <allele name="HLA-A*02:01:01:01" id="HLA00005">
  <sequence>
   <feature name="Exon 1" featuretype="Exon">
    <SequenceCoordinates start="1" end="70"/>
   </feature>
  </sequence>
 </allele>
 <allele name="HLA-A*01:01:01:01" id="HLA00001">
  <sequence>
   <feature name="5' UTR" featuretype="UTR">
    <SequenceCoordinates start="1" end="300"/>
   </feature>
   <feature name="Exon 1" featuretype="Exon">
    <SequenceCoordinates start="301" end="373"/>
   </feature>
   <feature name="Intron 1" featuretype="Intron">
    <SequenceCoordinates start="374" end="503"/>
   </feature>
   <feature name="TM" featuretype="Protein">
    <SequenceCoordinates start="1" end="10"/>
   </feature>
  </sequence>
 </allele>
</alleles>"""
    zp = tmp_path / "hla.xml.zip"
    with zipfile.ZipFile(zp, "w") as z:
        z.writestr("hla.xml", xml)
    outs = {}
    for p in PKGS:
        out = tmp_path / f"{p}.txt"
        _mod(p)._feature_info_from_xml(str(zp), str(out), "3.22.0", ("A",),
                                       {"A": "A*01:01:01:01"})
        outs[p] = out.read_text()
    lines = outs[pkg].splitlines()
    assert lines[2:] == ["id\tname\tstart\tend", "A\t5' UTR\t1\t300",
                         "A\tExon 1\t301\t373", "A\tIntron 1\t374\t503"]
    assert outs["hibag_tpu"] == outs["hibag_tpu_torch"]
