"""The port's file formats (hibag_tpu_torch.io: bed, bgzf, gds, rdata, vcf,
vcf_in, native; data.geno.switch_strand / combine_geno;
models.publish.model_to_robj / save_rdata) held against hibag_tpu's on the
same seeded synthetic files: equal SNPGenoData from every reader, the same
exception types on broken files, byte-equal payloads from the writers.

Cases of hibag_tpu's own tests that need no bundled fixture run here over
both packages (the `pkg` parameter); the files come from chip_smoke.py's
PLINK and VCF writers and from a GDS builder below, written from the block
grammar that io/gds.py's docstring sets out."""

import gzip
import importlib
import lzma
import os
import pathlib
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import hibag_tpu  # noqa: E402
import hibag_tpu_torch  # noqa: E402
from hibag_tpu_torch.utils.synthetic import (synthetic_cohort,  # noqa: E402
                                             synthetic_model)

PKGS = ("hibag_tpu", "hibag_tpu_torch")


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for k in list(os.environ):
        if k.startswith("HIBAG_TPU_"):
            monkeypatch.delenv(k)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _geno(seed=0, n_snp=40, n_samp=30):
    """(SNPGenoData of the port, chromosome per SNP): 30 samples (not a
    multiple of 4), 5% missing, SNPs on chromosome 6 inside and outside
    the xMHC window and on chromosome 1."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, (n_snp, n_samp)).astype(np.uint8)
    g[rng.random(g.shape) < 0.05] = 3
    chrom = np.array(["6"] * (n_snp - 8) + ["6"] * 4 + ["1"] * 4, dtype=object)
    pos = np.concatenate([
        np.sort(rng.choice(np.arange(29_400_000, 33_400_000), n_snp - 8,
                           replace=False)),
        5_000_000 + 1_000 * np.arange(4), 30_000_000 + 1_000 * np.arange(4),
    ]).astype(np.int64)
    pairs = np.array(["A/G", "C/T", "G/A", "T/C", "A/C", "G/T"], dtype=object)
    geno = hibag_tpu_torch.SNPGenoData(
        genotype=g,
        sample_id=np.array([f"s{i}" for i in range(n_samp)], dtype=object),
        snp_id=np.array([f"rs{100 + i}" for i in range(n_snp)], dtype=object),
        snp_position=pos, snp_allele=pairs[rng.integers(0, 6, n_snp)],
        assembly="hg19")
    return geno, chrom


def _assert_same_geno(a, b):
    np.testing.assert_array_equal(a.genotype, b.genotype)
    assert a.genotype.dtype == b.genotype.dtype == np.uint8
    for f in ("sample_id", "snp_id", "snp_allele"):
        assert list(getattr(a, f)) == list(getattr(b, f)), f
    np.testing.assert_array_equal(a.snp_position, b.snp_position)
    assert a.snp_position.dtype == b.snp_position.dtype
    assert a.assembly == b.assembly


def _expected(geno, chrom, import_chr):
    keep = _mod("hibag_tpu_torch", "io.bed").select_region(
        chrom, geno.snp_position, import_chr, "hg19")
    return geno.subset(snp_mask=keep)


def _both(fn, *args, **kw):
    """fn's result from each package's module, and that they are equal."""
    got = [fn(pkg, *args, **kw) for pkg in PKGS]
    _assert_same_geno(got[0], got[1])
    return got[1]


# --- PLINK ------------------------------------------------------------------

@pytest.mark.parametrize("import_chr", ["", "xMHC", "6", "1"])
def test_read_bed_matches(tmp_path, import_chr):
    geno, chrom = _geno()
    bed = chip_smoke.write_plink(geno, str(tmp_path / "c"), chrom)
    got = _both(lambda pkg: _mod(pkg, "io.bed").read_bed(
        bed, import_chr=import_chr))
    _assert_same_geno(got, _expected(geno, chrom, import_chr))


def test_read_bed_individual_major_and_duplicate_iids(tmp_path):
    """Mode 0 (individual-major) .bed and a .fam whose IIDs repeat (sample
    ids become FID-IID)."""
    geno, chrom = _geno(1, n_snp=9, n_samp=7)
    prefix = str(tmp_path / "i")
    chip_smoke.write_plink(geno, prefix, chrom)
    bits = chip_smoke._PLINK_BITS[geno.genotype.T]          # [N, P]
    bits = np.pad(bits, ((0, 0), (0, -bits.shape[1] % 4)))
    q = bits.reshape(bits.shape[0], -1, 4)
    packed = q[..., 0] | q[..., 1] << 2 | q[..., 2] << 4 | q[..., 3] << 6
    pathlib.Path(prefix + ".bed").write_bytes(
        b"\x6c\x1b\x00" + packed.astype(np.uint8).tobytes())
    fam = [f"F{j % 2}\tX{j // 2}\t0\t0\t0\t-9\n" for j in range(7)]
    pathlib.Path(prefix + ".fam").write_text("".join(fam))
    got = _both(lambda pkg: _mod(pkg, "io.bed").read_bed(
        prefix + ".bed", import_chr=""))
    np.testing.assert_array_equal(got.genotype, geno.genotype)
    assert list(got.sample_id) == [f"F{j % 2}-X{j // 2}" for j in range(7)]


@pytest.mark.parametrize("fault", ["magic", "truncated", "no_region",
                                   "dup_snp"])
def test_read_bed_errors_match(tmp_path, fault):
    geno, chrom = _geno(2, n_snp=12, n_samp=9)
    prefix = str(tmp_path / "e")
    bed = chip_smoke.write_plink(geno, prefix, chrom)
    raw = pathlib.Path(bed).read_bytes()
    kw = {"import_chr": ""}
    if fault == "magic":
        pathlib.Path(bed).write_bytes(b"\x00\x00" + raw[2:])
    elif fault == "truncated":
        pathlib.Path(bed).write_bytes(raw[:-5])
    elif fault == "no_region":
        kw = {"import_chr": "22"}
    else:
        bim = pathlib.Path(prefix + ".bim").read_text().splitlines()
        bim[1] = bim[1].replace("rs101", "rs100")
        pathlib.Path(prefix + ".bim").write_text("\n".join(bim) + "\n")
    errs = []
    for pkg in PKGS:
        with pytest.raises(Exception) as e:
            _mod(pkg, "io.bed").read_bed(bed, **kw)
        errs.append(type(e.value))
    assert errs[0] is errs[1] is ValueError


@pytest.mark.parametrize("pkg", PKGS)
def test_select_region(pkg):
    """tests/test_bed.py::test_select_region, for both packages."""
    select_region = _mod(pkg, "io.bed").select_region
    chrom = np.array(["6", "6", "1"], dtype=object)
    pos = np.array([30_000_000, 5_000_000, 30_000_000])
    f = select_region(chrom, pos, "xMHC", "hg19")
    assert f[0] and not f[1] and not f[2]
    assert select_region(chrom, pos, "", "hg19").all()
    f6 = select_region(chrom, pos, "6", "hg19")
    assert f6[0] and f6[1] and not f6[2]


def test_write_ped_matches(tmp_path):
    geno, _ = _geno(3, n_snp=20, n_samp=5)
    text = []
    for pkg in PKGS:
        mod = _mod(pkg, "io.bed")
        g = _mod(pkg, "data.geno").SNPGenoData(
            genotype=geno.genotype, sample_id=geno.sample_id,
            snp_id=geno.snp_id, snp_position=geno.snp_position,
            snp_allele=geno.snp_allele, assembly="hg19")
        mod.write_ped(g, str(tmp_path / pkg))
        text.append([(tmp_path / f"{pkg}.{ext}").read_text()
                     for ext in ("ped", "map")])
    assert text[0] == text[1]
    assert len(text[1][0].splitlines()) == 5
    assert len(text[1][1].splitlines()) == 20


def test_native_bindings_match_numpy(monkeypatch):
    """bed_decode and snp_stats: the native library's results equal the
    NumPy versions (and hibag_tpu's), and bed_decode refuses a short
    payload before the unchecked C++ reads it."""
    native = _mod("hibag_tpu_torch", "io.native")
    jnative = _mod("hibag_tpu", "io.native")
    rng = np.random.default_rng(4)
    n_snp, n_samp = 11, 27
    raw = rng.integers(0, 256, n_snp * ((n_samp + 3) // 4), dtype=np.uint8)
    keep = np.array([0, 3, 4, 10], dtype=np.int64)
    codes = rng.integers(0, 4, (9, 50)).astype(np.int8)
    out = {}
    for lib in ("native", "numpy"):
        if lib == "numpy":
            monkeypatch.setattr(native, "get_lib", lambda: None)
        elif native.get_lib() is None:
            continue
        out[lib] = (native.bed_decode(raw, n_snp, n_samp, keep),
                    native.snp_stats(codes))
        with pytest.raises(ValueError, match="too short"):
            native.bed_decode(raw[:-1], n_snp, n_samp, keep)
        with pytest.raises(ValueError, match="out of range"):
            native.bed_decode(raw, n_snp, n_samp, np.array([n_snp]))
    want = (jnative.bed_decode(raw, n_snp, n_samp, keep),
            jnative.snp_stats(codes))
    for got in out.values():
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == np.int8
        np.testing.assert_allclose(got[1][0], want[1][0], rtol=1e-15)
        np.testing.assert_allclose(got[1][1], want[1][1], rtol=1e-15)
    freq = np.where(codes <= 2, codes, 0).sum(1) / (2.0 * (codes <= 2).sum(1))
    np.testing.assert_allclose(out["numpy"][1][0], freq, rtol=1e-15)


# --- VCF in -----------------------------------------------------------------

def _write_small_vcf(path, gz=False):
    """tests/test_vcf_in.py::_write_vcf: an indel, a multi-allelic record
    and a record off chromosome 6 among biallelic SNPs."""
    lines = [
        "##fileformat=VCFv4.2",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1\ts2\ts3",
        "6\t29910500\trs1\tA\tG\t.\tPASS\t.\tGT\t0/0\t0/1\t1/1",
        "6\t29910600\trs2\tC\tT\t.\tPASS\t.\tGT:DP\t0|1:10\t./.:3\t0/0:8",
        "6\t29910700\trs3\tA\tGT\t.\tPASS\t.\tGT\t0/0\t0/0\t0/0",
        "6\t29910800\trs4\tA\tG,C\t.\tPASS\t.\tGT\t0/0\t0/0\t0/0",
        "1\t1000\trs5\tA\tG\t.\tPASS\t.\tGT\t0/0\t0/1\t1/1",
    ]
    data = "\n".join(lines) + "\n"
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(data)
    else:
        pathlib.Path(path).write_text(data)


@pytest.mark.parametrize("pkg", PKGS)
def test_read_vcf_small(pkg, tmp_path):
    """tests/test_vcf_in.py::test_read_vcf and ::test_read_vcf_gz_all_chr,
    for both packages."""
    read_vcf = _mod(pkg, "io.vcf_in").read_vcf
    p = str(tmp_path / "t.vcf")
    _write_small_vcf(p)
    g = read_vcf(p, import_chr="xMHC", assembly="hg19")
    assert g.n_samp == 3
    assert list(g.snp_id) == ["rs1", "rs2"]
    np.testing.assert_array_equal(g.genotype[0], [2, 1, 0])
    np.testing.assert_array_equal(g.genotype[1], [1, 3, 2])
    assert g.snp_allele[0] == "A/G"
    pz = str(tmp_path / "t.vcf.gz")
    _write_small_vcf(pz, gz=True)
    assert read_vcf(pz, import_chr="").n_snp == 3


@pytest.mark.parametrize("kind", ["vcf", "gzip", "bgzf"])
@pytest.mark.parametrize("import_chr", ["", "xMHC"])
def test_read_vcf_matches(tmp_path, kind, import_chr):
    """A cohort written as plain VCF, as gzip and as BGZF (the port's
    BgzfWriter) reads back equal to the cohort in both packages; the BGZF
    file is also plain gzip."""
    geno, chrom = _geno(5)
    plain = chip_smoke.write_geno_vcf(geno, str(tmp_path / "c.vcf"), chrom)
    path = plain
    if kind == "gzip":
        path = str(tmp_path / "c.vcf.gz")
        with gzip.open(path, "wb") as f:
            f.write(pathlib.Path(plain).read_bytes())
    elif kind == "bgzf":
        path = chip_smoke.write_geno_vcf(geno, str(tmp_path / "b.vcf.gz"),
                                         chrom)
        assert gzip.decompress(pathlib.Path(path).read_bytes()) == \
            pathlib.Path(plain).read_bytes()
    got = _both(lambda pkg: _mod(pkg, "io.vcf_in").read_vcf(
        path, import_chr=import_chr))
    _assert_same_geno(got, _expected(geno, chrom, import_chr))


@pytest.mark.parametrize("fault", ["no_header", "no_snps", "no_region"])
def test_read_vcf_errors_match(tmp_path, fault):
    p = str(tmp_path / "e.vcf")
    _write_small_vcf(p)
    lines = pathlib.Path(p).read_text().splitlines()
    kw = {"import_chr": ""}
    if fault == "no_header":
        lines = [lines[0]] + lines[2:]
    elif fault == "no_snps":
        lines = lines[:2] + [lines[4], lines[5]]
    else:
        kw = {"import_chr": "22"}
    pathlib.Path(p).write_text("\n".join(lines) + "\n")
    errs = []
    for pkg in PKGS:
        with pytest.raises(Exception) as e:
            _mod(pkg, "io.vcf_in").read_vcf(p, **kw)
        errs.append(type(e.value))
    assert errs[0] is errs[1] is ValueError


@pytest.mark.parametrize("pkg", PKGS)
def test_native_gt_parser(pkg):
    """tests/test_vcf_in.py::test_native_gt_parser_matches_python, for both
    packages."""
    native = _mod(pkg, "io.native")
    if native.get_lib() is None:
        pytest.skip("native lib not built")
    cells = ["0/0", "0|1", "1/1", "./.", ".", "0", "1", "./1", "0/.",
             "0/1:35:99", "1|1:2", ".:.", "0/0/0", "12/0", "0/12"]
    want = [2, 1, 0, 3, 3, 1, 0, 0, 1, 1, 0, 3, 2, 1, 1]
    got = native.vcf_gt_codes("\t".join(cells).encode(), 0, len(cells))
    assert got.tolist() == want
    cells2 = ["99:0/1", "12:1|1", "5:./."]
    got2 = native.vcf_gt_codes("\t".join(cells2).encode(), 1, len(cells2))
    assert got2.tolist() == [1, 0, 3]


def test_read_vcf_python_parser_matches(tmp_path, monkeypatch):
    """Without the native library the port's Python GT loop gives the
    native parser's codes."""
    geno, chrom = _geno(6)
    path = chip_smoke.write_geno_vcf(geno, str(tmp_path / "c.vcf"), chrom)
    vcf_in = _mod("hibag_tpu_torch", "io.vcf_in")
    native = _mod("hibag_tpu_torch", "io.native")
    want = vcf_in.read_vcf(path, import_chr="")
    monkeypatch.setattr(native, "get_lib", lambda: None)
    _assert_same_geno(vcf_in.read_vcf(path, import_chr=""), want)


# --- GDS --------------------------------------------------------------------

_G = _mod("hibag_tpu_torch", "io.gds")


def _lz4_frame(raw: bytes, bs: int = 65536) -> bytes:
    """An LZ4 frame of literals-only blocks (valid per the public block
    format)."""
    def block(b):
        head = bytearray([min(len(b), 15) << 4])
        if len(b) >= 15:
            rem = len(b) - 15
            while rem >= 255:
                head.append(255)
                rem -= 255
            head.append(rem)
        return bytes(head) + b

    out = bytearray(_G._LZ4F_MAGIC + bytes([(1 << 6) | 0x20, 0x70, 0x00]))
    for i in range(0, len(raw), bs):
        blk = block(raw[i:i + bs])
        out += len(blk).to_bytes(4, "little") + blk
    return bytes(out + (0).to_bytes(4, "little"))


def _encode(raw: bytes, coder: str) -> bytes:
    """A node payload under `coder` ("" raw, ZIP, LZMA, LZ4, or a *_ra
    random-access chain of 10,000-byte blocks behind a 4-byte prefix)."""
    enc = {"ZIP": zlib.compress, "LZ4": _lz4_frame,
           "LZMA": lambda b: lzma.compress(b, format=lzma.FORMAT_XZ)}
    if coder.endswith("_ra"):
        out = bytearray(b"\x10\x01\x00\x00")
        for i in range(0, len(raw), 10_000):
            blk = raw[i:i + 10_000]
            cb = enc[coder[:-3]](blk)
            out += len(cb).to_bytes(4, "little")
            out += len(blk).to_bytes(4, "little") + cb
        return bytes(out)
    return enc[coder](raw) if coder in enc else raw


def _entry(name: str, sid: int) -> bytes:
    """A folder entry: 26 bytes (length, the header stream id at 12) and
    the name behind the directory marker."""
    pre = bytearray(26)
    pre[12:16] = sid.to_bytes(4, "little")
    body = bytes(pre) + _G._DIR_MARKER + bytes([len(name)]) + name.encode()
    return len(body).to_bytes(6, "little") + body[6:]


def _header(coder: str, data_sid: int) -> bytes:
    rec = b"\x15" + _G._CODER_MARKER + bytes([len(coder)]) + coder.encode() \
        if coder else b""
    return b"\x00" * 8 + rec + _G._DATA_MARKER + data_sid.to_bytes(4, "little")


def _blocks(streams: dict, split_sid=None) -> bytes:
    """The block chain of {sid: payload}; `split_sid`'s payload goes into a
    head block of 1,000 bytes and a continuation block at the end."""
    out = bytearray(_G._MAGIC + b"\x00" * 6)
    tail = None
    for sid, content in streams.items():
        head = content[:1000] if sid == split_sid else content
        out += ((22 + len(head)) | _G._HEAD_BIT).to_bytes(6, "little")
        nxt = len(out)
        out += bytes(6) + sid.to_bytes(4, "little")
        out += len(content).to_bytes(6, "little") + head
        if sid == split_sid:
            tail = (nxt, content[1000:])
    if tail is not None:
        out[tail[0]:tail[0] + 6] = len(out).to_bytes(6, "little")
        out += (12 + len(tail[1])).to_bytes(6, "little") + bytes(6) + tail[1]
    return bytes(out)


def _strings(xs) -> bytes:
    return ("\x00".join(map(str, xs)) + "\x00").encode()


def _pack2(codes) -> bytes:
    flat = np.asarray(codes, dtype=np.uint8).reshape(-1)
    flat = np.concatenate([flat, np.zeros(-len(flat) % 4, np.uint8)])
    q = flat.reshape(-1, 4)
    return (q[:, 0] | q[:, 1] << 2 | q[:, 2] << 4 | q[:, 3] << 6).astype(
        np.uint8).tobytes()


def _gds(geno, chrom, coder="ZIP", fmt="SNP_ARRAY", split=False,
         folder_idx=None, drop=()):
    """A CoreArray file of `geno`: SNP_ARRAY (genotypes count the first
    allele of "A/B") or flat SEQ_ARRAY (alleles "B,A", calls as 2-bit allele
    indices per chromosome copy); with `folder_idx`, SEQ_ARRAY's genotypes
    go under a genotype/data + genotype/@data folder whose rows-per-variant
    index holds `folder_idx`."""
    P = geno.n_snp
    if fmt == "SNP_ARRAY":
        nodes = {
            "sample.id": _strings(geno.sample_id),
            "snp.id": _strings(geno.snp_id),
            "snp.position": geno.snp_position.astype("<i4").tobytes(),
            "snp.chromosome": np.asarray(chrom, dtype=int).astype(
                "<i4").tobytes(),
            "snp.allele": _strings(geno.snp_allele),
            "genotype": _pack2(geno.genotype),
        }
    else:
        g = geno.genotype
        hap = np.zeros(g.shape + (2,), np.uint8)
        hap[g == 1, 0] = 1
        hap[g == 2] = 1
        hap[g >= 3] = 3
        nodes = {
            "sample.id": _strings(geno.sample_id),
            "variant.id": _strings(geno.snp_id),
            "position": geno.snp_position.astype("<i4").tobytes(),
            "chromosome": _strings(chrom),
            "allele": _strings(",".join(reversed(a.split("/")))
                               for a in geno.snp_allele),
            "genotype": _pack2(hap),
        }
    streams, root, sid = {}, b"", 2
    geno_hdr = None
    for name, raw in nodes.items():
        if name in drop:
            continue
        streams[sid + 1] = _encode(raw, coder)
        streams[sid] = _header(coder, sid + 1)
        if name == "genotype" and folder_idx is not None:
            geno_hdr = sid
        else:
            root += _entry(name, sid)
        sid += 2
    if geno_hdr is not None:
        streams[sid + 1] = bytes([folder_idx]) * P
        streams[sid] = _header("", sid + 1)
        folder = _entry("data", geno_hdr) + _entry("@data", sid)
        streams[sid + 2] = len(folder).to_bytes(6, "little") + folder
        root += _entry("genotype", sid + 2)
    root += b"FileFormat\x0e" + bytes([len(fmt)]) + fmt.encode()
    streams = {1: len(root).to_bytes(6, "little") + root, **streams}
    split_sid = next((s for s in streams if streams[s] == _encode(
        nodes["genotype"], coder)), None) if split else None
    return _blocks(streams, split_sid)


def _gds_geno():
    geno, chrom = _geno(7, n_snp=60, n_samp=2001)
    return geno, chrom


@pytest.mark.parametrize("fmt", ["SNP_ARRAY", "SEQ_ARRAY"])
@pytest.mark.parametrize("coder", ["", "ZIP", "LZMA", "LZ4", "ZIP_ra",
                                   "LZMA_ra", "LZ4_ra"])
def test_read_gds_matches(tmp_path, coder, fmt):
    """Every codec in both formats: equal SNPGenoData in both packages, and
    the cohort itself (its xMHC part with the default region)."""
    geno, chrom = _gds_geno()
    p = tmp_path / "c.gds"
    p.write_bytes(_gds(geno, chrom, coder=coder, fmt=fmt))
    got = _both(lambda pkg: _mod(pkg, "io.gds").read_gds(str(p),
                                                         import_chr=""))
    if fmt == "SEQ_ARRAY":
        # snp.allele comes back as "ALT/REF": the allele the codes count
        assert list(got.snp_allele) == list(geno.snp_allele)
    _assert_same_geno(got, geno)
    mhc = _both(lambda pkg: _mod(pkg, "io.gds").read_gds(str(p)))
    _assert_same_geno(mhc, _expected(geno, chrom, "xMHC"))


@pytest.mark.parametrize("layout", ["continuation", "folder"])
def test_read_gds_layouts_match(tmp_path, layout):
    """A genotype stream split over a head and a continuation block; the
    SeqArray genotype/data + genotype/@data folder hierarchy."""
    geno, chrom = _gds_geno()
    p = tmp_path / "c.gds"
    if layout == "continuation":
        p.write_bytes(_gds(geno, chrom, split=True))
    else:
        p.write_bytes(_gds(geno, chrom, fmt="SEQ_ARRAY", folder_idx=1))
    got = _both(lambda pkg: _mod(pkg, "io.gds").read_gds(str(p),
                                                         import_chr=""))
    _assert_same_geno(got, geno)


@pytest.mark.parametrize("fault", [
    "magic", "codec", "format", "snp_nodes", "seq_nodes", "multirow"])
def test_read_gds_errors_match(tmp_path, fault):
    geno, chrom = _geno(8, n_snp=12, n_samp=9)
    data = {
        "magic": lambda: b"NOTCOREARRAY" + _gds(geno, chrom)[12:],
        "codec": lambda: _gds(geno, chrom, coder="XYZ"),
        "format": lambda: _gds(geno, chrom).replace(b"SNP_ARRAY",
                                                    b"ABC_ARRAY"),
        "snp_nodes": lambda: _gds(geno, chrom, drop=("snp.allele",)),
        "seq_nodes": lambda: _gds(geno, chrom).replace(b"SNP_ARRAY",
                                                       b"SEQ_ARRAY"),
        "multirow": lambda: _gds(geno, chrom, fmt="SEQ_ARRAY", folder_idx=2),
    }[fault]()
    p = tmp_path / "e.gds"
    p.write_bytes(data)
    errs = []
    for pkg in PKGS:
        with pytest.raises(Exception) as e:
            _mod(pkg, "io.gds").read_gds(str(p), import_chr="")
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1]
    assert errs[1][0] is (ValueError if fault == "magic"
                          else NotImplementedError)


@pytest.mark.parametrize("pkg", PKGS)
def test_lz4_block_format(pkg):
    """tests/test_gds.py::test_lz4_block_format, for both packages."""
    G = _mod(pkg, "io.gds")
    vec = bytes([0x43]) + b"abcd" + bytes([0x04, 0x00, 0x50]) + b"dabcd"
    assert G._lz4_block(vec) == b"abcdabcdabcdabcd"
    assert G._lz4_block(bytes([0x12]) + b"a" + bytes([0x01, 0x00])) == \
        b"a" * 7
    assert G._lz4_block(bytes([0x04, 0x08, 0x00]),
                        hist=b"abcdefgh") == b"abcdefgh"
    frame = bytearray(G._LZ4F_MAGIC + bytes([1 << 6, 0x70, 0x00]))
    for b in (bytes([0x80]) + b"abcdefgh", bytes([0x04, 0x08, 0x00])):
        frame += len(b).to_bytes(4, "little") + b
    frame += (0).to_bytes(4, "little")
    assert G._lz4f_decompress(bytes(frame), "t") == b"abcdefgh" * 2


@pytest.mark.parametrize("pkg", PKGS)
def test_parse_streams_cyclic_continuation_terminates(pkg):
    """tests/test_gds.py's cycle guard, for both packages."""
    G = _mod(pkg, "io.gds")
    cont_off = G._BLOCK_START + 22
    head = ((1 << 47) | 22).to_bytes(6, "little") \
        + cont_off.to_bytes(6, "little") + (7).to_bytes(4, "little") \
        + (8).to_bytes(6, "little")
    cont = (12).to_bytes(6, "little") + cont_off.to_bytes(6, "little")
    data = b"\x00" * G._BLOCK_START + head + cont
    assert G._parse_streams(data).get(7, b"") == b""


# --- BGZF -------------------------------------------------------------------

def test_bgzf_writers_byte_equal(tmp_path):
    """Both BgzfWriters write the same bytes (no time in a BGZF header):
    three data blocks and the EOF block, walkable by BSIZE + 1."""
    rng = np.random.default_rng(9)
    out = []
    for pkg in PKGS:
        bgzf = _mod(pkg, "io.bgzf")
        payload = rng.integers(32, 127, 2 * bgzf.MAX_BLOCK + 1234,
                               dtype=np.uint8).tobytes()
        rng = np.random.default_rng(9)
        p = str(tmp_path / f"{pkg}.gz")
        with bgzf.BgzfWriter(p) as f:
            f.write(payload)
        out.append(pathlib.Path(p).read_bytes())
    raw = out[1]
    assert out[0] == raw
    assert gzip.decompress(raw) == payload
    pos = blocks = 0
    while pos < len(raw):
        assert raw[pos:pos + 4] == b"\x1f\x8b\x08\x04"
        pos += struct.unpack("<H", raw[pos + 16:pos + 18])[0] + 1
        blocks += 1
    assert pos == len(raw) and blocks == 4
    assert raw.endswith(_mod("hibag_tpu_torch", "io.bgzf").EOF_BLOCK)


# --- R serialization ----------------------------------------------------------

def _prims(pkg):
    rdata = _mod(pkg, "io.rdata")
    return {
        "ints": np.arange(5, dtype=np.int64),
        "reals": np.array([1.5, np.nan, -2.0]),
        "strs": np.array(["a", None, "ccc"], dtype=object),
        "lgl": np.array([True, False, True]),
        "nested": {"x": 1, "y": "two", "z": [1.0, 2.0]},
        "nil": None,
        "scalar": 3.25,
        "m": np.arange(12, dtype=np.float64).reshape(3, 4),
        "df": rdata.r_dataframe({"a": np.array([1, 2], np.int64),
                                 "b": np.array(["u", "v"], dtype=object)}),
    }


def _payload(path):
    raw = pathlib.Path(path).read_bytes()
    return gzip.decompress(raw) if raw[:2] == b"\x1f\x8b" else raw


def _deep_eq(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _deep_eq(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _deep_eq(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        if a.dtype == object:
            assert a.shape == b.shape and list(a.ravel()) == list(b.ravel())
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), path


@pytest.mark.parametrize("compress", ["gzip", "none"])
def test_write_rdata_payloads_byte_equal(tmp_path, compress):
    """write_rdata and write_rds: the payloads are byte-equal (compared
    after decompression: gzip stamps the time), and each package reads the
    other's file to equal values."""
    files = {}
    for pkg in PKGS:
        rdata = _mod(pkg, "io.rdata")
        files[pkg] = (str(tmp_path / f"{pkg}.RData"),
                      str(tmp_path / f"{pkg}.rds"))
        rdata.write_rdata(files[pkg][0], _prims(pkg), compress=compress)
        rdata.write_rds(files[pkg][1], _prims(pkg), compress=compress)
    for k in (0, 1):
        assert _payload(files["hibag_tpu"][k]) == \
            _payload(files["hibag_tpu_torch"][k])
    for reader in PKGS:
        rdata = _mod(reader, "io.rdata")
        vals = [rdata.r_to_py(rdata.read_rds(files[w][1])) for w in PKGS]
        _deep_eq(vals[0], vals[1])
        back = {k: rdata.r_to_py(v)
                for k, v in rdata.read_rdata(files[PKGS[0]][0]).items()}
        assert list(back) == list(_prims(reader))
        assert back["m"].shape == (3, 4)
        assert list(back["strs"]) == ["a", None, "ccc"]


@pytest.mark.parametrize("codec", ["bz2", "xz", "raw"])
def test_read_rdata_codecs_match(tmp_path, codec):
    """.RData compressed with bzip2, xz or not at all reads to the same
    values in both packages."""
    import bz2
    src = str(tmp_path / "p.RData")
    _mod("hibag_tpu_torch", "io.rdata").write_rdata(
        src, _prims("hibag_tpu_torch"), compress="none")
    raw = pathlib.Path(src).read_bytes()
    enc = {"bz2": bz2.compress, "xz": lzma.compress, "raw": bytes}[codec]
    p = tmp_path / f"c.{codec}.RData"
    p.write_bytes(enc(raw))
    vals = []
    for pkg in PKGS:
        rdata = _mod(pkg, "io.rdata")
        vals.append({k: rdata.r_to_py(v)
                     for k, v in rdata.read_rdata(str(p)).items()})
    _deep_eq(vals[0], vals[1])


@pytest.mark.parametrize("fault", ["workspace", "format"])
def test_read_rdata_errors_match(tmp_path, fault):
    p = tmp_path / "e.RData"
    src = str(tmp_path / "ok.RData")
    _mod("hibag_tpu_torch", "io.rdata").write_rdata(src, {"x": 1},
                                                    compress="none")
    raw = pathlib.Path(src).read_bytes()
    p.write_bytes(b"XY" + raw[2:] if fault == "workspace"
                  else raw.replace(b"RDX2\nX\n", b"RDX2\nA\n"))
    errs = []
    for pkg in PKGS:
        with pytest.raises(Exception) as e:
            _mod(pkg, "io.rdata").read_rdata(str(p))
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1] and errs[1][0] is ValueError


@pytest.fixture(scope="module")
def small_model(tmp_path_factory):
    """A seeded synthetic model (12 classifiers, 200 SNPs, 10 alleles),
    saved as .npz and loaded in each package."""
    model, pool = synthetic_model(3, n_classifiers=12, n_snp=200,
                                  n_alleles=10)
    model.matching = np.linspace(0.1, 1.0, 7)
    path = str(tmp_path_factory.mktemp("m") / "m.npz")
    model.save(path)
    return {pkg: _mod(pkg, "models.model").AttrBagModel.load(path)
            for pkg in PKGS}, pool


def _assert_same_model(a, b):
    assert a.locus == b.locus and a.n_classifiers == b.n_classifiers
    assert list(a.hla_alleles) == list(b.hla_alleles)
    for f in ("snp_id", "snp_allele"):
        assert list(getattr(a, f)) == list(getattr(b, f))
    np.testing.assert_array_equal(a.snp_position, b.snp_position)
    for c1, c2 in zip(a.classifiers, b.classifiers):
        for f in ("snp_index", "hap_bits", "hap_freq", "hap_allele"):
            np.testing.assert_array_equal(getattr(c1, f), getattr(c2, f))
        np.testing.assert_equal(c1.oob_accuracy, c2.oob_accuracy)


@pytest.mark.parametrize("what", ["model", "modellist"])
def test_save_rdata_payloads_byte_equal(tmp_path, small_model, what):
    """save_rdata (model_to_robj + write_rdata) of one model and of a
    {locus: model} list: byte-equal payloads; the port's file reads back to
    the model exactly (hlaModelFromObj), with the hlaAttrBagObj class."""
    models, _ = small_model
    paths = {}
    for pkg in PKGS:
        arg = models[pkg] if what == "model" else {"A": models[pkg]}
        paths[pkg] = str(tmp_path / f"{pkg}.RData")
        _mod(pkg, "models.publish").save_rdata(arg, paths[pkg])
    assert _payload(paths["hibag_tpu"]) == _payload(paths["hibag_tpu_torch"])
    rdata = _mod("hibag_tpu_torch", "io.rdata")
    objs = rdata.read_rdata(paths["hibag_tpu_torch"])
    robj = objs["mobj"] if what == "model" else objs["modellist"].data[0]
    assert robj.rclass == ["hlaAttrBagObj"]
    d = rdata.r_to_py(objs["mobj"] if what == "model" else objs["modellist"])
    back = hibag_tpu_torch.hlaModelFromObj(d if what == "model" else d["A"],
                                           locus="A")
    _assert_same_model(back, models["hibag_tpu_torch"])
    np.testing.assert_array_equal((d if what == "model" else d["A"])[
        "matching"], models["hibag_tpu_torch"].matching)


def test_model_to_robj_matches(small_model):
    models, _ = small_model
    vals = [_mod(pkg, "io.rdata").r_to_py(
        _mod(pkg, "models.publish").model_to_robj(models[pkg]))
        for pkg in PKGS]
    _deep_eq(vals[0], vals[1])
    assert hibag_tpu_torch.hlaModelToObj(models["hibag_tpu_torch"]).keys() \
        == hibag_tpu.hlaModelToObj(models["hibag_tpu"]).keys()


# --- VCF out ----------------------------------------------------------------

def _no_date(text):
    return [ln for ln in text.splitlines() if not ln.startswith("##fileDate")]


@pytest.mark.parametrize("opts", [{}, {"prob_cutoff": 0.6},
                                  {"ds": False, "allele_list": True}])
@pytest.mark.parametrize("gz", [False, True])
def test_write_vcf_matches(tmp_path, small_model, opts, gz):
    """write_vcf of one prediction (the port's predict on the CPU) and of it
    with an HLA table: equal text in both packages without the date line;
    `.vcf.gz` is BGZF, read by gzip."""
    models, pool = small_model
    model = models["hibag_tpu_torch"]
    geno, t1, t2 = synthetic_cohort(model, pool, 21, 4)
    res = hibag_tpu_torch.predict(model, geno, device="cpu")
    table = hibag_tpu_torch.HLATypeTable.from_alleles(
        geno.sample_id, t1, t2, locus="B")
    text = []
    for pkg in PKGS:
        p = str(tmp_path / (pkg + (".vcf.gz" if gz else ".vcf")))
        _mod(pkg, "io.vcf").write_vcf([res, table], p, **opts)
        raw = pathlib.Path(p).read_bytes()
        if gz:
            assert raw[:4] == b"\x1f\x8b\x08\x04"
            assert raw.endswith(_mod(pkg, "io.bgzf").EOF_BLOCK)
        text.append(_no_date(_payload(p).decode()))
    assert text[0] == text[1]
    body = [ln for ln in text[1] if not ln.startswith("#")]
    assert len(body) >= model.n_alleles // 2
    assert any(ln.split("\t")[2].startswith("HLA-B*") for ln in body)


# --- genotype helpers -------------------------------------------------------

def _flipped(geno, seed):
    """geno with a third of its SNPs coded on the other allele order, a
    third on the other strand and both; its samples renamed."""
    rng = np.random.default_rng(seed)
    g = geno.genotype.copy()
    alleles = geno.snp_allele.copy()
    comp = str.maketrans("ACGT", "TGCA")
    for i in range(geno.n_snp):
        a, b = alleles[i].split("/")
        r = rng.integers(0, 3)
        if r >= 1:
            a, b = b, a
            g[i] = np.where(g[i] <= 2, 2 - g[i], 3)
        if r == 2:
            a, b = a.translate(comp), b.translate(comp)
        alleles[i] = f"{a}/{b}"
    return hibag_tpu_torch.SNPGenoData(
        genotype=g, sample_id=np.array([f"t{s}" for s in geno.sample_id],
                                       dtype=object),
        snp_id=geno.snp_id, snp_position=geno.snp_position,
        snp_allele=alleles, assembly=geno.assembly)


def _as(pkg, g):
    return _mod(pkg, "data.geno").SNPGenoData(
        genotype=g.genotype, sample_id=g.sample_id, snp_id=g.snp_id,
        snp_position=g.snp_position, snp_allele=g.snp_allele,
        assembly=g.assembly)


@pytest.mark.parametrize("match_type", ["Position", "RefSNP+Position"])
def test_switch_strand_and_combine_match(match_type):
    """switch_strand onto a genotype template and onto a model, and
    combine_geno: equal in both packages; switching a recoded copy back
    gives the original codes."""
    geno, _ = _geno(10, n_snp=30, n_samp=12)
    other = _flipped(geno, 11).subset(snp_mask=np.arange(3, 30))
    sw = _both(lambda pkg: _mod(pkg, "data.geno").switch_strand(
        _as(pkg, other), _as(pkg, geno), match_type=match_type))
    np.testing.assert_array_equal(sw.genotype, geno.genotype[3:30])
    cmb = _both(lambda pkg: _mod(pkg, "data.geno").combine_geno(
        _as(pkg, geno), _as(pkg, other), match_type=match_type))
    assert cmb.n_samp == 24 and cmb.n_snp == 27
    model, _ = synthetic_model(5, n_classifiers=3, n_snp=30, n_alleles=4,
                               snp_range=(5, 20))
    tmpl = {pkg: _mod(pkg, "models.model").AttrBagModel.from_hibag_obj(
        model.to_hibag_obj(), locus="A") for pkg in PKGS}
    target = _flipped(hibag_tpu_torch.SNPGenoData(
        genotype=geno.genotype, sample_id=geno.sample_id,
        snp_id=model.snp_id, snp_position=model.snp_position,
        snp_allele=model.snp_allele, assembly="hg19"), 12)
    _both(lambda pkg: _mod(pkg, "data.geno").switch_strand(
        _as(pkg, target), tmpl[pkg], match_type=match_type))
    for pkg in PKGS:
        with pytest.raises(ValueError):
            _mod(pkg, "data.geno").combine_geno(_as(pkg, geno),
                                                _as(pkg, geno))


def test_alias_surface_matches():
    """Every hla* name of hibag_tpu exists in the port (hlaConvSequence,
    the last, came with seq/aa.py); the genotype helpers agree."""
    names = [n for n in dir(hibag_tpu) if n.startswith("hla")]
    missing = [n for n in names if not hasattr(hibag_tpu_torch, n)]
    assert missing == []
    geno, _ = _geno(13)
    jg = _as("hibag_tpu", geno)
    for fn in ("hlaGenoAFreq", "hlaGenoMFreq", "hlaGenoMRate",
               "hlaGenoMRate_Samp", "hlaSNPID"):
        np.testing.assert_array_equal(getattr(hibag_tpu_torch, fn)(geno),
                                      getattr(hibag_tpu, fn)(jg))
    _assert_same_geno(
        hibag_tpu_torch.hlaGenoSubsetFlank(geno, "A"),
        hibag_tpu.hlaGenoSubsetFlank(jg, "A"))
    made = hibag_tpu_torch.hlaMakeSNPGeno(
        geno.genotype, geno.sample_id, geno.snp_id, geno.snp_position,
        [a.split("/")[0] for a in geno.snp_allele],
        [a.split("/")[1] for a in geno.snp_allele], assembly="hg19")
    _assert_same_geno(made, geno)
    assert hibag_tpu_torch.hlaClose(None) is None
    want = ({"target": "max", "backend": "cuda",
             "device": torch.cuda.get_device_name()}
            if torch.cuda.is_available() else
            {"target": "max", "backend": "cpu", "device": "cpu"})
    assert hibag_tpu_torch.hlaSetKernelTarget() == want
