"""GDS (CoreArray) import for SNPRelate "SNP_ARRAY" files.

Equivalent of hlaGDS2Geno (reference R/DataUtilities.R:787) for SNPRelate
SNP_ARRAY GDS files with the standard node set (sample.id, snp.id,
snp.position, snp.chromosome, snp.allele, genotype).

The CoreArray container is parsed at the block-graph level (reverse-
engineered from SNPRelate-written files; the reference links the gdsfmt C++
library instead):

- After the 12-byte "COREARRAYx0A" magic and a 6-byte version prefix, the
  file is a chain of blocks. Each block head is a 6-byte little-endian word
  whose low 46 bits are the block's total length (header included) and
  whose bit 47 marks a stream head, followed by a 6-byte next-block file
  offset (0 = none). Stream-head blocks carry 10 more bytes: a u32 stream
  ID and a 48-bit total stream size (continuation blocks chained through
  the next pointer carry only the 12-byte header).
- Stream 1 is the root folder: length-prefixed entries whose name follows
  the 4-byte marker 44 C6 60 10 and whose node-header stream ID sits 14
  bytes before it, plus the FileFormat attribute.
- Each node-header stream is a record list: the codec name ("ZIP", "LZMA",
  ...) follows marker C4 46 6D 10 (absent for uncompressed storage) and the
  data-stream ID follows marker C4 C3 7C 0C. Array dims follow C3 43 61.
- Data streams hold the node payload: a raw zlib stream for "ZIP", a raw
  xz container for "LZMA", or the uncompressed bytes when no codec record
  is present.

Genotypes are 2-bit packed SNP-major with 0/1/2 = count of the FIRST
allele of snp.allele "A/B" and 3 = missing — verified genotype-for-
genotype against the PLINK copy of the same cohort (tests/test_gds.py:
100% agreement on ~50k calls).

Codecs: ZIP (zlib), LZMA (xz), LZ4 (pure-Python frame + block decoder,
_lz4f_decompress — xxHash checksums skipped), uncompressed, and the
random-access block variants ZIP_RA / LZMA_RA / LZ4_RA (independently
compressed blocks with [compressed size, raw size] headers —
structure-validated, falling back to the conversion-guidance error on
mismatch) are supported. SeqArray
("SEQ_ARRAY") files import with the reference's dosage rules
(_read_seq_array) in both the flat node layout and the genotype/data +
genotype/@data folder hierarchy real SeqArray files write (folders reuse
the root-folder grammar and are walked recursively by _list_nodes); unknown
codecs and multi-row (>3 ALT) genotype encodings raise with conversion
guidance (GDS→BED via SNPRelate, or GDS→VCF).

The port's copy of hibag_tpu/io/gds.py, so that the port imports nothing
of that package.
"""

from __future__ import annotations

import lzma
import zlib

import numpy as np

from ..constants import GENO_MISSING
from ..data.geno import SNPGenoData

_MAGIC = b"COREARRAYx0A"
_EXPECTED = ("sample.id", "snp.id", "snp.position", "snp.chromosome",
             "snp.allele", "genotype")

_BLOCK_START = 18            # magic (12) + version prefix (6)
_HEAD_BIT = 1 << 47
_SIZE_MASK = (1 << 46) - 1
_DIR_MARKER = b"\x44\xc6\x60\x10"    # precedes a directory entry name
_CODER_MARKER = b"\xc4\x46\x6d\x10"  # precedes the codec name record
_DATA_MARKER = b"\xc4\xc3\x7c\x0c"   # precedes the data-stream ID


def _u(b: bytes) -> int:
    return int.from_bytes(b, "little")


def _parse_streams(data: bytes) -> dict:
    """Walk the block chain and reassemble {stream id: payload bytes}."""
    n = len(data)
    blocks = {}       # offset -> (size, next, sid, total, content_start)
    pos = _BLOCK_START
    while pos + 12 <= n:
        word = _u(data[pos:pos + 6])
        size = word & _SIZE_MASK
        if size < 12 or pos + size > n:
            break
        nxt = _u(data[pos + 6:pos + 12])
        if (word & _HEAD_BIT) and size >= 22:
            sid = _u(data[pos + 12:pos + 16])
            total = _u(data[pos + 16:pos + 22])
            blocks[pos] = (size, nxt, sid, total, pos + 22)
        else:
            blocks[pos] = (size, nxt, None, None, pos + 12)
        pos += size

    streams = {}
    for off, (size, nxt, sid, total, cstart) in blocks.items():
        if sid is None:
            continue
        chunks = [data[cstart:off + size]]
        got = len(chunks[0])
        seen = {off}                  # cycle guard: corrupted/crafted next
        while got < total and nxt in blocks and nxt not in seen:
            seen.add(nxt)
            bsize, bnxt, bsid, _, bstart = blocks[nxt]
            if bsid is not None:      # head blocks never continue a chain
                break
            chunk = data[bstart:nxt + bsize]
            chunks.append(chunk)
            got += len(chunk)
            nxt = bnxt
        streams[sid] = b"".join(chunks)[:total]
    return streams


def _dir_entries(root: bytes, streams: dict | None = None) -> list:
    """(name, node-header stream id) pairs from the root folder stream.

    The stream id is read from a fixed offset before the name marker, which
    is layout-dependent; when ``streams`` is given, entries whose id does
    not resolve to a parsed stream containing the data/codec markers are
    dropped so callers fall through to the conversion-guidance error rather
    than misreading an unfamiliar record layout."""
    entries = []
    pos = 0
    while True:
        i = root.find(_DIR_MARKER, pos)
        if i < 0:
            break
        ln = root[i + 4]
        name = root[i + 5:i + 5 + ln]
        pos = i + 5 + ln
        if i < 14:
            continue
        sid = _u(root[i - 14:i - 10])
        if streams is not None:
            hdr = streams.get(sid)
            if hdr is None or (_DATA_MARKER not in hdr
                               and _CODER_MARKER not in hdr):
                continue
        try:
            entries.append((name.decode("ascii"), sid))
        except UnicodeDecodeError:
            pass
    return entries


def _list_nodes(root: bytes, streams: dict, prefix: str = "",
                _seen: frozenset = frozenset()) -> dict:
    """Recursive {path: node-header stream id} map over the folder tree.

    A directory entry whose header stream carries the data/codec markers is
    an array node; one whose header stream carries directory-entry markers
    is a sub-folder (CoreArray folders reuse the root-folder grammar) and
    is walked recursively with a ``parent/`` path prefix — real SeqArray
    files store genotypes under such a folder (``genotype/data`` +
    ``genotype/@data``). Unrecognisable entries are dropped so callers fall
    through to the conversion-guidance error instead of misparsing."""
    nodes = {}
    for name, sid in _dir_entries(root):
        if sid in _seen:
            continue                    # cycle guard
        hdr = streams.get(sid)
        if hdr is None:
            continue
        if _DATA_MARKER in hdr or _CODER_MARKER in hdr:
            nodes[prefix + name] = sid
        elif _DIR_MARKER in hdr:
            nodes.update(_list_nodes(hdr, streams, prefix + name + "/",
                                     _seen | {sid}))
    return nodes


def _file_format(root: bytes) -> str:
    """The FileFormat attribute stored on the root folder."""
    # layout: "FileFormat" [type tag 0x0e] [len u8] [chars]; scan past
    # stray matches (e.g. inside string data) missing the type tag
    pos = 0
    while True:
        i = root.find(b"FileFormat", pos)
        if i < 0:
            return ""
        if i + 12 <= len(root) and root[i + 10] == 0x0E:
            ln = root[i + 11]
            return root[i + 12:i + 12 + ln].decode("ascii", "replace")
        pos = i + 10


def _node_info(hdr: bytes):
    """(codec name, data stream id) from a node-header stream."""
    coder = ""
    i = hdr.find(_CODER_MARKER)
    if i >= 0:
        ln = hdr[i + 4]
        coder = hdr[i + 5:i + 5 + ln].decode("ascii", "replace")
    j = hdr.find(_DATA_MARKER)
    data_sid = _u(hdr[j + 4:j + 8]) if j >= 0 else None
    return coder, data_sid


def _lz4_block(src: bytes, hist: bytes = b"") -> bytes:
    """Decompress one raw LZ4 block (the public LZ4 block format: token,
    extended literal/match lengths, 16-bit little-endian match offsets,
    4-byte minimum match). ``hist`` seeds the window for block-dependent
    frames; only bytes produced by THIS block are returned."""
    out = bytearray(hist)
    base = len(out)
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        ll = token >> 4
        if ll == 15:
            while True:
                b = src[i]
                i += 1
                ll += b
                if b != 255:
                    break
        out += src[i:i + ll]
        i += ll
        if i >= n:
            break                       # final sequence: literals only
        off = src[i] | (src[i + 1] << 8)
        i += 2
        ml = token & 15
        if ml == 15:
            while True:
                b = src[i]
                i += 1
                ml += b
                if b != 255:
                    break
        ml += 4
        pos = len(out) - off
        if off == 0 or pos < 0:
            raise ValueError("corrupt LZ4 block (bad match offset)")
        while ml > 0:                   # overlap-safe chunked copy
            avail = min(ml, len(out) - pos)
            out += out[pos:pos + avail]
            pos += avail
            ml -= avail
    return bytes(out[base:])


_LZ4F_MAGIC = b"\x04\x22\x4d\x18"


def _lz4f_decompress(payload: bytes, name: str) -> bytes:
    """Decompress an LZ4 frame (public frame format v1: FLG/BD descriptor,
    u32-length-prefixed blocks with a high-bit uncompressed flag, 0
    end-mark). Block-dependent frames thread a 64 KiB history window;
    xxHash32 header/content checksums are skipped, not verified."""
    if len(payload) < 7 or payload[:4] != _LZ4F_MAGIC:
        raise NotImplementedError(
            f"GDS node {name!r}: LZ4 payload lacks the frame magic — "
            "convert to VCF/BED first (in R: SNPRelate::snpgdsGDS2BED).")
    flg = payload[4]
    if flg >> 6 != 1:
        raise NotImplementedError(
            f"GDS node {name!r}: unsupported LZ4 frame version {flg >> 6}")
    b_indep = (flg >> 5) & 1
    b_checksum = (flg >> 4) & 1
    pos = 6                             # magic + FLG + BD
    if (flg >> 3) & 1:
        pos += 8                        # content size
    if flg & 1:
        pos += 4                        # dictionary id
    pos += 1                            # header checksum byte
    out = bytearray()
    while pos + 4 <= len(payload):
        word = _u(payload[pos:pos + 4])
        pos += 4
        if word == 0:
            break                       # end mark
        stored = word & 0x7FFFFFFF
        blob = payload[pos:pos + stored]
        if len(blob) != stored:
            raise ValueError(f"truncated LZ4 frame in GDS node {name!r}")
        pos += stored
        if b_checksum:
            pos += 4
        if word >> 31:
            out += blob                 # stored uncompressed
        else:
            out += _lz4_block(blob, b"" if b_indep else bytes(out[-65536:]))
    return bytes(out)


#: maximum sane raw block size for RA streams (CoreArray caps blocks at 8M)
_RA_MAX_RAW = 16 * 1024 * 1024


def _decode_ra(payload: bytes, name: str, dec) -> bytes:
    """Random-access (block-compressed) stream: a chain of independently
    compressed blocks, each prefixed by an 8-byte header
    [u32le compressed size][u32le raw size].

    The per-block layout is a reconstruction (no gdsfmt is available in
    this environment to produce an authoritative RA fixture): an optional
    stream prefix of up to 16 bytes is skipped by scanning for the first
    offset at which the WHOLE chain validates — every block must
    decompress to exactly its declared raw size and the headers must
    chain exactly to the end of the stream. Files that do not match fall
    through to the conversion-guidance error rather than misparsing
    (tests/test_gds.py exercises multi-block reassembly on transcoded
    fixtures)."""
    def try_chain(off: int):
        parts = []
        pos = off
        n = len(payload)
        while pos < n:
            if pos + 8 > n:
                return None
            csize = _u(payload[pos:pos + 4])
            rsize = _u(payload[pos + 4:pos + 8])
            if not (0 < csize <= n - pos - 8) or not (0 < rsize <= _RA_MAX_RAW):
                return None
            blob = payload[pos + 8:pos + 8 + csize]
            try:
                raw = dec(blob)
            except Exception:
                return None
            if len(raw) != rsize:
                return None
            parts.append(raw)
            pos += 8 + csize
        return b"".join(parts) if pos == n and parts else None

    for off in range(0, 17):
        out = try_chain(off)
        if out is not None:
            return out
    raise NotImplementedError(
        f"GDS node {name!r}: random-access block stream did not match the "
        "supported layout — convert to VCF/BED first "
        "(in R: SNPRelate::snpgdsGDS2BED).")


def _decode_payload(payload: bytes, coder: str, name: str) -> bytes:
    if coder == "":
        return payload
    if coder == "ZIP":
        dec = zlib.decompressobj()
        return dec.decompress(payload)
    if coder == "LZMA":
        dec = lzma.LZMADecompressor(format=lzma.FORMAT_XZ)
        return dec.decompress(payload)
    cu = coder.upper()
    if cu.startswith("ZIP_RA"):
        return _decode_ra(payload, name,
                          lambda b: zlib.decompressobj().decompress(b))
    if cu.startswith("LZMA_RA"):
        return _decode_ra(payload, name, lambda b: lzma.LZMADecompressor(
            format=lzma.FORMAT_XZ).decompress(b))
    if cu.startswith("LZ4_RA"):
        return _decode_ra(payload, name,
                          lambda b: _lz4f_decompress(b, name))
    if cu.startswith("LZ4"):            # incl. LZ4.fast/.hc level suffixes
        return _lz4f_decompress(payload, name)
    raise NotImplementedError(
        f"GDS node {name!r} uses the {coder!r} codec; only ZIP, ZIP_RA, "
        "LZMA, LZMA_RA, LZ4, LZ4_RA and uncompressed storage are "
        "supported — convert to VCF/BED first "
        "(in R: SNPRelate::snpgdsGDS2BED).")


def _read_nodes(streams: dict, entries: dict, names) -> dict:
    by_name = {}
    for name in names:
        hdr = streams.get(entries[name])
        if hdr is None:
            raise ValueError(f"GDS node {name!r} has no header stream")
        coder, data_sid = _node_info(hdr)
        if data_sid is None or data_sid not in streams:
            raise ValueError(f"GDS node {name!r} has no data stream")
        by_name[name] = _decode_payload(streams[data_sid], coder, name)
    return by_name


_SEQ_EXPECTED = ("sample.id", "variant.id", "position", "chromosome",
                 "allele", "genotype")


def _read_seq_array(streams: dict, root: bytes, import_chr: str,
                    assembly: str) -> SNPGenoData:
    """SeqArray "SEQ_ARRAY" import (reference hlaGDS2Geno SeqArray branch,
    R/DataUtilities.R:860-912).

    Node semantics follow the reference exactly: `allele` holds
    comma-separated "REF,ALT[,...]" strings and the imported snp.allele is
    "ALT/REF"; the genotype code counts copies of the FIRST alternative
    allele ((x[1]==1) + (x[2]==1)), with any missing haplotype making the
    call missing. The genotype node is 2-bit packed allele indices,
    ploidy-major within sample within variant, index 3 = missing.

    Both layouts are read: a flat ``genotype`` array node, or the folder
    hierarchy real SeqArray files write — ``genotype/data`` holding the
    packed calls with a ``genotype/@data`` rows-per-variant index (all-ones
    for biallelic data; multi-row variants, i.e. >3 ALT alleles, raise with
    conversion guidance)."""
    from .bed import select_region

    nodes = _list_nodes(root, streams)
    geno_key = ("genotype" if "genotype" in nodes
                else "genotype/data" if "genotype/data" in nodes else None)
    flat = [n for n in _SEQ_EXPECTED if n != "genotype"]
    missing = [n for n in flat if n not in nodes]
    if geno_key is None:
        missing.append("genotype (or genotype/data)")
    if missing:
        raise NotImplementedError(
            f"SEQ_ARRAY GDS lacks nodes {missing} (found "
            f"{sorted(nodes)}) — convert to VCF first (in R: "
            "SeqArray::seqGDS2VCF).")
    by_name = _read_nodes(streams, nodes, flat + [geno_key])
    by_name["genotype"] = by_name[geno_key]

    sample_id = by_name["sample.id"].decode().rstrip("\x00").split("\x00")
    variant_id = by_name["variant.id"].decode().rstrip("\x00").split("\x00")
    position = np.frombuffer(by_name["position"], dtype="<i4")
    n_samp, n_var = len(sample_id), len(variant_id)
    if geno_key == "genotype/data" and "genotype/@data" in nodes:
        raw = _read_nodes(
            streams, nodes, ["genotype/@data"])["genotype/@data"]
        # the rows-per-variant index may be stored at any integer width;
        # infer it from the payload size (fail safe on anything else —
        # never skip the multi-row check or misread interleaved bytes)
        width = len(raw) // n_var if n_var and len(raw) % n_var == 0 else 0
        if width not in (1, 2, 4, 8):
            raise NotImplementedError(
                f"SEQ_ARRAY genotype/@data index has unexpected size "
                f"{len(raw)} for {n_var} variants — convert to VCF first "
                "(in R: SeqArray::seqGDS2VCF).")
        idx = np.frombuffer(raw, dtype=f"<u{width}")
        if not bool((idx[:n_var] == 1).all()):
            raise NotImplementedError(
                "SEQ_ARRAY genotype/@data has multi-row variants (more "
                "than 3 alternative alleles) — convert to VCF first "
                "(in R: SeqArray::seqGDS2VCF).")
    chrom_raw = by_name["chromosome"]
    if len(chrom_raw) == 4 * n_var:
        chrom = np.frombuffer(chrom_raw, dtype="<i4").astype(str)
    else:
        chrom = np.asarray(chrom_raw.decode().rstrip("\x00").split("\x00"))
    alleles = by_name["allele"].decode().rstrip("\x00").split("\x00")
    if not (len(position) == len(chrom) == len(alleles) == n_var):
        raise ValueError("inconsistent variant annotation lengths in "
                         "SEQ_ARRAY GDS file")
    ref = [a.split(",")[0] if a else "0" for a in alleles]
    alt = [a.split(",")[1] if "," in a else "0" for a in alleles]
    out_allele = [f"{b}/{a}" for a, b in zip(ref, alt)]

    gb = np.frombuffer(by_name["genotype"], dtype=np.uint8)
    idx = np.stack([(gb >> (2 * k)) & 3 for k in range(4)],
                   axis=1).reshape(-1)
    need = n_var * n_samp * 2
    if len(idx) < need:
        raise ValueError("genotype payload shorter than 2*n_var*n_samp")
    hap = idx[:need].reshape(n_var, n_samp, 2)
    miss = (hap == 3).any(axis=2)
    geno = (hap == 1).sum(axis=2).astype(np.uint8)
    geno[miss] = GENO_MISSING

    keep = select_region(chrom.astype(object), position.astype(np.int64),
                         import_chr, assembly)
    if keep.sum() == 0:
        raise ValueError("no variants in the requested region")
    return SNPGenoData(
        genotype=geno[keep],
        sample_id=np.asarray(sample_id, dtype=object),
        snp_id=np.asarray(variant_id, dtype=object)[keep],
        snp_position=position.astype(np.int64)[keep],
        snp_allele=np.asarray(out_allele, dtype=object)[keep],
        assembly=assembly)


def read_gds(path: str, import_chr: str = "xMHC",
             assembly: str = "hg19") -> SNPGenoData:
    """Read a SNPRelate SNP_ARRAY GDS file into SNPGenoData."""
    from .bed import select_region

    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_MAGIC):
        raise ValueError(f"not a CoreArray GDS file: {path}")
    streams = _parse_streams(data)
    if 1 not in streams:
        raise ValueError(f"no root folder stream in GDS file: {path}")
    root = streams[1]
    fmt = _file_format(root)
    if fmt == "SEQ_ARRAY":
        return _read_seq_array(streams, root, import_chr, assembly)
    if fmt and fmt != "SNP_ARRAY":
        raise NotImplementedError(
            f"GDS FileFormat {fmt!r} is not supported (only SNP_ARRAY and "
            "SEQ_ARRAY); convert with SeqArray/SNPRelate to VCF or PLINK "
            "BED first.")
    entries = dict(_dir_entries(root, streams))
    missing = [n for n in _EXPECTED if n not in entries]
    if missing:
        raise NotImplementedError(
            f"GDS file lacks expected SNP_ARRAY nodes {missing} "
            f"(found {sorted(entries)}); convert to VCF/BED first.")

    by_name = _read_nodes(streams, entries, _EXPECTED)

    sample_id = by_name["sample.id"].decode().rstrip("\x00").split("\x00")
    snp_id = by_name["snp.id"].decode().rstrip("\x00").split("\x00")
    position = np.frombuffer(by_name["snp.position"], dtype="<i4")
    chrom = np.frombuffer(by_name["snp.chromosome"], dtype="<i4")
    allele = by_name["snp.allele"].decode().rstrip("\x00").split("\x00")
    gb = np.frombuffer(by_name["genotype"], dtype=np.uint8)

    n_samp, n_snp = len(sample_id), len(snp_id)
    if not (len(position) == len(chrom) == len(allele) == n_snp):
        raise ValueError("inconsistent SNP annotation lengths in GDS file")
    codes = np.stack([(gb >> (2 * k)) & 3 for k in range(4)],
                     axis=1).reshape(-1)
    if len(codes) < n_snp * n_samp:
        raise ValueError("genotype payload shorter than n_snp * n_samp")
    geno = codes[:n_snp * n_samp].reshape(n_snp, n_samp).astype(np.uint8)
    geno[geno == 3] = GENO_MISSING

    keep = select_region(chrom.astype(str).astype(object),
                         position.astype(np.int64), import_chr, assembly)
    if keep.sum() == 0:
        raise ValueError("no SNPs in the requested region")
    return SNPGenoData(
        genotype=geno[keep],
        sample_id=np.asarray(sample_id, dtype=object),
        snp_id=np.asarray(snp_id, dtype=object)[keep],
        snp_position=position.astype(np.int64)[keep],
        snp_allele=np.asarray(allele, dtype=object)[keep],
        assembly=assembly)
