"""BGZF (blocked gzip) writer — tabix/pysam-compatible `.vcf.gz` output.

The reference writes true BGZF through Rsamtools' bgzip connection
(reference src/samtools_ext.c:1-97); this is the dependency-free equivalent:
a stream of independent gzip members, each carrying the BC extra field with
the compressed block size, terminated by the fixed 28-byte EOF block. Every
BGZF file is also a valid multi-member gzip file, so plain `gzip` readers
work unchanged.

The port's copy of hibag_tpu/io/bgzf.py, so that the port imports nothing
of that package.
"""

from __future__ import annotations

import struct
import zlib

#: maximum uncompressed payload per block (samtools uses 64 KiB minus
#: overhead so BSIZE-1 always fits in uint16)
MAX_BLOCK = 65280

#: the fixed empty final block marking BGZF EOF (SAM spec section 4.1.2)
EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _compress_block(data: bytes, level: int = 6) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    payload = co.compress(data) + co.flush()
    # BSIZE stores (total block size - 1): header(18) + payload + crc/isize(8)
    bsize = len(payload) + 18 + 8 - 1
    if bsize >= 65536:
        raise ValueError("BGZF block overflow (incompressible payload)")
    header = struct.pack(
        "<4BI2BH2B2H",
        0x1F, 0x8B, 8, 4,       # magic, deflate, FEXTRA
        0,                       # mtime
        0, 0xFF,                 # XFL, OS=unknown
        6,                       # XLEN
        66, 67,                  # 'B','C'
        2,                       # SLEN
        bsize)                   # BSIZE field = total block size - 1
    return (header + payload
            + struct.pack("<2I", zlib.crc32(data) & 0xFFFFFFFF,
                          len(data) & 0xFFFFFFFF))


class BgzfWriter:
    """Minimal file-like BGZF writer (binary or text via `mode="wt"`)."""

    def __init__(self, path: str, mode: str = "wb", level: int = 6):
        self._fh = open(path, "wb")
        self._text = "t" in mode
        self._buf = bytearray()
        self._level = level
        self._closed = False

    def write(self, data) -> int:
        if self._text and isinstance(data, str):
            data = data.encode()
        self._buf += data
        while len(self._buf) >= MAX_BLOCK:
            chunk = bytes(self._buf[:MAX_BLOCK])
            del self._buf[:MAX_BLOCK]
            self._fh.write(_compress_block(chunk, self._level))
        return len(data)

    def flush(self) -> None:
        if self._buf:
            self._fh.write(_compress_block(bytes(self._buf), self._level))
            self._buf.clear()
        self._fh.flush()

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        self._fh.write(EOF_BLOCK)
        self._fh.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
