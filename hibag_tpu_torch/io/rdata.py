"""Pure-Python reader for R serialization format (RDX2 / XDR, versions 2-3).

Used to load the reference's bundled fixtures (``data/*.rdata``,
``inst/extdata/*.RData`` — HIBAG models serialize as plain R lists per
reference src/HIBAG.cpp:881-958 / R/HIBAG.R:1041) without an R runtime.

Supports the subset of SEXP types that appear in saved data objects:
vectors (logical/int/real/string/list), pairlists, symbols, attributes,
factors, data.frames, ALTREP compact integer sequences, and reference
objects. Not a general R interpreter — environments/closures raise.

The port's copy of hibag_tpu/io/rdata.py, so that the port imports nothing
of that package.
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import struct
from dataclasses import dataclass, field
from typing import Any

import numpy as np

# SEXP type codes (R internals, public serialization format)
NILSXP = 0
SYMSXP = 1
LISTSXP = 2
CLOSXP = 3
ENVSXP = 4
PROMSXP = 5
LANGSXP = 6
CHARSXP = 9
LGLSXP = 10
INTSXP = 13
REALSXP = 14
CPLXSXP = 15
STRSXP = 16
DOTSXP = 17
VECSXP = 19
EXPRSXP = 20
BCODESXP = 21
RAWSXP = 24
S4SXP = 25

# serialization pseudo-types
REFSXP = 255
NILVALUE_SXP = 254
GLOBALENV_SXP = 253
UNBOUNDVALUE_SXP = 252
MISSINGARG_SXP = 251
BASENAMESPACE_SXP = 250
NAMESPACESXP = 249
PACKAGESXP = 248
PERSISTSXP = 247
EMPTYENV_SXP = 242
BASEENV_SXP = 241
ALTREP_SXP = 238
ATTRLISTSXP = 239  # not real; placeholder

R_NA_INT = -2147483648
# R's NA_real_ payload: 0x7FF00000000007A2
_NA_REAL_BITS = 0x7FF00000000007A2


@dataclass
class RObj:
    """A decoded R object: `data` plus an attribute dict."""

    type: int
    data: Any
    attrs: dict = field(default_factory=dict)

    @property
    def rclass(self):
        c = self.attrs.get("class")
        if c is None:
            return None
        return list(c.data) if isinstance(c, RObj) else list(c)

    def attr(self, name, default=None):
        a = self.attrs.get(name)
        if a is None:
            return default
        return a.data if isinstance(a, RObj) else a

    def __repr__(self):  # pragma: no cover
        cls = self.rclass
        d = self.data
        shape = getattr(d, "shape", None) or (len(d) if hasattr(d, "__len__") else None)
        return f"RObj(type={self.type}, class={cls}, shape={shape})"


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.refs: list[Any] = []

    def read(self, n: int) -> bytes:
        b = self.buf[self.pos : self.pos + n]
        if len(b) != n:
            raise EOFError("truncated RData stream")
        self.pos += n
        return b

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def i32(self) -> int:
        return struct.unpack(">i", self.read(4))[0]

    def f64(self) -> float:
        return struct.unpack(">d", self.read(8))[0]

    def i32s(self, n: int) -> np.ndarray:
        a = np.frombuffer(self.read(4 * n), dtype=">i4").astype(np.int64)
        return a

    def f64s(self, n: int) -> np.ndarray:
        raw = self.read(8 * n)
        a = np.frombuffer(raw, dtype=">f8").astype(np.float64)
        # map R NA_real_ to nan (already nan numerically)
        return a

    # --- flag decoding ---------------------------------------------------
    def read_flags(self):
        flags = self.i32()
        ptype = flags & 255
        levels = flags >> 12
        is_obj = bool(flags & 0x100)
        has_attr = bool(flags & 0x200)
        has_tag = bool(flags & 0x400)
        return ptype, levels, is_obj, has_attr, has_tag, flags

    def read_length(self) -> int:
        n = self.i32()
        if n == -1:  # long vector
            hi = self.i32() & 0xFFFFFFFF
            lo = self.i32() & 0xFFFFFFFF
            n = (hi << 32) | lo
        return n

    # --- item reader -----------------------------------------------------
    def read_item(self) -> Any:
        ptype, levels, is_obj, has_attr, has_tag, flags = self.read_flags()

        if ptype == NILVALUE_SXP or ptype == NILSXP:
            return None
        if ptype == REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self.i32()
            return self.refs[idx - 1]
        if ptype == SYMSXP:
            ch = self.read_item()  # CHARSXP
            sym = RObj(SYMSXP, ch.data if isinstance(ch, RObj) else ch)
            self.refs.append(sym)
            return sym
        if ptype in (GLOBALENV_SXP, BASEENV_SXP, EMPTYENV_SXP, UNBOUNDVALUE_SXP, MISSINGARG_SXP):
            return RObj(ptype, None)
        if ptype in (PACKAGESXP, NAMESPACESXP, PERSISTSXP):
            # string vector of names
            self.i32()  # skip a flag int (attr marker per format)
            n = self.i32()
            names = [self.read_item() for _ in range(n)]
            o = RObj(ptype, [x.data if isinstance(x, RObj) else x for x in names])
            self.refs.append(o)
            return o
        if ptype == ENVSXP:
            o = RObj(ENVSXP, {})
            self.refs.append(o)
            self.i32()  # locked
            self.read_item()  # enclos
            self.read_item()  # frame
            self.read_item()  # hashtab
            self.read_item()  # attrib
            return o
        if ptype in (LISTSXP, LANGSXP, CLOSXP, PROMSXP, DOTSXP):
            attrs = self.read_attrs() if has_attr else {}
            tag = self.read_item() if has_tag else None
            car = self.read_item()
            cdr = self.read_item()
            pairs = [(tag.data if isinstance(tag, RObj) else tag, car)]
            if isinstance(cdr, RObj) and cdr.type in (LISTSXP, LANGSXP, CLOSXP, PROMSXP, DOTSXP):
                pairs.extend(cdr.data)
            elif cdr is not None:
                pairs.append((None, cdr))
            return RObj(ptype, pairs, attrs)
        if ptype == CHARSXP:
            n = self.i32()
            if n == -1:
                return RObj(CHARSXP, None)
            return RObj(CHARSXP, self.read(n).decode("utf-8", "replace"))
        if ptype == LGLSXP:
            n = self.read_length()
            a = self.i32s(n)
            data = np.where(a == R_NA_INT, -1, a).astype(np.int8)  # NA → -1
            return self.finish_vec(RObj(LGLSXP, data), has_attr)
        if ptype == INTSXP:
            n = self.read_length()
            a = self.i32s(n)
            return self.finish_vec(RObj(INTSXP, a), has_attr)
        if ptype == REALSXP:
            n = self.read_length()
            return self.finish_vec(RObj(REALSXP, self.f64s(n)), has_attr)
        if ptype == CPLXSXP:
            n = self.read_length()
            re = self.f64s(2 * n)
            return self.finish_vec(RObj(CPLXSXP, re[0::2] + 1j * re[1::2]), has_attr)
        if ptype == STRSXP:
            n = self.read_length()
            out = []
            for _ in range(n):
                ch = self.read_item()
                out.append(ch.data if isinstance(ch, RObj) else ch)
            return self.finish_vec(RObj(STRSXP, out), has_attr)
        if ptype == VECSXP or ptype == EXPRSXP:
            n = self.read_length()
            out = [self.read_item() for _ in range(n)]
            return self.finish_vec(RObj(VECSXP, out), has_attr)
        if ptype == RAWSXP:
            n = self.read_length()
            return self.finish_vec(RObj(RAWSXP, np.frombuffer(self.read(n), dtype=np.uint8)), has_attr)
        if ptype == S4SXP:
            attrs = self.read_attrs() if has_attr else {}
            return RObj(S4SXP, None, attrs)
        if ptype == ALTREP_SXP:
            info = self.read_item()  # pairlist: (class-sym, package, type)
            state = self.read_item()
            attr = self.read_item()
            return self.decode_altrep(info, state, attr)
        raise ValueError(f"unsupported SEXP type {ptype} at offset {self.pos}")

    def finish_vec(self, obj: RObj, has_attr: bool) -> RObj:
        if has_attr:
            obj.attrs = self.read_attrs()
        return obj

    def read_attrs(self) -> dict:
        # attributes serialize as a pairlist starting with its own flags
        attrs = {}
        while True:
            ptype, levels, is_obj, has_attr, has_tag, flags = self.read_flags()
            if ptype in (NILVALUE_SXP, NILSXP):
                break
            if ptype != LISTSXP:
                raise ValueError(f"bad attribute pairlist type {ptype}")
            if has_attr:
                self.read_attrs()
            tag = self.read_item() if has_tag else None
            car = self.read_item()
            name = tag.data if isinstance(tag, RObj) else tag
            attrs[name] = car
        return attrs

    def decode_altrep(self, info, state, attr) -> RObj:
        # info is a pairlist; first car is the class symbol
        cls = None
        if isinstance(info, RObj) and info.type in (LISTSXP, LANGSXP):
            car = info.data[0][1]
            if isinstance(car, RObj):
                cls = car.data
        if cls == "compact_intseq":
            n, start, step = state.data  # REALSXP of 3
            a = (np.arange(n) * step + start).astype(np.int64)
            o = RObj(INTSXP, a)
        elif cls == "compact_realseq":
            n, start, step = state.data
            o = RObj(REALSXP, np.arange(n) * step + start)
        elif cls in ("wrap_real", "wrap_integer", "wrap_logical", "wrap_string", "wrap_raw"):
            payload = state.data[0][1] if state.type in (LISTSXP, LANGSXP) else state
            o = payload
        elif cls == "deferred_string":
            # state: pairlist (values . sexp); force by formatting — rare; fall back
            payload = state.data[0][1] if state.type in (LISTSXP, LANGSXP) else state
            vals = payload.data
            o = RObj(STRSXP, [None if v is None else str(v) for v in np.asarray(vals)])
        else:
            raise ValueError(f"unsupported ALTREP class {cls!r}")
        if isinstance(attr, RObj) and attr.type in (LISTSXP,):
            for nm, v in attr.data:
                o.attrs[nm] = v
        return o


def _decompress(path: str) -> bytes:
    with open(path, "rb") as f:
        head = f.read(6)
    if head[:2] == b"\x1f\x8b":
        with gzip.open(path, "rb") as f:
            return f.read()
    if head[:6] == b"\xfd7zXZ\x00":
        with lzma.open(path, "rb") as f:
            return f.read()
    if head[:3] == b"BZh":
        with bz2.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _parse_stream(buf: bytes, workspace: bool):
    pos = 0
    if workspace:
        if not buf.startswith(b"RD"):
            raise ValueError("not an RData workspace file")
        nl = buf.index(b"\n")
        pos = nl + 1
    # format marker: 'X\n' (XDR), 'B\n' (native binary), 'A\n' (ascii)
    fmt = buf[pos : pos + 2]
    if fmt != b"X\n":
        raise ValueError(f"unsupported serialization format {fmt!r} (only XDR)")
    r = _Reader(buf)
    r.pos = pos + 2
    version = r.i32()
    r.i32()  # writer version
    r.i32()  # min reader version
    if version >= 3:
        n = r.i32()
        r.read(n)  # native encoding string
    obj = r.read_item()
    return obj


def read_rdata(path: str) -> dict:
    """Read a .RData / .rda workspace file → {name: RObj}."""
    buf = _decompress(path)
    obj = _parse_stream(buf, workspace=True)
    out = {}
    # top object is a pairlist of name=value bindings
    while obj is not None:
        if isinstance(obj, RObj) and obj.type == LISTSXP:
            for nm, val in obj.data:
                out[nm] = val
            break
        raise ValueError("unexpected top-level object in RData file")
    return out


def read_rds(path: str) -> Any:
    """Read a .rds single-object file."""
    buf = _decompress(path)
    return _parse_stream(buf, workspace=False)


# --- writer (mirror of the reader; R `save()` XDR version-2 format) ---------

class _Writer:
    """Serialize RObj trees / plain Python values to the XDR stream.

    Python conventions (inverse of r_to_py): dict → named VECSXP, list →
    VECSXP, str → length-1 STRSXP, bool/int/float scalars → length-1
    vectors, NumPy arrays by dtype (bool→LGLSXP, integer→INTSXP,
    float→REALSXP, object/str→STRSXP), None → NULL. RObj passes through
    with its attributes (class, names, row.names, dim, levels) — so
    objects parsed by read_rdata re-serialize loadable by R."""

    def __init__(self):
        self.out = bytearray()

    def i32(self, v: int) -> None:
        self.out += struct.pack(">i", int(v))

    def _charsxp(self, s) -> None:
        if s is None:
            self.i32(CHARSXP)
            self.i32(-1)
            return
        b = str(s).encode("utf-8")
        # CHARSXP levels: ASCII flag 64, else UTF-8 flag 8
        levels = 64 if all(c < 128 for c in b) else 8
        self.i32(CHARSXP | (levels << 12))
        self.i32(len(b))
        self.out += b

    def _symbol(self, name: str) -> None:
        self.i32(SYMSXP)
        self._charsxp(name)

    def _flags(self, ptype: int, attrs: dict, has_tag: bool = False) -> None:
        f = ptype
        if attrs:
            f |= 0x200
            if "class" in attrs:
                f |= 0x100          # object bit
        if has_tag:
            f |= 0x400
        self.i32(f)

    def _attrs(self, attrs: dict) -> None:
        for name, val in attrs.items():
            self.i32(LISTSXP | 0x400)
            self._symbol(name)
            self.write_item(val)
        self.i32(NILVALUE_SXP)

    def write_item(self, obj: Any) -> None:
        obj = py_to_r(obj)
        if obj is None:
            self.i32(NILVALUE_SXP)
            return
        attrs = obj.attrs or {}
        t = obj.type
        if t == SYMSXP:
            self._symbol(obj.data)
            return
        if t == CHARSXP:
            self._charsxp(obj.data)
            return
        if t in (LISTSXP, LANGSXP):
            # flattened (tag, car) pairs → nested pairlist nodes; attrs
            # attach to the first node
            pairs = obj.data
            for k, (tag, car) in enumerate(pairs):
                a = attrs if k == 0 else {}
                self._flags(t, a, has_tag=tag is not None)
                if a:
                    self._attrs(a)
                if tag is not None:
                    self._symbol(tag)
                self.write_item(car)
            self.i32(NILVALUE_SXP)
            return
        if t == STRSXP:
            self._flags(t, attrs)
            self.i32(len(obj.data))
            for s in obj.data:
                self._charsxp(s)
        elif t == VECSXP:
            self._flags(t, attrs)
            self.i32(len(obj.data))
            for x in obj.data:
                self.write_item(x)
        elif t == LGLSXP:
            self._flags(t, attrs)
            # R atomic vectors are flat; matrices carry a `dim` attribute
            # and column-major data, so multi-d input is flattened F-order
            # (matching r_to_py's reshape) — length is a.size, never the
            # first-dimension len()
            a = np.asarray(obj.data).ravel(order="F")
            self.i32(a.size)
            ints = np.where(a < 0, R_NA_INT, a.astype(np.int64))
            self.out += ints.astype(">i4").tobytes()
        elif t == INTSXP:
            self._flags(t, attrs)
            a = np.asarray(obj.data, dtype=np.int64).ravel(order="F")
            self.i32(a.size)
            self.out += a.astype(">i4").tobytes()
        elif t == REALSXP:
            self._flags(t, attrs)
            a = np.asarray(obj.data, dtype=np.float64).ravel(order="F")
            self.i32(a.size)
            raw = a.astype(">f8").tobytes()
            if np.isnan(a).any():
                # write NaNs as R NA_real_ (the reader maps both to nan)
                buf = np.frombuffer(raw, dtype=">u8").copy()
                buf[np.isnan(a)] = _NA_REAL_BITS
                raw = buf.astype(">u8").tobytes()
            self.out += raw
        elif t == RAWSXP:
            self._flags(t, attrs)
            a = np.asarray(obj.data, dtype=np.uint8).ravel(order="F")
            self.i32(a.size)
            self.out += a.tobytes()
        else:
            raise ValueError(f"cannot serialize SEXP type {t}")
        if attrs:
            self._attrs(attrs)


def py_to_r(obj: Any) -> Any:
    """Convert a plain Python value to an RObj (see _Writer conventions).
    RObj and None pass through."""
    if obj is None or isinstance(obj, RObj):
        return obj
    if isinstance(obj, str):
        return RObj(STRSXP, [obj])
    if isinstance(obj, (bool, np.bool_)):
        return RObj(LGLSXP, np.asarray([1 if obj else 0], np.int8))
    if isinstance(obj, (int, np.integer)):
        return RObj(INTSXP, np.asarray([obj], np.int64))
    if isinstance(obj, (float, np.floating)):
        return RObj(REALSXP, np.asarray([obj], np.float64))
    if isinstance(obj, dict):
        return RObj(VECSXP, [py_to_r(v) for v in obj.values()],
                    {"names": RObj(STRSXP, [str(k) for k in obj])})
    if isinstance(obj, (list, tuple)):
        if all(isinstance(x, str) or x is None for x in obj):
            return RObj(STRSXP, list(obj))
        if obj and all(isinstance(x, (bool, np.bool_)) for x in obj):
            return RObj(LGLSXP, np.asarray(obj, np.int8))
        if obj and all(isinstance(x, (int, np.integer))
                       and not isinstance(x, bool) for x in obj):
            return RObj(INTSXP, np.asarray(obj, np.int64))
        if obj and all(isinstance(x, (int, float, np.integer, np.floating))
                       and not isinstance(x, bool) for x in obj):
            return RObj(REALSXP, np.asarray(obj, np.float64))
        return RObj(VECSXP, [py_to_r(v) for v in obj])
    a = np.asarray(obj)
    # multi-d arrays become R matrices/arrays: a `dim` attribute plus
    # column-major data (the writer flattens F-order; r_to_py reshapes
    # back). Raw vectors (RAWSXP) are never inferred — uint8 maps to
    # INTSXP like every integer dtype; construct RObj(RAWSXP, ...)
    # explicitly to emit R raw.
    dims = ({"dim": RObj(INTSXP, np.asarray(a.shape, np.int64))}
            if a.ndim > 1 else {})
    if a.dtype == np.bool_:
        return RObj(LGLSXP, a.astype(np.int8), dims)
    if np.issubdtype(a.dtype, np.integer):
        return RObj(INTSXP, a.astype(np.int64), dims)
    if np.issubdtype(a.dtype, np.floating):
        return RObj(REALSXP, a.astype(np.float64), dims)
    if a.dtype.kind in ("U", "S", "O"):
        return RObj(STRSXP, [None if x is None else str(x)
                             for x in a.ravel().tolist()])
    raise ValueError(f"cannot convert {type(obj)} to an R object")


def r_dataframe(cols: dict) -> RObj:
    """Build a data.frame RObj from {column name: vector}."""
    vals = [py_to_r(v) for v in cols.values()]
    n = len(vals[0].data) if vals else 0
    return RObj(VECSXP, vals, {
        "names": RObj(STRSXP, [str(k) for k in cols]),
        # compact row.names: c(NA_integer_, -n)
        "row.names": RObj(INTSXP, np.asarray([R_NA_INT, -n], np.int64)),
        "class": RObj(STRSXP, ["data.frame"]),
    })


def _serialize(objects: dict, version: int = 2) -> bytes:
    w = _Writer()
    w.out += b"RDX2\nX\n"
    w.i32(version)
    w.i32(0x030600)     # writer R version (3.6.0)
    w.i32(0x020300)     # minimum reader version (2.3.0)
    for name, val in objects.items():
        w.i32(LISTSXP | 0x400)
        w._symbol(name)
        w.write_item(val)
    w.i32(NILVALUE_SXP)
    return bytes(w.out)


def write_rds(path: str, obj: Any, compress: str = "gzip") -> None:
    """Write a single object as .rds (readRDS-compatible; mirror of
    read_rds)."""
    w = _Writer()
    w.out += b"X\n"
    w.i32(2)
    w.i32(0x030600)
    w.i32(0x020300)
    w.write_item(obj)
    payload = bytes(w.out)
    if compress == "gzip":
        with gzip.open(path, "wb", compresslevel=6) as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)


def write_rdata(path: str, objects: dict, compress: str = "gzip") -> None:
    """Write a .RData workspace file ({name: value}) loadable by R `load()`
    — the mirror of read_rdata (XDR version 2, the format the reference's
    bundled models use). Values follow the _Writer conventions; pass RObj
    trees (e.g. from read_rdata, or r_dataframe) to control classes."""
    payload = _serialize(objects)
    if compress == "gzip":
        with gzip.open(path, "wb", compresslevel=6) as f:
            f.write(payload)
    elif compress in (None, "", "none"):
        with open(path, "wb") as f:
            f.write(payload)
    else:
        raise ValueError(f"unsupported compression {compress!r}")


# --- convenience conversion -------------------------------------------------

def r_to_py(obj: Any) -> Any:
    """Convert an RObj tree into plain Python/NumPy structures.

    Named lists → dict; data.frames → dict of columns; factors → string
    arrays; NA ints → None-preserving masked handling is *not* done (R NA int
    stays as R_NA_INT sentinel; callers in this codebase treat it explicitly).
    """
    if obj is None:
        return None
    if not isinstance(obj, RObj):
        return obj
    cls = obj.rclass or []
    if "factor" in cls:
        levels = [lv for lv in obj.attrs["levels"].data]
        idx = np.asarray(obj.data)
        out = np.array([levels[i - 1] if i != R_NA_INT and i >= 1 else None for i in idx], dtype=object)
        return out
    if "data.frame" in cls:
        names = obj.attr("names")
        return {nm: r_to_py(col) for nm, col in zip(names, obj.data)}
    if obj.type == VECSXP:
        names = obj.attr("names")
        vals = [r_to_py(x) for x in obj.data]
        if names is not None and len(names) == len(vals):
            return dict(zip(names, vals))
        return vals
    if obj.type == STRSXP:
        data = obj.data
        if len(data) == 1 and not obj.attrs.get("names"):
            pass
        return np.array(data, dtype=object)
    if obj.type in (INTSXP, REALSXP, LGLSXP, CPLXSXP, RAWSXP):
        a = obj.data
        dim = obj.attr("dim")
        if dim is not None:
            a = np.asarray(a).reshape(tuple(int(d) for d in dim), order="F")
        return a
    if obj.type == LISTSXP:
        return {nm: r_to_py(v) for nm, v in obj.data}
    if obj.type == SYMSXP or obj.type == CHARSXP:
        return obj.data
    return obj.data
