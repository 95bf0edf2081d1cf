"""Minimal pure-numpy FITS image I/O.

Counterpart of ``subpixal_tpu/io/fits.py``, carried into the port so
that reading and writing FITS never loads JAX: the same code, so both
packages write identical bytes for identical HDUs and read each other's
files. ``astropy`` is not a dependency; this implements the subset of
the FITS standard the pipeline needs: primary + IMAGE-extension HDUs
with integer/float pixel data, plus header cards (including the WCS
keywords :mod:`subpixal_tpu_torch.fitswcs` reads and writes).

Supported:

* reading/writing primary HDUs and ``XTENSION = 'IMAGE'`` extensions;
* BITPIX 8 / 16 / 32 / 64 / -32 / -64, BSCALE/BZERO scaling, big-endian;
* header cards: logical, integer, float, string (with quote escaping),
  HISTORY/COMMENT, END; EXTNAME/EXTVER lookup (``hdul["SCI", 2]``-style);
* in-place header updates + rewrite (the align loop's WCS write-back);
* gzip compression: ``read_fits`` detects gzip magic bytes regardless
  of suffix (archive ``.fits.gz`` deliveries), ``write_fits`` emits
  gzip when the path ends in ``.gz``.

Not supported (and not needed here): ASCII/binary tables, random groups,
tile compression, CONTINUE long strings.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Iterator

import numpy as np

__all__ = ["Header", "HDU", "read_fits", "write_fits", "getdata", "getheader"]

BLOCK = 2880
CARD = 80

_BITPIX_TO_DTYPE = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}
_DTYPE_TO_BITPIX = {
    np.dtype(np.uint8): 8,
    np.dtype(np.int16): 16,
    np.dtype(np.int32): 32,
    np.dtype(np.int64): 64,
    np.dtype(np.float32): -32,
    np.dtype(np.float64): -64,
}


class Header:
    """Ordered FITS header: keyword -> value, with optional comments.

    A deliberately small subset of the astropy Header API surface
    (``__getitem__``/``__setitem__``/``get``/``cards``), enough for the
    alignment pipeline's WCS read/update cycle.
    """

    def __init__(self, cards: list[tuple[str, object, str]] | None = None):
        self._d: OrderedDict[str, object] = OrderedDict()
        self._comments: dict[str, str] = {}
        self.history: list[str] = []
        self.comments_raw: list[str] = []
        if cards:
            for key, val, com in cards:
                if key == "HISTORY":
                    self.history.append(str(val))
                elif key == "COMMENT":
                    self.comments_raw.append(str(val))
                elif key:
                    self._d[key] = val
                    if com:
                        self._comments[key] = com

    def __getitem__(self, key: str):
        return self._d[key.upper()]

    def __setitem__(self, key: str, value):
        if isinstance(value, tuple) and len(value) == 2:
            value, comment = value
            self._comments[key.upper()] = comment
        self._d[key.upper()] = value

    def __delitem__(self, key: str):
        del self._d[key.upper()]
        self._comments.pop(key.upper(), None)

    def __contains__(self, key: str) -> bool:
        return key.upper() in self._d

    def __iter__(self) -> Iterator[str]:
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key: str, default=None):
        return self._d.get(key.upper(), default)

    def get_comment(self, key: str) -> str:
        return self._comments.get(key.upper(), "")

    def add_history(self, text: str):
        self.history.append(str(text))

    def items(self):
        return self._d.items()

    def copy(self) -> "Header":
        h = Header()
        h._d = OrderedDict(self._d)
        h._comments = dict(self._comments)
        h.history = list(self.history)
        h.comments_raw = list(self.comments_raw)
        return h

    def __repr__(self):
        return f"Header({len(self._d)} cards)"


class HDU:
    """One header-data unit: a :class:`Header` plus an optional ndarray."""

    def __init__(self, data: np.ndarray | None = None,
                 header: Header | None = None, name: str = "", ver: int = 1):
        self.data = data
        self.header = header if header is not None else Header()
        if name and "EXTNAME" not in self.header:
            self.header["EXTNAME"] = name
        if ver != 1 and "EXTVER" not in self.header:
            self.header["EXTVER"] = ver

    @property
    def name(self) -> str:
        return str(self.header.get("EXTNAME", "PRIMARY" )).strip().upper()

    @property
    def ver(self) -> int:
        return int(self.header.get("EXTVER", 1))

    def __repr__(self):
        shape = None if self.data is None else self.data.shape
        return f"HDU(name={self.name!r}, ver={self.ver}, shape={shape})"


# --------------------------------------------------------------------- #
# parsing
# --------------------------------------------------------------------- #
def _parse_value(raw: str):
    """Parse a FITS card value field (without the comment)."""
    s = raw.strip()
    if not s:
        return None
    if s.startswith("'"):
        # string: quotes doubled for escaping; value ends at the closing '
        out = []
        i = 1
        while i < len(s):
            if s[i] == "'":
                if i + 1 < len(s) and s[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(s[i])
            i += 1
        return "".join(out).rstrip()
    if s == "T":
        return True
    if s == "F":
        return False
    try:
        if any(c in s for c in ".EeDd") and not s.lstrip("+-").isdigit():
            return float(s.replace("D", "E").replace("d", "e"))
        return int(s)
    except ValueError:
        return s  # free-form


def _parse_header(buf: bytes, offset: int) -> tuple[Header, int]:
    """Parse one header starting at ``offset``; return (Header, data_offset)."""
    cards = []
    pos = offset
    end_found = False
    while not end_found:
        block = buf[pos:pos + BLOCK]
        if len(block) < BLOCK:
            raise ValueError("truncated FITS header")
        for i in range(0, BLOCK, CARD):
            card = block[i:i + CARD].decode("ascii", errors="replace")
            key = card[:8].strip().upper()
            if key == "END":
                end_found = True
                break
            if not key:
                continue
            if key in ("HISTORY", "COMMENT"):
                cards.append((key, card[8:].rstrip(), ""))
                continue
            if card[8:10] != "= ":
                continue  # commentary/invalid card
            rest = card[10:]
            # split off inline comment: a '/' outside quotes
            in_q = False
            cidx = None
            j = 0
            while j < len(rest):
                ch = rest[j]
                if ch == "'":
                    if in_q and j + 1 < len(rest) and rest[j + 1] == "'":
                        j += 2
                        continue
                    in_q = not in_q
                elif ch == "/" and not in_q:
                    cidx = j
                    break
                j += 1
            if cidx is None:
                vraw, com = rest, ""
            else:
                vraw, com = rest[:cidx], rest[cidx + 1:].strip()
            cards.append((key, _parse_value(vraw), com))
        pos += BLOCK
    return Header(cards), pos


def _data_size_bytes(hdr: Header) -> int:
    naxis = int(hdr.get("NAXIS", 0))
    if naxis == 0:
        return 0
    n = 1
    for i in range(1, naxis + 1):
        n *= int(hdr[f"NAXIS{i}"])
    bitpix = int(hdr["BITPIX"])
    nbytes = n * abs(bitpix) // 8
    # PCOUNT for extensions
    nbytes += int(hdr.get("PCOUNT", 0)) * abs(bitpix) // 8
    return nbytes


def _read_data(buf: bytes, offset: int, hdr: Header) -> tuple[np.ndarray | None, int]:
    nbytes = _data_size_bytes(hdr)
    if nbytes == 0:
        return None, offset
    bitpix = int(hdr["BITPIX"])
    dtype = _BITPIX_TO_DTYPE[bitpix]
    naxis = int(hdr["NAXIS"])
    shape = tuple(int(hdr[f"NAXIS{i}"]) for i in range(naxis, 0, -1))
    raw = np.frombuffer(buf[offset:offset + nbytes], dtype=dtype)
    data = raw.reshape(shape)
    bscale = float(hdr.get("BSCALE", 1.0))
    bzero = float(hdr.get("BZERO", 0.0))
    if bscale != 1.0 or bzero != 0.0:
        data = data.astype(np.float64) * bscale + bzero
        if bitpix == 16 and bzero == 32768.0 and bscale == 1.0:
            data = data.astype(np.uint16)
        # the scaling is now APPLIED to the in-memory data; drop the
        # cards so a read->update->write round trip (e.g. the align
        # pipeline's header update) does not emit physical values with
        # stale scale cards that a later reader would re-apply
        for key in ("BSCALE", "BZERO"):
            if key in hdr:
                del hdr[key]
    else:
        data = data.astype(dtype.newbyteorder("="))
    padded = (nbytes + BLOCK - 1) // BLOCK * BLOCK
    return data, offset + padded


class HDUList(list):
    """A list of HDUs with astropy-style (name, ver) indexing."""

    def __getitem__(self, key):
        if isinstance(key, (int, slice)):
            return super().__getitem__(key)
        if isinstance(key, str):
            key = (key, None)
        name, ver = key
        name = name.strip().upper()
        for h in self:
            if h.name == name and (ver is None or h.ver == int(ver)):
                return h
        raise KeyError(f"no HDU with EXTNAME={name!r}"
                       + (f", EXTVER={ver}" if ver is not None else ""))

    def index_of(self, key) -> int:
        target = self[key] if not isinstance(key, int) else super().__getitem__(key)
        for i, h in enumerate(self):
            if h is target:
                return i
        raise KeyError(key)


def read_fits(path: str | os.PathLike) -> HDUList:
    """Read all HDUs of a FITS file into memory.

    Gzip-compressed files (``.fits.gz`` — the archive-delivery form of
    most HST/JWST products) are detected by their magic bytes and
    decompressed transparently, matching ``astropy.io.fits.open``'s
    behavior (SURVEY.md §1 Host I/O).
    """
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] == b"\x1f\x8b":  # gzip magic, regardless of suffix
        import gzip

        buf = gzip.decompress(buf)
    hdus = HDUList()
    offset = 0
    while offset < len(buf):
        if not buf[offset:offset + 9].strip():
            break
        hdr, data_off = _parse_header(buf, offset)
        data, offset = _read_data(buf, data_off, hdr)
        hdus.append(HDU(data=data, header=hdr))
    return hdus


# --------------------------------------------------------------------- #
# writing
# --------------------------------------------------------------------- #
def _format_value(v) -> str:
    if isinstance(v, bool):
        return "T".rjust(20) if v else "F".rjust(20)
    if isinstance(v, (int, np.integer)):
        return str(int(v)).rjust(20)
    if isinstance(v, (float, np.floating)):
        s = repr(float(v))
        if "e" in s:
            s = f"{float(v):.16E}"
        return s.rjust(20)
    if v is None:
        return " " * 20
    s = str(v).replace("'", "''")
    return ("'" + s.ljust(8) + "'").ljust(20)


def _make_card(key: str, value, comment: str = "") -> bytes:
    if key in ("HISTORY", "COMMENT"):
        card = f"{key:<8}{str(value)[:72]}"
    else:
        card = f"{key.upper():<8}= {_format_value(value)}"
        if len(card) > CARD and isinstance(value, str):
            # truncate the VALUE, keeping the closing quote — slicing
            # the finished card would drop the quote and silently
            # corrupt the value on the next read
            import warnings

            warnings.warn(
                f"FITS card {key}: string value longer than one card; "
                "truncated", stacklevel=2)
            raw = str(value)
            while raw:  # shrink pre-escape so quotes stay balanced
                sval = raw.replace("'", "''")
                card = f"{key.upper():<8}= '{sval}'"
                if len(card) <= CARD:
                    break
                raw = raw[:-1]
        if comment:
            card += f" / {comment}"
    return card[:CARD].ljust(CARD).encode("ascii", errors="replace")


def _serialize_header(hdr: Header, data: np.ndarray | None,
                      primary: bool) -> bytes:
    cards = []
    if data is not None:
        arr = np.asarray(data)
        bitpix = _DTYPE_TO_BITPIX.get(arr.dtype.newbyteorder("="), None)
        if bitpix is None:
            arr = arr.astype(np.float32)
            bitpix = -32
        naxes = list(arr.shape[::-1])
    else:
        bitpix = 8
        naxes = []
    if primary:
        cards.append(_make_card("SIMPLE", True, "conforms to FITS standard"))
    else:
        cards.append(_make_card("XTENSION", "IMAGE", "image extension"))
    cards.append(_make_card("BITPIX", bitpix, "array data type"))
    cards.append(_make_card("NAXIS", len(naxes), "number of array dimensions"))
    for i, n in enumerate(naxes, 1):
        cards.append(_make_card(f"NAXIS{i}", n))
    if not primary:
        cards.append(_make_card("PCOUNT", int(hdr.get("PCOUNT", 0))))
        cards.append(_make_card("GCOUNT", int(hdr.get("GCOUNT", 1))))
    reserved = {"SIMPLE", "XTENSION", "BITPIX", "NAXIS", "PCOUNT", "GCOUNT",
                "END"} | {f"NAXIS{i}" for i in range(1, 10)}
    for key, val in hdr.items():
        if key in reserved:
            continue
        cards.append(_make_card(key, val, hdr.get_comment(key)))
    # commentary text wraps at the 72-char card payload instead of
    # truncating (astropy behavior — long align HISTORY records carry
    # full affine matrices that a silent cut would corrupt)
    for h in hdr.history:
        for k in range(0, max(len(str(h)), 1), 72):
            cards.append(_make_card("HISTORY", str(h)[k:k + 72]))
    for c in hdr.comments_raw:
        for k in range(0, max(len(str(c)), 1), 72):
            cards.append(_make_card("COMMENT", str(c)[k:k + 72]))
    cards.append(b"END".ljust(CARD))
    blob = b"".join(cards)
    pad = (-len(blob)) % BLOCK
    return blob + b" " * pad


def _serialize_data(data: np.ndarray | None) -> bytes:
    if data is None:
        return b""
    arr = np.asarray(data)
    if arr.dtype.newbyteorder("=") not in _DTYPE_TO_BITPIX:
        arr = arr.astype(np.float32)
    be = arr.astype(arr.dtype.newbyteorder(">"))
    blob = be.tobytes()
    pad = (-len(blob)) % BLOCK
    return blob + b"\x00" * pad


def write_fits(path: str | os.PathLike, hdus: list[HDU] | HDU,
               overwrite: bool = True):
    """Write HDU(s) to ``path``. The first HDU becomes the primary.

    The write is ATOMIC (tmp file + ``os.replace``): the align pipeline
    rewrites its INPUT files' headers in place, and a crash mid-write
    must never leave a truncated file — the killed-run recovery story
    ("resume from the last written headers") depends on the previous
    intact version surviving any interruption.

    A ``.gz`` suffix writes gzip-compressed output (mtime pinned to 0
    so identical pixels produce identical bytes).
    """
    if isinstance(hdus, HDU):
        hdus = [hdus]
    if not overwrite and os.path.exists(path):
        raise FileExistsError(path)
    path = os.fspath(path)
    tmp = path + f".tmp{os.getpid()}"
    try:
        payload = b"".join(
            _serialize_header(h.header, h.data, primary=(i == 0))
            + _serialize_data(h.data)
            for i, h in enumerate(hdus))
        if path.endswith(".gz"):
            import gzip

            payload = gzip.compress(payload, mtime=0)
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):  # pragma: no cover - error cleanup
            os.unlink(tmp)


def getdata(path, ext=0):
    """Convenience: data of one extension (int index or (name, ver))."""
    return read_fits(path)[ext].data


def getheader(path, ext=0):
    return read_fits(path)[ext].header
