"""A plain FITS writer for the benchmark's visits, in numpy and the
standard library: it imports nothing of the program, and is part of the
benchmark's yardstick.

One file per exposure: a PRIMARY HDU without data (``EXPTIME``,
``NEXTEND``), then for each chip a ``SCI`` image extension (``EXTVER`` 1,
2, ...), followed by that chip's ``ERR`` and ``DQ`` where the visit
carries them. Pixels are big-endian, BITPIX -32 (``DQ``: 16). Each
``SCI`` header holds a TAN WCS (``CTYPE1/2`` ``RA---TAN`` / ``DEC--TAN``,
the 1-based ``CRPIX1/2``, ``CRVAL1/2``, ``CD1_1`` ... ``CD2_2``), every
float written by ``repr``, so that a reader gets the visit's float64
values back exactly, and ``BUNIT`` a rate form. A name ending in ``.gz``
is written gzip'd.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

BLOCK = 2880
CARD = 80
#: the unit of the scenes' frames: a count rate
BUNIT = "ELECTRONS/S"


def _value(v) -> str:
    if isinstance(v, (bool, np.bool_)):
        return ("T" if v else "F").rjust(20)
    if isinstance(v, (int, np.integer)):
        return str(int(v)).rjust(20)
    if isinstance(v, (float, np.floating)):
        return repr(float(v)).upper().rjust(20)
    return "'" + str(v).replace("'", "''").ljust(8) + "'"


def header(cards) -> bytes:
    """A header block of ``(keyword, value)`` cards, ``END`` and the
    padding to whole 2880-byte blocks."""
    out = []
    for key, v in cards:
        card = f"{key:<8}= {_value(v)}"
        if len(card) > CARD:
            raise ValueError(f"{key}: {v!r} does not fit one card")
        out.append(card.ljust(CARD))
    blob = ("".join(out) + "END".ljust(CARD)).encode("ascii")
    return blob + b" " * (-len(blob) % BLOCK)


def image(extname: str, extver: int, data, extra=()) -> bytes:
    """One image extension: its header (``extra`` cards after the
    structural ones) and its big-endian pixels, padded."""
    data = np.asarray(data)
    kind = {np.dtype(np.float32): (-32, ">f4"),
            np.dtype(np.int16): (16, ">i2")}[data.dtype]
    H, W = data.shape
    head = header([("XTENSION", "IMAGE"), ("BITPIX", kind[0]),
                   ("NAXIS", 2), ("NAXIS1", W), ("NAXIS2", H),
                   ("PCOUNT", 0), ("GCOUNT", 1), ("EXTNAME", extname),
                   ("EXTVER", extver), *extra])
    pix = data.astype(kind[1]).tobytes()
    return head + pix + b"\0" * (-len(pix) % BLOCK)


def tan_cards(crpix, crval, cd) -> list:
    """The TAN WCS cards of a 0-based ``crpix``, ``crval`` and ``cd`` in
    degrees."""
    crpix, crval, cd = (np.asarray(a, np.float64) for a in (crpix, crval,
                                                             cd))
    return [("WCSAXES", 2), ("CTYPE1", "RA---TAN"), ("CTYPE2", "DEC--TAN"),
            ("CRPIX1", crpix[0] + 1.0), ("CRPIX2", crpix[1] + 1.0),
            ("CRVAL1", crval[0]), ("CRVAL2", crval[1]),
            ("CD1_1", cd[0, 0]), ("CD1_2", cd[0, 1]),
            ("CD2_1", cd[1, 0]), ("CD2_2", cd[1, 1])]


def exposure(chips, exptime: float = 1.0) -> bytes:
    """One exposure's file: ``chips`` is a list of dicts with ``sci``
    (an (H, W) float32 array), ``crpix``, ``crval``, ``cd`` and
    optionally ``err`` (float32) and ``dq`` (int16)."""
    parts = []
    for ver, c in enumerate(chips, 1):
        parts.append(image("SCI", ver, c["sci"], [("BUNIT", BUNIT)]
                           + tan_cards(c["crpix"], c["crval"], c["cd"])))
        for name in ("err", "dq"):
            if c.get(name) is not None:
                parts.append(image(name.upper(), ver, c[name]))
    primary = header([("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0),
                      ("EXTEND", True), ("NEXTEND", len(parts)),
                      ("EXPTIME", float(exptime))])
    return primary + b"".join(parts)


def visit_files(stack) -> dict:
    """File name -> the indices of its frames, in file order, then chip
    order: the stack's ``files``, or one single-SCI file a frame."""
    names = stack.files or [(f"exp{e}.fits", 1)
                            for e in range(len(stack.frames))]
    files: dict = {}
    for e, (name, ver) in enumerate(names):
        frames = files.setdefault(name, [])
        if ver != len(frames) + 1 or (frames and frames[-1] != e - 1):
            raise ValueError(f"frame {e} ({name}, EXTVER {ver}): frames go "
                             f"in file order, then chip order")
        frames.append(e)
    return files


def write_visit(stack, directory: str) -> dict:
    """Write a visit's files into ``directory``: path -> the bytes
    written, in file order."""
    out = {}
    for name, frames in visit_files(stack).items():
        chips = [dict(sci=np.asarray(stack.frames[e], np.float32),
                      crpix=stack.crpix[e], crval=stack.crval, cd=stack.cd,
                      err=None if stack.err is None else stack.err[e],
                      dq=None if stack.dq is None else stack.dq[e])
                 for e in frames]
        blob = exposure(chips)
        if name.endswith(".gz"):
            blob = gzip.compress(blob, compresslevel=6, mtime=0)
        path = os.path.join(directory, name)
        with open(path, "wb") as f:
            f.write(blob)
        out[path] = blob
    return out
