"""Small host-side helpers.

Counterpart of the host helpers of ``subpixal_tpu/utils.py``:
``parse_file_name`` (``"image.fits[sci,1]"``-style file specifications)
and ``py2round``. Its other helpers (the compilation cache, device sync
and fetch) exist only for JAX runtimes and have no port.
"""

from __future__ import annotations

import math
import re

__all__ = ["parse_file_name", "py2round"]

_EXT_RE = re.compile(r"^(?P<file>.+?)(?:\[(?P<ext>[^\]]+)\])?$")


def parse_file_name(image_fname: str) -> tuple[str, int | tuple[str, int] | None]:
    """Split ``"name.fits[sci,2]"`` into (``"name.fits"``, ``("SCI", 2)``).

    Supported extension specs: ``[3]`` (integer index), ``[sci]`` (name,
    ver 1 implied -> returned as ``("SCI", 1)``), ``[sci,2]`` (name, ver).
    Returns ``(filename, None)`` when no extension is given.
    """
    m = _EXT_RE.match(image_fname.strip())
    if m is None:  # pragma: no cover - regex always matches
        raise ValueError(f"cannot parse file name: {image_fname!r}")
    fname = m.group("file")
    ext = m.group("ext")
    if ext is None:
        return fname, None
    parts = [p.strip() for p in ext.split(",")]
    if len(parts) == 1:
        if re.fullmatch(r"[+-]?\d+", parts[0]):
            return fname, int(parts[0])
        return fname, (parts[0].upper(), 1)
    if len(parts) == 2:
        return fname, (parts[0].upper(), int(parts[1]))
    raise ValueError(f"invalid extension specification in {image_fname!r}")


def py2round(x: float) -> float:
    """Round half away from zero (Python-2 style), as the reference does
    for pixel index math."""
    return math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5)
