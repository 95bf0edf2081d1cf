"""FITS-level pipeline: the reference's file-based workflow, on the card.

Counterpart of ``subpixal_tpu/pipeline.py``: the corrected WCSs are
written back into the SCI extension headers with HISTORY records, so a
killed run resumes from the last written headers.

* :func:`load_exposures` — read SCI extensions (+ optional WHT / ERR)
  into :class:`~subpixal_tpu_torch.resample.Exposure` objects;
* :func:`align_fits` — load, align on ``device`` ('cuda' by default),
  write the corrected WCS keywords + HISTORY back into the input files;
* :class:`AlignState` — an explicit JSON checkpoint of the alignment
  state (per-image affine, iteration count, fit history).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Sequence

import numpy as np

from .align import AlignResult, align_images
from .fitswcs import wcs_from_hdul, wcs_to_header
from .io.fits import read_fits, write_fits
from .resample import Drizzle, Exposure
from .utils import parse_file_name

__all__ = ["load_exposures", "align_fits", "AlignState"]

#: BUNIT forms of a per-second (rate) unit: '/S', 'S-1', 'S^-1', ...
_RATE_FORMS = ("/S", "S-1", "S^-1", "S**-1",
               "SEC-1", "SEC^-1", "SEC**-1", "/SEC")


def _aux_data(hdul, aux_ext, sci_ver):
    """A WHT/ERR-style companion extension of one SCI chip: a bare NAME
    pairs with the chip's EXTVER (``SCI,2`` ↔ ``WHT,2``); a tuple or int
    is used as given. None when absent."""
    if aux_ext is None:
        return None
    key = (aux_ext, sci_ver) if isinstance(aux_ext, str) else aux_ext
    try:
        return np.asarray(hdul[key].data, np.float32)
    except (KeyError, IndexError):
        return None


def _exposure_from_hdu(hdul, hdu, name, wht_ext, err_ext) -> Exposure:
    """One chip's Exposure: the SCI header's TAN+SIP with the file's
    lookup-table distortions (chip k's grids at EXTVER 2k-1, 2k, or the
    single (1, 2) pair shared), EXPTIME from the SCI or primary header,
    and the data units from BUNIT (per-second forms are rate, any other
    unit but UNITLESS counts, none rate)."""
    ver = getattr(hdu, "ver", 1)
    wcs = wcs_from_hdul(hdul, ext=hdu, chip=ver)
    exptime = float(hdu.header.get(
        "EXPTIME", hdul[0].header.get("EXPTIME", 1.0)))
    bunit = str(hdu.header.get("BUNIT", "")).upper()
    counts = (bool(bunit) and not any(f in bunit for f in _RATE_FORMS)
              and bunit not in ("UNITLESS",))
    return Exposure(np.asarray(hdu.data, np.float32), wcs,
                    weight=_aux_data(hdul, wht_ext, ver),
                    exptime=exptime, name=name,
                    data_units="counts" if counts else "rate",
                    err=_aux_data(hdul, err_ext, ver))


def _target_hdu(hdul, fname, fext, ext):
    """The HDU a spec names (``fext``, else ``ext``, else ``("SCI", 1)``),
    falling back to the first HDU with data."""
    use_ext = fext if fext is not None else (
        ext if ext is not None else ("SCI", 1))
    try:
        return hdul[use_ext]
    except (KeyError, IndexError):  # int specs raise IndexError
        hdu = next((h for h in hdul if h.data is not None), None)
        if hdu is None:
            raise ValueError(f"{fname}: no HDU with image data")
        return hdu


def load_exposures(
    image_fnames: Sequence[str] | str,
    ext=None,
    wht_ext=None,
    err_ext=None,
) -> list[Exposure]:
    """Read FITS exposures (``"file.fits[sci,1]"`` specs supported).

    With ``ext=None`` a bare filename expands to every SCI extension: a
    2-chip file yields two Exposures named ``f.fits[sci,1]`` /
    ``f.fits[sci,2]`` (and :func:`align_fits` writes each chip's WCS back
    to its own header). An explicit ``ext`` (``("SCI", 1)`` / int) or a
    per-spec ``"f.fits[sci,2]"`` loads one extension. ``wht_ext`` /
    ``err_ext`` load companion weight / error extensions (a bare name like
    ``"WHT"`` pairs with each SCI chip's EXTVER).
    """
    if isinstance(image_fnames, str):
        image_fnames = [image_fnames]
    exps = []
    for spec in image_fnames:
        fname, fext = parse_file_name(spec)
        hdul = read_fits(fname)
        if fext is None and ext is None:
            scis = [h for h in hdul if h.name == "SCI" and h.data is not None]
            if len(scis) > 1:
                exps.extend(_exposure_from_hdu(
                    hdul, h, f"{fname}[sci,{h.ver}]", wht_ext, err_ext)
                    for h in scis)
                continue
            if scis:
                exps.append(_exposure_from_hdu(hdul, scis[0], spec,
                                               wht_ext, err_ext))
                continue
        exps.append(_exposure_from_hdu(
            hdul, _target_hdu(hdul, fname, fext, ext), spec, wht_ext,
            err_ext))
    return exps


def align_fits(
    image_fnames: Sequence[str] | str,
    ext=None,
    wht_ext=None,
    update_headers: bool = True,
    state_file: str | None = None,
    device="cuda",
    **align_kwargs,
) -> AlignResult:
    """End-to-end file-based alignment (the reference's usage pattern).

    Reads the exposures (multi-SCI files expand to one exposure per chip,
    :func:`load_exposures`), runs
    :func:`~subpixal_tpu_torch.align.align_images` on ``device`` with
    ``align_kwargs`` (whose ``use_pallas`` the Drizzle takes too), and
    (by default) writes the corrected WCS keywords
    into each chip's own SCI header with a HISTORY record, each file
    rewritten once (atomically). ``state_file`` also saves an
    :class:`AlignState` JSON checkpoint.
    """
    exps = load_exposures(image_fnames, ext=ext, wht_ext=wht_ext)
    result = align_images(resample=Drizzle(
        exps, use_pallas=align_kwargs.get("use_pallas", "auto"),
        device=device), device=device, **align_kwargs)
    if update_headers:
        by_file: dict[str, list] = {}
        for exp, M, t in zip(result.exposures, result.matrices,
                             result.shifts):
            fname, fext = parse_file_name(exp.name)
            hist = [
                "subpixal_tpu_torch: aligned "
                f"(converged={result.converged}, "
                f"iters={result.n_iterations})",
                f"subpixal_tpu_torch: shift=({t[0]:.6f}, {t[1]:.6f}) "
                f"matrix=[[{M[0,0]:.8f},{M[0,1]:.8f}],"
                f"[{M[1,0]:.8f},{M[1,1]:.8f}]]",
            ]
            by_file.setdefault(fname, []).append((fext, exp.wcs, hist))
        for fname, items in by_file.items():
            hdul = read_fits(fname)
            for fext, wcs, hist in items:
                hdu = _target_hdu(hdul, fname, fext, ext)
                wcs_to_header(wcs, hdu.header)
                for line in hist:
                    hdu.header.add_history(line)
            write_fits(fname, list(hdul))
    if state_file:
        AlignState.from_result(
            result, [e.name for e in result.exposures]).save(state_file)
    return result


@dataclasses.dataclass
class AlignState:
    """Explicit serializable alignment state: per-image affines,
    convergence and the per-iteration fit history, as JSON."""

    images: list[str]
    matrices: list  # (E, 2, 2) nested lists
    shifts: list    # (E, 2)
    converged: bool
    n_iterations: int
    history: list   # per-iteration list of per-image record dicts

    @classmethod
    def from_result(cls, result: AlignResult,
                    images: Sequence[str]) -> "AlignState":
        return cls(
            images=list(images),
            matrices=np.asarray(result.matrices).tolist(),
            shifts=np.asarray(result.shifts).tolist(),
            converged=bool(result.converged),
            n_iterations=int(result.n_iterations),
            history=[[dataclasses.asdict(r) for r in recs]
                     for recs in result.history],
        )

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=1)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "AlignState":
        with open(path) as f:
            return cls(**json.load(f))
