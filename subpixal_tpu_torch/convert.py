"""Carry exposures from the JAX package into the port.

The system has no model weights; its state is the exposure stack. This
reads a JAX-package ``Exposure`` by duck typing (it never imports that
package): ``.data``, ``.weight``, ``.exptime``, ``.name``,
``.data_units``, ``.err``, ``.ivm`` and the WCS's ``crpix``, ``crval``,
``cd``, SIP matrices (``a``, ``b``, ``ap``, ``bp``) and lookup-table
distortions (``cpdis``, ``d2im``) as numpy arrays, so both packages can
run the same scene.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from .resample import Exposure
from .wcs import DistGrid, TanWCS

__all__ = ["exposures_from_reference", "wcs_from_reference"]


def _arr(a):
    return None if a is None else np.array(a, np.float64)


def _grid(g):
    if g is None:
        return None
    return DistGrid(data_x=_arr(g.data_x), data_y=_arr(g.data_y),
                    crpix=tuple(g.crpix), crval=tuple(g.crval),
                    cdelt=tuple(g.cdelt))


def wcs_from_reference(wcs) -> TanWCS:
    """Port :class:`~subpixal_tpu_torch.wcs.TanWCS` equal to a JAX-package
    ``TanWCS``."""
    return TanWCS(crpix=_arr(wcs.crpix), crval=_arr(wcs.crval),
                  cd=_arr(wcs.cd), a=_arr(getattr(wcs, "a", None)),
                  b=_arr(getattr(wcs, "b", None)),
                  ap=_arr(getattr(wcs, "ap", None)),
                  bp=_arr(getattr(wcs, "bp", None)),
                  cpdis=_grid(getattr(wcs, "cpdis", None)),
                  d2im=_grid(getattr(wcs, "d2im", None)))


def exposures_from_reference(exps: Iterable) -> list[Exposure]:
    """Port Exposures holding the same pixels, weights, metadata and WCS
    as the given JAX-package Exposures (arrays copied to host numpy)."""

    def host(a):
        return None if a is None else np.array(a, np.float32)

    return [Exposure(host(e.data), wcs_from_reference(e.wcs),
                     weight=host(e.weight), exptime=float(e.exptime),
                     name=e.name,
                     data_units=getattr(e, "data_units", "rate"),
                     err=host(getattr(e, "err", None)),
                     ivm=host(getattr(e, "ivm", None)))
            for e in exps]
