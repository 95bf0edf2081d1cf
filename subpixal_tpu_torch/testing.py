"""Synthetic dithered star-field stacks with planted pointing errors.

Counterpart of ``subpixal_tpu/testing.py`` (its host renderer, with the
same numpy random draws, so both packages build the same scene from one
seed) and ``pairwise_shift_errors``, used by the tests and by
``chip_smoke.py`` to assert alignment accuracy against ground truth.
:class:`SpawnedRanks` runs one program as the ranks of a local
``torch.distributed`` group, as the multi-process tests and
``chip_smoke.py`` do.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch.distributed as dist

from .resample import Exposure
from .wcs import TanWCS

__all__ = ["simulate_stack", "pairwise_shift_errors", "SpawnedRanks"]


def simulate_stack(
    n_exp: int = 4,
    shape: tuple[int, int] = (512, 512),
    n_stars: int = 30,
    seed: int = 42,
    amp: float = 25.0,
    sigma: float = 1.8,
    noise: float = 0.01,
    shift_scale: float = 0.5,
    pscale_as: float = 0.05,
) -> tuple[list[Exposure], list[tuple[float, float]]]:
    """Dithered exposures whose DATA carry true sub-pixel offsets the
    header WCS does not know about (the alignment problem).

    Stars are painted patch-wise (a full-frame radius test per star
    costs minutes at 2k+ scales), at least 40 px from every edge.

    Returns ``(exposures, planted)`` with ``planted[e] = (dx, dy)`` the
    true per-exposure pointing error in pixels; only pairwise
    DIFFERENCES are recoverable (alignment is relative).
    """
    rng = np.random.default_rng(seed)
    H, W = shape
    cd = (pscale_as / 3600.0) * np.array([[-1.0, 0.0], [0.0, 1.0]])
    stars = np.stack([rng.uniform(40, W - 40, n_stars),
                      rng.uniform(40, H - 40, n_stars)], 1)
    R = max(int(np.ceil(4.5 * sigma)) + 2, 9)
    pyy, pxx = np.mgrid[-R:R + 1, -R:R + 1].astype(np.float32)
    r_cut = (R - 1) ** 2
    exps, planted = [], []
    shifts = [tuple(rng.uniform(-shift_scale, shift_scale, 2))
              for _ in range(n_exp)]
    for e in range(n_exp):
        dx, dy = shifts[e]
        planted.append((float(dx), float(dy)))
        img = rng.normal(0, noise, shape).astype(np.float32)
        for x0, y0 in stars:
            cx, cy = int(round(x0)), int(round(y0))
            r2 = (pxx + cx - x0 - dx) ** 2 + (pyy + cy - y0 - dy) ** 2
            img[cy - R:cy + R + 1, cx - R:cx + R + 1] += np.where(
                r2 < r_cut, amp * np.exp(-r2 / (2 * sigma * sigma)),
                0.0)
        wcs = TanWCS(crpix=np.array([W / 2, H / 2]),
                     crval=np.array([150.0, 2.0]), cd=cd)
        exps.append(Exposure(img, wcs, name=f"sim{e}"))
    return exps, planted


def pairwise_shift_errors(shifts, planted) -> float:
    """Max pairwise |fitted - planted| relative shift error in pixels.

    ``shifts``: the (E, 2) fitted corrections from ``AlignResult``;
    ``planted``: the true per-exposure (dx, dy) errors from
    :func:`simulate_stack`. Only frame DIFFERENCES are compared —
    alignment is gauge-free (a common shift of all frames is
    unobservable).
    """
    sh = np.asarray(shifts)
    errs = []
    for i in range(len(planted)):
        for j in range(len(planted)):
            got = sh[i] - sh[j]
            want = (planted[j][0] - planted[i][0],
                    planted[j][1] - planted[i][1])
            errs.append(float(np.hypot(got[0] - want[0],
                                       got[1] - want[1])))
    return max(errs)


class SpawnedRanks:
    """``world`` processes running one Python program, one rank each.

    Rank r runs ``python -c code r world tcp://127.0.0.1:<port> *args``
    (the address for ``init_distributed``), with this package's checkout
    first on its ``PYTHONPATH``. The rendezvous store is served from this
    process on a port the system picks, as torchrun's agent serves it
    (``TORCHELASTIC_USE_AGENT_STORE``: every rank joins as a client), so
    runs started side by side never race for a port. Output goes to
    temporary files, so no pipe fills up and blocks a rank. The processes
    start at construction; :meth:`wait` collects them (a second call
    repeats the first one's outcome).
    """

    def __init__(self, code: str, world: int, args=()):
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, TORCHELASTIC_USE_AGENT_STORE="True")
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        self._store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                                    wait_for_workers=False)
        addr = f"tcp://127.0.0.1:{self._store.port}"
        self._outcome = None
        self._out = [(tempfile.TemporaryFile("w+"),
                      tempfile.TemporaryFile("w+")) for _ in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(world), addr,
             *map(str, args)], stdout=o, stderr=e, text=True, env=env)
            for r, (o, e) in enumerate(self._out)]

    def _read(self, r: int) -> tuple[str, str]:
        outs = []
        for f in self._out[r]:
            f.seek(0)
            outs.append(f.read())
        return outs[0], outs[1]

    def wait(self, timeout: float) -> list[str]:
        """Each rank's standard output, once every rank has exited with
        0. The first rank that fails, or ``timeout`` seconds, kills every
        rank and raises ``RuntimeError`` with their output."""
        if isinstance(self._outcome, RuntimeError):
            raise self._outcome
        if self._outcome is not None:
            return self._outcome
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in self.procs]
            failed = any(c not in (None, 0) for c in codes)
            late = time.monotonic() > deadline
            if failed or late:
                self._stop()
                logs = "\n".join(
                    f"--- rank {r} (exit {p.returncode}) ---\n{o}\n{e}"
                    for r, (p, (o, e)) in enumerate(
                        zip(self.procs, map(self._read,
                                            range(len(self.procs))))))
                self._close()
                self._outcome = RuntimeError(
                    ("a rank failed" if failed else
                     f"the ranks did not finish within {timeout} s")
                    + ":\n" + logs[-20000:])
                raise self._outcome
            if all(c == 0 for c in codes):
                self._outcome = [self._read(r)[0]
                                 for r in range(len(self.procs))]
                self._close()
                return self._outcome
            time.sleep(0.05)

    def _stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    def _close(self) -> None:
        for pair in self._out:
            for f in pair:
                f.close()
        self._store = None  # stops serving the rendezvous

    def kill(self) -> None:
        """Stop every rank that still runs (after :meth:`wait`, nothing)."""
        if self._outcome is None:
            self._stop()
            self._close()
