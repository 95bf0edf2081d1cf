"""Synthetic dithered star-field stacks with planted pointing errors.

Counterpart of ``subpixal_tpu/testing.py`` (its host renderer, with the
same numpy random draws, so both packages build the same scene from one
seed; its device renderer, on a torch device) and
``pairwise_shift_errors``, used by the tests and by
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
import torch
import torch.distributed as dist

from .aot import get_executable
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
    star_box=None,
    device=None,
) -> tuple[list[Exposure], list[tuple[float, float]]]:
    """Dithered exposures whose DATA carry true sub-pixel offsets the
    header WCS does not know about (the alignment problem).

    Stars are painted patch-wise (a full-frame radius test per star
    costs minutes at 2k+ scales), at least 40 px from every edge, or
    inside ``star_box = (x_lo, x_hi, y_lo, y_hi)`` when given (e.g. a
    scene whose sparse-deposit live set engages).

    Returns ``(exposures, planted)`` with ``planted[e] = (dx, dy)`` the
    true per-exposure pointing error in pixels; only pairwise
    DIFFERENCES are recoverable (alignment is relative).

    ``device`` None (or False) renders on the host, as the JAX package's
    host renderer, draw for draw. A torch device (or its name) renders
    the whole stack on that device, and ``True`` on the current CUDA
    device (raising without one): the Gaussian patches scatter-added
    into the frames there, the noise from a ``torch.Generator`` on that
    device seeded with ``seed``, and the Exposures hold the frames as
    tensors there, so a following ``align_images`` or ``Drizzle`` copies
    no scene from the host. Star positions and planted shifts come from
    the same numpy draws in every mode, so ``planted`` is identical; the
    pixels differ by their noise (and the patches by float32 rounding:
    the device renders them in float32, the host in float64).
    """
    rng = np.random.default_rng(seed)
    H, W = shape
    cd = (pscale_as / 3600.0) * np.array([[-1.0, 0.0], [0.0, 1.0]])
    lo_x, hi_x, lo_y, hi_y = (star_box if star_box is not None
                              else (40, W - 40, 40, H - 40))
    stars = np.stack([rng.uniform(lo_x, hi_x, n_stars),
                      rng.uniform(lo_y, hi_y, n_stars)], 1)
    R = max(int(np.ceil(4.5 * sigma)) + 2, 9)
    pyy, pxx = np.mgrid[-R:R + 1, -R:R + 1].astype(np.float32)
    r_cut = (R - 1) ** 2
    exps, planted = [], []
    shifts = [tuple(rng.uniform(-shift_scale, shift_scale, 2))
              for _ in range(n_exp)]
    dev = _render_device(device)
    if dev is not None:
        frames = _render_stack_device(shape, stars, np.asarray(shifts),
                                      amp, sigma, noise, R, r_cut, seed,
                                      dev)
    for e in range(n_exp):
        dx, dy = shifts[e]
        planted.append((float(dx), float(dy)))
        if dev is not None:
            img = frames[e]
        else:
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


def _render_device(device) -> torch.device | None:
    """``simulate_stack``'s ``device``: None for a host render."""
    if device is None or device is False:
        return None
    if device is True:
        if not torch.cuda.is_available():
            raise ValueError("simulate_stack(device=True) renders on the "
                             "current CUDA device, and CUDA is not "
                             "available")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _render_stack_device(shape, stars, shifts, amp, sigma, noise, R, r_cut,
                         seed, device) -> torch.Tensor:
    """(E, H, W) float32 star-field frames rendered on ``device``: the star
    data copied there, then the program ``render_stack``
    (:func:`_render_core`, through ``aot.get_executable``), whose noise
    comes from a ``torch.Generator`` on ``device`` seeded with ``seed``."""
    cx = np.round(stars[:, 0]).astype(np.int64)
    cy = np.round(stars[:, 1]).astype(np.int64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    args = (gen, torch.as_tensor(shifts.astype(np.float32), device=device),
            torch.as_tensor((stars[:, 0] - cx).astype(np.float32),
                            device=device),
            torch.as_tensor((stars[:, 1] - cy).astype(np.float32),
                            device=device),
            torch.as_tensor(cx, device=device),
            torch.as_tensor(cy, device=device))
    statics = dict(E=int(shifts.shape[0]), H=int(shape[0]), W=int(shape[1]),
                   amp=float(amp), sigma=float(sigma), noise=float(noise),
                   R=int(R), r_cut=float(r_cut))
    return get_executable("render_stack", _render_core, args,
                          statics=statics)(*args)


def _render_core(gen, sh, fx, fy, cx, cy, *, E, H, W, amp, sigma, noise, R,
                 r_cut):
    """The program ``render_stack``, as the JAX package's device
    renderer: noise from ``gen``, then each star's (2R+1)^2 Gaussian patch
    (its sub-pixel offset ``fx``, ``fy`` plus the frame's planted shift
    ``sh``, in float32) added at its integer center ``cx``, ``cy`` into
    the flattened frames; a patch's cells off the frame add 0 (at a
    clamped cell), where the JAX package drops them."""
    device = sh.device
    frames = torch.randn((E, H, W), generator=gen, device=device,
                         dtype=torch.float32) * np.float32(noise)
    off = torch.arange(-R, R + 1, device=device)
    p = off.to(torch.float32)
    ddx = fx[None, :] + sh[:, 0:1]                       # (E, S)
    ddy = fy[None, :] + sh[:, 1:2]
    r2 = ((p[None, None, None, :] - ddx[..., None, None]) ** 2
          + (p[None, None, :, None] - ddy[..., None, None]) ** 2)
    rows = cy[:, None] + off[None]                       # (S, P)
    cols = cx[:, None] + off[None]
    inside = (((rows >= 0) & (rows < H))[:, :, None]
              & ((cols >= 0) & (cols < W))[:, None, :])      # (S, P, P)
    patch = torch.where((r2 < r_cut) & inside,
                        np.float32(amp) * torch.exp(
                            -r2 / np.float32(2 * sigma * sigma)),
                        torch.zeros((), device=device))  # (E, S, P, P)
    cell = (rows.clamp(0, H - 1)[:, :, None] * W
            + cols.clamp(0, W - 1)[:, None, :])              # (S, P, P)
    flat = (torch.arange(E, device=device)[:, None, None, None] * (H * W)
            + cell[None])                                    # (E, S, P, P)
    frames.view(-1).index_add_(0, flat.reshape(-1), patch.reshape(-1))
    return frames


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


#: appended to every rank program: the ranks leave the group together
_LEAVE_GROUP = """
import torch.distributed as _dist
if _dist.is_initialized():
    _dist.barrier()
    _dist.destroy_process_group()
"""


class SpawnedRanks:
    """``world`` processes running one Python program, one rank each.

    Rank r runs ``python -c code r world tcp://127.0.0.1:<port> *args``
    (the address for ``init_distributed``), with this package's checkout
    first on its ``PYTHONPATH``. The rendezvous store is served from this
    process on a port the system picks, as torchrun's agent serves it
    (``TORCHELASTIC_USE_AGENT_STORE``: every rank joins as a client), so
    runs started side by side never race for a port. Output goes to
    temporary files, so no pipe fills up and blocks a rank. The program
    ends with every rank leaving the process group together (a barrier,
    then ``destroy_process_group``): a rank that exits while another
    still tears its gloo group down can abort the other ("terminate
    called without an active exception"). The processes start at
    construction; :meth:`wait` collects them (a second call repeats the
    first one's outcome).
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
        code = code + _LEAVE_GROUP
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
