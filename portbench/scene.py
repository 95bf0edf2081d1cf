"""Frozen copy of subpixal_tpu_torch/testing.py: simulate_stack's draws
and _render_core, with the visit's dither pattern added.

Dithered star-field visits whose pixels carry planted pointing errors that
the header WCS does not know about. The star positions and the planted
shifts are ``simulate_stack``'s numpy draws, in its order, so a seed gives
the scene ``simulate_stack(seed=...)`` gives; the frames are rendered as
its device renderer does (noise from a ``torch.Generator`` seeded with the
stack's seed, then each star's Gaussian patch added), on any torch device,
and handed over as host float32 arrays, as frames read from FITS are.

The dither, which ``simulate_stack`` leaves out, is the configuration's
``dither_offsets_px``: exposure ``e`` takes point ``e`` modulo the
pattern's length, its stars sit that far from the first exposure's in
its pixels, and its header records the move (its ``crpix`` moves with
them); the planted error lies on top and is not recorded. Without the
key, every exposure points alike, as in ``simulate_stack``.

This copy is part of the benchmark's yardstick: it changes only with the
benchmark, never with the program.

A configuration names the module that renders its visits by its key
``"scene"`` (this one without it): a module under ``portbench/`` whose
``make_pool(config, seed, count, device)`` returns ``count`` visits, each
a :class:`Stack` that keeps this contract:

* ``frames``: one host float32 (H, W) array for each frame the program
  aligns; each chip of an exposure is a frame.
* ``planted``: (E, 2), one row a frame.
* ``crpix``: (E, 2), each frame's 0-based reference pixel; ``crval``
  (RA, Dec) and ``cd`` (2, 2), in degrees, shared by the frames.
* ``index``: the visit's place among a run's scenes (the last of a pool
  is the visit outside it); ``device_frames``: the card's copies of the
  frames, which the harness sets where the traffic hands them over
  there.
* ``files`` (optional): one ``(file name, EXTVER)`` a frame, the frames
  listed in file order, then chip order; without it, each frame is its
  own single-SCI file.
* ``err``, ``dq`` (optional): one ERR (float32) and one DQ (int16) plane
  a frame, which a file carries beside its SCI.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: the scene's fixed sky position (RA, Dec) in degrees
CRVAL = (150.0, 2.0)


@dataclasses.dataclass
class Stack:
    """One visit, as the contract above states it: host frames (E arrays
    of (H, W) float32), the planted per-frame pointing errors (E, 2) in
    pixels, the stars (S, 2) and each frame's TAN parameters (0-based
    crpix, crval, cd in degrees)."""

    frames: list
    planted: np.ndarray
    stars: np.ndarray
    crpix: np.ndarray    # (E, 2): each frame's, the dither recorded
    crval: np.ndarray
    cd: np.ndarray
    dither: np.ndarray   # (E, 2) pixels
    index: int = 0       # the scene's place among a run's scenes
    device_frames: list | None = None   # on the card, for traffic that
                                        # hands the frames over there
    files: list | None = None   # (file name, EXTVER) a frame
    err: list | None = None     # an ERR plane a frame
    dq: list | None = None      # a DQ plane a frame


def stack_seed(seed: int, index: int) -> int:
    """A 63-bit seed for stack ``index`` of a run seeded with ``seed``
    (any whole number, however large)."""
    ss = np.random.SeedSequence(entropy=abs(int(seed)),
                                spawn_key=(int(index), int(seed < 0)))
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def draw(seed: int, n_exp: int, shape, n_stars: int, shift_scale: float,
         star_box=None):
    """``simulate_stack``'s draws: star positions (S, 2) at least 40 px
    from every edge, or inside ``star_box`` = (x_lo, x_hi, y_lo, y_hi)
    where given, then one (dx, dy) planted error a frame, uniform in
    +-``shift_scale``."""
    rng = np.random.default_rng(seed)
    H, W = shape
    lo_x, hi_x, lo_y, hi_y = (star_box if star_box is not None
                              else (40, W - 40, 40, H - 40))
    stars = np.stack([rng.uniform(lo_x, hi_x, n_stars),
                      rng.uniform(lo_y, hi_y, n_stars)], 1)
    shifts = np.array([rng.uniform(-shift_scale, shift_scale, 2)
                       for _ in range(n_exp)])
    return stars, shifts


def render(stars, shifts, shape, amp: float, sigma: float, noise: float,
           seed: int, device, dither=None) -> torch.Tensor:
    """(E, H, W) float32 frames on ``device``: Gaussian noise from a
    ``torch.Generator`` seeded with ``seed``, then each star's (2R+1)^2
    patch at its integer center in the frame (the star moved by the
    frame's ``dither`` (E, 2), none when None), offset by its sub-pixel
    part plus the frame's planted shift, inside radius R - 1
    (``_render_core``)."""
    H, W = shape
    E = shifts.shape[0]
    R = max(int(np.ceil(4.5 * sigma)) + 2, 9)
    r_cut = float((R - 1) ** 2)
    pos = stars[None] + (np.zeros((E, 2)) if dither is None
                         else np.asarray(dither, np.float64))[:, None, :]
    cx = np.round(pos[..., 0]).astype(np.int64)       # (E, S)
    cy = np.round(pos[..., 1]).astype(np.int64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    frames = torch.randn((E, H, W), generator=gen, device=device,
                         dtype=torch.float32) * np.float32(noise)

    def dev(a, dt=torch.float32):
        return torch.as_tensor(a, device=device).to(dt)

    sh = dev(shifts.astype(np.float32))
    fx = dev((pos[..., 0] - cx).astype(np.float32))
    fy = dev((pos[..., 1] - cy).astype(np.float32))
    cxt, cyt = dev(cx, torch.int64), dev(cy, torch.int64)
    off = torch.arange(-R, R + 1, device=device)
    p = off.to(torch.float32)
    ddx = fx + sh[:, 0:1]
    ddy = fy + sh[:, 1:2]
    r2 = ((p[None, None, None, :] - ddx[..., None, None]) ** 2
          + (p[None, None, :, None] - ddy[..., None, None]) ** 2)
    rows = cyt[..., None] + off                       # (E, S, 2R+1)
    cols = cxt[..., None] + off
    inside = (((rows >= 0) & (rows < H))[..., :, None]
              & ((cols >= 0) & (cols < W))[..., None, :])
    patch = torch.where((r2 < r_cut) & inside,
                        np.float32(amp) * torch.exp(
                            -r2 / np.float32(2 * sigma * sigma)),
                        torch.zeros((), device=device))
    cell = (rows.clamp(0, H - 1)[..., :, None] * W
            + cols.clamp(0, W - 1)[..., None, :])
    flat = torch.arange(E, device=device)[:, None, None, None] * (H * W) \
        + cell
    frames.view(-1).index_add_(0, flat.reshape(-1), patch.reshape(-1))
    return frames


def dither_offsets(config: dict) -> np.ndarray:
    """(E, 2) pixel offsets of the configuration's exposures: its
    ``dither_offsets_px`` taken in turn, or none."""
    E = int(config["n_exposures"])
    pts = np.asarray(config.get("dither_offsets_px", [[0.0, 0.0]]),
                     np.float64).reshape(-1, 2)
    return pts[np.arange(E) % len(pts)]


def make_stack(config: dict, seed: int, device, index: int = 0) -> Stack:
    """One visit of ``config`` (a configuration file's contents) from
    ``seed`` (stars, planted errors and noise), rendered on ``device``
    and copied to host memory; ``index`` is its place among the
    scenes."""
    shape = tuple(config["shape"])
    a = config["assumed"]
    stars, shifts = draw(seed, config["n_exposures"], shape, a["n_sources"],
                         a["shift_scale_px"], a.get("star_box"))
    dither = dither_offsets(config)
    frames = render(stars, shifts, shape, a["psf_amplitude"],
                    a["psf_sigma_px"], a["noise"], seed, device, dither)
    host = frames.cpu().numpy()
    del frames
    H, W = shape
    s = config["pscale_arcsec"] / 3600.0
    return Stack(frames=[host[e] for e in range(host.shape[0])],
                 planted=shifts, stars=stars,
                 crpix=np.array([W / 2.0, H / 2.0]) + dither,
                 crval=np.array(CRVAL),
                 cd=s * np.array([[-1.0, 0.0], [0.0, 1.0]]), dither=dither,
                 index=index)


#: the seed of the pool's scenes, the same in every run
FIELDS = 0


def make_pool(config: dict, seed: int, count: int, device) -> list:
    """``count`` visits: every run has the same ``count`` scenes, scene k
    drawn whole (stars, planted errors, noise) from :func:`stack_seed`
    (:data:`FIELDS`, k), so the sources, their blends, the catalog's
    size, the cutout windows and the live blocks, and with them the work,
    the shapes the program captures and the memory it holds, are the same
    for every seed; the seed draws the order of the visits (the last
    stays last: the visit outside the pool)."""
    rng = np.random.default_rng(stack_seed(seed, count))
    order = list(rng.permutation(count - 1)) + [count - 1]
    return [make_stack(config, stack_seed(FIELDS, k), device, index=int(k))
            for k in order]
