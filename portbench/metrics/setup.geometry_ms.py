"""setup.geometry_ms: mean ``setup_breakdown['align.geometry']`` over the
window's calls that carry it, ms (the set-up's host geometry: the cutout
shape and windows, the predicted positions, the f64 Jacobians or pixmaps,
the corner bboxes)."""

from portbench.harness import mean


def read(run):
    v = mean(c["breakdown"]["align.geometry"] for c in run.calls
             if "align.geometry" in c["breakdown"])
    return None if v is None else 1e3 * v
