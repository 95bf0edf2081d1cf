"""resample.h2d_ms: mean ``setup_breakdown['resample.h2d_stack']`` over the
window's calls, ms (the frames' host-to-device copy; pageable, so the
span ends with the copy)."""

from portbench.harness import mean


def read(run):
    v = mean(c["breakdown"]["resample.h2d_stack"] for c in run.calls
             if "resample.h2d_stack" in c["breakdown"])
    return None if v is None else 1e3 * v
