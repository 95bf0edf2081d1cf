"""loop.ms: mean of each window call's wall less its ``setup_s``, ms: the
fixed-point loop and the write-back of the corrections."""

from portbench.harness import mean


def read(run):
    v = mean(c["wall"] - c["setup_s"] for c in run.calls)
    return None if v is None else 1e3 * v
