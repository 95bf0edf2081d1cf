"""writeback.ms: mean ``setup_breakdown['align.writeback']`` over the
window's calls that carry it, ms (the corrections read back, the WCSs
updated, the final Drizzle built)."""

from portbench.harness import mean


def read(run):
    v = mean(c["breakdown"]["align.writeback"] for c in run.calls
             if "align.writeback" in c["breakdown"])
    return None if v is None else 1e3 * v
