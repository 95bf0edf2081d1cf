"""loop.span_ms: mean ``setup_breakdown['align.loop']`` over the window's
calls that carry it, ms (the program's span of its loop entries, the
sparse heals included)."""

from portbench.harness import mean


def read(run):
    v = mean(c["breakdown"]["align.loop"] for c in run.calls
             if "align.loop" in c["breakdown"])
    return None if v is None else 1e3 * v
