"""catalog.ms: mean ``setup_breakdown['catalog']`` over the window's calls,
ms (the device finder; its table read back ends the span)."""

from portbench.harness import mean


def read(run):
    v = mean(c["breakdown"]["catalog"] for c in run.calls
             if "catalog" in c["breakdown"])
    return None if v is None else 1e3 * v
