"""align.setup_ms: mean ``AlignResult.setup_s`` over the window's calls,
ms (the program's own span of its set-up, before the loop)."""

from portbench.harness import mean


def read(run):
    v = mean(c["setup_s"] for c in run.calls)
    return None if v is None else 1e3 * v
