"""loop.iterations: mean ``AlignResult.n_iterations`` over the window's
calls."""

from portbench.harness import mean


def read(run):
    return mean(c["n_iter"] for c in run.calls)
