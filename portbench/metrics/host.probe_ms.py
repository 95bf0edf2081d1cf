"""host.probe_ms: median ms of a fixed host workload (float64 numpy and a
Python loop), the mean of its readings before and after the window: the
host's speed while the run ran, read beside ``stacks_per_s``."""


def read(run):
    return run.host_probe_ms
