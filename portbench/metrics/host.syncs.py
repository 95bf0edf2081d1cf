"""host.syncs: mean ``setup_breakdown['host_syncs']`` over the window's
calls that carry it: the program's reads from the device to the host and
its synchronizes, a call."""

from portbench.harness import mean


def read(run):
    return mean(c["breakdown"]["host_syncs"] for c in run.calls
                if "host_syncs" in c["breakdown"])
