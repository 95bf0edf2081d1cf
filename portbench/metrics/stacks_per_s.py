"""stacks_per_s: visits aligned over the whole window, which closes when
the call running at the deadline ends."""


def read(run):
    return len(run.calls) / run.window_s if run.calls else None
