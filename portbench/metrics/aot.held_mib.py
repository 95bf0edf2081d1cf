"""aot.held_mib: MiB the program's cached setup programs hold at the
window's end (the sum of their ``nbytes``)."""


def read(run):
    return run.aot_held_bytes / 2 ** 20 if run.aot_held_bytes else None
