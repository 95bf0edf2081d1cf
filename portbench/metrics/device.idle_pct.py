"""device.idle_pct: 100 x (1 - the union of the device's operation
intervals over the traced window's wall), from ``torch.profiler``."""


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
