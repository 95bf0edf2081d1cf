"""measure_displacement_roofline, %: kernel B3, the windowed correlation:
the least time of the traced calls' launches (their work counted from
the shapes each call took) over the device time of the traced operations
that match ``PATTERN``, from ``torch.profiler``."""

from portbench.roofline import b3_work, share, visit_sources

#: the kernel's demangled names in the profiler
PATTERN = r"\bmeasure_(fft|mixed)_kernel<"


def work(run, call):
    """Each launch measures the visit's sources: every exposure's pairs
    in batch, one exposure's in otf."""
    got = visit_sources(run, call)
    if got is None:
        return []
    n_src, cut = got
    settings = run.cell.traffic.get("align", {})
    E = call["G_M"].shape[1]    # the frames the call aligned
    rows = n_src if settings.get("wcsupdate", "batch") == "otf" \
        else E * n_src
    return [b3_work(rows, cut, int(settings.get("usfac", 1)),
                    int(settings.get("peak_fit_box", 5)))
            + (call["launches"]["measure_displacement"],)]


def read(run):
    return share(run, "measure_displacement_roofline", PATTERN, work)
