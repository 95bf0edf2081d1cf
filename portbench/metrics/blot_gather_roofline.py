"""blot_gather_roofline, %: kernel B2, the blot at the cutouts: the least
time of the traced calls' launches (their work counted from the shapes
each call took) over the device time of the traced operations that match
``PATTERN``, from ``torch.profiler``."""

from portbench.roofline import b2_work, share, visit_sources

#: the kernel's demangled names in the profiler (PyTorch's own
#: ``vectorized_gather_kernel`` is not B2)
PATTERN = r"\b(gather_kernel<|nearest_kernel\()"


def work(run, call):
    """Each launch blots the visit's sources: every exposure's in batch,
    one exposure's in otf, over footprints of the cutout's shape."""
    got = visit_sources(run, call)
    if got is None:
        return []
    n_src, cut = got
    settings = run.cell.traffic.get("align", {})
    E = call["G_M"].shape[1]    # the frames the call aligned
    rows = n_src if settings.get("wcsupdate", "batch") == "otf" \
        else E * n_src
    out = call["out_shape"]
    return [b2_work(rows, cut, n_src, out[0] * out[1],
                    settings.get("interp", "poly5"))
            + (call["launches"]["blot_gather"],)]


def read(run):
    return share(run, "blot_gather_roofline", PATTERN, work)
