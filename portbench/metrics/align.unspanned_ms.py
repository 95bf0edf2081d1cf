"""align.unspanned_ms: mean ``setup_breakdown['align.unspanned']`` over the
window's calls that carry it, ms: the part of the ``align.call`` span that
its direct child spans leave unnamed."""

from portbench.harness import mean


def read(run):
    v = mean(c["breakdown"]["align.unspanned"] for c in run.calls
             if "align.unspanned" in c["breakdown"])
    return None if v is None else 1e3 * v
