"""setup.live_blocks_ms: mean ``setup_breakdown['sparse_blocks']`` over the
window's calls that carry it, ms (the sparse deposit's live-block search
and compaction)."""

from portbench.harness import mean


def read(run):
    v = mean(c["breakdown"]["sparse_blocks"] for c in run.calls
             if "sparse_blocks" in c["breakdown"])
    return None if v is None else 1e3 * v
