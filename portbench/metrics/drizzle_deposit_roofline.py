"""drizzle_deposit_roofline, %: kernel B1, the drizzle deposit: the least
time of the traced calls' launches (their work counted from the shapes
each call took) over the device time of the traced operations that match
``PATTERN``, from ``torch.profiler``."""

from portbench.roofline import b1_work, share

#: the kernel's demangled name in the profiler
PATTERN = r"\bdeposit_tiles<"


def work(run, call):
    """One per-plane deposit of the whole frames at set-up (science
    planes only), then each of the loop's deposits: the live share of
    the input pixels, with weights, into one plane."""
    E = call["G_M"].shape[1]    # the frames the call aligned
    H, W = run.cell.config["shape"]
    n = call["launches"]["drizzle_deposit"]
    out = call["out_shape"]
    live = call["breakdown"].get("sparse_live_frac", 1.0)
    return [b1_work(E * H * W, E, out, weights=False) + (1,),
            b1_work(live * E * H * W, 1, out, weights=True) + (n - 1,)]


def read(run):
    return share(run, "drizzle_deposit_roofline", PATTERN, work)
