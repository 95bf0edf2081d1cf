"""What the benchmark reads from a ``torch.profiler`` trace of its window:
the device's busy seconds (the union of every interval in which an
operation ran on the card), every device operation's seconds and count by
its name (a metric's reader picks its kernels from these by a pattern of
its own), the operations that took most device time, and the idle gaps by
what the host was doing meanwhile."""

from __future__ import annotations

import re

import numpy as np


def _union(starts, ends):
    """Merged [start, end) intervals (sorted by start)."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    out_s, out_e = [], []
    cur_s, cur_e = None, None
    for a, b in zip(s.tolist(), e.tolist()):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                out_s.append(cur_s)
                out_e.append(cur_e)
            cur_s, cur_e = a, b
        elif b > cur_e:
            cur_e = b
    if cur_e is not None:
        out_s.append(cur_s)
        out_e.append(cur_e)
    return np.array(out_s, np.int64), np.array(out_e, np.int64)


#: the harness's span around the traced calls
WINDOW = "portbench.window"


def summarize(prof) -> dict:
    """The trace of ``prof`` inside its :data:`WINDOW` span: ``busy_s``,
    ``window_s``, ``ops`` (every device operation's name -> [device
    seconds, count]), ``device_ops`` and ``idle_gaps`` (at most 10
    [name, seconds] each)."""
    events = prof.profiler.kineto_results.events()
    span = [ev for ev in events if ev.name() == WINDOW]
    if not span:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    t0_ns = span[0].start_ns()
    t1_ns = t0_ns + span[0].duration_ns()
    dev_name, dev_s, dev_e = [], [], []
    cpu_name, cpu_s, cpu_e = [], [], []
    for ev in events:
        # record_function spans show on the device's timeline too: they
        # are the host's marks, not device work
        if ev.name() == WINDOW or ev.is_user_annotation():
            continue
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if e <= t0_ns or s >= t1_ns:
            continue
        if ev.device_type().name == "CUDA":
            dev_name.append(ev.name())
            dev_s.append(s)
            dev_e.append(e)
        else:
            cpu_name.append(ev.name())
            cpu_s.append(s)
            cpu_e.append(e)
    window_s = (t1_ns - t0_ns) * 1e-9
    out = dict(window_s=window_s, busy_s=0.0, ops={}, device_ops=[],
               idle_gaps=[])
    if not dev_s:
        return out
    ds = np.clip(np.array(dev_s, np.int64), t0_ns, t1_ns)
    de = np.clip(np.array(dev_e, np.int64), t0_ns, t1_ns)
    ms, me = _union(ds, de)
    out["busy_s"] = float((me - ms).sum()) * 1e-9
    dur = (de - ds) * 1e-9
    ops = out["ops"]
    for n, d in zip(dev_name, dur.tolist()):
        o = ops.setdefault(n, [0.0, 0])
        o[0] += d
        o[1] += 1
    out["device_ops"] = [[n[:200], o[0]] for n, o in sorted(
        ops.items(), key=lambda kv: -kv[1][0])[:10]]
    # idle gaps: between merged busy intervals, and at the window's ends
    gs = np.concatenate([[t0_ns], me])
    ge = np.concatenate([ms, [t1_ns]])
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    cs = np.array(cpu_s, np.int64)
    ce = np.array(cpu_e, np.int64)
    cl = ce - cs
    idle: dict = {}
    for a, b in zip(gs.tolist(), ge.tolist()):
        mid = (a + b) // 2
        cover = np.nonzero((cs <= mid) & (ce >= mid))[0] if cs.size else []
        name = ("host (no torch call)" if len(cover) == 0
                else cpu_name[int(cover[np.argmin(cl[cover])])])
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-9
    out["idle_gaps"] = [[n[:200], s] for n, s in sorted(
        idle.items(), key=lambda kv: -kv[1])[:10]]
    return out


def kernel(trace: dict | None, pattern: str) -> tuple[float, int] | None:
    """(device seconds, count) of the traced operations whose name
    matches ``pattern`` (a regular expression), or None where none ran."""
    if not trace:
        return None
    hits = [o for n, o in trace["ops"].items() if re.search(pattern, n)]
    if not hits:
        return None
    return float(sum(o[0] for o in hits)), int(sum(o[1] for o in hits))
