"""Spans and counters of one ``align_images`` call.

A *record* is the dict a call's spans and counters write into:
``align_images`` makes its ``setup_breakdown`` the current record for the
duration of the call (:func:`recording`), so code deeper down
(``Drizzle.execute``, the device finder, ``aot``) records into it without
a dict being passed. With no current record :func:`span` and
:func:`count` do nothing.

* :class:`span` stores the host seconds of a stage under its name
  (``time.perf_counter``); a repeated name accumulates, and an exception
  inside the span still closes it. A span given a CUDA ``device`` also
  records a pair of CUDA timing events on that device's current stream
  (none while the stream is capturing a graph, nor under a record that
  keeps no events); :func:`read_device` turns the pairs into
  ``<name>.device``, the device-timeline seconds between the two events,
  once the call's last host read has passed them, so it adds no
  synchronize.
  While ``torch.profiler`` is on, every span is also a
  ``record_function`` range of its name, on the profiler's clock beside
  the device's kernels.
* :func:`count` adds to a counter: :data:`HOST_SYNCS` counts the reads
  from a tensor to the host (:func:`to_host`) and the synchronizes
  (:func:`synchronize`) on the call's path.

A record opened inside another (``Drizzle.execute``'s inside
``align_images``) writes into both: its own dict gets each name with
``strip`` taken off its front, the outer one the whole name. Spans nest
across the records: a span's ``rest`` key gets the part of its time that
its direct child spans leave uncovered.
"""

from __future__ import annotations

import contextlib
import contextvars
import time

import torch

__all__ = ["HOST_SYNCS", "count", "read_device", "recording", "span",
           "synchronize", "to_host"]

#: the counter of host reads and synchronizes
HOST_SYNCS = "host_syncs"

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "subpixal_tpu_torch_record", default=None)


class _Record:
    """One dict written into, the record it is nested in (None at the
    top), and what the nest shares: the open spans and the device events
    (None where the top record keeps none)."""

    __slots__ = ("out", "strip", "parent", "open", "events")

    def __init__(self, out: dict, strip: str, parent, events: bool):
        self.out, self.strip, self.parent = out, strip, parent
        self.open = [] if parent is None else parent.open
        self.events = ([] if events else None) if parent is None \
            else parent.events

    def chain(self):
        r = self
        while r is not None:
            yield r
            r = r.parent

    def add(self, name: str, v) -> None:
        for r in self.chain():
            k = name[len(r.strip):] if r.strip and name.startswith(
                r.strip) else name
            r.out[k] = r.out.get(k, 0) + v


@contextlib.contextmanager
def recording(out: dict | None, *, strip: str = "",
              device_events: bool = False):
    """Make ``out`` the current record inside the ``with`` block (nested
    in the current one, if any). ``device_events`` lets a top record keep
    its device spans' events for :func:`read_device`. ``out`` None opens
    nothing."""
    if out is None:
        yield
        return
    token = _CURRENT.set(_Record(out, strip, _CURRENT.get(), device_events))
    try:
        yield
    finally:
        _CURRENT.reset(token)


class span:
    """``with span(name):`` records the host seconds of its block under
    ``name`` in the current record (see the module's docstring); with
    ``device`` a CUDA device, its device time too, and with ``rest`` a
    key, the time its direct child spans leave uncovered. ``open()`` and
    ``close()`` do the same for a stretch of straight-line code; a span
    left open is closed by the enclosing span's close, so an exception
    that skips ``close()`` still closes it."""

    __slots__ = ("name", "device", "rest", "rec", "t0", "child", "ev",
                 "stream", "rf")

    def __init__(self, name: str, device=None, rest: str | None = None):
        self.name, self.device, self.rest = name, device, rest
        self.rec = None

    def open(self) -> "span":
        rec = self.rec = _CURRENT.get()
        if rec is None:
            return self
        self.rf = self.ev = None
        if torch.autograd.profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        if (self.device is not None and rec.events is not None
                and torch.device(self.device).type == "cuda"):
            self.stream = torch.cuda.current_stream(self.device)
            self.ev = _event(self.stream)
        self.child = 0.0
        rec.open.append(self)
        self.t0 = time.perf_counter()
        return self

    def close(self) -> None:
        rec, self.rec = self.rec, None
        if rec is None or self not in rec.open:
            return
        while rec.open[-1] is not self:  # spans an exception left open
            rec.open[-1].close()
        t = time.perf_counter() - self.t0
        rec.open.pop()
        if rec.open:
            rec.open[-1].child += t
        rec.add(self.name, t)
        if self.rest is not None:
            rec.add(self.rest, t - self.child)
        if self.ev is not None:
            end = _event(self.stream)
            if end is not None:
                rec.events.append((self.name, self.ev, end))
        if self.rf is not None:
            self.rf.__exit__(None, None, None)

    def __enter__(self) -> "span":
        return self.open()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def _event(stream):
    """A timing event recorded on ``stream``, or None while the current
    stream is capturing a graph."""
    if torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` of the current record."""
    rec = _CURRENT.get()
    if rec is not None:
        rec.add(name, n)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``, counted under :data:`HOST_SYNCS` (from a card, a read
    that waits for the work queued before it)."""
    count(HOST_SYNCS)
    return t.cpu()


def synchronize(device) -> None:
    """``torch.cuda.synchronize(device)``, counted under
    :data:`HOST_SYNCS`."""
    count(HOST_SYNCS)
    torch.cuda.synchronize(device)


def read_device() -> None:
    """Add each device span's event pair of the current record to
    ``<name>.device`` (seconds) and forget the pairs. Call it after a
    host read that follows every pair's end event on its stream: an end
    event still pending is waited for, and counted as a synchronize."""
    rec = _CURRENT.get()
    if rec is None or not rec.events:
        return
    for name, a, b in rec.events:
        if not b.query():
            count(HOST_SYNCS)
            b.synchronize()
        rec.add(name + ".device", 1e-3 * a.elapsed_time(b))
    rec.events.clear()
