"""Named setup programs as CUDA graphs, captured once per shape.

Counterpart of ``subpixal_tpu/aot.py``. The JAX package compiles each of
its named setup programs (the stacked deposit, the cutout pixmaps, the
staging, the device finder's programs, the scene renderer) once per
shape and static arguments, keeps the executable in an in-memory LRU and,
on accelerators, serialises it to disk for the next process. The port
keeps the in-memory half. On CUDA tensors :func:`get_executable` returns
an executable whose first call runs the program eagerly on a side stream
(its answer, and the warm-up a capture needs: the kernels' builds, the
cached constants, plans and allocator blocks), then captures it as CUDA
graphs on static input buffers; each later call copies its arguments into
those buffers, replays, and returns copies of the outputs. On CPU tensors
it returns the plain function with its statics bound. A CUDA graph is
bound to its process and cannot be serialised, so nothing of it is
written to disk: what outlives a process is the kernels' builds, under
:func:`aot_dir`.

A program is a function of tensors and keyword statics that reads
nothing from the host. Where it must wait on its data, as a flood fill
run to its fixed point, it calls :func:`repeat_until`: eagerly a host
loop with one read a block, and in a captured program a graph of its own
that the executable replays until the flag holds, between the graphs of
the program's other parts.

The align loop (``align._fixed_point``) captures its masked step with the
same helpers: :func:`warm_up` runs a real, counted first call on the side
stream, :func:`capture_graph` records a graph and the kernels' launches
it holds, and :meth:`Captured.replay` adds those launches to
``kernels.LAUNCHES`` at every replay (a replay calls no kernel wrapper),
so the counts always equal the kernels the card ran.

The cache holds at most ``_MEM_MAX`` executables and, on each card, at
most ``_MEM_MAX_SHARE`` of its memory in the programs' static inputs and
graph pools (outputs included); past either limit the oldest go. An
evicted program's graphs and buffers are freed; PyTorch's allocator
returns a freed graph pool to the card at its next failed allocation or
``torch.cuda.empty_cache()``.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import threading
import warnings
from typing import Any

import torch

from . import _precision
from .kernels import LAUNCHES
from .tracing import recording, span, synchronize, to_host

__all__ = ["code_fingerprint", "aot_dir", "aot_enabled", "get_executable"]

_PKG = os.path.dirname(os.path.abspath(__file__))


@functools.lru_cache(maxsize=1)
def code_fingerprint() -> str:
    """Content hash of the package's sources (``.py``, ``.cu``, ``.cpp``):
    a change to any of them keys every program anew."""
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(_PKG)):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "build"))
        for fname in sorted(filenames):
            if fname.endswith((".py", ".cu", ".cpp")):
                h.update(fname.encode())
                with open(os.path.join(dirpath, fname), "rb") as f:
                    h.update(f.read())
    return h.hexdigest()[:16]


def aot_dir() -> str:
    """The directory of what outlives a process: the kernels' builds
    (``kernels._build``), ``SUBPIXAL_TPU_AOT_DIR`` when set, else the
    package's ``build/``. No captured program is ever written there (a
    CUDA graph cannot be serialised)."""
    d = os.environ.get("SUBPIXAL_TPU_AOT_DIR") or os.path.join(_PKG,
                                                              "build")
    os.makedirs(d, exist_ok=True)
    return d


def aot_enabled() -> bool:
    """Whether :func:`get_executable` captures programs on CUDA.

    ``SUBPIXAL_TPU_AOT_LOOP`` is the JAX package's switch, with another
    meaning here: there it decides only whether executables are written to
    disk (its programs are compiled either way); here, where nothing is
    written to disk, ``0``/``false``/``off`` runs every program eagerly
    (the executable is the plain function) and ``1``/``true``/``on``
    captures. By default it is on where CUDA is available."""
    v = os.environ.get("SUBPIXAL_TPU_AOT_LOOP", "").lower()
    if v in ("0", "false", "off"):
        return False
    if v in ("1", "true", "on"):
        return True
    return torch.cuda.is_available()


#: key -> executable, oldest first (the JAX package's in-memory LRU)
_MEM: dict = {}
_MEM_MAX = 64
#: the share of a card's memory that the cached programs may hold
_MEM_MAX_SHARE = 0.25

#: one side stream a device for the warm-ups and captures (the programs'
#: and the align loop's), kept so that the allocator's blocks cached for
#: it serve later calls
_SIDE_STREAMS: dict = {}


def side_stream(dev: torch.device) -> torch.cuda.Stream:
    """The kept side stream of CUDA device ``dev``."""
    s = _SIDE_STREAMS.get(dev)
    if s is None:
        s = _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
    return s


# --------------------------------------------------------------------- #
# argument trees: tuples, lists and dicts of tensors, generators and
# other leaves
# --------------------------------------------------------------------- #

def _flatten(tree, leaves: list):
    """The leaves of ``tree`` appended to ``leaves``; returns a function
    that rebuilds the tree from an iterator of new leaves."""
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(t, leaves) for t in tree]
        kind = type(tree)
        return lambda it: kind(p(it) for p in parts)
    if isinstance(tree, dict):
        parts = {k: _flatten(v, leaves) for k, v in tree.items()}
        return lambda it: {k: p(it) for k, p in parts.items()}
    leaves.append(tree)
    return lambda it: next(it)


def _leaf_sig(a):
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), str(a.dtype), str(a.device))
    if isinstance(a, torch.Generator):
        return ("generator", str(a.device))
    return repr(a)


def _key(name: str, leaves, statics, key_extra) -> str:
    raw = repr((name, torch.__version__, code_fingerprint(),
                _precision.matmul_precision(),
                tuple(_leaf_sig(a) for a in leaves),
                repr(sorted(statics.items())), key_extra))
    return hashlib.sha256(raw.encode()).hexdigest()[:32]


def _device(leaves) -> torch.device | None:
    for a in leaves:
        if isinstance(a, (torch.Tensor, torch.Generator)):
            return a.device
    return None


# --------------------------------------------------------------------- #
# warm-up and capture (the programs' and the align loop's)
# --------------------------------------------------------------------- #

@dataclasses.dataclass
class Captured:
    """One captured graph and the kernels' launches one replay of it
    makes; with ``done`` (a one-element flag the graph sets) it is a
    :func:`repeat_until` block, replayed until the flag holds (at most
    ``max_blocks`` times), with one host read a replay."""

    graph: Any
    launches: dict
    done: torch.Tensor | None = None
    max_blocks: int | None = None

    def replay(self) -> int:
        """Replay (a block until its flag holds), adding the graph's
        launches to ``kernels.LAUNCHES`` each time; returns the host
        reads made."""
        n = 0
        while True:
            self.graph.replay()
            for k, c in self.launches.items():
                LAUNCHES[k] += c
            n += 1
            if self.done is None:
                return 0
            if n == self.max_blocks or bool(to_host(self.done)):
                return n


class _Capturing:
    """A capture begun on the current stream, into ``pool`` (None: the
    graph's own), drawing from ``generators`` besides the device's default
    one. ``end()`` returns the :class:`Captured` graph; the wrapper calls
    made in between are the graph's launches, not the card's, so they
    leave ``kernels.LAUNCHES`` as it was."""

    def __init__(self, pool=None, generators=()):
        self.generators = tuple(generators)
        self.graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            self.graph.register_generator_state(gen)
        self.before = dict(LAUNCHES)
        # capture_begin/end, not torch.cuda.graph: that context also
        # collects garbage and empties the allocator's cache.
        # thread_local: the CUDA calls of other threads (NCCL's watchdog
        # queries its events) do not end this capture
        self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")

    def end(self, done=None, max_blocks=None) -> Captured:
        try:
            end_capture(self.graph, self.generators)
        finally:
            launches = {k: LAUNCHES[k] - n for k, n in self.before.items()}
            LAUNCHES.update(self.before)
        return Captured(self.graph, launches, done, max_blocks)


def end_capture(graph, generators=()) -> None:
    """``graph.capture_end()``. A capture that failed raises there, before
    PyTorch ends the capture state of the generators the graph draws from
    (the device's default one, and ``generators``); a state left so
    refuses every later draw ("Offset increment outside graph capture").
    So on a failure an empty capture of the same generators (on the
    current stream, the failed capture's) ends them first, then the error
    propagates."""
    try:
        graph.capture_end()
    except BaseException:
        empty = torch.cuda.CUDAGraph()
        for gen in generators:
            empty.register_generator_state(gen)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the empty graph's warning
            empty.capture_begin(capture_error_mode="thread_local")
            empty.capture_end()
        raise


def warm_up(fn, dev: torch.device):
    """``fn()`` run eagerly on ``dev``'s side stream after the work queued
    on the current stream, and waited for, so that nothing is in flight
    when a capture begins. It is a real call: its launches count, and
    what it returns is its answer (each tensor kept alive for the current
    stream's use)."""
    cur = torch.cuda.current_stream(dev)
    side = side_stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    synchronize(dev)
    leaves: list = []
    _flatten(out, leaves)
    for t in leaves:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            t.record_stream(cur)
    return out


def capture_graph(fn, dev: torch.device) -> Captured:
    """``fn()`` captured as one CUDA graph, in a pool of its own, on
    ``dev``'s side stream (see :class:`_Capturing`). A capture that fails
    raises; nothing of it stays."""
    with torch.cuda.stream(side_stream(dev)):
        c = _Capturing()
        try:
            fn()
        finally:
            cap = c.end()
    return cap


_RECORDING = threading.local()


def repeat_until(block, done: torch.Tensor, max_blocks: int | None = None):
    """Run ``block()`` until ``done`` (a one-element tensor that the block
    sets, on the block's device) holds, or ``max_blocks`` times: one host
    read of ``done`` a block. ``block`` updates its state in place.

    Inside a program that :func:`get_executable` captures, the program's
    graph ends here, ``block`` becomes a graph of its own that each call
    replays until ``done`` holds, and the next graph begins: the state the
    block works on must be tensors made before this call."""
    rec = getattr(_RECORDING, "rec", None)
    if rec is None:
        n = 0
        while True:
            block()
            n += 1
            if n == max_blocks or bool(to_host(done)):
                return
    rec.split(block, done, max_blocks)


class _Recorder:
    """Captures a program as a sequence of graphs in one pool, split at
    each :func:`repeat_until`."""

    def __init__(self, generators):
        self.pool = torch.cuda.graph_pool_handle()
        self.generators = generators
        self.steps: list[Captured] = []
        self.open = _Capturing(self.pool, generators)

    def close(self, done=None, max_blocks=None):
        c, self.open = self.open, None
        if c is not None:
            self.steps.append(c.end(done, max_blocks))

    def split(self, block, done, max_blocks):
        self.close()
        self.open = _Capturing(self.pool, self.generators)
        block()
        self.close(done, max_blocks)
        self.open = _Capturing(self.pool, self.generators)


def _static_like(a):
    if isinstance(a, torch.Tensor):
        return torch.empty(a.shape, dtype=a.dtype, device=a.device)
    if isinstance(a, torch.Generator):
        g = torch.Generator(device=a.device)
        g.set_state(a.get_state())
        return g
    return a


class _Program:
    """A program on a card: uncaptured until its first call, which runs it
    eagerly and then captures it; after that its static inputs, its
    graphs in order, the static outputs they leave, and the generators
    they draw from."""

    def __init__(self, name, fn, statics, key, timings):
        self.name, self.fn, self.statics = name, fn, statics
        self.key = key
        self.timings = timings        # the miss's, for the compile time
        self.inputs: list = []        # static leaves (tensors, generators)
        self.steps: list[Captured] = []
        self.out_leaves: list = []
        self.rebuild = None
        self.nbytes = 0               # static inputs and graph pool
        self.dev = None
        self.host_reads = 0           # repeat_until reads over all calls

    @property
    def launches(self) -> dict:
        """Each kernel's launches in one replay (a repeat_until block's
        counted once)."""
        out = {k: 0 for k in LAUNCHES}
        for s in self.steps:
            for k, c in s.launches.items():
                out[k] += c
        return out

    def __call__(self, *args):
        if self.rebuild is None:
            with recording(self.timings), span(f"{self.name}.compile"):
                out = self._first_call(args)
            self.timings = None
            return out
        leaves: list = []
        _flatten(args, leaves)
        own = []
        for dst, src in zip(self.inputs, leaves):
            if isinstance(dst, torch.Generator):
                dst.set_state(src.get_state())
                own.append((dst, src))
            elif isinstance(dst, torch.Tensor):
                dst.copy_(src)
        for s in self.steps:
            self.host_reads += s.replay()
        for dst, src in own:  # the callers' generators advance as eagerly
            src.set_state(dst.get_state())
        return self.rebuild(iter(
            o.clone() if isinstance(o, torch.Tensor) else o
            for o in self.out_leaves))

    def _first_call(self, args):
        """Run the program eagerly (this call's answer), then capture it;
        a capture that fails raises and leaves the program out of the
        cache."""
        leaves: list = []
        rebuild = _flatten(args, leaves)
        dev = _device(leaves)
        gens = [a for a in leaves if isinstance(a, torch.Generator)]
        try:
            if gens and not hasattr(torch.cuda.CUDAGraph,
                                    "register_generator_state"):
                raise RuntimeError(f"{self.name}: this PyTorch cannot "
                                   "capture draws from a torch.Generator")
            out = warm_up(lambda: self.fn(*args, **self.statics), dev)
            inputs = [_static_like(a) for a in leaves]
            nbytes = sum(a.nbytes for a in inputs
                         if isinstance(a, torch.Tensor))
            reserved = torch.cuda.memory_reserved(dev)
            with torch.cuda.stream(side_stream(dev)):
                rec = _Recorder([a for a in inputs
                                 if isinstance(a, torch.Generator)])
                _RECORDING.rec = rec
                try:
                    static_out = self.fn(*rebuild(iter(inputs)),
                                         **self.statics)
                finally:
                    _RECORDING.rec = None
                    rec.close()
        except BaseException:
            if _MEM.get(self.key) is self:
                del _MEM[self.key]
            raise
        self.inputs, self.steps = inputs, rec.steps
        self.rebuild = _flatten(static_out, self.out_leaves)
        # a fresh pool's blocks are all new segments
        self.nbytes = nbytes + torch.cuda.memory_reserved(dev) - reserved
        self.dev = dev
        _evict()
        return out


def get_executable(name: str, fn, arg_shapes: tuple, *,
                   statics: dict | None = None, key_extra=(),
                   timings: dict | None = None):
    """The executable of ``fn(*arg_shapes, **statics)``, called as
    ``exe(*args)`` with arguments of the same shapes (the statics are
    bound).

    ``arg_shapes`` is a tuple of arguments (tensors, tuples, lists or
    dicts of them, ``torch.Generator`` objects and other leaves); each
    tensor's shape, dtype and device key the executable, with ``name``,
    the sorted ``statics``, ``key_extra``, the package's source
    fingerprint and the matmul precision (TF32 on or off). Executables are
    kept in an in-memory LRU (see the module's docstring for its limits).

    On a CUDA device (with :func:`aot_enabled`), a miss returns a program
    whose first call runs ``fn`` eagerly on a side stream, returns that
    run's outputs, and captures ``fn`` as CUDA graphs on static input
    buffers (split at each :func:`repeat_until`), recording the span
    ``{name}.compile`` (seconds of that call: the eager run and the
    capture) in the current record (:mod:`~subpixal_tpu_torch.tracing`)
    and in ``timings``. A later call copies its arguments into the buffers
    (a generator's state into the program's own, and back after),
    replays, and returns new tensors: copies of the outputs, never views
    that a later call overwrites. A capture that fails raises and caches
    nothing; there is no eager fallback. Elsewhere the executable is
    ``fn`` with ``statics`` bound, and the miss's time is the span.

    Code that patches a function a program calls must clear ``_MEM``: a
    program captured before the patch replays the old function.
    """
    statics = dict(statics or {})
    leaves: list = []
    _flatten(tuple(arg_shapes), leaves)
    key = _key(name, leaves, statics, key_extra)
    hit = _MEM.get(key)
    if hit is not None:
        _MEM[key] = _MEM.pop(key)  # LRU refresh
        return hit
    dev = _device(leaves)
    if dev is not None and dev.type == "cuda" and aot_enabled():
        exe = _Program(name, fn, statics, key, timings)
    else:
        with recording(timings), span(f"{name}.compile"):
            exe = functools.partial(fn, **statics)
    _MEM[key] = exe
    _evict()
    return exe


def ensure_captured(exe, *args) -> None:
    """Give ``exe`` its first call on ``args`` where it is a program on a
    card that has not had one, so that it is captured ahead of its use
    (what the JAX package's ahead-of-time compile does); an executable
    that is captured already, or a plain function, is not run."""
    if isinstance(exe, _Program) and exe.rebuild is None:
        exe(*args)


def _evict() -> None:
    """Drop the oldest executables while the cache holds more than
    ``_MEM_MAX`` of them, or its programs on one card more than
    ``_MEM_MAX_SHARE`` of its memory (the newest is always kept)."""
    while len(_MEM) > _MEM_MAX:
        _MEM.pop(next(iter(_MEM)))
    held: dict = {}
    for e in _MEM.values():
        if getattr(e, "nbytes", 0):
            held[e.dev] = held.get(e.dev, 0) + e.nbytes
    for dev, n in held.items():
        cap = _MEM_MAX_SHARE * torch.cuda.get_device_properties(
            dev).total_memory
        for k in list(_MEM)[:-1]:
            if n <= cap:
                break
            e = _MEM[k]
            if getattr(e, "nbytes", 0) and e.dev == dev:
                n -= e.nbytes
                del _MEM[k]
