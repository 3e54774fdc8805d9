"""The port's tracer: spans and counters at its layer boundaries, profiler
traces reduced to them, and a NaN/Inf guard.

- **Spans.** ``with span("fusionnet"):`` marks a layer boundary. Tracing
  is off unless :func:`enabled` or :func:`trace` turns it on for a block;
  off, a span is one check of a module global that returns a shared no-op
  context manager (no allocation, no clock read, no torch call). On, a
  span records its name, its start and end (``time.perf_counter_ns``),
  the index of its parent span and the chunk it belongs to; with
  ``labels`` it is also a ``torch.profiler.record_function`` range named
  ``sf:<name>``, so a profiler's trace holds it on the kernels' clock.
  A chunk is one request (one ``Pipeline._fuse_rows`` or
  ``train_sequence_rows`` call), numbered in order (:func:`chunk`); every
  span inside it carries its number. Spans stay in memory
  (:attr:`Tracer.spans`, :meth:`Tracer.summary`); the tracer never
  synchronises the device nor reads a value back from it. Spans are
  opened on one thread at a time.
- **Counters** (host integers): ``frames`` (real frames handed in, the
  padding of ``frame_block`` left out), ``blocks``, ``chunks``; through
  :func:`count`, made at the first count, ``<x>.eager``,
  ``<x>.captures`` and ``<x>.replays`` for ``x`` = ``fusionnet`` (the
  folded executor, ``models/fusionnet_fast.FastV3``) and ``adapnet``
  (the segmenter, ``models/adapnet.SegmenterAdapter``): their calls that
  ran eager, their CUDA graph captures, and their calls that replayed
  one (``models/cuda_graphs.py``). Off, a count is one check of the
  module global, as a span is.
- :func:`reduce_profile` reduces a ``torch.profiler`` trace taken with
  labels to numbers per span name: the host's launch calls (kernel
  launches, async copies and sets; a graph launch once), the device time
  of the work they launched, and the device's idle gaps, each put down to
  the innermost span open on the host when the device woke.
- :func:`trace` runs ``torch.profiler`` (CPU and, where torch sees a card,
  CUDA activity) with the tracer on and labels, and writes a Chrome trace
  ``trace.json`` and ``spans.json`` (the spans, the counters and the
  reduction) into ``log_dir``; a no-op when ``log_dir`` is falsy.
- :func:`nan_guard` raises ``FloatingPointError`` on the host when an
  operation makes a NaN or an infinity from finite inputs. The JAX
  package's ``checkify.float_checks`` trips on any intermediate primitive,
  so the port checks every operation too: a ``TorchDispatchMode`` sees each
  aten op's floating outputs (checking only the function's outputs would
  miss a NaN that a later op hides, such as a ``where``). Each check reads
  a flag back from the device, so a guarded call runs op by op.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import json
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["Tracer", "enabled", "span", "chunk", "block", "count",
           "reduce_profile", "reduce_events", "profile_events", "trace",
           "nan_guard"]

LABEL = "sf:"          # prefix of a span's profiler range

# the tracer of the innermost enabled() block; None while tracing is off
_TRACER: Optional["Tracer"] = None


class _Off:
    """The shared no-op context manager of every span while tracing is
    off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """One open span of an enabled tracer; ``chunk_id`` given: a chunk's
    own span, which numbers the spans inside it."""

    __slots__ = ("tr", "rec", "label", "outer_chunk")

    def __init__(self, tr: "Tracer", name: str, attrs, chunk_id=None):
        self.tr = tr
        # [name, start_ns, end_ns, parent, chunk, attrs]
        self.rec = [name, 0, 0, -1, chunk_id, attrs]
        self.label = None
        self.outer_chunk = None

    def __enter__(self):
        tr, rec = self.tr, self.rec
        rec[3] = tr._stack[-1] if tr._stack else -1
        self.outer_chunk = tr._chunk
        if rec[4] is None:
            rec[4] = tr._chunk
        tr._chunk = rec[4]
        tr._stack.append(len(tr._spans))
        tr._spans.append(rec)
        if tr.labels:
            self.label = torch.profiler.record_function(LABEL + rec[0])
            self.label.__enter__()
        rec[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec[2] = time.perf_counter_ns()
        if self.label is not None:
            self.label.__exit__(*exc)
        tr = self.tr
        tr._stack.pop()
        tr._chunk = self.outer_chunk
        return False


class Tracer:
    """The spans and counters of one :func:`enabled` block."""

    def __init__(self, labels: bool = False):
        self.labels = bool(labels)
        self.counters: Dict[str, int] = {"frames": 0, "blocks": 0,
                                         "chunks": 0}
        self._spans: List[list] = []
        self._stack: List[int] = []
        self._chunk: Optional[int] = None

    @property
    def spans(self) -> List[dict]:
        """Every span in the order it opened: ``name``, ``start_ns``,
        ``end_ns``, ``parent`` (index into this list, -1 for none),
        ``chunk`` (None outside a chunk) and ``attrs``."""
        keys = ("name", "start_ns", "end_ns", "parent", "chunk", "attrs")
        return [dict(zip(keys, rec)) for rec in self._spans]

    def durations_ms(self, name: str) -> List[float]:
        """Host milliseconds of each span called ``name``, in order."""
        return [(r[2] - r[1]) * 1e-6 for r in self._spans if r[0] == name]

    def summary(self) -> Dict[str, dict]:
        """Per span name: ``count``, ``host_ms`` (the spans' durations
        summed) and ``self_ms`` (less what their child spans cover)."""
        child_ns = [0] * len(self._spans)
        for r in self._spans:
            if r[3] >= 0:
                child_ns[r[3]] += r[2] - r[1]
        out: Dict[str, dict] = {}
        for r, kids in zip(self._spans, child_ns):
            s = out.setdefault(r[0], {"count": 0, "host_ms": 0.0,
                                      "self_ms": 0.0})
            s["count"] += 1
            s["host_ms"] += (r[2] - r[1]) * 1e-6
            s["self_ms"] += (r[2] - r[1] - kids) * 1e-6
        return out


@contextlib.contextmanager
def enabled(labels: bool = False):
    """Tracing on for the block; yields its :class:`Tracer`, whose spans
    and counters stay readable after the block. ``labels``: every span is
    also a ``record_function`` range ``sf:<name>`` (for a profiler's
    trace; costs the host more)."""
    global _TRACER
    tr = Tracer(labels)
    prev, _TRACER = _TRACER, tr
    try:
        yield tr
    finally:
        _TRACER = prev


def span(name: str):
    """A span called ``name`` around the ``with`` block."""
    tr = _TRACER
    if tr is None:
        return _OFF
    return _Span(tr, name, None)


def chunk(frames: int, frame_block: int = 1):
    """The span of one request (``chunk``): counts the chunk and its
    ``frames`` real frames, and numbers the spans inside it."""
    tr = _TRACER
    if tr is None:
        return _OFF
    c = tr.counters
    c["frames"] += int(frames)
    c["chunks"] += 1
    return _Span(tr, "chunk", {"T": int(frames),
                               "frame_block": int(frame_block)},
                 c["chunks"] - 1)


def block():
    """The span of one integration block (``block``), counted."""
    tr = _TRACER
    if tr is None:
        return _OFF
    tr.counters["blocks"] += 1
    return _Span(tr, "block", None)


def count(name: str) -> None:
    """Add one to the counter ``name`` (made at its first count)."""
    tr = _TRACER
    if tr is not None:
        tr.counters[name] = tr.counters.get(name, 0) + 1


# -- a profiler's trace, reduced to the spans ---------------------------------

# (kind, name, start_ns, end_ns, correlation id); kind is "span" (a host
# range of a span, its name without the prefix), "call" (a host CUDA
# runtime or driver call) or "work" (a kernel, copy or set on the device)
Event = Tuple[str, str, int, int, int]


def profile_events(prof) -> List[Event]:
    """The events of a ``torch.profiler`` trace that :func:`reduce_events`
    reads, from the profiler's raw results (a window's million events
    parse in seconds this way, in minutes through ``prof.events()``)."""
    cuda = torch.autograd.DeviceType.CUDA
    out: List[Event] = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == cuda:
            # a range's mirror on the device's timeline is no work
            if name.startswith(LABEL) or e.is_user_annotation():
                continue
            out.append(("work", name, start, end, e.correlation_id()))
        elif name.startswith(LABEL):
            out.append(("span", name[len(LABEL):], start, end, 0))
        elif name.startswith("cu"):
            out.append(("call", name, start, end, e.correlation_id()))
    return out


class _Ranges:
    """The span ranges of one trace, innermost-first lookup by time (the
    ranges of one thread nest)."""

    def __init__(self, ranges: List[Tuple[int, int, str]]):
        ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in ranges]
        self.ends = [r[1] for r in ranges]
        self.names = [r[2] for r in ranges]
        self.parent = []
        stack: List[int] = []
        for i, (s, e, _) in enumerate(ranges):
            while stack and self.ends[stack[-1]] < e:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)
        self._chains: Dict[int, frozenset] = {}

    def innermost(self, t: int) -> int:
        """Index of the innermost range open at ``t``, or -1."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ends[i] < t:
            i = self.parent[i]
        return i

    def chain(self, i: int) -> frozenset:
        """The names of range ``i`` and of every range around it."""
        got = self._chains.get(i)
        if got is None:
            names, j = set(), i
            while j >= 0:
                names.add(self.names[j])
                j = self.parent[j]
            got = self._chains[i] = frozenset(names)
        return got


def _new_row():
    return {"count": 0, "launches": 0, "launches_total": 0,
            "device_ms": 0.0, "device_ms_total": 0.0, "idle_s": 0.0,
            "kernels": collections.Counter()}


def _unclaimed_row():
    return {"launches": 0, "device_ms": 0.0, "idle_s": 0.0,
            "kernels": collections.Counter()}


def reduce_events(events: Iterable[Event]) -> dict:
    """Per span name (``spans``): ``count`` (ranges), ``launches`` (launch
    calls whose innermost range is this span; distinct correlation ids, so
    a graph launch counts once) and ``launches_total`` (inside it at any
    depth), ``device_ms`` / ``device_ms_total`` (the device time of the
    work those calls launched), ``idle_s`` (the device's idle gaps whose
    end, when the device woke, fell in this span innermost) and
    ``kernels`` (device ms by kernel name, own work). ``unclaimed``: the
    same of work and idle that no span claims. A call belongs to the
    innermost range open when it was made; the spans are opened on one
    thread, so a call from another thread (the autograd engine's) belongs
    to the span that thread's work was asked for in. The idle gaps lie
    between the first range's start and the last range's end."""
    ranges, calls, work = [], [], []
    for ev in events:
        kind = ev[0]
        if kind == "span":
            ranges.append((ev[2], ev[3], ev[1]))
        elif kind == "call":
            calls.append(ev)
        elif kind == "work":
            work.append(ev)
    rs = _Ranges(ranges)
    spans: Dict[str, dict] = collections.defaultdict(_new_row)
    for name in rs.names:
        spans[name]["count"] += 1
    unclaimed = _unclaimed_row()

    worked = {w[4] for w in work}
    owner: Dict[int, int] = {}         # correlation id -> range index
    for _, _, start, _, corr in sorted(calls, key=lambda c: c[2]):
        if corr in worked and corr not in owner:
            owner[corr] = i = rs.innermost(start)
            if i < 0:
                unclaimed["launches"] += 1
                continue
            spans[rs.names[i]]["launches"] += 1
            for name in rs.chain(i):
                spans[name]["launches_total"] += 1
    busy = []
    for _, kname, start, end, corr in work:
        ms = (end - start) * 1e-6
        busy.append((start, end))
        i = owner.get(corr, -1)
        if i < 0:
            unclaimed["device_ms"] += ms
            unclaimed["kernels"][kname] += ms
            continue
        row = spans[rs.names[i]]
        row["device_ms"] += ms
        row["kernels"][kname] += ms
        for name in rs.chain(i):
            spans[name]["device_ms_total"] += ms

    if rs.starts:
        t0, t1 = rs.starts[0], max(rs.ends)
        prev = t0
        for s, e in sorted(busy) + [(t1, t1)]:
            s, e = min(max(s, t0), t1), min(e, t1)
            if s > prev:
                i = rs.innermost(s)
                row = spans[rs.names[i]] if i >= 0 else unclaimed
                row["idle_s"] += (s - prev) * 1e-9
            prev = max(prev, e)
    out_spans = {}
    for name, row in spans.items():
        row["kernels"] = dict(row["kernels"].most_common())
        out_spans[name] = row
    unclaimed["kernels"] = dict(unclaimed["kernels"].most_common())
    return {"spans": out_spans, "unclaimed": unclaimed,
            "launches": len(owner),
            "device_ms": sum((e - s) * 1e-6 for s, e in busy)}


def reduce_profile(prof) -> dict:
    """:func:`reduce_events` of a ``torch.profiler`` trace taken with the
    tracer's labels on (CPU and CUDA activity)."""
    return reduce_events(profile_events(prof))


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block with the tracer on and its
    labels; writes the Chrome trace ``log_dir/trace.json`` (open in
    Perfetto or chrome://tracing) and ``log_dir/spans.json`` (``spans``,
    ``counters``, ``summary`` and the trace's ``reduction``). No-op when
    ``log_dir`` is falsy. Yields the profiler (None when off)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with enabled(labels=True) as tr:
        with profile(activities=activities) as prof:
            yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as fh:
        json.dump({"counters": tr.counters, "summary": tr.summary(),
                   "reduction": reduce_profile(prof), "spans": tr.spans},
                  fh)


# -- NaN / Inf guard ----------------------------------------------------------

def _nonfinite(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.numel() > 0 and not bool(torch.isfinite(t).all()))


class _FiniteCheck(TorchDispatchMode):
    """Raises when an op's floating output holds a NaN or an infinity
    and none of its floating inputs did."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(_nonfinite(t) for t in tree_leaves(out)) and not any(
                _nonfinite(t) for t in tree_leaves((args, kwargs))):
            raise FloatingPointError(
                f"non-finite values produced by {func}")
        return out


def nan_guard(fn: Callable, enabled: bool = True) -> Callable:
    """``fn`` with every operation checked for NaN / Inf made from finite
    inputs (raises ``FloatingPointError``); ``fn`` itself when not
    ``enabled``."""
    if not enabled:
        return fn

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _FiniteCheck():
            return fn(*args, **kwargs)

    return wrapped
