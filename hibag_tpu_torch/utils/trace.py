"""Spans, counters and kernel launch records of the program's layers, off by
default.

    from hibag_tpu_torch.utils import trace
    trace.enable()
    ht.predict(model, geno)            # or a training
    print(trace.summary())             # per-span totals, self times, counts
    trace.disable(); trace.reset()

Off, `span` returns one shared no-op context manager after a single check
of a module flag, and `count` and `launch` return after the same check:
nothing is allocated, timed or sent to the device. On:

* a span (``with trace.span("train.em", x):``) records its name, its start
  and end on ``time.perf_counter_ns()``, its parent span (a stack per
  thread; `carry` hands the open span to a worker thread), the id of its
  root span (every span of one ``predict`` call or one training batch
  shares it) and its thread. Given a CUDA device, or a tensor on one, it
  also records a timing-enabled CUDA event pair on that device's current
  stream, whose elapsed time is read only in `snapshot`. While a
  ``torch.profiler`` is recording, the span is also a
  ``torch.profiler.record_function`` range of the same name, on the
  device trace's own clock. A span whose name is already open in its
  chain of parents records nothing (the outermost call of a layer counts);
* a counter (``trace.count("host_syncs")``) is a named integer recorded
  with its time and the span open at that moment;
* a launch record (``with trace.launch(name, dims, counts, dev) as rec:``
  around a kernel launch, in the ops wrappers that count ``LAUNCHES``)
  holds the kernel's name, its input shapes `dims`, a CUDA event pair that
  the launcher records around its kernels (``rec.marks``, the two events'
  handles, passed to it: csrc/launch_marks.cuh), and optionally
  data-dependent counts: `counts` is called only while tracing is on,
  before the launch, and returns a device tensor that is read in
  `snapshot`.

`snapshot` synchronises the card and returns every record with its host
and device times in ms and each span's self time (its time less what its
child spans cover); `summary` reduces it per name.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict

_ON = False
_LOCK = threading.Lock()
_LOCAL = threading.local()
_IDS = itertools.count(1)
_SPANS: list = []
_COUNTS: list = []
_LAUNCHES: list = []


class _Null:
    """The shared no-op context manager of tracing off."""

    __slots__ = ()
    #: no launch marks (`launch`)
    marks = (None, None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def enable() -> None:
    """Turn tracing on (process-wide, every thread)."""
    global _ON
    _ON = True


def disable() -> None:
    """Turn tracing off; the records stay until `reset`."""
    global _ON
    _ON = False


def enabled() -> bool:
    return _ON


def reset() -> None:
    """Drop every record."""
    with _LOCK:
        _SPANS.clear()
        _COUNTS.clear()
        _LAUNCHES.clear()


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


def _current():
    """The innermost open span of this thread, or the span `carry` handed
    to it, or None."""
    st = _stack()
    return st[-1] if st else getattr(_LOCAL, "carried", None)


def _cuda_device(where):
    """The CUDA device of `where` (a torch.device, a tensor or None), or
    None."""
    if where is None:
        return None
    dev = getattr(where, "device", where)
    return dev if getattr(dev, "type", None) == "cuda" else None


def _event(dev):
    """A timing-enabled CUDA event recorded now on `dev`'s current
    stream."""
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(dev))
    return ev


def _profiling() -> bool:
    import torch

    return torch._C._autograd._profiler_enabled()


class _Span:
    __slots__ = ("name", "id", "parent", "root", "thread", "t0", "t1",
                 "dev", "ev0", "ev1", "rf")

    def __init__(self, name, parent, dev):
        self.name = name
        self.id = next(_IDS)
        self.parent = parent
        self.root = parent.root if parent is not None else self.id
        self.thread = threading.get_ident()
        self.dev = dev
        self.ev0 = self.ev1 = self.rf = None

    def __enter__(self):
        if _profiling():
            import torch

            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        if self.dev is not None:
            self.ev0 = _event(self.dev)
        _stack().append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.dev is not None:
            self.ev1 = _event(self.dev)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack().pop()
        with _LOCK:
            _SPANS.append(self)
        return False


def span(name: str, device=None):
    """A context manager timing the layer `name`; `device` (a torch.device
    or a tensor on it) gives the span CUDA events on that device's current
    stream when it is a card. Off: the shared no-op."""
    if not _ON:
        return _NULL
    parent = _current()
    p = parent
    while p is not None:
        if p.name == name:
            return _NULL
        p = p.parent
    return _Span(name, parent, _cuda_device(device))


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name`, recorded at this moment under the open
    span."""
    if not _ON:
        return
    s = _current()
    rec = (name, int(n), time.perf_counter_ns(),
           s.id if s is not None else None,
           s.root if s is not None else None, threading.get_ident())
    with _LOCK:
        _COUNTS.append(rec)


class _Launch:
    __slots__ = ("name", "dims", "counts", "span", "thread", "t0", "t1",
                 "ev0", "ev1", "marks")

    def __init__(self, name, dims, counts, dev):
        self.name, self.dims = name, dims
        self.counts = counts
        self.span = _current()
        self.thread = threading.get_ident()
        self.ev0 = self.ev1 = None
        self.marks = (None, None)
        if dev is not None:
            # recorded once here so that they exist; the launcher records
            # them again around its kernels
            self.ev0, self.ev1 = _event(dev), _event(dev)
            self.marks = (self.ev0.cuda_event, self.ev1.cuda_event)

    def __enter__(self):
        if self.counts is not None:
            self.counts = self.counts()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        with _LOCK:
            _LAUNCHES.append(self)
        return False


def launch(name: str, dims: dict, counts=None, device=None):
    """A context manager around one kernel launch: records `name`, the
    input shapes `dims`, `counts()` (called only while tracing is on,
    before the launch; a tensor read in `snapshot`) and, on a CUDA
    `device`, a pair of timing events whose handles ``marks`` the launcher
    records on its stream around its kernels. Off: the shared no-op, whose
    ``marks`` are (None, None)."""
    if not _ON:
        return _NULL
    return _Launch(name, dims, counts, _cuda_device(device))


def carry(fn):
    """`fn` to run on another thread under the span open here (a mesh's
    shard threads), so its spans keep their parent and root."""
    if not _ON:
        return fn
    parent = _current()

    def run(*a, **k):
        before = getattr(_LOCAL, "carried", None)
        _LOCAL.carried = parent
        try:
            return fn(*a, **k)
        finally:
            _LOCAL.carried = before
    return run


def _elapsed_ms(ev0, ev1):
    if ev0 is None or ev1 is None:
        return None
    return float(ev0.elapsed_time(ev1))


def _union_ns(intervals, lo, hi):
    """Length of the union of `intervals` clipped to [lo, hi]."""
    total, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def snapshot() -> dict:
    """Every record so far, with times resolved (this synchronises the
    card): {"spans": [...], "counters": [...], "launches": [...]}. A span
    is a dict of name, id, parent, root, thread, t0_ns, t1_ns, host_ms,
    device_ms (None without events), self_host_ms (host_ms less the union
    of its child spans' host intervals) and self_device_ms (device_ms less
    its same-thread children's, which run in order on its stream). A
    counter: name, n, t_ns, span, root, thread. A launch: name, dims,
    counts (a list, or None), t0_ns, t1_ns, device_ms, span, root,
    thread."""
    with _LOCK:
        spans = list(_SPANS)
        counts = list(_COUNTS)
        launches = list(_LAUNCHES)
    if any(x.ev0 is not None for x in spans + launches):
        import torch

        torch.cuda.synchronize()
    kids = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            kids[s.parent.id].append(s)
    out_spans = []
    for s in spans:
        dev_ms = _elapsed_ms(s.ev0, s.ev1)
        ch = kids.get(s.id, [])
        covered = _union_ns([(c.t0, c.t1) for c in ch], s.t0, s.t1)
        self_dev = None
        if dev_ms is not None:
            self_dev = dev_ms - sum(
                _elapsed_ms(c.ev0, c.ev1) or 0.0 for c in ch
                if c.thread == s.thread)
        out_spans.append({
            "name": s.name, "id": s.id,
            "parent": s.parent.id if s.parent is not None else None,
            "root": s.root, "thread": s.thread, "t0_ns": s.t0,
            "t1_ns": s.t1, "host_ms": (s.t1 - s.t0) * 1e-6,
            "device_ms": dev_ms, "self_host_ms": (s.t1 - s.t0 - covered)
            * 1e-6, "self_device_ms": self_dev})
    out_counts = [{"name": n, "n": k, "t_ns": t, "span": sid, "root": root,
                   "thread": th} for n, k, t, sid, root, th in counts]
    out_launches = []
    for x in launches:
        c = x.counts
        if c is not None and hasattr(c, "tolist"):
            c = c.tolist()
        out_launches.append({
            "name": x.name, "dims": dict(x.dims), "counts": c,
            "t0_ns": x.t0, "t1_ns": x.t1,
            "device_ms": _elapsed_ms(x.ev0, x.ev1),
            "span": x.span.id if x.span is not None else None,
            "root": x.span.root if x.span is not None else None,
            "thread": x.thread})
    return {"spans": out_spans, "counters": out_counts,
            "launches": out_launches}


def summary(snap=None) -> dict:
    """Per name: {"spans": {name: {n, host_ms, self_host_ms, device_ms,
    self_device_ms}}, "counters": {name: total}, "launches": {name: {n,
    device_ms}}}; device times are None where no span of the name had
    events. `snap` defaults to a new `snapshot()`."""
    snap = snapshot() if snap is None else snap
    spans = {}
    for s in snap["spans"]:
        a = spans.setdefault(s["name"], {"n": 0, "host_ms": 0.0,
                                         "self_host_ms": 0.0,
                                         "device_ms": None,
                                         "self_device_ms": None})
        a["n"] += 1
        a["host_ms"] += s["host_ms"]
        a["self_host_ms"] += s["self_host_ms"]
        if s["device_ms"] is not None:
            a["device_ms"] = (a["device_ms"] or 0.0) + s["device_ms"]
            a["self_device_ms"] = ((a["self_device_ms"] or 0.0)
                                   + s["self_device_ms"])
    counters = defaultdict(int)
    for c in snap["counters"]:
        counters[c["name"]] += c["n"]
    launches = {}
    for x in snap["launches"]:
        a = launches.setdefault(x["name"], {"n": 0, "device_ms": None})
        a["n"] += 1
        if x["device_ms"] is not None:
            a["device_ms"] = (a["device_ms"] or 0.0) + x["device_ms"]
    return {"spans": spans, "counters": dict(counters),
            "launches": launches}
