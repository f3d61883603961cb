"""Spans around the program's layers and a profiled stretch, for the traced
run (``--trace 1``) only.

``Layers`` swaps module attributes of the program for wrappers (as
``hibag_tpu_torch/utils/profile_train.py``'s layer timers do) that record
each call's host-clock span under a label. A layer marked ``sync``
synchronises the card before and after, so its span holds its device work;
the synchronisations lengthen the step, which is why they run in the traced
run alone. A call of a label already open (a layer calling another of the
same label) is passed through untimed, so a label's time is its outermost
spans'. Under ``profiling`` the wrappers only mark their spans for the
profiler (``record_function``) and synchronise nothing.

``profile`` runs a stretch of calls under ``torch.profiler`` (the device
alone, or host and device) and reduces it: the device's busy seconds (the union of its kernel and copy
intervals), the device seconds of each operation, and the idle gaps
between device intervals, each put down to the innermost labelled span
open on the host at the gap's middle.
"""

from __future__ import annotations

import importlib
import time
from collections import defaultdict

import numpy as np
import torch


class Layers:
    """Wrappers over `specs`, a list of (module path, attribute, label,
    sync) tuples. ``stats[label]`` is [seconds, calls]."""

    def __init__(self, specs, profiling=False):
        self.specs = specs
        self.profiling = profiling
        self.stats = defaultdict(lambda: [0.0, 0])
        self.open = []
        self.saved = []
        self.cuda = torch.cuda.is_available()

    def __enter__(self):
        for mod_name, attr, label, sync in self.specs:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, label, sync))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)
        self.saved = []

    def _wrap(self, fn, label, sync):
        def wrapped(*a, **k):
            return self.span(label, fn, *a, _sync=sync, **k)
        return wrapped

    def span(self, label, fn, *a, _sync=False, **k):
        """fn(*a, **k) as a span of `label`."""
        if label in self.open:
            return fn(*a, **k)
        self.open.append(label)
        try:
            if self.profiling:
                with torch.profiler.record_function(label):
                    return fn(*a, **k)
            sync = _sync and self.cuda
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            st = self.stats[label]
            st[0] += time.perf_counter() - t0
            st[1] += 1
            return out
        finally:
            self.open.pop()


def _merge(intervals):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _events(prof):
    """(name, device type, start ns, end ns, user annotation) of every
    event of a finished profile: from the raw Kineto results, much faster
    than building ``prof.events()``'s tree, which stays as the fallback."""
    try:
        raw = prof.profiler.kineto_results.events()
        return [(e.name(), e.device_type(), e.start_ns(),
                 e.start_ns() + e.duration_ns(), e.is_user_annotation())
                for e in raw]
    except (AttributeError, RuntimeError):
        return [(e.name, e.device_type, 1e3 * e.time_range.start,
                 1e3 * e.time_range.end,
                 getattr(e, "is_user_annotation", False))
                for e in prof.events()]


def _label_gaps(mids, host):
    """The innermost labelled host span holding each time of `mids`, or
    "outside spans"."""
    if not host:
        return ["outside spans"] * len(mids)
    names = [n for n, _, _ in host]
    s0 = np.array([s for _, s, _ in host], dtype=np.float64)
    s1 = np.array([e for _, _, e in host], dtype=np.float64)
    dur = s1 - s0
    out = []
    for lo in range(0, len(mids), 65536):
        m = np.asarray(mids[lo:lo + 65536], dtype=np.float64)[:, None]
        inside = (s0[None] <= m) & (m <= s1[None])
        k = np.where(inside, dur[None], np.inf).argmin(1)
        out += [names[j] if inside[i, j] else "outside spans"
                for i, j in enumerate(k)]
    return out


def profile(run, labels, n_top=10, host=True):
    """Run `run()` under torch.profiler and reduce the trace. ``host``
    records the host's operations too, which the idle gaps' labels need;
    without it only the device is traced, which slows the host far less.
    Returns (dict, what `run` returned); the dict has window_s (host clock
    around `run`, which ends synchronised), busy_s, device_s_by_op {name:
    seconds}, device_ops and idle_gaps (the `n_top` largest, [name,
    seconds])."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    elif not acts:
        acts = [ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        ran = run()
        window = time.perf_counter() - t0
    dev, host = [], []
    for name, kind, s, e, user in _events(prof):
        user = user or name in labels
        if kind == DeviceType.CUDA and not user:
            dev.append((name, s, e))
        elif kind == DeviceType.CPU and name in labels:
            host.append((name, s, e))
    by_op = defaultdict(float)
    for name, s, e in dev:
        by_op[name] += (e - s) * 1e-9
    merged = _merge([(s, e) for _, s, e in dev])
    busy = sum(e - s for s, e in merged) * 1e-9
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(merged, merged[1:])]
    idle = defaultdict(lambda: [0.0, 0])
    for (e0, s1), label in zip(gaps, _label_gaps(
            [0.5 * (e0 + s1) for e0, s1 in gaps], host)):
        idle[label][0] += (s1 - e0) * 1e-9
        idle[label][1] += 1
    top = sorted(by_op.items(), key=lambda x: -x[1])[:n_top]
    idle = sorted(idle.items(), key=lambda x: -x[1][0])[:n_top]
    return {"window_s": window, "busy_s": busy, "device_s_by_op": by_op,
            "device_ops": [[n[:80], s] for n, s in top],
            "idle_gaps": [[f"{n} ({c} gaps)", s] for n, (s, c) in idle]}, ran
