"""The program's own records (``hibag_tpu_torch/utils/trace.py``: spans,
counters and kernel launch records) inside a traced run's window.

A reader that reads them calls `program_trace` when it is loaded, which
turns the program's tracing on with its records dropped. The harness loads
readers only in a ``--trace 1`` run, after set-up and before the window,
so no ``--trace 0`` run traces. A program without the module (one older
than its tracing) gives no records, and its readers report nothing.
"""

from __future__ import annotations


def program_trace():
    """The program's tracing module, turned on and emptied; None where the
    program has none."""
    try:
        from hibag_tpu_torch.utils import trace
    except ImportError:
        return None
    trace.reset()
    trace.enable()
    return trace


def in_window(ctx, trace):
    """The records of `trace` whose spans lie inside the window, from the
    first call's start to the last call's end in ``ctx.calls`` on the
    shared ``perf_counter`` clock (the profiled stretches after the window
    are left out): a dict of lists ``spans``, ``launches``, ``counters``
    as ``trace.snapshot()`` gives them; None without records there."""
    if trace is None or not ctx.calls:
        return None
    lo = int(min(c[0] for c in ctx.calls) * 1e9)
    hi = int(max(c[1] for c in ctx.calls) * 1e9)
    snap = trace.snapshot()
    out = {"spans": [s for s in snap["spans"]
                     if lo <= s["t0_ns"] and s["t1_ns"] <= hi],
           "launches": [x for x in snap["launches"]
                        if lo <= x["t0_ns"] and x["t1_ns"] <= hi],
           "counters": [c for c in snap["counters"]
                        if lo <= c["t_ns"] <= hi]}
    if not out["spans"] and not out["launches"]:
        return None
    return out


def roofline(ctx, trace, names):
    """The least time of the window's launches of the kernels `names`
    (``work/train_bounds.py::launch_seconds``, from each launch record's
    shapes and counts) over their event-timed device time, in %; None off
    the card or without such launches."""
    from . import train_bounds

    if ctx.popc_rate is None:
        return None
    rec = in_window(ctx, trace)
    if rec is None:
        return None
    runs = [x for x in rec["launches"]
            if x["name"] in names and x["device_ms"] is not None]
    spent = sum(x["device_ms"] for x in runs) * 1e-3
    if not runs or spent <= 0:
        return None
    least = sum(train_bounds.launch_seconds(x, ctx.popc_rate) for x in runs)
    return 100.0 * least / spent
