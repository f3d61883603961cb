"""match_pairs.roofline: the pair-matching kernel's share of its roofline in
the traced window: the least time the card needs for the window's launches
of ``match_pairs`` and ``match_pairs_packed`` (work/match_bounds.py: the
bytes term, from each launch record's dims) over those launches' device
time (a CUDA event pair around each launch), in %. A program without the
kernel records no such launch, and the metric is then not read. Loading
this reader turns the program's tracing on (work/records.py), in a
``--trace 1`` run only."""

from portbench.work import match_bounds, records

TRACE = records.program_trace()
LAYERS = []


def read(ctx):
    if ctx.popc_rate is None:
        return None
    rec = records.in_window(ctx, TRACE)
    if rec is None:
        return None
    runs = [x for x in rec["launches"]
            if x["name"] in match_bounds.MATCH_KERNELS
            and x["device_ms"] is not None]
    spent = sum(x["device_ms"] for x in runs) * 1e-3
    if not runs or spent <= 0:
        return None
    least = sum(match_bounds.launch_seconds(x) for x in runs)
    return 100.0 * least / spent
