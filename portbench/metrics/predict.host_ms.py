"""predict.host_ms: the host time of a predict() call other than alignment
and waiting on the card: per call, the host-clock length of the window's
``predict.call`` spans less their ``predict.align`` and ``predict.fetch``
spans (``models/predict.py``), in ms. Loading this reader turns the
program's tracing on (work/records.py); the harness loads readers only in
a ``--trace 1`` run, after set-up and before the window, so no
``--trace 0`` run traces."""

from portbench.work import records

TRACE = records.program_trace()
LAYERS = []


def read(ctx):
    rec = records.in_window(ctx, TRACE)
    if rec is None:
        return None
    spans = rec["spans"]
    calls = {s["id"] for s in spans if s["name"] == "predict.call"}
    if not calls:
        return None
    host = sum(s["host_ms"] for s in spans if s["id"] in calls)
    host -= sum(s["host_ms"] for s in spans
                if s["name"] in ("predict.align", "predict.fetch")
                and s["parent"] in calls)
    return host / len(calls)
