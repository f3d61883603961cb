"""train.em_ms: the EM iterations of a growth step on the card
(``models/em.py::em_all_candidates``, the program's span ``train.em``):
the device time (CUDA events) of the window's ``train.em`` spans less
that of the ``train.match`` spans nested in them, over the window's
``train.step`` spans, in ms. Loading this reader turns the program's
tracing on (work/records.py); the harness loads readers only in a
``--trace 1`` run, after set-up and before the window, so no ``--trace 0``
run traces."""

from portbench.work import records

TRACE = records.program_trace()
LAYERS = []


def read(ctx):
    rec = records.in_window(ctx, TRACE)
    if rec is None:
        return None
    spans = rec["spans"]
    steps = sum(s["name"] == "train.step" for s in spans)
    em = {s["id"]: s for s in spans if s["name"] == "train.em"}
    if not steps or not em or any(s["device_ms"] is None
                                  for s in em.values()):
        return None
    parent = {s["id"]: s["parent"] for s in spans}

    def in_em(s):
        p = s["parent"]
        while p is not None and p not in em:
            p = parent.get(p)
        return p is not None

    match = sum(s["device_ms"] or 0.0 for s in spans
                if s["name"] == "train.match" and in_em(s))
    return (sum(s["device_ms"] for s in em.values()) - match) / steps
