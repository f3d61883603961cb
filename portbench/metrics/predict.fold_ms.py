"""predict.fold_ms: the scan engine's plain-PyTorch fold of each chunk's
scores (``models/predict.py::_one_classifier_fn`` after the scoring kernel
returns: the unordered cells, the weighting and the sum over the chunk,
the program's span ``predict.fold``): the device time (CUDA events) of
the window's ``predict.fold`` spans over its ``predict.call`` spans, in
ms a call. A program without the span (or a call on the ensemble
kernel's path) reads nothing. Loading this reader turns the program's
tracing on (work/records.py); the harness loads readers only in a
``--trace 1`` run, after set-up and before the window, so no
``--trace 0`` run traces."""

from portbench.work import records

TRACE = records.program_trace()
LAYERS = []


def read(ctx):
    rec = records.in_window(ctx, TRACE)
    if rec is None:
        return None
    spans = rec["spans"]
    calls = sum(s["name"] == "predict.call" for s in spans)
    fold = [s["device_ms"] for s in spans if s["name"] == "predict.fold"]
    if not calls or not fold or any(t is None for t in fold):
        return None
    return sum(fold) / calls
