"""eval_cand.roofline: the candidate-evaluation kernel's share of its
roofline in the traced window: the least time the card needs for the
window's launches of ``evaluate_candidates_kernel`` (work/train_bounds.py:
bytes, popcounts and float operations from each launch record's shapes
and counts) over those launches' device time (a CUDA event pair around
each launch), in %. Loading this reader turns the program's tracing on
(work/records.py); the harness loads readers only in a ``--trace 1`` run,
after set-up and before the window, so no ``--trace 0`` run traces."""

from portbench.work import records, train_bounds

TRACE = records.program_trace()
LAYERS = []


def read(ctx):
    return records.roofline(ctx, TRACE, (train_bounds.EVAL_KERNEL,))
