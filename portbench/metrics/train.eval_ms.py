"""train.eval_ms: the candidate-evaluation kernel
(``ops/train_step.py::evaluate_candidates_kernel`` -> ``csrc/eval_cand.cu``),
synchronised spans, ms per growth step."""

LAYERS = [("hibag_tpu_torch.ops.train_step", "evaluate_candidates_kernel",
           "eval", True),
          ("hibag_tpu_torch.models.train_fused", "_step", "step", False)]


def read(ctx):
    seconds, calls = ctx.layers.get("eval", (0.0, 0))
    _, steps = ctx.layers.get("step", (0.0, 0))
    return 1e3 * seconds / steps if calls and steps else None
