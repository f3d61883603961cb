"""train.match_ms: pair matching (``models/em.py::match_pairs`` and
``match_pairs_packed``, which calls it), synchronised spans, ms per growth
step."""

LAYERS = [("hibag_tpu_torch.models.em", "match_pairs", "match", True),
          ("hibag_tpu_torch.models.em", "match_pairs_packed", "match", True),
          ("hibag_tpu_torch.models.train_fused", "_step", "step", False)]


def read(ctx):
    seconds, calls = ctx.layers.get("match", (0.0, 0))
    _, steps = ctx.layers.get("step", (0.0, 0))
    return 1e3 * seconds / steps if calls and steps else None
