"""train.step_ms: the traced window's wall time over the growth steps it
took (``models/train_fused.py::_step``, counted by a wrapper), in ms."""

LAYERS = [("hibag_tpu_torch.models.train_fused", "_step", "step", False)]


def read(ctx):
    _, steps = ctx.layers.get("step", (0.0, 0))
    return 1e3 * ctx.window_s / steps if steps else None
