"""predict.align_ms: host alignment of a call's cohort to the model's SNPs
(``data/geno.py::align_to_model`` -> ``io/native.py``), mean ms per call,
from a host-clock span around it (host work: no synchronisation)."""

LAYERS = [("hibag_tpu_torch.data.geno", "align_to_model", "align", False)]


def read(ctx):
    seconds, calls = ctx.layers.get("align", (0.0, 0))
    return 1e3 * seconds / calls if calls else None
