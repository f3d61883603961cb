"""Where a training step spends its time, on one CUDA card.

    python -m hibag_tpu_torch.utils.profile_train [out.json]

Trains the training cells of chip_smoke.py on seeded synthetic mosaic
panels (synthetic.PANEL_RECOMBINATION): fused mid-scale (1,000 samples x
266 SNPs, K=8, hcap=256), fused headline (60 samples x 1,000 SNPs, K=25,
hcap=128 on the packed EM tier) and host mid-scale (phase 8's
train_parallel(mode="host"), K=8). It reports per cell: the wall time of
three plain calls after a warm-up, the device time (kernels and copies,
each once) and idle share of one call under torch.profiler with its top
device ops, and the time of each layer of the growth step (draw, pair
matching, EM kernel, EM loop, erase, evaluation kernel, decide; in host
mode the device step, the decision scan and the list doubling, the rest of
the host loop being the wall time less those) under timers that
synchronise the card around each layer. The timers add a synchronisation
per call, so their total is above the plain wall time.
"""

from __future__ import annotations

import collections
import contextlib
import json
import sys
import time

import torch

#: (module path, attribute, layer name) of the timed layers
LAYERS = (
    ("hibag_tpu_torch.utils.threefry", "split", "split"),
    ("hibag_tpu_torch.utils.threefry", "draw_top_k", "draw"),
    ("hibag_tpu_torch.models.em", "match_pairs", "match_pairs"),
    ("hibag_tpu_torch.models.em", "match_pairs_packed", "match_pairs_packed"),
    ("hibag_tpu_torch.ops.train_step", "em_estep", "em_kernel"),
    ("hibag_tpu_torch.ops.train_step", "em_estep_packed", "em_kernel_packed"),
    ("hibag_tpu_torch.models.train_fused", "em_all_candidates",
     "em_all_candidates"),
    ("hibag_tpu_torch.models.train_fused", "erase_rare", "erase"),
    ("hibag_tpu_torch.ops.train_step", "evaluate_candidates_kernel",
     "eval_kernel"),
    ("hibag_tpu_torch.models.train_fused", "_decide", "decide"),
    ("hibag_tpu_torch.models.train_fused", "_step", "step"),
    ("hibag_tpu_torch.models.train", "grow_step", "host_device_step"),
    ("hibag_tpu_torch.models.train", "_decide_host", "host_decide"),
    ("hibag_tpu_torch.models.train", "_double", "host_double"),
)

FUSED = dict(mode="fused", on_overflow="freeze", max_steps=192)
CELLS = {
    "mid": (dict(seed=0, n_samples=1000, n_snp=266, n_alleles=14),
            dict(n_classifiers=8, batch=8, hcap=256, **FUSED)),
    "headline": (dict(seed=2, n_samples=60, n_snp=1000, n_alleles=14),
                 dict(n_classifiers=25, batch=25, hcap=128,
                      mask_budget=256 * 1024, **FUSED)),
    "host_mid": (dict(seed=0, n_samples=1000, n_snp=266, n_alleles=14),
                 dict(n_classifiers=8, batch=8, mtry=17, mode="host")),
}


@contextlib.contextmanager
def layer_timers(layers=LAYERS):
    """Wrap each layer of `layers` ((module path, attribute, name) triples)
    with a synchronising timer; yields {layer: [seconds, calls]} and
    restores the functions on exit."""
    import importlib

    acc = collections.defaultdict(lambda: [0.0, 0])
    saved = []
    for mod_name, attr, label in layers:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def timed(*a, _fn=fn, _label=label, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            acc[_label][0] += time.perf_counter() - t0
            acc[_label][1] += 1
            return out
        setattr(mod, attr, timed)
    try:
        yield acc
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def device_summary(prof, n_top):
    """(device seconds, top device ops) of a torch.profiler run: the kernels
    and copies that ran on the card, each counted once (an operator on the
    host reports its kernels' device time as its own too, so summing every
    event would count them twice)."""
    from torch.autograd import DeviceType

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev = lambda e: getattr(e, "self_device_time_total", 0) or 0
    top = [(e.key[:60], round(dev(e) / 1e3, 3), e.count)
           for e in sorted(events, key=lambda e: -dev(e))[:n_top]]
    return sum(dev(e) for e in events) / 1e6, top


def profile_cell(table, geno, kw) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from ..models.train import train_parallel

    def run():
        t0 = time.perf_counter()
        train_parallel(table, geno, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run()
    walls = [run() for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled = run()
    device_s, top = device_summary(prof, 12)
    with layer_timers() as acc:
        timed_wall = run()
    return {"walls_s": walls, "profiled_wall_s": profiled,
            "device_s": device_s, "idle_share": 1 - device_s / profiled,
            "top_device_ms": top, "timed_wall_s": timed_wall,
            "layers_ms": {k: [round(v[0] * 1e3, 3), v[1]]
                          for k, v in acc.items()}}


def main(argv) -> int:
    from ..device import resolve_device
    from ..ops import _build
    from .synthetic import PANEL_RECOMBINATION, synthetic_panel

    resolve_device("cuda")
    _build.load()
    out = {"device": torch.cuda.get_device_name(0)}
    for cell, (panel_kw, train_kw) in CELLS.items():
        (table, geno), _ = synthetic_panel(
            **panel_kw, recombination=PANEL_RECOMBINATION)
        kw = dict(seed=100, verbose=False, with_matching=False,
                  device="cuda", **train_kw)
        out[cell] = profile_cell(table, geno, kw)
        print(cell, json.dumps(out[cell]), flush=True)
    if len(argv) > 1:
        with open(argv[1], "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
