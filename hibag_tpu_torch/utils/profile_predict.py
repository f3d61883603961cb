"""Where a predict() call spends its time, on one CUDA card.

    python -m hibag_tpu_torch.utils.profile_predict [out.json]

Predicts the two prediction cells of chip_smoke.py on seeded synthetic
models at the published HLA-A model's width (100 classifiers, 1,000 SNPs):
"slice", 48 alleles and 30-120 haplotypes per classifier on 3,840 samples
(the ensemble kernel), and "wide", 160 alleles and 600-1,600 haplotypes on
1,024 samples (the scan engine on the scoring kernel). Reports per cell: the
wall time of three plain calls after a warm-up, the device time (kernels
and copies, each once) and idle share of one call under torch.profiler with
its top device ops, its peak device memory, and the time of each layer
(host alignment, code gather, the kernels, the scan engine's block, the
output reduction) under timers that synchronise the card around each layer;
their total is above the plain wall time by those synchronisations. On the
wide cell it then times predict() with models.predict.SCAN_CCHUNK (the
classifiers per launch of the scoring kernel) set to each of CCHUNKS, three
calls each after a warm-up, interleaved, with each setting's peak device
memory: the comparison SCAN_CCHUNK is chosen from.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from .profile_train import device_summary, layer_timers

#: (module path, attribute, layer name) of the timed layers
LAYERS = (
    ("hibag_tpu_torch.data.geno", "align_to_model", "align"),
    ("hibag_tpu_torch.models.predict", "_gather_codes", "gather"),
    ("hibag_tpu_torch.models.predict", "ensemble_accumulate", "ens_kernel"),
    ("hibag_tpu_torch.models.predict", "ensemble_scores", "scan_kernel"),
    ("hibag_tpu_torch.models.predict", "_predict_block_mesh", "block"),
    ("hibag_tpu_torch.models.predict", "_pack_stats", "stats"),
)

CELLS = {
    "slice": (dict(n_alleles=48), 3840, 1),
    "wide": (dict(n_alleles=160, hap_range=(600, 1600), max_variants=20,
                  mutation=0.1), 1024, 8),
}

#: classifiers per scoring launch compared on the wide cell
CCHUNKS = (1, 2, 4, 8, 16)


def _timed_predict(model, geno) -> float:
    from ..models.predict import predict

    t0 = time.perf_counter()
    predict(model, geno, device="cuda")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_cell(model, geno) -> dict:
    from torch.profiler import ProfilerActivity, profile

    def run():
        return _timed_predict(model, geno)

    run()
    walls = [run() for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled = run()
    device_s, top = device_summary(prof, 10)
    peak = torch.cuda.max_memory_allocated()
    with layer_timers(LAYERS) as acc:
        timed_wall = run()
    return {"walls_s": walls, "profiled_wall_s": profiled,
            "device_s": device_s, "idle_share": 1 - device_s / profiled,
            "top_device_ms": top, "peak_memory_bytes": peak,
            "timed_wall_s": timed_wall,
            "layers_ms": {k: [round(v[0] * 1e3, 3), v[1]]
                          for k, v in acc.items()}}


def cchunk_sweep(model, geno, reps: int = 3) -> dict:
    """{cchunk: {"walls_s", "peak_memory_bytes"}} of predict() with
    SCAN_CCHUNK at each of CCHUNKS: one warm-up call each, then `reps`
    rounds over all settings in turn. Restores SCAN_CCHUNK."""
    from ..models import predict as mod

    keep = mod.SCAN_CCHUNK
    out = {k: {"walls_s": [], "peak_memory_bytes": 0} for k in CCHUNKS}
    try:
        for k in CCHUNKS:
            mod.SCAN_CCHUNK = k
            _timed_predict(model, geno)
        for _ in range(reps):
            for k in CCHUNKS:
                mod.SCAN_CCHUNK = k
                torch.cuda.reset_peak_memory_stats()
                out[k]["walls_s"].append(_timed_predict(model, geno))
                out[k]["peak_memory_bytes"] = max(
                    out[k]["peak_memory_bytes"],
                    torch.cuda.max_memory_allocated())
    finally:
        mod.SCAN_CCHUNK = keep
    return out


def main(argv) -> int:
    from ..device import resolve_device
    from ..ops import _build
    from .synthetic import synthetic_cohort, synthetic_model

    resolve_device("cuda")
    _build.load()
    out = {"device": torch.cuda.get_device_name(0)}
    for cell, (model_kw, n, cohort_seed) in CELLS.items():
        model, pool = synthetic_model(0, n_classifiers=100, n_snp=1000,
                                      **model_kw)
        geno, _, _ = synthetic_cohort(model, pool, n, cohort_seed)
        torch.cuda.reset_peak_memory_stats()
        out[cell] = profile_cell(model, geno)
        print(cell, json.dumps(out[cell]), flush=True)
        if cell == "wide":
            out["wide_cchunk"] = cchunk_sweep(model, geno)
            print("wide_cchunk", json.dumps(out["wide_cchunk"]), flush=True)
    if len(argv) > 1:
        with open(argv[1], "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
