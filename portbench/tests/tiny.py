"""Tiny configurations and mixes that the CPU tests run the harness on."""

CFG = {
    "name": "tiny", "missing": 0.02, "precision": "float32",
    "model": {"n_classifiers": 6, "n_snp": 80, "n_alleles": 7,
              "snp_range": [6, 14], "hap_range": [8, 20], "max_variants": 3,
              "mutation": 0.05, "shape_seed": 0},
    "panel": {"panel_seed": 0, "n_samples": 160, "n_snp": 40, "n_alleles": 6,
              "max_variants": 3, "mutation": 0.02, "recombination": 0.5},
}
PREDICT = {"kind": "predict", "entry": "predict", "call": {},
           "cohort": 300, "chunks": [128, 64], "compare": 40,
           "profile_calls": 2, "launches": {"ens_acc": [1, None]}}
TRAIN = {"kind": "train", "entry": "train_parallel",
         "call": {"n_classifiers": 2, "batch": 2, "mode": "fused", "mtry": 5,
                  "hcap": 64, "max_steps": 40, "on_overflow": "freeze",
                  "with_matching": False, "verbose": False},
         "train_seed": 100, "ids": 4, "warm_id": 1000, "compare": 2,
         "profile_calls": 1,
         "launches": {"train_step:evaluate_candidates_kernel": [1, None]}}
#: the training control's test: at 160 x 40 the bfloat16 control's
#: frequencies stay within the limit, at 400 x 80 they read 0.017
CONTROL_PANEL = {"n_samples": 400, "n_snp": 80, "n_alleles": 10}
