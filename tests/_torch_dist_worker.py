"""Worker of the two-process cases of tests/test_torch_parallel.py: one
process of a pair that joins a gloo process group and runs one task of
hibag_tpu_torch on the CPU. Imports no jax.

Usage: python tests/_torch_dist_worker.py <task> <coordinator> <nproc>
       <pid> <work_dir> <out.npz> [late]

task:
  train-host, train-fused
           train_distributed of TRAIN_KW's classifiers in that mode
           (MODE_KW);
  dynamic  train_dynamic of them (host mode), one classifier per job,
           claim files in work_dir; with `late`, the process starts
           claiming only once another has claimed a job (a late joiner);
  predict  predict_distributed of the synthetic model over its cohort;
  gather   gather_classifiers of N_GATHER classifiers made from their ids
           (classifier_range's share in each process).
The result goes to out.npz (classifiers: n, snp<k>, bits<k>, freq<k>,
allele<k>, oob<k>; prediction: the PredictionResult's arrays).
"""

import os
import sys
import time

import numpy as np
import torch

#: the training cases' panel, classifiers and arguments
PANEL = dict(seed=1, n_samples=96, n_snp=60, n_alleles=6, recombination=10.0)
TRAIN_KW = dict(n_classifiers=4, seed=100, batch=2, mode="host",
                verbose=False, device="cpu")
#: what each training mode adds to TRAIN_KW
MODE_KW = {"host": {}, "fused": dict(mode="fused", hcap=32,
                                     on_overflow="freeze")}
#: classifiers of the gather case
N_GATHER = 100


def panel():
    from hibag_tpu_torch.utils.synthetic import synthetic_panel
    (table, geno), _ = synthetic_panel(
        PANEL["seed"], PANEL["n_samples"], PANEL["n_snp"], PANEL["n_alleles"],
        recombination=PANEL["recombination"])
    return table, geno


def model_and_cohort():
    """A 42-classifier model (not a multiple of 2 or 3) and 48 samples."""
    from hibag_tpu_torch.utils.synthetic import (synthetic_cohort,
                                                 synthetic_model)
    model, pool = synthetic_model(3, n_classifiers=42, n_snp=200, n_alleles=9,
                                  snp_range=(4, 12), mutation=0.15)
    geno, _, _ = synthetic_cohort(model, pool, 48, 4, missing=0.3)
    return model, geno


def gather_classifier(k):
    """Classifier id k of the gather case; its arrays depend on k alone."""
    from hibag_tpu_torch.models.model import Classifier
    rng = np.random.default_rng(k)
    H = 50 + k
    return Classifier(
        snp_index=np.sort(rng.choice(300, 40, replace=False)).astype(np.int32),
        hap_bits=rng.integers(0, 2, (H, 40)).astype(np.uint8),
        hap_freq=rng.dirichlet(np.ones(H)),
        hap_allele=np.sort(rng.integers(0, 12, H)).astype(np.int32),
        bootstrap_count=rng.integers(0, 3, 80).astype(np.int32),
        oob_accuracy=float(rng.random()))


def gather_model(classifiers):
    from hibag_tpu_torch.models.model import AttrBagModel
    P, A = 300, 12
    return AttrBagModel(
        locus="A", snp_id=np.array([f"rs{i}" for i in range(P)], dtype=object),
        snp_position=np.arange(P, dtype=np.int64) * 100 + 29_900_000,
        snp_allele=np.array(["A/G"] * P, dtype=object),
        snp_allele_freq=np.full(P, 0.5),
        hla_alleles=[f"{i:02d}:01" for i in range(A)],
        hla_freq=np.full(A, 1.0 / A), assembly="hg19",
        sample_id=np.array([f"s{i}" for i in range(80)], dtype=object),
        classifiers=classifiers)


def await_claim(work_dir, timeout=60.0):
    """Return once `work_dir` holds a claim file."""
    deadline = time.monotonic() + timeout
    while not (os.path.isdir(work_dir) and os.listdir(work_dir)):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no claim in {work_dir} after {timeout} s")
        time.sleep(0.01)


def save_model(out, model):
    arrays = {"n": model.n_classifiers}
    for k, c in enumerate(model.classifiers):
        arrays.update({f"snp{k}": c.snp_index, f"bits{k}": c.hap_bits,
                       f"freq{k}": c.hap_freq, f"allele{k}": c.hap_allele,
                       f"oob{k}": c.oob_accuracy})
    np.savez(out, **arrays)


def main():
    task, coord, nproc, pid, work_dir, out = sys.argv[1:7]
    late = sys.argv[7:] == ["late"]
    nproc, pid = int(nproc), int(pid)
    torch.set_num_threads(2)
    from hibag_tpu_torch import train_distributed, train_dynamic
    from hibag_tpu_torch.parallel.mesh import (classifier_range,
                                               distributed_init,
                                               gather_classifiers,
                                               predict_distributed)

    dist = dict(coordinator=coord, num_processes=nproc, process_id=pid)
    if task.startswith("train-"):
        kw = dict(TRAIN_KW, **MODE_KW[task[len("train-"):]])
        save_model(out, train_distributed(*panel(), **kw, **dist))
    elif task == "dynamic":
        distributed_init(**dist)
        if late:
            await_claim(work_dir)
        save_model(out, train_dynamic(*panel(), job_size=1,
                                      work_dir=work_dir, **TRAIN_KW))
    elif task == "predict":
        model, geno = model_and_cohort()
        res = predict_distributed(model, geno, device="cpu", with_prob=True,
                                  **dist)
        np.savez(out, sample_id=res.sample_id.astype(str),
                 allele1=res.allele1.astype(str),
                 allele2=res.allele2.astype(str), prob=res.prob,
                 matching=res.matching, postprob=res.postprob)
    elif task == "gather":
        pi, pc = distributed_init(**dist)
        share = classifier_range(N_GATHER, pi, pc)
        local = gather_model([gather_classifier(k) for k in share])
        save_model(out, gather_classifiers(local, N_GATHER))
    else:
        raise SystemExit(f"unknown task {task!r}")
    print(f"process {pid}: {task} done")


if __name__ == "__main__":
    main()
