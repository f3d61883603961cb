"""Smoke run of the PyTorch/CUDA port (hibag_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the exit code is non-zero):
  1. device  — requires torch.cuda.is_available(); prints the card's name
               and nvidia-smi's name and power limit; TF32 off.
  2. build   — compiles hibag_tpu_torch/csrc/*.cu with nvcc into
               build/hibag_tpu_torch/ and prints the build seconds.
  3. kernel  — the ensemble kernel against its plain PyTorch version on the
               same CUDA tensors, prob and majority voting, H up to 1024 and
               A up to 128, with padded slots, all-missing and zero-weight
               samples and a forced exact tie; dmin exact, ens and total at
               rtol 3e-4. Then both timed at the slice's shape.
  4. slice   — a seeded synthetic model at the width of a published HLA-A
               model (100 classifiers, 1,000 SNPs, 48 alleles) saved to
               .npz and loaded back; predict(device="cuda") on 3,840
               samples, twice, the second timed. Checks that the kernel
               ran, that probabilities and matching are sane, that calls
               agree with the float64 scan engine on the first 256 samples
               outside the tie margin, and accuracy >= 0.9 against the
               planted truth.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
N_SLICE = 3840
N_F64 = 256
RTOL = 3e-4
ATOL = 1e-7


def _close(name, got, want, rtol=RTOL, atol=ATOL):
    """(max abs err, max rel err); raises when |got - want| > atol +
    rtol·|want| anywhere."""
    err = (got.double() - want.double()).abs()
    rel = err / want.double().abs().clamp_min(1e-30)
    bad = err > atol + rtol * want.double().abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} entries differ, max "
                             f"abs {err.max().item():.3e}")
    return err.max().item(), rel.max().item()


def _cuda_ms(fn, reps):
    """Mean device time of fn() over `reps` runs, after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script "
                           "needs a CUDA card")
    from hibag_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[dev.index]
    print(f"[device] {torch.cuda.get_device_name(dev)} | nvidia-smi: {card} "
          f"| torch {torch.__version__} cuda {torch.version.cuda}")
    print(card)
    return dev, card


def phase_build():
    from hibag_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    print(f"[build] {os.path.relpath(path)} in "
          f"{time.perf_counter() - t0:.2f} s")


def _case(rng, C, H, A, N, dev):
    """Random kernel inputs with padded slots, all-missing samples (0, 1),
    a zero-weight sample (3) and an exact tie: in classifier 0, alleles 0,
    1 and 2 hold one haplotype each, 0 and 1 identical with equal frequency,
    and sample 2 is haplotypes 0 + 2, so Q[0,2] == Q[1,2] is its maximum."""
    from hibag_tpu_torch.ops.ens_acc import pack_haplotypes

    bits = rng.integers(0, 2, (C, H, 128), dtype=np.uint8)
    freq = rng.dirichlet(np.ones(H), C)
    freq[:, H - H // 8:] = 0.0
    allele = np.sort(rng.integers(3, A, (C, H)), axis=1)
    allele[0, :3] = [0, 1, 2]
    bits[0, 1] = bits[0, 0]
    freq[0, 1] = freq[0, 0]
    g = rng.integers(0, 4, (C, N, 128)).astype(np.int8)
    g[:, :2] = 3
    g[0, 2] = bits[0, 0] + bits[0, 2]
    wgt = rng.random((C, N)).astype(np.float32)
    wgt[:, 3] = 0.0
    hap = pack_haplotypes(bits, freq, allele, A, dev)
    return (hap, torch.from_numpy(g).to(dev), torch.from_numpy(wgt).to(dev))


def phase_kernel(dev, hap, g, w, A):
    from hibag_tpu_torch.ops.ens_acc import (ensemble_accumulate,
                                             ensemble_accumulate_ref,
                                             unpack_bits)
    from hibag_tpu_torch.ops.scoring import posterior_scores, unordered_from_S

    rng = np.random.default_rng(SEED)
    cases = [(H, a) for H in (64, 128, 256, 512) for a in (9, 48, 128)]
    cases.append((1024, 128))
    for H, a in cases:
        ch, cg, cw = _case(rng, 3, H, a, 64, dev)
        S = posterior_scores(unpack_bits(ch.hb[0]), ch.freq[0], ch.allele[0],
                             cg[0, 2:3], a)["S"]
        Q = unordered_from_S(S)[0]
        if not (Q[0, 2] == Q[1, 2] == Q.max()):
            raise AssertionError(f"H={H} A={a}: the tie was not forced")
        for majority in (False, True):
            ens, dmin, total = ensemble_accumulate(ch, cg, cw, a, majority)
            torch.cuda.synchronize()
            ens_r, dmin_r, total_r = ensemble_accumulate_ref(ch, cg, cw, a,
                                                             majority)
            if not torch.equal(dmin, dmin_r):
                raise AssertionError(f"H={H} A={a}: dmin differs")
            _close(f"H={H} A={a} total", total, total_r)
            ea, er = _close(f"H={H} A={a} majority={majority} ens", ens, ens_r)
            print(f"[kernel] H={H} A={a} {'majority' if majority else 'prob'}"
                  f": dmin exact, ens max abs {ea:.3e} rel {er:.3e}")

    # at the slice's shape, on the slice's own tensors
    ens, dmin, total = ensemble_accumulate(hap, g, w, A)
    ens2, _, _ = ensemble_accumulate(hap, g, w, A)
    torch.cuda.synchronize()
    spread = (ens - ens2).abs().max().item()
    ens_r, dmin_r, total_r = ensemble_accumulate_ref(hap, g, w, A)
    if not torch.equal(dmin, dmin_r):
        raise AssertionError("slice shape: dmin differs")
    _close("slice shape total", total, total_r)
    max_abs, max_rel = _close("slice shape ens", ens, ens_r)
    ms = _cuda_ms(lambda: ensemble_accumulate(hap, g, w, A), 10)
    plain_ms = _cuda_ms(lambda: ensemble_accumulate_ref(hap, g, w, A), 3)
    C, H = hap.n_classifiers, hap.n_slots
    print(f"[kernel] slice shape C={C} N={g.shape[1]} H={H} A={A}: ens max "
          f"abs {max_abs:.3e} rel {max_rel:.3e}, run-to-run max abs "
          f"{spread:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def main():
    dev, card = phase_device()
    phase_build()

    from hibag_tpu_torch import AttrBagModel, predict
    from hibag_tpu_torch.data.geno import align_to_model
    from hibag_tpu_torch.models import predict as predict_mod
    from hibag_tpu_torch.ops import ens_acc
    from hibag_tpu_torch.utils.synthetic import (synthetic_cohort,
                                                 synthetic_model)

    built, pool = synthetic_model(SEED, n_classifiers=100, n_snp=1000,
                                  n_alleles=48)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.npz")
        built.save(path)
        model = AttrBagModel.load(path)
    geno, true1, true2 = synthetic_cohort(model, pool, N_SLICE, SEED + 1)
    A = model.n_alleles

    # phase 3 on the tensors predict() builds for the slice
    packed = model.pack()
    hap = predict_mod._prepare_ensemble(packed, dev)
    codes, _ = align_to_model(model, geno)
    g, w = predict_mod._gather_codes(
        torch.from_numpy(packed.snp_index).to(dev),
        torch.from_numpy(packed.snp_weight).to(dev),
        torch.from_numpy(codes).to(dev))
    timing = phase_kernel(dev, hap, g, w, A)

    # phase 4: the main path
    ens_acc.LAUNCHES = 0
    predict(model, geno, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = predict(model, geno, device="cuda")
    elapsed = time.perf_counter() - t0
    launches = ens_acc.LAUNCHES
    if launches < 1:
        raise AssertionError("predict() did not launch the ensemble kernel")
    t0 = time.perf_counter()
    align_to_model(model, geno)
    t_align = time.perf_counter() - t0

    # float32 sums may end an ulp above 1: the bound of tests/test_predict.py
    if not (np.all(res.prob > 0) and np.all(res.prob <= 1 + 1e-4)):
        raise AssertionError("probabilities outside (0, 1 + 1e-4]")
    if not np.all(np.isfinite(res.matching)):
        raise AssertionError("non-finite matching")
    acc = res.accuracy_vs(true1, true2)
    if acc < 0.9:
        raise AssertionError(f"accuracy {acc:.4f} < 0.9")

    sub = geno.subset(samp_mask=np.arange(N_F64))
    r64 = predict(model, sub, device="cuda", dtype=np.float64, with_prob=True)
    top2 = -np.sort(-r64.postprob, axis=0)[:2]
    clear = top2[0] - top2[1] > 1e-4 * top2[0]
    same = ((res.allele1[:N_F64] == r64.allele1)
            & (res.allele2[:N_F64] == r64.allele2))
    if not np.all(same[clear]):
        raise AssertionError(f"{int((~same[clear]).sum())} calls differ from "
                             "the float64 scan engine outside the tie margin")

    rate = N_SLICE / elapsed
    print(f"[slice] C={model.n_classifiers} P={model.n_snp} A={A} "
          f"N={N_SLICE}: {rate:.1f} samples/s ({elapsed * 1e3:.2f} ms; "
          f"align_to_model {t_align * 1e3:.2f} ms on the host, kernel "
          f"{timing['ms']:.4f} ms), accuracy {acc:.4f}, kernel launches "
          f"{launches}, f64 calls equal on {int(clear.sum())}/{N_F64} "
          f"clear samples | {card}")

    print(json.dumps({"kernels": [{
        "name": "ens_acc", "route": "cuda",
        "source": "hibag_tpu_torch/csrc/ens_acc.cu",
        "replaces": "hibag_tpu/ops/scoring_pallas.py:140",
        "launches": launches, **timing}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
