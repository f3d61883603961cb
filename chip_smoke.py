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
               samples and a forced exact tie, codes with heterozygous calls
               in all four 32-SNP words, in none and only in word 3, and
               classifiers in which one allele holds most haplotypes; two
               runs bitwise equal, dmin exact, ens and total at rtol 3e-4.
               Then at the slice's shape (two runs bitwise equal) and both
               timed there.
  4. slice   — a seeded synthetic model at the width of a published HLA-A
               model (100 classifiers, 1,000 SNPs, 48 alleles) saved to
               .npz and loaded back; predict(device="cuda") on 3,840
               samples, twice, the second timed, and once more: calls, prob
               and matching bitwise equal to the timed call's, and two
               calls with_prob=True with bitwise-equal postprob. Checks
               that the kernel ran, that probabilities and matching are
               sane, that calls
               agree with the float64 scan engine on the first 256 samples
               outside the tie margin, and accuracy >= 0.9 against the
               planted truth.
  3b. train kernels — the EM step kernel (int8 and bit-packed masks) and
               the candidate-evaluation kernel against their plain PyTorch
               versions on the same CUDA tensors: H 128..1024 (4096 for the
               evaluation), A 4..128, C 1..64, with all-missing and
               zero-weight samples, haplotypes dropped per candidate and two
               candidates with the same genotype column (an exact tie),
               at both training cells' step shapes (K=8, S=1,024, H=256,
               C=17 and K=25, S=64, H=128, C=32; A=14), and a case of
               untyped samples. EM outputs at rtol 1e-4; evaluation counts
               exact and -2logLik at rtol 1e-4 (for the untyped case over
               the samples whose true pair scores at least 2^-100, the
               difference over all printed); each kernel run twice must
               agree bitwise. The EM's packed and re-matched mask tiers
               against its int8 tier through em_all_candidates. The
               packed EM kernel also with one allele at H=1,024 (whole
               blocks match: the pair lists overflow to the block), S=5,
               every B = 0, C = 1 and C = 64, each bitwise equal under the
               forced device-memory plan and with every sample taken by the
               block (no pair lists), and classifiers stepped alone bitwise equal to a
               batch; timed (three 10-launch means) at the slice's, the
               headline step's and a re-seated mid-scale classifier's
               shapes (PACKED_SHAPES). The
               evaluation kernel also on samples with heterozygous codes in
               0..4 of the four 32-SNP words, at C=64 with identical
               candidates across float4 boundaries (EVAL_TWINS,
               bitwise equal) at H=256 and H=4,096 (its device-memory plan,
               timed) and the headline step (C=32); there and at the
               mid-scale step shape also under the budget that forces the
               device-memory plan (bitwise equal to the default
               shared-memory plan; both timed). Then each kernel timed
               beside its plain version at the mid-scale cell's step
               shape.
  5. train   — a seeded synthetic typed panel of 1,000 samples x 266 SNPs and
               14 alleles, its haplotypes mosaics away from the middle SNP
               (synthetic.PANEL_RECOMBINATION switches per Mb, which puts
               the classifiers around hcap);
               train_parallel(mode="fused", device="cuda") of 8
               classifiers (hcap=256, max_steps=192, on_overflow="freeze",
               mtry=17) twice, the second timed.
               Checks that the EM and evaluation kernels ran, that the two
               runs' classifiers are bitwise equal, frequencies sum to 1,
               mean OOB accuracy >= 0.9, and that the model predicts 500
               held-out samples at accuracy >= 0.9 through the ensemble
               kernel. Prints the haplotype counts, the freeze re-seats and
               how many classifiers an engine="torch" run on the card
               agrees with.
  6. packed  — the headline training shape: 60 samples (64 padded) x 1,000
               SNPs, 25 classifiers, hcap=128, mtry=32, on a mosaic panel,
               with a mask budget that puts the EM on the bit-packed tier;
               checks that the packed kernel ran, and times a second run.
  7. wide    — the scoring kernel (through ensemble_scores, and through
               posterior_scores_kernel, its call at one classifier) against
               its plain PyTorch version on the same CUDA tensors: H
               64..4,096, A 1..1,024, C 1 and 8, with padded slots,
               all-missing samples, a forced exact tie, the three
               heterozygous-word patterns, dominant-allele classifiers (the
               warp-split cells; one at 300 alleles, where the cells' minima
               go to device scratch) and a case of ordered pairs within and
               across alleles; dmin exact, S exactly symmetric, S and total
               at rtol 2e-4 and atol 1e-30, two runs bitwise equal. Then a
               seeded synthetic model at the published HLA-A model's width
               (100 classifiers, 1,000 SNPs) with 160 alleles and 600-1,600
               haplotypes per classifier, wider than the ensemble kernel
               takes, saved to .npz and loaded back; the kernel timed at the
               scan engine's chunk shape (SCAN_CCHUNK classifiers) and at one
               classifier beside its plain version; predict(device="cuda")
               on 1,024 samples twice, the second timed, and the repeat
               checks of phase 4. Checks that the
               scoring kernel ran in the timed run and the ensemble kernel
               did not, accuracy >= 0.9, sane probabilities and matching, and
               calls equal to the float64 scan engine on the first 64 samples
               outside the tie margin.
  8. host    — the host trainer on the card: train_parallel(mode="host",
               device="cuda") of HOST_K classifiers on phase 5's panel
               (mtry=17, one batch) twice, the second timed; checks that
               the EM and evaluation kernels ran, the two runs' classifiers
               are bitwise equal, frequencies sum to 1, mean OOB and
               held-out accuracy (through the ensemble kernel) >= 0.9, and
               that the first greedy step's EM step and evaluation through
               the kernels match their plain versions on the same CUDA
               tensors (EM at rtol 1e-4; counts exact, -2logLik at rtol
               1e-4). Prints classifiers/s beside phase 5's, the greedy
               steps, the launches per kernel and the EM mask tiers used.
               Then train() of 4 classifiers through grow_classifier on
               phase 6's panel; out_of_bag of the host model on the card
               (one ensemble-kernel launch per classifier at least); and
               publish -> .npz -> load -> predict, whose held-out calls
               must equal the trained model's.
  9. files   — the CLI (hibag_tpu_torch.cli) from files, on the card: phase
               4's model written as .RData (save_rdata) and its cohort as
               PLINK .bed/.bim/.fam (write_plink) and BGZF .vcf.gz
               (write_geno_vcf); `impute --model M.RData --geno cohort.bed`
               in this process, timed by layer (read, align, predict,
               write), must launch the ensemble kernel, and its TSV must
               hold predict()'s calls, prob and matching (%.6g); accuracy
               >= 0.9; the .vcf.gz input gives the same TSV, and so does
               `python -m hibag_tpu_torch impute` in a new process with no
               --device. `impute --engine jnp` on the first 256 samples
               launches the scoring kernel and not the ensemble kernel, with
               the calls outside the tie margin. `train` (fused, 25
               classifiers, hcap 128, mtry 32, the flank filter on) from
               phase 6's panel as PLINK plus an HLA table launches the EM and
               evaluation kernels, mean OOB >= 0.9; `impute` with the
               trained .npz and `report` against the truth, whose accuracy
               must be compare_alleles'. `convert` .RData -> .npz -> .RData
               and `summary`: the model that comes back equals phase 4's.
  10. limits — the kernels past their old limits of 4,096 slots and 128
               alleles, each against its plain version on seeded tie-free
               inputs (LIMIT_EM, LIMIT_EVAL, LIMIT_SCORES): both EM kernels
               at H 4,160 and 10,016 and C 1, 17 and 64; the evaluation at
               A 130 and 320 and H 64 to 10,016; both at the wide
               training's own shapes (K=2, C=17, H=832, 1,000 samples, the
               evaluation at A=160); scoring at H 4,160 and
               10,016 and A 14 and 160. Counts and dmin exact, other values
               at rtol 1e-4 (scoring: 2e-4), two runs bitwise equal, every
               other plan or route that fits (device-memory plans, slot
               records in device memory, one scoring block a classifier)
               bitwise equal to the default; each timed beside its bound and
               plain version. Then the wide panel (WIDE_PANEL: 1,000 x 266
               SNPs, 160 alleles, an HLA-B-like locus) trained by
               train_parallel(mode="host") and (mode="fused") of WIDE_K
               classifiers with no engine= override: the kernels launched,
               mean OOB and held-out accuracy >= 0.9, the held-out
               prediction and out_of_bag through the scoring kernel (A=160
               is past the ensemble kernel); how many classifiers an
               engine="torch" run matches over the first WIDE_TORCH_STEPS
               greedy steps is printed as a reading. Last, a fused training
               at hcap=4,160 (on_overflow="freeze"): every step's kernels at
               H=4,160, of which a few hundred slots are live (the rest
               padding; the live count is printed).
  11. mesh  — the classifiers split over mesh A = ["cuda:0", "cuda:0"]
               (two shards on the one card), on earlier phases' artifacts:
               (a) predict(devices=mesh A, with_prob=True) of phase 4's model
               and cohort twice (bitwise equal; calls equal phase 4's;
               postprob and matching at rtol 2e-4, atol 1e-6 of one card's;
               ens_acc launches 2 x the blocks; the second timed), and of
               phase 7's model (scoring-kernel launches, one per shard's
               chunk and block, no ens_acc; calls equal phase 7's outside
               the tie margin); (b) train_parallel(mesh=mesh A) host (phase
               8's arguments) and fused (phase 5's): SNPs, haplotypes,
               bootstraps and OOB equal the one-card runs', frequencies at
               rtol 1e-5, every shard step in a shard's thread with its
               kernels; (c) the evaluation, int8 EM and packed EM kernels at
               K=8, S=1,024, H=256, C=17, A=14 bitwise equal to two launches
               of K=4; (d) one pair of `chip_smoke.py --dist-worker`
               processes on the card over gloo, each running in turn
               train_distributed (phase 5's arguments: equal phase 5's
               classifiers), train_dynamic (phase 6's panel and mask budget,
               K=8, two per job, worker 1 joining once worker 0 has
               claimed a job: every claim taken once, each worker claiming
               jobs and launching the packed EM, equal a one-process run)
               and predict_distributed of phase 4's model (calls equal phase
               4's, prob at rtol 2e-4). At most MESH_BUDGET_S seconds; its
               speeds are two shards on one card, not a multi-GPU speed.
`python3 chip_smoke.py --limits` runs phases 1, 2 and 10 alone, and
`python3 chip_smoke.py --mesh` phases 1, 2 and 11 (with phase 11's inputs
made anew).
The line before the last is the kernels' JSON record (each kernel's
launches on its phase's timed main-path run, with the counts set to 0 just
before it; its time and its plain version's; its bound from this run's
inputs); the last line is {"ok": true, "device": {...}}.
"""

import functools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

SEED = 0
#: classifiers of phase 8's host training (the batch)
HOST_K = 8
N_SLICE = 3840
N_F64 = 256
N_WIDE = 1024
N_WIDE_F64 = 64
RTOL = 3e-4
ATOL = 1e-7
#: the scoring kernel's tolerance (tests/test_pallas.py:33-38)
SCORE_RTOL, SCORE_ATOL = 2e-4, 1e-30

#: H100 SXM data sheet: device-memory rate and float32 rate outside the
#: tensor cores
MEM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
#: 32-bit population counts per clock per SM at compute capability 9.0
#: (CUDA C++ Programming Guide, arithmetic instruction throughput)
POPC_PER_CLOCK_SM = 16


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


@functools.cache
def _popc_rate():
    """(popcounts per second, SMs, max SM clock in MHz) of the current card:
    POPC_PER_CLOCK_SM x its SM count x nvidia-smi's clocks.max.sm."""
    dev = torch.cuda.current_device()
    clk = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.splitlines()[dev])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * POPC_PER_CLOCK_SM * clk * 1e6, sms, clk


def _bound(nbytes, popc=0.0, flops=0.0):
    """The least time the card could take: the larger of `nbytes` over the
    memory rate and the operations over their peak rates (popcounts, float32
    operations), and which of the two bounds it."""
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = max(popc / _popc_rate()[0], flops / F32_FLOP_PER_S)
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _pairs(nh, n):
    """Unordered pairs of valid haplotypes, n * sum over classifiers of
    m(m+1)/2 for m = nh[c]: the pair distances a scoring function needs."""
    m = nh.double()
    return n * float((m * (m + 1) / 2).sum())


def _pair_popc(nh, g):
    """Popcounts the pair distances need: for classifier c and sample n, one
    per unordered pair of c's nh[c] valid haplotypes and 32-slot word of
    g[c, n] (codes int8 [C, N, 128]) that holds a heterozygous code. A
    pair's distance is a_i + a_j + popc(~(h_i ^ h_j) & het) over the words,
    and a word without a heterozygous code adds 0: slots past a classifier's
    SNPs hold code 3."""
    het = (g.reshape(*g.shape[:-1], -1, 32) == 1).any(-1).sum(-1)
    m = nh.double()
    return float(((m * (m + 1) / 2)[:, None] * het.double()).sum())


def _hap_bytes(hap):
    return 4 * (hap.hb.numel() + hap.freq.numel() + hap.allele.numel()
                + hap.nh.numel())


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


#: PLINK's 2-bit code of each genotype code (copies of the .bim's first
#: allele 0, 1, 2, then missing): 11, 10, 00, 01
_PLINK_BITS = np.array([3, 2, 0, 1], dtype=np.uint8)


def write_plink(geno, prefix, chrom="6"):
    """`geno` (SNPGenoData) as a SNP-major PLINK fileset prefix.bed/.bim/.fam
    on chromosome `chrom` (a name, or one per SNP), each .bim line's first
    allele the one its genotype codes count."""
    bits = _PLINK_BITS[np.minimum(np.asarray(geno.genotype), 3)]
    bits = np.pad(bits, ((0, 0), (0, -bits.shape[1] % 4)))
    q = bits.reshape(bits.shape[0], -1, 4)
    packed = q[..., 0] | q[..., 1] << 2 | q[..., 2] << 4 | q[..., 3] << 6
    with open(prefix + ".bed", "wb") as f:
        f.write(b"\x6c\x1b\x01" + packed.astype(np.uint8).tobytes())
    chrom = np.broadcast_to(np.asarray(chrom, dtype=object), (geno.n_snp,))
    with open(prefix + ".bim", "w") as f:
        for c, s, p, a in zip(chrom, geno.snp_id, geno.snp_position,
                              geno.snp_allele):
            a1, a2 = str(a).split("/")
            f.write(f"{c}\t{s}\t0\t{p}\t{a1}\t{a2}\n")
    with open(prefix + ".fam", "w") as f:
        f.writelines(f"{s}\t{s}\t0\t0\t0\t-9\n" for s in geno.sample_id)
    return prefix + ".bed"


def write_geno_vcf(geno, path, chrom="6"):
    """`geno` as a VCF of GT calls (REF the allele its codes count), BGZF
    through hibag_tpu_torch.io.bgzf.BgzfWriter when `path` ends in .gz."""
    from hibag_tpu_torch.io.bgzf import BgzfWriter

    gt = np.array(["1/1", "0/1", "0/0", "./."], dtype=object)
    chrom = np.broadcast_to(np.asarray(chrom, dtype=object), (geno.n_snp,))
    with (BgzfWriter(path, "wt") if path.endswith(".gz")
          else open(path, "w")) as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\t" + "\t".join(geno.sample_id) + "\n")
        for i in range(geno.n_snp):
            ref, alt = str(geno.snp_allele[i]).split("/")
            f.write(f"{chrom[i]}\t{geno.snp_position[i]}\t{geno.snp_id[i]}\t"
                    f"{ref}\t{alt}\t.\tPASS\t.\tGT\t"
                    + "\t".join(gt[np.minimum(geno.genotype[i], 3)]) + "\n")
    return path


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
    popc, sms, clk = _popc_rate()
    print(f"[device] {torch.cuda.get_device_name(dev)} | nvidia-smi: {card} "
          f"| torch {torch.__version__} cuda {torch.version.cuda} | bound "
          f"rates: memory {MEM_BYTES_PER_S:.3e} B/s, float32 "
          f"{F32_FLOP_PER_S:.3e} FLOP/s, popcount {popc:.4e}/s ({sms} "
          f"SMs x {POPC_PER_CLOCK_SM} x {clk:.0f} MHz)")
    print(card)
    return dev, card


def phase_build():
    from hibag_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    print(f"[build] {os.path.relpath(path)} in "
          f"{time.perf_counter() - t0:.2f} s")


#: genotype patterns the scoring kernels' distance branches on: a
#: heterozygous code in each of the four 32-SNP words, in none, and only in
#: word 3 (SNP slots 96..127)
HET_PATTERNS = ("all4", "none", "word3")


def het_codes(rng, pattern, shape):
    """int8 genotype codes of `shape` (last axis 128) drawn from {0, 1, 2,
    3 = missing} with heterozygous codes (1) placed by `pattern`, one of
    HET_PATTERNS, or anywhere for None."""
    if pattern is None:
        return rng.integers(0, 4, shape).astype(np.int8)
    g = rng.choice(np.array([0, 2, 3], np.int8), shape)
    if pattern == "all4":
        g[..., 64:] = rng.integers(0, 4, (*shape[:-1], 64))
        g[..., [5, 37, 69, 101]] = 1
    elif pattern == "word3":
        g[..., 96:] = rng.integers(0, 4, (*shape[:-1], 32))
        g[..., 100] = 1
    elif pattern != "none":
        raise ValueError(f"unknown pattern {pattern!r}")
    return g


def dominant_alleles(rng, C, H, A, lo=0):
    """Sorted allele indices [C, H] in [lo, A) of which about 7 in 8 are lo:
    one allele holds most haplotypes, so its cells hold thousands of pairs
    and the kernels split them over a warp."""
    allele = rng.integers(lo, A, (C, H))
    allele[rng.random((C, H)) < 0.875] = lo
    return np.sort(allele, axis=1)


def _case(rng, C, H, A, N, dev, pattern=None, dominant=False):
    """Random kernel inputs with padded slots, all-missing samples (0, 1),
    a zero-weight sample (3) and an exact tie: in classifier 0, alleles 0,
    1 and 2 hold one haplotype each, 0 and 1 identical with equal frequency,
    and sample 2 is haplotypes 0 + 2, so Q[0,2] == Q[1,2] is its maximum.
    The other samples' codes follow `pattern` (het_codes); with `dominant`
    the other haplotypes' alleles are dominant_alleles'."""
    from hibag_tpu_torch.ops.ens_acc import pack_haplotypes

    bits = rng.integers(0, 2, (C, H, 128), dtype=np.uint8)
    freq = rng.dirichlet(np.ones(H), C)
    freq[:, H - H // 8:] = 0.0
    allele = (dominant_alleles(rng, C, H, A, lo=3) if dominant
              else np.sort(rng.integers(3, A, (C, H)), axis=1))
    allele[0, :3] = [0, 1, 2]
    bits[0, 1] = bits[0, 0]
    freq[0, 1] = freq[0, 0]
    g = het_codes(rng, pattern, (C, N, 128))
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
    cases = [(H, a, None, False) for H in (64, 128, 256, 512)
             for a in (9, 48, 128)]
    cases.append((1024, 128, None, False))
    cases += [(256, 48, p, False) for p in HET_PATTERNS]
    cases += [(1024, 48, None, True), (512, 9, "word3", True)]
    for H, a, pattern, dominant in cases:
        ch, cg, cw = _case(rng, 3, H, a, 64, dev, pattern, dominant)
        S = posterior_scores(unpack_bits(ch.hb[0]), ch.freq[0], ch.allele[0],
                             cg[0, 2:3], a)["S"]
        Q = unordered_from_S(S)[0]
        label = (f"H={H} A={a}" + (f" {pattern}" if pattern else "")
                 + (" dominant" if dominant else ""))
        if not (Q[0, 2] == Q[1, 2] == Q.max()):
            raise AssertionError(f"{label}: the tie was not forced")
        for majority in (False, True):
            out = ensemble_accumulate(ch, cg, cw, a, majority)
            out2 = ensemble_accumulate(ch, cg, cw, a, majority)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(out, out2)):
                raise AssertionError(f"{label}: two runs differ")
            ens, dmin, total = out
            ens_r, dmin_r, total_r = ensemble_accumulate_ref(ch, cg, cw, a,
                                                             majority)
            if not torch.equal(dmin, dmin_r):
                raise AssertionError(f"{label}: dmin differs")
            _close(f"{label} total", total, total_r)
            ea, er = _close(f"{label} majority={majority} ens", ens, ens_r)
            print(f"[kernel] {label} {'majority' if majority else 'prob'}: "
                  f"two runs bitwise equal, dmin exact, ens max abs {ea:.3e} "
                  f"rel {er:.3e}")

    # at the slice's shape, on the slice's own tensors
    ens, dmin, total = ensemble_accumulate(hap, g, w, A)
    again = ensemble_accumulate(hap, g, w, A)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip((ens, dmin, total), again)):
        raise AssertionError("slice shape: two runs differ")
    ens_r, dmin_r, total_r = ensemble_accumulate_ref(hap, g, w, A)
    if not torch.equal(dmin, dmin_r):
        raise AssertionError("slice shape: dmin differs")
    _close("slice shape total", total, total_r)
    max_abs, max_rel = _close("slice shape ens", ens, ens_r)
    ms = _cuda_ms(lambda: ensemble_accumulate(hap, g, w, A), 10)
    plain_ms = _cuda_ms(lambda: ensemble_accumulate_ref(hap, g, w, A), 3)
    C, H, N = hap.n_classifiers, hap.n_slots, int(g.shape[1])
    bound = _bound(_hap_bytes(hap) + g.numel() + 4 * w.numel()
                   + 4 * N * A * A + 8 * C * N, popc=_pair_popc(hap.nh, g),
                   flops=2 * _pairs(hap.nh, N))
    print(f"[kernel] slice shape C={C} N={N} H={H} A={A}: ens max "
          f"abs {max_abs:.3e} rel {max_rel:.3e}, two runs bitwise equal; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, **bound}


def _train_case(rng, K, C, H, A, S, dev, n_sel=24, typed=True,
                het_words=None, twins=((0, 1),), masks=None):
    """Kernel inputs of the training step: haplotypes in frequency order
    (alleles not grouped) with empty slots; samples 0 and 1 all-missing
    (sample 0 with weight), sample 2 of weight 0; frequencies dropped per
    candidate for the evaluation; for each (c, d) in ``twins`` (d < C),
    candidate d's genotype column and frequencies equal candidate c's. With
    ``typed`` the other samples carry two of the first 16 haplotypes, which
    no candidate drops, as a training panel does; else random codes, so that
    a sample's true pair can lie far from its nearest pair and score in
    float32's denormal range (as after erase_rare drops a sample's true
    haplotypes). With ``het_words`` = w (and n_sel = 128) those samples hold
    heterozygous codes in exactly the last w of the four 32-SNP words: the
    others' are made missing, and each kept word gets one. The EM's int8
    and packed masks are made with `masks` (by default up to H=1,024; with
    "packed", the packed mask alone)."""
    from hibag_tpu_torch.models.em import match_pairs, match_pairs_packed

    L = 128
    bits = np.zeros((K, H, L), np.float32)
    bits[:, :, :n_sel] = rng.integers(0, 2, (K, H, n_sel))
    freq = rng.random((K, H)).astype(np.float32)
    freq[:, H - H // 8:] = 0.0
    freq /= freq.sum(1, keepdims=True)
    allele = rng.integers(0, A, (K, H)).astype(np.int32)
    allele[:, :16] = allele[0, :16]
    pair = rng.integers(0, 16, (2, S))
    geno = np.full((K, S, L), 3, np.int8)
    if typed:
        geno[:, 3:, :n_sel] = (bits[:, pair[0, 3:], :n_sel]
                               + bits[:, pair[1, 3:], :n_sel])
    else:
        geno[:, 3:, :n_sel] = rng.integers(0, 3, (K, S - 3, n_sel))
    if het_words is not None:
        for w in range(4):
            word = geno[:, 3:, 32 * w:32 * (w + 1)]
            if w < 4 - het_words:
                word[word == 1] = 3
            else:
                word[..., 5] = 1
    a12 = np.sort(allele[0][pair], 0).astype(np.int32)
    B = rng.multinomial(S, np.ones(S) / S, size=K).astype(np.float32)
    B[:, 0] = 1.0
    B[:, 2] = 0.0
    gc = rng.integers(0, 4, (K, C, S)).astype(np.int8)
    gc[:, :, :2] = 3
    valid = (freq > 0)[:, None, :]
    fA = (np.abs(rng.normal(0, .1, (K, C, H))) * valid).astype(np.float32)
    fB = (np.abs(rng.normal(0, .1, (K, C, H))) * valid).astype(np.float32)
    drop = rng.random((2, K, C, H)) < 0.3
    drop[..., :16] = False
    fAe = np.where(drop[0], 0, fA).astype(np.float32)
    fBe = np.where(drop[1], 0, fB).astype(np.float32)
    for c0, c1 in twins:
        if c1 < C:
            gc[:, c1] = gc[:, c0]
            for x in (fA, fB, fAe, fBe):
                x[:, c1] = x[:, c0]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    c = dict(bits=t(bits), freq=t(freq), allele=t(allele), geno=t(geno),
             a1=t(a12[0]), a2=t(a12[1]), B=t(B), gc=t(gc), fA=t(fA),
             fB=t(fB), fAe=t(fAe), fBe=t(fBe), oob=t(B == 0), A=A)
    args = (c["bits"], c["freq"] > 0, c["allele"], c["geno"], c["a1"],
            c["a2"])
    if masks if masks is not None else H <= 1024:
        if masks != "packed":
            c["mask"] = match_pairs(*args).to(torch.int8)
        c["packed"] = match_pairs_packed(*args)
    return c


def _em_calls(c):
    from hibag_tpu_torch.ops import train_step as ts
    em = (c["fA"], c["fB"], c["mask"], c["gc"], c["B"], 1000.0)
    pk = (c["fA"], c["fB"], c["packed"], c["gc"], c["B"], 1000.0)
    return {"em_estep": (ts.em_estep, ts.em_estep_ref, em),
            "em_estep_packed": (ts.em_estep_packed, ts.em_estep_packed_ref,
                                pk)}


def _eval_call(c):
    from hibag_tpu_torch.ops import train_step as ts
    args = (c["bits"], c["allele"], c["fAe"], c["fBe"], c["gc"], c["geno"],
            c["a1"], c["a2"], c["oob"], c["B"], c["A"])
    return ts.evaluate_candidates_kernel, ts.evaluate_candidates_ref, args


def _check_train_kernel(name, kern, ref, args, label, check_ll=True,
                        twins=((0, 1),)):
    """Runs `kern` twice and `ref` once on `args`: the two runs must agree
    bitwise, EM outputs at rtol 1e-4, evaluation counts exactly, the
    identical candidates of each pair in `twins` bitwise equal in counts and
    -2logLik and, with `check_ll`, -2logLik at rtol 1e-4. Returns the max
    abs error (of -2logLik when not checked: its max rel error)."""
    out = kern(*args)
    out2 = kern(*args)
    torch.cuda.synchronize()
    want = ref(*args)
    if not all(torch.equal(x, y) for x, y in zip(out, out2)):
        raise AssertionError(f"{name} {label}: two runs differ")
    if name != "evaluate_candidates_kernel":
        return max(_close(f"{name} {label} output {i}", x, y, rtol=1e-4,
                          atol=1e-9)[0]
                   for i, (x, y) in enumerate(zip(out, want)))
    if not torch.equal(out[0], want[0]):
        raise AssertionError(f"{name} {label}: accuracy counts differ in "
                             f"{int((out[0] != want[0]).sum())} places")
    for c0, c1 in twins:
        if c1 < out[0].shape[1] and not (
                torch.equal(out[0][:, c0], out[0][:, c1])
                and torch.equal(out[1][:, c0], out[1][:, c1])):
            raise AssertionError(f"{name} {label}: identical candidates "
                                 f"{c0} and {c1} differ")
    if not check_ll:
        rel = (out[1].double() - want[1].double()).abs() \
            / want[1].double().abs().clamp_min(1e-30)
        return rel.max().item()
    return _close(f"{name} {label} ll", out[1], want[1], rtol=1e-4,
                  atol=1e-6)[0]


def _resolved(args):
    """The evaluation's arguments with weight 0 on each sample whose true
    pair scores below 2^-100 for some candidate in the plain version, and
    the count of such weighted samples. Above 2^-100 every term of the
    score is summed at float32's full precision; below, terms fall into the
    denormal range, where the kernel's and the plain version's orders of
    summation keep different bits."""
    from hibag_tpu_torch.models import em

    _, _, tq, _ = em.evaluate_candidates(*args, per_sample=True)
    ok = (tq >= 2.0 ** -100).all(dim=1)
    B = args[9]
    return (*args[:9], B * ok, *args[10:]), int(((B > 0) & ~ok).sum())


def _check_em_tiers(dev):
    """em_all_candidates through the EM kernels on the three mask tiers of
    one problem: H=248 slots (padded to 256 for the kernel) and S=160
    samples, so that the re-matched tier runs the int8 kernel on three
    sample chunks. The packed and re-matched tiers must agree with the int8
    tier at rtol 1e-4, and the re-matched tier with itself bitwise. Returns
    the largest absolute difference."""
    from hibag_tpu_torch.models.em import em_all_candidates
    from hibag_tpu_torch.ops import train_step as ts

    K, C, H, S = 2, 17, 248, 160
    c = _train_case(np.random.default_rng(SEED + 5), K, C, H, 14, S, dev)
    afreq = torch.from_numpy(np.random.default_rng(SEED + 6).uniform(
        0.1, 0.9, (K, C)).astype(np.float32)).to(dev)
    run = lambda budget: em_all_candidates(
        c["freq"], c["freq"] > 0, c["bits"], c["allele"], c["geno"],
        c["a1"], c["a2"], c["B"], c["gc"], afreq, float(S),
        mask_budget=budget, engine="cuda")
    before = dict(ts.LAUNCHES)
    int8 = run(None)
    packed = run(S * 256 * 32)
    remat, remat2 = run(0), run(0)
    torch.cuda.synchronize()
    launched = {k: ts.LAUNCHES[k] - before[k] for k in before}
    if launched["em_estep_packed"] < 1:
        raise AssertionError("the packed tier did not launch its kernel")
    if launched["em_estep"] < int(int8[3].max()) + 3 * int(remat[3].max()):
        raise AssertionError("the re-matched tier did not launch the EM "
                             "kernel once per sample chunk")
    if not all(torch.equal(x, y) for x, y in zip(remat, remat2)):
        raise AssertionError("the re-matched tier differs run to run")
    worst = 0.0
    for tier, got in (("packed", packed), ("remat", remat)):
        for i, (x, y) in enumerate(zip(got[:3], int8[:3])):
            worst = max(worst, _close(f"EM {tier} tier output {i}", x, y,
                                      rtol=1e-4, atol=1e-9)[0])
    print(f"[train-kernel] EM tiers at K={K} C={C} H={H} S={S}: packed and "
          f"re-matched (3 chunks) agree with int8, max abs {worst:.3e}; "
          f"iterations int8 {int8[3].tolist()} packed {packed[3].tolist()} "
          f"re-matched {remat[3].tolist()}; re-matched bitwise "
          "deterministic")
    return worst


#: (K, C, H, A, S) where the packed EM kernel's launches happen: the
#: headline training step, and a mid-scale classifier re-seated at 512
#: slots (the packed tier's K=1 calls of phase 5)
PACKED_SHAPES = ((25, 32, 128, 14, 64), (1, 17, 512, 14, 1000))


def _packed_variants(c, label):
    """The packed EM kernel on c under the budget that forces its
    device-memory plan and with a pair list of 0 (every sample taken by
    the whole block): both must give bitwise the default's outputs.
    Returns the default plan (G, R, shared)."""
    from hibag_tpu_torch.ops import _build
    from hibag_tpu_torch.ops import train_step as ts

    _, _, args = _em_calls(c)["em_estep_packed"]
    want = ts.em_estep_packed(*args)
    K, C, H = c["fA"].shape
    smem = _build.load().hibag_em_packed_smem
    plan = ts.em_packed_plan(H, C, int(c["B"].shape[1]), smem)
    device = int(smem(H, C, ts.EM_PAIR_LIST, 0))
    for kw in ({"smem_budget": device}, {"pair_list": 0},
               {"smem_budget": device, "pair_list": 0}):
        got = ts.em_estep_packed(*args, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"em_estep_packed {label}: {kw} differs "
                                 "from the default plan")
    return plan


def _check_packed_alone(c, label):
    """Each classifier of c stepped alone by the packed EM kernel gives
    bitwise its dfA, dfB and dll inside the batch."""
    from hibag_tpu_torch.ops import train_step as ts

    _, _, args = _em_calls(c)["em_estep_packed"]
    batch = ts.em_estep_packed(*args)
    for k in range(c["fA"].shape[0]):
        one = ts.em_estep_packed(*(x[k:k + 1].contiguous() for x in args[:5]),
                                 args[5])
        torch.cuda.synchronize()
        if not all(torch.equal(x[k:k + 1], y) for x, y in zip(batch, one)):
            raise AssertionError(f"em_estep_packed {label}: classifier {k} "
                                 "alone differs from the batch")


def _check_packed_cases(rng, dev):
    """Phase 3b's packed EM cases, each against the plain version (rtol
    1e-4, atol 1e-9), run twice bitwise, and bitwise equal under the forced
    device-memory plan and with every sample taken by the block: one allele
    at H=1,024 (whole blocks match, the pair lists overflow), S below one
    batch of warps, every B = 0, C = 1 and C = 64 (at H=128 in shared
    memory, at H=256 in device memory); then classifiers stepped alone and
    in a batch, bitwise equal. Returns the max abs error."""
    name = "em_estep_packed"
    worst = 0.0
    for K, C, H, A, S, what in ((1, 17, 1024, 1, 32, "one allele"),
                                (2, 17, 256, 14, 5, "S=5"),
                                (2, 17, 256, 14, 64, "every B = 0"),
                                (2, 1, 256, 14, 64, "C=1"),
                                (2, 64, 128, 14, 64, "C=64"),
                                (2, 64, 256, 14, 40, "C=64")):
        c = _train_case(rng, K, C, H, A, S, dev)
        if what == "every B = 0":
            c["B"].zero_()
        label = f"K={K} C={C} H={H} A={A} S={S} {what}"
        e = _check_train_kernel(name, *_em_calls(c)[name], label)
        worst = max(worst, e)
        plan = _packed_variants(c, label)
        pairs = (c["mask"] != 0).sum(dim=(2, 3))
        print(f"[train-kernel] {name} {label}: plan (G, R, shared) {plan}, "
              f"pairs per sample {int(pairs.min())}..{int(pairs.max())}; "
              f"bitwise deterministic, the forced device plan and block-taken "
              f"samples "
              f"bitwise equal, max abs err {e:.3e}")
    c = _train_case(rng, 4, 17, 256, 14, 100, dev)
    _check_packed_alone(c, "K=4 C=17 H=256 A=14 S=100")
    print(f"[train-kernel] {name} K=4 C=17 H=256 A=14 S=100: each classifier "
          "alone bitwise equal to the batch")
    return worst


def _means(fn, n=3, reps=10):
    """n means of `reps` launches each (_cuda_ms)."""
    return [_cuda_ms(fn, reps) for _ in range(n)]


def _packed_times(rng, dev, c, label, record):
    """Three 10-launch means of the packed EM kernel at the slice's shape
    (c) and at PACKED_SHAPES, each checked first, with its bound; adds them
    to `record` and returns them as text."""
    from hibag_tpu_torch.ops import train_step as ts

    name = "em_estep_packed"
    out = []
    for shape in (None, *PACKED_SHAPES):
        if shape is not None:
            c = _train_case(rng, *shape[:4], shape[4], dev, n_sel=16)
            label = "K={} C={} H={} A={} S={}".format(*shape)
            _check_train_kernel(name, *_em_calls(c)[name], label)
        args = _em_calls(c)[name][2]
        ms = _means(lambda: ts.em_estep_packed(*args))
        bound = _train_bound(name, c)
        record.setdefault("at", {})[label] = {"ms": ms, **bound}
        out.append(f"{label}: {' / '.join(f'{t:.4f}' for t in ms)} ms, bound "
                   f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    return "packed kernel, three 10-launch means: " + "; ".join(out)


def phase_train_kernels(dev):
    """Phase 3b; returns {name: {"max_abs_err", "ms", "plain_ms"}}."""
    rng = np.random.default_rng(SEED + 3)
    err = {"em_estep": 0.0, "em_estep_packed": 0.0,
           "evaluate_candidates_kernel": 0.0}
    # the last case is the headline training cell's step (K=25, S=64,
    # H=128, C=32, A=14); the slice's own is compared below, where timed
    cases = [(1, 1, 128, 4, 96), (2, 17, 256, 14, 128),
             (2, 32, 640, 14, 64), (1, 64, 1024, 128, 32),
             (2, 17, 256, 128, 64), (1, 17, 4096, 4, 16),
             (25, 32, 128, 14, 64)]
    for K, C, H, A, S in cases:
        c = _train_case(rng, K, C, H, A, S, dev)
        calls = dict(_em_calls(c)) if "mask" in c else {}
        calls["evaluate_candidates_kernel"] = _eval_call(c)
        label = f"K={K} C={C} H={H} A={A} S={S}"
        for name, (kern, ref, args) in calls.items():
            e = _check_train_kernel(name, kern, ref, args, label)
            err[name] = max(err[name], e)
            print(f"[train-kernel] {name} {label}: bitwise deterministic, "
                  f"max abs err {e:.3e}")

    # untyped samples: counts exact; -2logLik over the resolved samples
    c = _train_case(rng, 2, 17, 256, 14, 128, dev, typed=False)
    kern, ref, args = _eval_call(c)
    label = "K=2 C=17 H=256 A=14 S=128 untyped"
    for name, call in _em_calls(c).items():
        err[name] = max(err[name], _check_train_kernel(name, *call, label))
    rel = _check_train_kernel("evaluate_candidates_kernel", kern, ref, args,
                              label, check_ll=False)
    rargs, n_unres = _resolved(args)
    e = _check_train_kernel("evaluate_candidates_kernel", kern, ref, rargs,
                            label + " resolved")
    err["evaluate_candidates_kernel"] = max(err["evaluate_candidates_kernel"],
                                            e)
    print(f"[train-kernel] evaluate_candidates_kernel {label}: counts exact; "
          f"-2logLik over the {n_unres} weighted samples whose true pair "
          f"scores below 2^-100 too differs by max rel {rel:.3e}; without "
          f"them max abs err {e:.3e}")
    _check_em_tiers(dev)
    _check_eval_cases(rng, dev)

    err["em_estep_packed"] = max(err["em_estep_packed"],
                                 _check_packed_cases(rng, dev))

    # at the training slice's shape
    c = _train_case(rng, 8, 17, 256, 14, 1024, dev, n_sel=16)
    calls = dict(_em_calls(c))
    calls["evaluate_candidates_kernel"] = _eval_call(c)
    label = "K=8 C=17 H=256 A=14 S=1024"
    timing = {}
    for name, (kern, ref, args) in calls.items():
        e = _check_train_kernel(name, kern, ref, args, label)
        err[name] = max(err[name], e)
        ms = _cuda_ms(lambda: kern(*args), 10)
        plain_ms = _cuda_ms(lambda: ref(*args), 3)
        bound = _train_bound(name, c)
        timing[name] = {"max_abs_err": err[name], "ms": ms,
                        "plain_ms": plain_ms, **bound}
        extra = ""
        if name == "em_estep_packed":
            timing[name]["shape"] = label
            extra = "; " + _packed_times(rng, dev, c, label, timing[name])
        if name == "evaluate_candidates_kernel":
            old = _train_bound(name, c, flops_per_term=12)
            extra = (f"; bound at 12 float operations per pair-candidate "
                     f"term {old['bound_ms']:.4f} ms ({old['bound_by']}); "
                     f"{_plans_line(c, label)}")
        print(f"[train-kernel] {name} {label}: bitwise deterministic, max "
              f"abs err {e:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})"
              f"{extra}")
    return timing


def _eval_plan(c, budget=None):
    """The evaluation kernel's plan (ops/train_step.py:eval_plan) for
    _train_case's inputs c, under EVAL_SMEM_BYTES or `budget`."""
    from hibag_tpu_torch.ops import _build
    from hibag_tpu_torch.ops import train_step as ts

    K, C, H = c["fAe"].shape
    return ts.eval_plan(H, c["A"], C, K, int(c["geno"].shape[1]),
                        _build.load().hibag_eval_smem,
                        budget or ts.EVAL_SMEM_BYTES)


def _check_eval_plans(c, label):
    """The evaluation kernel on c, whose default plan keeps everything in
    shared memory, under the budget that forces its device-memory plan: it
    must give bitwise the default's counts and -2logLik. Returns [(plan, ms
    of one launch, a mean of 10)] for the default and the forced plan."""
    from hibag_tpu_torch.ops import _build
    from hibag_tpu_torch.ops import train_step as ts

    kern, _, args = _eval_call(c)
    want = kern(*args)
    M, shared, _ = _eval_plan(c)
    if not shared:
        raise AssertionError(f"{label}: the default plan is not shared")
    seen = []
    for budget in (ts.EVAL_SMEM_BYTES,
                   int(_build.load().hibag_eval_smem(
                       M, c["A"], c["fAe"].shape[1], 0))):
        plan = _eval_plan(c, budget)
        run = lambda: kern(*args, smem_budget=budget)
        got = run()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"{label}: plan {plan} differs from the "
                                 "default plan")
        seen.append((plan, _cuda_ms(run, 10)))
    if seen[1][0][1]:
        raise AssertionError(f"{label}: no device-memory plan was forced")
    return seen


#: identical candidates across a float4 boundary (3/4, 7/8) and within the
#: last float4 of 64 (62/63)
EVAL_TWINS = ((0, 1), (3, 4), (7, 8), (62, 63))


def _check_eval_cases(rng, dev):
    """Phase 3b's evaluation-only cases: samples with heterozygous codes in
    0..4 of the four 32-SNP words (the kernel's distance is compiled per
    count); EVAL_TWINS at C=64 with H=256 and H=4,096 (the device-memory
    plan) and at the headline step (K=25, C=32, H=128, S=64), where the
    device-memory plan is also forced and timed. Counts exact, -2logLik at
    rtol 1e-4, two runs and the twins bitwise equal."""
    from hibag_tpu_torch.ops import train_step as ts

    name = "evaluate_candidates_kernel"
    for nw in range(5):
        c = _train_case(rng, 2, 17, 256, 14, 64, dev, n_sel=128,
                        het_words=nw)
        label = f"K=2 C=17 H=256 A=14 S=64 het words {nw}"
        e = _check_train_kernel(name, *_eval_call(c), label)
        print(f"[train-kernel] {name} {label}: bitwise deterministic, max "
              f"abs err {e:.3e}")
    for K, C, H, S in EVAL_TWIN_CASES:
        c = _train_case(rng, K, C, H, 14, S, dev, twins=EVAL_TWINS)
        label = f"K={K} C={C} H={H} A=14 S={S} twins {EVAL_TWINS}"
        kern, ref, args = _eval_call(c)
        e = _check_train_kernel(name, kern, ref, args, label,
                                twins=EVAL_TWINS)
        M, shared, per = _eval_plan(c)
        extra = ""
        if not shared:
            mib = K * -(-S // per) * ts.eval_scratch_bytes(M, 14, C) / 2 ** 20
            ms = _cuda_ms(lambda: kern(*args), 5)
            extra = (f"; device-memory plan {ms:.4f} ms, scratch "
                     f"{mib:.1f} MiB")
        print(f"[train-kernel] {name} {label}: plan (M, shared, S) "
              f"{(M, shared, per)}; twins bitwise equal, bitwise "
              f"deterministic, max abs err {e:.3e}{extra}")
    print(f"[train-kernel] {name} {label}: {_plans_line(c, label)}")


def _plans_line(c, label):
    """_check_eval_plans(c, label) as a line of text."""
    return "plans (M, shared, S) and ms " + ", ".join(
        f"{p} {ms:.4f}" for p, ms in _check_eval_plans(c, label)) \
        + "; bitwise equal"


#: (K, C, H, S) of the twin cases: C=64 at H=256 and at H=4,096 (the
#: device-memory plan), and the headline step
EVAL_TWIN_CASES = ((2, 64, 256, 64), (1, 64, 4096, 16), (25, 32, 128, 64))


def _packed_counts(packed):
    """(set pairs, rows with a set pair) of a bit-packed mask [K, S, H,
    H // 8], one sample at a time."""
    lut = torch.tensor([bin(i).count("1") for i in range(256)],
                       dtype=torch.int64, device=packed.device)
    nnz = rows = 0
    for s in range(packed.shape[1]):
        x = packed[:, s]
        nnz += int(lut[x.long()].sum())
        rows += int((x != 0).any(-1).sum())
    return float(nnz), float(rows)


def _train_bound(name, c, flops_per_term=None):
    """_bound of a training kernel on _train_case's inputs c. EM: the mask
    (int8, or 1 bit a pair packed) and frequencies in, dfA, dfB and dll out;
    per candidate 2 adds per set mask entry and 16 float operations per
    active row (one with a set entry) of a sample. Evaluation: _pair_popc's
    popcounts over the ok haplotypes; per candidate and sample, 2 FMAs per
    unordered pair of them (rA += pen fA_j, rB += pen fB_j) and 2 per ok
    slot i and allele b >= i's with ok slots (folding rA, rB into the
    cell), 4 float operations each. With `flops_per_term`, that many per
    pair, sample and candidate instead (the count before the fold was
    factorised: 12)."""
    K, C, H = c["fA"].shape
    N = c["geno"].shape[1]
    if name.startswith("em_estep"):
        if "mask" in c:
            mask = c["mask"] != 0
            nnz, rows = float(mask.sum()), float(mask.any(-1).sum())
        else:
            nnz, rows = _packed_counts(c["packed"])
        mbytes = K * N * H * H // (8 if name == "em_estep_packed" else 1)
        nbytes = (mbytes + 4 * 4 * K * C * H + c["gc"].numel()
                  + 4 * c["B"].numel() + 4 * K * C)
        return _bound(nbytes, flops=C * (2 * nnz + 16 * rows))
    ok = ((c["fAe"] > 0) | (c["fBe"] > 0)).any(dim=1)
    pairs = _pairs(ok.sum(1), N)
    nbytes = (4 * c["bits"].numel() + 4 * c["allele"].numel()
              + 8 * K * C * H + c["gc"].numel() + c["geno"].numel()
              + 8 * N + c["oob"].numel() + 4 * c["B"].numel() + 8 * K * C)
    popc = _pair_popc(ok.sum(1), c["geno"])
    if flops_per_term is not None:
        return _bound(nbytes, popc=popc, flops=flops_per_term * C * pairs)
    A = c["A"]
    cnt = torch.zeros((K, A + 1), dtype=torch.float64, device=ok.device)
    cnt.scatter_add_(1, torch.where(ok, c["allele"].long(), A),
                     torch.ones_like(ok, dtype=torch.float64))
    cnt = cnt[:, :A]
    # alleles b >= a with ok slots, for each a
    later = (cnt > 0).double().flip(1).cumsum(1).flip(1)
    row_cells = float((cnt * later).sum())
    return _bound(nbytes, popc=popc,
                  flops=4 * C * (pairs + N * row_cells))


def _repeatable(label, predict, model, geno, timed):
    """Raises unless predict() on the card is bitwise repeatable, as
    tests/test_parity.py asks of hibag_tpu: the timed call's best guesses,
    their probability and matching equal one more call's, and two calls
    with_prob=True give equal postprob too. (The timed call leaves out the
    posterior table, whose host-side assembly would dominate its time.)"""
    def check(r1, r2, names):
        for name in names:
            if not np.array_equal(getattr(r1, name), getattr(r2, name)):
                raise AssertionError(f"{label}: two predict() calls differ "
                                     f"in {name}")
    names = ("allele1", "allele2", "prob", "matching")
    check(timed, predict(model, geno, device="cuda"), names)
    check(predict(model, geno, device="cuda", with_prob=True),
          predict(model, geno, device="cuda", with_prob=True),
          ("postprob",) + names)


def _same_classifiers(m1, m2):
    return sum(np.array_equal(a.snp_index, b.snp_index)
               and np.array_equal(a.hap_bits, b.hap_bits)
               and np.array_equal(a.hap_freq, b.hap_freq)
               and np.array_equal(a.hap_allele, b.hap_allele)
               for a, b in zip(m1.classifiers, m2.classifiers))


def _freq_sums(model, label):
    for c in model.classifiers:
        if abs(c.hap_freq.sum() - 1.0) > 1e-2:
            raise AssertionError(f"{label}: hap_freq sums to "
                                 f"{c.hap_freq.sum()}")


#: phase 5's train_parallel arguments (the mid-scale fused cell)
FUSED_KW = dict(n_classifiers=8, batch=8, seed=100, verbose=False,
                with_matching=False, mode="fused", hcap=256, max_steps=192,
                on_overflow="freeze", device="cuda")
#: phase 6's (the headline fused cell: int8 mask 64*128*128 B = 1 MiB >
#: 256 KiB >= packed 128 KiB)
PACKED_KW = dict(n_classifiers=25, batch=25, seed=100, verbose=False,
                 with_matching=False, mode="fused", hcap=128, max_steps=192,
                 on_overflow="freeze", device="cuda", mask_budget=256 * 1024)
#: phase 8's (the host mid-scale cell)
HOST_KW = dict(n_classifiers=HOST_K, batch=HOST_K, seed=100, mtry=17,
               verbose=False, with_matching=False, mode="host",
               device="cuda")


def _mid_panel():
    """Phases 5 and 8's panel: ((table, geno), (held-out table, geno))."""
    from hibag_tpu_torch.utils.synthetic import (PANEL_RECOMBINATION,
                                                 synthetic_panel)
    return synthetic_panel(SEED, 1000, 266, 14, n_held_out=500,
                           recombination=PANEL_RECOMBINATION)


def _headline_panel():
    """Phase 6's panel (and phase 8's train()): (table, geno)."""
    from hibag_tpu_torch.utils.synthetic import (PANEL_RECOMBINATION,
                                                 synthetic_panel)
    return synthetic_panel(SEED + 2, 60, 1000, 14,
                           recombination=PANEL_RECOMBINATION)[0]


def phase_train(card, keep=None):
    """Phase 5; returns the main path's kernel launches. Puts the panel and
    its timed run's model in `keep`."""
    from hibag_tpu_torch import predict, train_parallel
    from hibag_tpu_torch.models import train_fused
    from hibag_tpu_torch.ops import ens_acc
    from hibag_tpu_torch.ops import train_step as ts

    (table, geno), (htable, hgeno) = _mid_panel()
    kw = FUSED_KW
    first = train_parallel(table, geno, **kw)
    torch.cuda.synchronize()
    steps, reseats = [0], [0]
    step, reseat = train_fused._step, train_fused._freeze_reseat

    def counted(*a, **k):
        steps[0] += 1
        return step(*a, **k)

    def counted_reseat(state, idx, new_hc):
        reseats[0] += int(idx.shape[0])
        return reseat(state, idx, new_hc)

    train_fused._step = counted
    train_fused._freeze_reseat = counted_reseat
    for k in ts.LAUNCHES:
        ts.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    model = train_parallel(table, geno, **kw)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(ts.LAUNCHES)
    train_fused._step, train_fused._freeze_reseat = step, reseat
    for name in ("em_estep", "evaluate_candidates_kernel"):
        if launches[name] < 1:
            raise AssertionError(f"training did not launch {name}")
    same = _same_classifiers(first, model)
    if same != 8:
        raise AssertionError(f"two trainings differ: {8 - same}/8 "
                             "classifiers not bitwise equal")
    _freq_sums(model, "train")
    oob = float(np.mean([c.oob_accuracy for c in model.classifiers]))
    if oob < 0.9:
        raise AssertionError(f"mean OOB accuracy {oob:.4f} < 0.9")

    ens_acc.LAUNCHES = 0
    res = predict(model, hgeno, device="cuda")
    torch.cuda.synchronize()
    if ens_acc.LAUNCHES < 1:
        raise AssertionError("held-out predict did not launch ens_acc")
    acc = res.accuracy_vs(htable.allele1, htable.allele2)
    if acc < 0.9:
        raise AssertionError(f"held-out accuracy {acc:.4f} < 0.9")

    plain = train_parallel(table, geno, engine="torch", **kw)
    same_seq = sum(np.array_equal(a.snp_index, b.snp_index)
                   for a, b in zip(model.classifiers, plain.classifiers))
    n_snp = [c.n_snp for c in model.classifiers]
    n_hap = [c.n_haplo for c in model.classifiers]
    print(f"[train] N=1000 P=266 A=14 K=8 hcap=256 mtry=17: "
          f"{8 / elapsed:.4f} classifiers/s ({elapsed:.3f} s), {steps[0]} "
          f"growth steps, EM kernel launches {launches['em_estep']} "
          f"({launches['em_estep'] / max(steps[0], 1):.2f} per step), eval "
          f"launches {launches['evaluate_candidates_kernel']}; runs bitwise "
          f"equal 8/8; mean OOB {oob:.4f}; held-out accuracy {acc:.4f} "
          f"(500 samples); SNPs {n_snp}, haplotypes {n_hap}, freeze "
          f"re-seats {reseats[0]}; same SNP "
          f"sequence as engine='torch' on the card: {same_seq}/8 | {card}")
    if keep is not None:
        keep.update(mid_panel=(table, geno), fused_model=model,
                    fused_rate=8 / elapsed)
    return launches, 8 / elapsed


def phase_packed(card, keep=None):
    """Phase 6; returns the packed kernel's launches. Puts the panel in
    `keep`."""
    from hibag_tpu_torch import train_parallel
    from hibag_tpu_torch.ops import train_step as ts

    table, geno = _headline_panel()
    kw = PACKED_KW
    if keep is not None:
        keep.update(headline_panel=(table, geno))
    train_parallel(table, geno, **kw)
    torch.cuda.synchronize()
    for k in ts.LAUNCHES:
        ts.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    model = train_parallel(table, geno, **kw)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = ts.LAUNCHES["em_estep_packed"]
    if launches < 1:
        raise AssertionError("the packed tier did not launch em_estep_packed")
    oob = float(np.mean([c.oob_accuracy for c in model.classifiers]))
    n_hap = [c.n_haplo for c in model.classifiers]
    # a classifier re-seated above 128 slots outgrows the budget's packed
    # mask too and takes the re-matched tier (the int8 kernel per chunk)
    print(f"[packed] N=60 P=1000 A=14 K=25 hcap=128 mtry=32: "
          f"{25 / elapsed:.4f} classifiers/s ({elapsed:.3f} s), packed EM "
          f"launches {launches}, int8 EM launches {ts.LAUNCHES['em_estep']}, "
          f"mean OOB {oob:.4f}, haplotypes {min(n_hap)}..{max(n_hap)} "
          f"(mean {np.mean(n_hap):.1f}) | {card}")
    return launches


def _check_host_step(first, label):
    """The first greedy step of a host training, recorded as its
    grow_step call: one EM E+M step (int8 mask) and the candidate
    evaluation on the kernels' converged, erased frequencies, each kernel
    against its plain version on the same CUDA tensors (EM at rtol 1e-4,
    counts exact, -2logLik at rtol 1e-4). Returns the max abs errors."""
    from hibag_tpu_torch.constants import EM_INIT_VAL_FRAC
    from hibag_tpu_torch.models import em
    from hibag_tpu_torch.ops import train_step as ts

    (bits, freq, allele, geno_sel, B, is_oob, g_cand, afreq, a1, a2, A,
     rare, total_n, budget, engine), kw = first
    if engine != "cuda":
        raise AssertionError(f"{label}: the host trainer ran engine "
                             f"{engine!r} on the card")
    valid = freq > 0
    v = valid.to(freq.dtype)[:, None, :]
    fA0 = (freq[:, None, :] * (1.0 - afreq[..., None]) + EM_INIT_VAL_FRAC) * v
    fB0 = (freq[:, None, :] * afreq[..., None] + EM_INIT_VAL_FRAC) * v
    mask = em.match_pairs(bits, valid, allele, geno_sel, a1, a2).to(
        torch.int8)
    err_em = _check_train_kernel(
        "em_estep", ts.em_estep, ts.em_estep_ref,
        (fA0.contiguous(), fB0.contiguous(), mask, g_cand, B, total_n), label)
    fA, fB, _, _ = em.em_all_candidates(
        freq, valid, bits, allele, geno_sel, a1, a2, B, g_cand, afreq,
        total_n, reltol=kw["reltol"], mask_budget=budget, engine="cuda")
    fA, fB = em.erase_rare(fA, fB, rare)
    err_ev = _check_train_kernel(
        "evaluate_candidates_kernel", ts.evaluate_candidates_kernel,
        ts.evaluate_candidates_ref,
        (bits, allele, fA, fB, g_cand, geno_sel, a1, a2, is_oob, B, A),
        label, twins=())
    return err_em, err_ev


def phase_host(card, fused_rate, keep=None):
    """Phase 8: the host trainer and the post-training surface on the card;
    returns nothing (the kernels' line keeps phases 4-7's counts). Puts the
    timed run's model and rate in `keep`."""
    import collections

    from hibag_tpu_torch import (AttrBagModel, out_of_bag, predict, publish,
                                 train, train_parallel)
    from hibag_tpu_torch.models import em
    from hibag_tpu_torch.models import train as train_mod
    from hibag_tpu_torch.ops import ens_acc
    from hibag_tpu_torch.ops import train_step as ts

    # (a) train_parallel(mode="host") on phase 5's panel
    (table, geno), (htable, hgeno) = _mid_panel()
    kw = HOST_KW
    first_model = train_parallel(table, geno, **kw)
    torch.cuda.synchronize()
    step, tier = train_mod.grow_step, em.mask_tier
    first, steps, tiers = [], [0], collections.Counter()

    def counted(*a, **k):
        if not first:
            first.append((a, k))
        steps[0] += 1
        return step(*a, **k)

    def counted_tier(*a):
        t = tier(*a)
        tiers[t] += 1
        return t

    train_mod.grow_step, em.mask_tier = counted, counted_tier
    for k in ts.LAUNCHES:
        ts.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    model = train_parallel(table, geno, **kw)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(ts.LAUNCHES)
    train_mod.grow_step, em.mask_tier = step, tier
    if launches["em_estep"] + launches["em_estep_packed"] < 1:
        raise AssertionError("host training launched no EM kernel")
    if launches["evaluate_candidates_kernel"] < 1:
        raise AssertionError("host training did not launch "
                             "evaluate_candidates_kernel")
    same = _same_classifiers(first_model, model)
    if same != HOST_K:
        raise AssertionError(f"two host trainings differ: {HOST_K - same}/"
                             f"{HOST_K} classifiers not bitwise equal")
    _freq_sums(model, "host")
    oob = float(np.mean([c.oob_accuracy for c in model.classifiers]))
    if oob < 0.9:
        raise AssertionError(f"host: mean OOB accuracy {oob:.4f} < 0.9")
    if keep is not None:
        keep.update(host_model=model, host_rate=HOST_K / elapsed)
    ens_acc.LAUNCHES = 0
    res = predict(model, hgeno, device="cuda")
    torch.cuda.synchronize()
    if ens_acc.LAUNCHES < 1:
        raise AssertionError("host: held-out predict did not launch ens_acc")
    acc = res.accuracy_vs(htable.allele1, htable.allele2)
    if acc < 0.9:
        raise AssertionError(f"host: held-out accuracy {acc:.4f} < 0.9")
    err_em, err_ev = _check_host_step(first[0], "host step 1")
    n_hap = [c.n_haplo for c in model.classifiers]
    print(f"[host] train_parallel(mode='host') N=1000 P=266 A=14 K={HOST_K} "
          f"mtry=17: {HOST_K / elapsed:.4f} classifiers/s ({elapsed:.3f} s; "
          f"fused, phase 5: {fused_rate:.4f}), {steps[0]} greedy "
          f"steps, launches: EM int8 {launches['em_estep']}, EM packed "
          f"{launches['em_estep_packed']}, eval "
          f"{launches['evaluate_candidates_kernel']}; mask tiers "
          f"{dict(tiers)}; runs bitwise equal {same}/{HOST_K}; mean OOB "
          f"{oob:.4f}; held-out accuracy {acc:.4f} ({len(res.allele1)} "
          f"samples, ens_acc "
          f"launches {ens_acc.LAUNCHES}); haplotypes {min(n_hap)}..."
          f"{max(n_hap)}; step 1 kernels vs plain: EM max abs err "
          f"{err_em:.3e}, evaluation counts exact, -2logLik max abs err "
          f"{err_ev:.3e} | {card}")

    # (b) train() through grow_classifier on phase 6's panel
    t6, g6 = _headline_panel()
    for k in ts.LAUNCHES:
        ts.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    serial = train(t6, g6, n_classifiers=4, seed=100, verbose=False,
                   with_matching=False, device="cuda")
    torch.cuda.synchronize()
    el_b = time.perf_counter() - t0
    lb = dict(ts.LAUNCHES)
    if lb["em_estep"] + lb["em_estep_packed"] < 1 \
            or lb["evaluate_candidates_kernel"] < 1:
        raise AssertionError(f"train() did not launch the step kernels: {lb}")
    _freq_sums(serial, "train()")
    oob_b = float(np.mean([c.oob_accuracy for c in serial.classifiers]))
    print(f"[host] train() N=60 P=1000 A=14 4 classifiers mtry=32: "
          f"{4 / el_b:.4f} classifiers/s ({el_b:.3f} s, first call), "
          f"launches: EM int8 {lb['em_estep']}, EM packed "
          f"{lb['em_estep_packed']}, eval {lb['evaluate_candidates_kernel']};"
          f" mean OOB {oob_b:.4f} | {card}")

    # (c) out_of_bag of (a)'s model, publish -> .npz -> predict
    ens_acc.LAUNCHES = 0
    t0 = time.perf_counter()
    oob_res = out_of_bag(model, table, geno, device="cuda")
    torch.cuda.synchronize()
    el_c = time.perf_counter() - t0
    n_oob = ens_acc.LAUNCHES
    if n_oob < HOST_K:
        raise AssertionError(f"out_of_bag launched ens_acc {n_oob} times, "
                             f"fewer than its {HOST_K} classifiers")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "published.npz")
        publish(model, platform="synthetic").save(path)
        pub = AttrBagModel.load(path)
    if pub.n_snp >= model.n_snp or pub.sample_id is not None:
        raise AssertionError("publish kept unused SNPs or sample IDs")
    res_pub = predict(pub, hgeno, device="cuda")
    if not (np.array_equal(res_pub.allele1, res.allele1)
            and np.array_equal(res_pub.allele2, res.allele2)):
        raise AssertionError("the published model's calls differ from the "
                             "trained model's")
    print(f"[host] out_of_bag: {el_c:.3f} s, ens_acc launches {n_oob}, "
          f"acc.haplo {oob_res['overall']['acc.haplo']:.4f}; publish: "
          f"{model.n_snp} -> {pub.n_snp} SNPs, held-out calls equal "
          f"{len(res.allele1)}/{len(res.allele1)} | {card}")


def _ordered_pair_case(dev):
    """Two haplotypes of allele 0, one of allele 1 and a padded slot, and
    three samples (the first all missing, the second haplotypes 0 + 2): the
    PackedHaplotypes, codes g int8 [1, 3, 128] and the float64 sum over
    ordered pairs want [1, 3, 3, 3] (allele 2 holds no haplotype). A kernel
    that walks pairs i <= j must add a cross pair to both S[0,1] and S[1,0],
    the pair within allele 0 twice to S[0,0], and each i == j once."""
    from hibag_tpu_torch.ops.ens_acc import pack_haplotypes

    rng = np.random.default_rng(SEED + 9)
    bits = np.zeros((1, 4, 128), np.uint8)
    bits[0, :, :12] = rng.integers(0, 2, (4, 12))
    freq = np.array([[0.5, 0.3, 0.2, 0.0]])
    allele = np.array([[0, 0, 1, 2]])
    g = np.full((1, 3, 128), 3, np.int8)
    g[0, 1, :12] = bits[0, 0, :12] + bits[0, 2, :12]
    g[0, 2, :12] = rng.integers(0, 3, 12)
    b = bits[0].astype(np.int64)
    want = np.zeros((1, 3, 3, 3))
    for n in range(3):
        obs = g[0, n] <= 2
        D = np.array([[np.abs(b[i] + b[j] - g[0, n])[obs].sum()
                       for j in range(3)] for i in range(3)])
        for i in range(3):
            for j in range(3):
                want[0, n, allele[0, i], allele[0, j]] += (
                    freq[0, i] * freq[0, j] * 1e-5 ** (D[i, j] - D.min()))
    hap = pack_haplotypes(bits, freq, allele, 3, dev)
    return hap, torch.from_numpy(g).to(dev), want


def _score_case(rng, C, H, A, N, dev, pattern=None, dominant=False):
    """Scoring-kernel inputs (hap, g) and whether classifier 0 forces the
    exact tie S[2][0,2] == S[2][1,2]: _case's inputs for A >= 4 (N >= 4),
    else random haplotypes over A alleles with padded slots and all-missing
    samples 0 and 1; codes by `pattern`, alleles dominant_alleles' with
    `dominant`."""
    from hibag_tpu_torch.ops.ens_acc import pack_haplotypes

    if A >= 4:
        hap, g, _ = _case(rng, C, H, A, N, dev, pattern, dominant)
        return hap, g, True
    bits = rng.integers(0, 2, (C, H, 128), dtype=np.uint8)
    freq = rng.dirichlet(np.ones(H), C)
    freq[:, H - H // 8:] = 0.0
    allele = (dominant_alleles(rng, C, H, A) if dominant
              else np.sort(rng.integers(0, A, (C, H)), axis=1))
    g = het_codes(rng, pattern, (C, N, 128))
    g[:, :2] = 3
    return (pack_haplotypes(bits, freq, allele, A, dev),
            torch.from_numpy(g).to(dev), False)


def _check_scores(hap, g, A, label, tie=False):
    """The scoring kernel twice and its plain version once on (hap, g):
    posterior_scores_kernel for one classifier, else ensemble_scores. The
    two runs must agree bitwise, dmin exactly, S must be exactly symmetric,
    S and total at SCORE_RTOL and SCORE_ATOL; with `tie`, S[0,2][0,2] ==
    S[0,2][1,2]. Returns the max abs error of S."""
    from hibag_tpu_torch.ops import post_scores as ps

    if hap.n_classifiers == 1:
        def run():
            return tuple(x[None] for x in ps.posterior_scores_kernel(
                hap, g[0], A))
    else:
        def run():
            return ps.ensemble_scores(hap, g, A)
    out, out2 = run(), run()
    torch.cuda.synchronize()
    want = ps.ensemble_scores_ref(hap, g, A)
    if not all(torch.equal(x, y) for x, y in zip(out, out2)):
        raise AssertionError(f"{label}: two runs differ")
    if not torch.equal(out[1], want[1]):
        raise AssertionError(f"{label}: dmin differs")
    if not torch.equal(out[0], out[0].transpose(-1, -2)):
        raise AssertionError(f"{label}: S is not symmetric")
    _close(f"{label} total", out[2], want[2], SCORE_RTOL, SCORE_ATOL)
    err = _close(f"{label} S", out[0], want[0], SCORE_RTOL, SCORE_ATOL)[0]
    if tie and not (out[0][0, 2, 0, 2] == out[0][0, 2, 1, 2] > 0):
        raise AssertionError(f"{label}: the forced tie is not exact")
    return err


def _scores_bound(hap, g, A):
    """_bound of one scoring launch: haplotypes and codes in, S, dmin and
    total out; _pair_popc's popcounts, and a multiply-add per unordered
    valid pair per sample."""
    C, N = hap.n_classifiers, int(g.shape[1])
    return _bound(_hap_bytes(hap) + g.numel() + 4 * C * N * A * A
                  + 8 * C * N, popc=_pair_popc(hap.nh, g),
                  flops=2 * _pairs(hap.nh, N))


def phase_wide_kernels(dev):
    """Phase 7's kernel checks; returns the max abs error of S."""
    rng = np.random.default_rng(SEED + 7)
    err = 0.0
    cases = [(1, 64, 1, 16), (8, 64, 2, 16), (8, 128, 9, 16),
             (1, 256, 48, 16), (8, 512, 48, 8), (1, 1024, 128, 8),
             (8, 1024, 128, 8), (1, 1600, 160, 8), (8, 1600, 160, 4),
             (8, 4096, 160, 4), (1, 4096, 1024, 4), (8, 640, 1024, 4)]
    cases = [c + (None, False) for c in cases]
    cases += [(8, 1024, 160, 8, p, False) for p in HET_PATTERNS]
    cases += [(1, 4096, 160, 4, None, True), (8, 1024, 2, 8, "all4", True),
              (2, 1024, 300, 4, "word3", True)]
    for C, H, A, N, pattern, dominant in cases:
        hap, g, tie = _score_case(rng, C, H, A, N, dev, pattern, dominant)
        label = (f"C={C} H={H} A={A} N={N}" + (f" {pattern}" if pattern else "")
                 + (" dominant" if dominant else ""))
        e = _check_scores(hap, g, A, label, tie)
        err = max(err, e)
        print(f"[wide-kernel] {label}: bitwise deterministic, dmin exact, "
              f"S max abs err {e:.3e}{', tie exact' if tie else ''}")
    from hibag_tpu_torch.ops import post_scores as ps
    hap, g, want = _ordered_pair_case(dev)
    for label, S in (("ensemble_scores", ps.ensemble_scores(hap, g, 3)[0]),
                     ("posterior_scores_kernel", ps.posterior_scores_kernel(
                         hap, g[0], 3)[0][None])):
        _close(f"ordered pairs {label}", S.cpu(), torch.from_numpy(want),
               SCORE_RTOL, SCORE_ATOL)
    print("[wide-kernel] ordered pairs within and across alleles: both entry "
          "points equal the float64 sum over ordered pairs")
    return err


def _through_npz(built):
    from hibag_tpu_torch import AttrBagModel
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.npz")
        built.save(path)
        return AttrBagModel.load(path)


def _slice_case():
    """Phase 4's model (through .npz) and cohort: (model, geno, true1,
    true2)."""
    from hibag_tpu_torch.utils.synthetic import (synthetic_cohort,
                                                 synthetic_model)
    built, pool = synthetic_model(SEED, n_classifiers=100, n_snp=1000,
                                  n_alleles=48)
    model = _through_npz(built)
    return (model,) + tuple(synthetic_cohort(model, pool, N_SLICE, SEED + 1))


def _wide_case():
    """Phase 7's 160-allele model (through .npz) and cohort."""
    from hibag_tpu_torch.utils.synthetic import (synthetic_cohort,
                                                 synthetic_model)
    built, pool = synthetic_model(SEED, n_classifiers=100, n_snp=1000,
                                  n_alleles=160, hap_range=(600, 1600),
                                  max_variants=20, mutation=0.1)
    model = _through_npz(built)
    return (model,) + tuple(synthetic_cohort(model, pool, N_WIDE, SEED + 8))


def phase_wide(dev, card, keep=None):
    """Phase 7; returns the scoring kernel's record at the scan engine's
    chunk shape, with its launches on the timed predict() run. Puts the
    model, cohort and timed run's result in `keep`."""
    from hibag_tpu_torch import predict
    from hibag_tpu_torch.data.geno import align_to_model
    from hibag_tpu_torch.models import predict as predict_mod
    from hibag_tpu_torch.ops import ens_acc
    from hibag_tpu_torch.ops import post_scores as ps

    err = phase_wide_kernels(dev)
    model, geno, true1, true2 = _wide_case()
    A = model.n_alleles
    nh = np.array([c.n_haplo for c in model.classifiers])
    if ens_acc.fits(int(nh.max()), A):
        raise AssertionError("the wide model fits the ensemble kernel")

    # the kernel at the scan engine's chunk shape and at one classifier, on
    # predict()'s tensors
    packed = model.pack()
    hap = predict_mod._prepare_ensemble(packed, dev)
    codes, _ = align_to_model(model, geno)
    cc = predict_mod.SCAN_CCHUNK
    g, _ = predict_mod._gather_codes(
        torch.from_numpy(packed.snp_index[:cc]).to(dev),
        torch.from_numpy(packed.snp_weight).to(dev),
        torch.from_numpy(codes).to(dev))
    timing = {}
    for name, part, gp in (("ensemble_scores", hap.subset(0, cc), g),
                           ("posterior_scores_kernel", hap.subset(0, 1),
                            g[:1])):
        args = (part, gp if name == "ensemble_scores" else gp[0], A)
        e = _check_scores(part, gp, A, f"wide chunk {name}")
        ms = _cuda_ms(lambda: getattr(ps, name)(*args), 5)
        plain_ms = _cuda_ms(lambda: getattr(ps, f"{name}_ref")(*args), 1)
        bound = _scores_bound(part, gp, A)
        timing[name] = {"max_abs_err": max(err, e), "ms": ms,
                        "plain_ms": plain_ms, **bound}
        print(f"[wide-kernel] {name} at C={part.n_classifiers} N={N_WIDE} "
              f"H={part.n_slots} A={A} (haplotypes {part.nh.tolist()}): S "
              f"max abs err {e:.3e}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}) | {card}")

    # the main path: predict() of the wide model, counted on the timed run
    predict(model, geno, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ps.LAUNCHES = 0
    ens_acc.LAUNCHES = 0
    t0 = time.perf_counter()
    res = predict(model, geno, device="cuda")
    elapsed = time.perf_counter() - t0
    launches, ens_launches = ps.LAUNCHES, ens_acc.LAUNCHES
    _repeatable("wide", predict, model, geno, res)
    peak = torch.cuda.max_memory_allocated(dev)
    chunks = -(-model.n_classifiers // cc)
    if launches < 1 or launches % chunks:
        raise AssertionError(f"the scan engine launched the scoring kernel "
                             f"{launches} times, not once per chunk of {cc} "
                             "classifiers and sample block")
    if ens_launches:
        raise AssertionError("the wide model launched the ensemble kernel")

    if not (np.all(res.prob > 0) and np.all(res.prob <= 1 + 1e-4)):
        raise AssertionError("wide: probabilities outside (0, 1 + 1e-4]")
    if not np.all(np.isfinite(res.matching)):
        raise AssertionError("wide: non-finite matching")
    acc = res.accuracy_vs(true1, true2)
    if acc < 0.9:
        raise AssertionError(f"wide: accuracy {acc:.4f} < 0.9")
    sub = geno.subset(samp_mask=np.arange(N_WIDE_F64))
    r64 = predict(model, sub, device="cuda", dtype=np.float64, with_prob=True)
    top2 = -np.sort(-r64.postprob, axis=0)[:2]
    clear = top2[0] - top2[1] > 1e-4 * top2[0]
    same = ((res.allele1[:N_WIDE_F64] == r64.allele1)
            & (res.allele2[:N_WIDE_F64] == r64.allele2))
    if not np.all(same[clear]):
        raise AssertionError(f"wide: {int((~same[clear]).sum())} calls differ "
                             "from the float64 scan engine outside the tie "
                             "margin")
    print(f"[wide] C={model.n_classifiers} P={model.n_snp} A={A} "
          f"N={N_WIDE}: haplotypes per classifier {nh.min()}..{nh.max()} "
          f"({int((nh > ens_acc.MAX_H).sum())} above {ens_acc.MAX_H}); "
          f"{N_WIDE / elapsed:.1f} samples/s ({elapsed * 1e3:.2f} ms, "
          f"SCAN_CCHUNK={cc}), peak device memory {peak / 2**30:.3f} GiB; "
          f"scoring kernel launches {launches}, ens_acc 0; two calls "
          f"bitwise equal; accuracy "
          f"{acc:.4f}; f64 calls equal on {int(clear.sum())}/{N_WIDE_F64} "
          f"clear samples | {card}")
    if keep is not None:
        keep.update(wide=(model, geno, res), wide_rate=N_WIDE / elapsed)
    return {"launches": launches, **timing["ensemble_scores"]}


def _cli(argv):
    """(exit code, standard output) of hibag_tpu_torch.cli.main(argv) in
    this process."""
    import contextlib
    import io

    from hibag_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} exited {rc}")
    return out.getvalue()


def _tsv_rows(path):
    rows = [ln.rstrip("\n").split("\t") for ln in open(path)]
    return rows[1:]


class _Split:
    """Times the calls of module-level functions (a CLI's layers): each
    wrapped name adds its seconds to `self.s[key]` until restore()."""

    def __init__(self):
        self.s = {}
        self._saved = []

    def wrap(self, mod, name, key):
        fn = getattr(mod, name)
        self.s.setdefault(key, 0.0)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.s[key] += time.perf_counter() - t0

        setattr(mod, name, timed)
        self._saved.append((mod, name, fn))

    def restore(self):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved.clear()


def _hibag_obj_equal(a, b, path="model"):
    """Raises unless two hlaAttrBagObj dicts (AttrBagModel.to_hibag_obj)
    are equal exactly, NaN equal to NaN."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or list(a) != list(b):
            raise AssertionError(f"{path}: keys differ")
        for k in a:
            _hibag_obj_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{path}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            _hibag_obj_equal(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


def phase_files(card, model, geno, true1, true2, res, clear):
    """Phase 9: the CLI from files on the card, through the entry points a
    user calls. `model`, `geno` and `res` are phase 4's model, cohort and
    predict() result; `clear` marks the first N_F64 samples outside the
    1e-4 tie margin. Returns nothing (the kernels' line keeps phases 4-7's
    counts)."""
    from hibag_tpu_torch import cli, compare_alleles, predict, save_rdata
    from hibag_tpu_torch.data import allele as allele_mod
    from hibag_tpu_torch.data import geno as geno_mod
    from hibag_tpu_torch.models import predict as predict_mod
    from hibag_tpu_torch.ops import ens_acc, post_scores
    from hibag_tpu_torch.ops import train_step as ts
    from hibag_tpu_torch.utils.synthetic import (PANEL_RECOMBINATION,
                                                 synthetic_panel)

    root = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        # (a) the inputs: the model as .RData, the cohort as PLINK and VCF
        t0 = time.perf_counter()
        mrd = os.path.join(d, "M.RData")
        save_rdata(model, mrd)
        bed = write_plink(geno, os.path.join(d, "cohort"))
        vcf = write_geno_vcf(geno, os.path.join(d, "cohort.vcf.gz"))
        t_inputs = time.perf_counter() - t0

        # (b) impute from .RData + .bed, timed by layer
        tsv = os.path.join(d, "calls.tsv")
        split = _Split()
        split.wrap(cli, "load_model", "read model")
        split.wrap(cli, "load_geno", "read genotypes")
        split.wrap(predict_mod, "predict", "predict")
        split.wrap(geno_mod, "align_to_model", "align")
        ens_acc.LAUNCHES = post_scores.LAUNCHES = 0
        try:
            t0 = time.perf_counter()
            _cli(["impute", "--model", mrd, "--geno", bed, "--out", tsv])
            total = time.perf_counter() - t0
        finally:
            split.restore()
        launches = ens_acc.LAUNCHES
        if launches < 1:
            raise AssertionError("impute did not launch the ensemble kernel")
        s = split.s
        t_write = total - s["read model"] - s["read genotypes"] - s["predict"]
        rows = _tsv_rows(tsv)
        want = [[str(x) for x in res.sample_id], [str(x) for x in res.allele1],
                [str(x) for x in res.allele2],
                [f"{p:.6g}" for p in res.prob],
                [f"{m:.6g}" for m in res.matching]]
        got = [list(c) for c in zip(*rows)]
        if got != want:
            raise AssertionError(
                "impute's TSV differs from predict(device='cuda'): "
                f"{sum(a != b for a, b in zip(got[1], want[1]))} allele1 "
                "calls differ")
        acc = res.accuracy_vs(true1, true2)
        if acc < 0.9:
            raise AssertionError(f"accuracy {acc:.4f} < 0.9")
        tsv_vcf = os.path.join(d, "calls_vcf.tsv")
        split.wrap(cli, "load_geno", "read .vcf.gz")
        try:
            _cli(["impute", "--model", mrd, "--geno", vcf, "--out", tsv_vcf])
        finally:
            split.restore()
        if open(tsv_vcf).read() != open(tsv).read():
            raise AssertionError("the .vcf.gz input gives other calls")

        # (c) as a user runs it: a new process, no --device (the card)
        tsv_sub = os.path.join(d, "calls_sub.tsv")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "hibag_tpu_torch", "impute", "--model",
             mrd, "--geno", bed, "--out", tsv_sub], cwd=root,
            capture_output=True, text=True, timeout=300)
        t_sub = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError("python -m hibag_tpu_torch impute failed: "
                                 + proc.stderr[-2000:])
        if open(tsv_sub).read() != open(tsv).read():
            raise AssertionError("the subprocess's TSV differs")

        # (d) the scan engine on the first N_F64 samples
        bed256 = write_plink(geno.subset(samp_mask=np.arange(N_F64)),
                             os.path.join(d, "first"))
        tsv_jnp = os.path.join(d, "calls_jnp.tsv")
        ens_acc.LAUNCHES = post_scores.LAUNCHES = 0
        _cli(["impute", "--model", mrd, "--geno", bed256, "--out", tsv_jnp,
              "--engine", "jnp"])
        scan = (post_scores.LAUNCHES, ens_acc.LAUNCHES)
        if scan[0] < 1 or scan[1] != 0:
            raise AssertionError(f"--engine jnp launched the scoring kernel "
                                 f"{scan[0]} and the ensemble kernel "
                                 f"{scan[1]} times")
        jrows = _tsv_rows(tsv_jnp)
        same = np.array([j[1:3] == r[1:3] for j, r in zip(jrows, rows)])
        if not np.all(same[clear]):
            raise AssertionError(f"{int((~same[clear]).sum())} --engine jnp "
                                 "calls differ outside the tie margin")

        # (e) train from PLINK + an HLA table (phase 6's panel), then impute
        # with the trained model and report against the truth
        (table, pgeno), _ = synthetic_panel(SEED + 2, 60, 1000, 14,
                                            recombination=PANEL_RECOMBINATION)
        pbed = write_plink(pgeno, os.path.join(d, "panel"))
        hla = os.path.join(d, "panel_hla.tsv")
        with open(hla, "w") as f:
            f.write("sample.id\tA.1\tA.2\n")
            f.writelines(f"{s_}\t{a}\t{b}\n" for s_, a, b in zip(
                table.sample_id, table.allele1, table.allele2))
        n_flank = len(allele_mod.flanking_snps(
            pgeno.snp_id, pgeno.snp_position, "A", 500_000, "hg19"))
        trained = os.path.join(d, "trained.npz")
        for k in ts.LAUNCHES:
            ts.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        _cli(["train", "--hla", hla, "--geno", pbed, "--locus", "A", "--out",
              trained, "--n-classifiers", "25", "--mtry", "32", "--hcap",
              "128", "--mode", "fused", "--on-overflow", "freeze", "--quiet"])
        t_train = time.perf_counter() - t0
        tl = dict(ts.LAUNCHES)
        if tl["em_estep"] + tl["em_estep_packed"] < 1:
            raise AssertionError("train did not launch an EM kernel")
        if tl["evaluate_candidates_kernel"] < 1:
            raise AssertionError("train did not launch the evaluation kernel")
        tmodel = cli.load_model(trained)
        oob = float(np.mean([c.oob_accuracy for c in tmodel.classifiers]))
        if oob < 0.9:
            raise AssertionError(f"trained mean OOB {oob:.4f} < 0.9")
        ptsv = os.path.join(d, "panel_calls.tsv")
        ens_acc.LAUNCHES = 0
        _cli(["impute", "--model", trained, "--geno", pbed, "--out", ptsv])
        if ens_acc.LAUNCHES < 1:
            raise AssertionError("impute of the trained model did not launch "
                                 "the ensemble kernel")
        rep = _cli(["report", "--pred", ptsv, "--truth", hla, "--locus",
                    "A"]).splitlines()[0]
        o = compare_alleles(table, predict(tmodel, pgeno,
                                           device="cuda")).overall
        want_rep = (f"Overall accuracy: {o['acc.haplo']:.1%} (per allele), "
                    f"{o['acc.ind']:.1%} (per individual)")
        if rep != want_rep:
            raise AssertionError(f"report says {rep!r}, compare_alleles "
                                 f"{want_rep!r}")

        # (f) convert .RData -> .npz -> .RData and summarize: the model
        # that comes back is the model that went in
        mnpz, m2 = os.path.join(d, "M.npz"), os.path.join(d, "M2.RData")
        _cli(["convert", mrd, mnpz])
        _cli(["convert", mnpz, m2])
        summ = json.loads(_cli(["summary", m2]))
        if summ["num.classifier"] != model.n_classifiers:
            raise AssertionError(f"summary counts {summ['num.classifier']} "
                                 "classifiers")
        _hibag_obj_equal(cli.load_model(m2).to_hibag_obj(),
                         model.to_hibag_obj())

    print(f"[files] impute .RData + .bed -> .tsv, C={model.n_classifiers} "
          f"P={model.n_snp} A={model.n_alleles} N={geno.n_samp}: "
          f"{geno.n_samp / total:.1f} samples/s end to end ({total * 1e3:.2f}"
          f" ms: read model {s['read model'] * 1e3:.2f}, read .bed "
          f"{s['read genotypes'] * 1e3:.2f}, align "
          f"{s['align'] * 1e3:.2f}, predict "
          f"{(s['predict'] - s['align']) * 1e3:.2f}, write "
          f"{t_write * 1e3:.2f}); launches ens_acc {launches}; calls equal "
          f"to predict() {len(rows)}/{geno.n_samp}, accuracy {acc:.4f}; "
          f".vcf.gz input (read {s['read .vcf.gz'] * 1e3:.2f} ms) same TSV; "
          f"python -m hibag_tpu_torch impute {t_sub:.2f} s wall, same TSV; "
          f"--engine jnp on {N_F64}: post_scores launches {scan[0]}, ens_acc "
          f"{scan[1]}, calls equal on {int(clear.sum())}/{N_F64} clear "
          f"samples; train N=60 P=1000 (flank keeps {n_flank}) A=14 K=25 "
          f"hcap=128 mtry=32: {25 / t_train:.4f} classifiers/s "
          f"({t_train:.3f} s, first call), launches EM int8 {tl['em_estep']} "
          f"packed {tl['em_estep_packed']} eval "
          f"{tl['evaluate_candidates_kernel']}, mean OOB {oob:.4f}; report "
          f"{rep[len('Overall accuracy: '):]} = compare_alleles; convert "
          f".RData -> .npz -> .RData and summary: model equal; inputs "
          f"written in {t_inputs:.2f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s | {card}")


#: the [limits] phase's kernel shapes, past 4,096 haplotype slots and 128
#: alleles: EM (K, C, H, A, S), evaluation (K, C, H, A, S), scoring (C, H,
#: A, N); the last EM and evaluation shapes are the wide training's own
#: (WIDE_K classifiers, 17 candidates, 832 slots, its 1,000 samples)
LIMIT_EM = tuple((1, C, H, 14, 8) for H in (4160, 10016)
                 for C in (1, 17, 64)) + ((2, 17, 832, 14, 1000),)
LIMIT_EVAL = tuple((2, 17, H, A, S) for A in (130, 320)
                   for H, S in ((64, 64), (512, 32), (4160, 16), (10016, 8))
                   ) + ((2, 17, 832, 160, 1000),)
LIMIT_SCORES = tuple((2, H, A, N) for H, N in ((4160, 8), (10016, 4))
                     for A in (14, 160))
#: the wide panel: an HLA-B-like locus, 1,000 typed samples x 266 SNPs and
#: 160 alleles drawn (149 present), mosaic haplotypes; its classifiers and
#: the greedy steps compared with engine="torch"
WIDE_PANEL = (3, 1000, 266, 160)
WIDE_K = 2
WIDE_TORCH_STEPS = 5


def _launched(name, fn):
    """fn() and the launches it made of training kernel `name` (at least
    one, or raises)."""
    from hibag_tpu_torch.ops import train_step as ts

    before = ts.LAUNCHES[name]
    out = fn()
    if ts.LAUNCHES[name] <= before:
        raise AssertionError(f"{name} did not launch its kernel")
    return out


def _limit_line(name, label, ms, plain_ms, bound, extra=""):
    return (f"[limits] {name} {label}: {extra}bitwise deterministic; "
            f"{ms:.4f} ms (CUDA events, mean of 3), plain {plain_ms:.4f} ms, "
            f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})")


def _limit_em(rng, dev):
    """The two EM kernels at LIMIT_EM against their plain versions (rtol
    1e-4), two runs bitwise equal, the packed kernel's forced device-memory
    plan and block-taken samples bitwise equal to its default; each timed
    beside its bound and its plain version."""
    from hibag_tpu_torch.ops import _build
    from hibag_tpu_torch.ops import train_step as ts

    worst = 0.0
    for shape in LIMIT_EM:
        c = _train_case(rng, *shape, dev, masks=True)
        label = "K={} C={} H={} A={} S={}".format(*shape)
        for name, (kern, ref, args) in _em_calls(c).items():
            e = _launched(name, lambda: _check_train_kernel(name, kern, ref,
                                                            args, label))
            worst = max(worst, e)
            extra = f"max abs err {e:.3e}; "
            if name == "em_estep_packed":
                plan = _packed_variants(c, label)
                smem = _build.load().hibag_em_packed_smem
                both = smem(shape[2], shape[1], ts.EM_PAIR_LIST, 1) \
                    <= ts.EM_SMEM_BYTES
                extra += (f"plan (G, R, shared) {plan}, "
                          + ("the forced device-memory plan and "
                             if both else "")
                          + "block-taken samples bitwise equal; ")
            ms = _cuda_ms(lambda: kern(*args), 3)
            plain_ms = _cuda_ms(lambda: ref(*args), 1)
            print(_limit_line(name, label, ms, plain_ms,
                              _train_bound(name, c), extra))
        del c
        torch.cuda.empty_cache()
    return worst


def _limit_eval(rng, dev):
    """The evaluation kernel at LIMIT_EVAL against its plain version
    (counts exact, -2logLik rtol 1e-4, identical candidates 0 and 1 bitwise
    equal), two runs bitwise equal, and under each plan that fits beside the
    default bitwise equal to it; timed beside its bound and plain version."""
    from hibag_tpu_torch.ops import _build
    from hibag_tpu_torch.ops import train_step as ts

    name = "evaluate_candidates_kernel"
    smem = _build.load().hibag_eval_smem
    worst = 0.0
    for shape in LIMIT_EVAL:
        c = _train_case(rng, *shape, dev)
        K, C, H, A, S = shape
        label = "K={} C={} H={} A={} S={}".format(*shape)
        kern, ref, args = _eval_call(c)
        e = _launched(name, lambda: _check_train_kernel(name, kern, ref, args,
                                                        label))
        worst = max(worst, e)
        M, plan, per = _eval_plan(c)
        want = kern(*args)
        forced = []
        for p in (ts.EVAL_PLAN_DEVICE, ts.EVAL_PLAN_RECORDS):
            if p >= plan:
                continue
            budget = int(smem(M, A, C, p))
            got = kern(*args, smem_budget=budget)
            torch.cuda.synchronize()
            if _eval_plan(c, budget)[1] != p or not all(
                    torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"{name} {label}: plan {p} differs from "
                                     f"plan {plan}")
            forced.append(p)
        ms = _cuda_ms(lambda: kern(*args), 3)
        plain_ms = _cuda_ms(lambda: ref(*args), 1)
        extra = (f"plan (M, plan, S) {(M, plan, per)}; counts exact, max abs "
                 f"err {e:.3e}; "
                 + (f"forced plans {forced} bitwise equal; " if forced
                    else ""))
        print(_limit_line(name, label, ms, plain_ms, _train_bound(name, c),
                          extra))
        del c
        torch.cuda.empty_cache()
    return worst


def _limit_scores(rng, dev):
    """The scoring kernel at LIMIT_SCORES through ensemble_scores against
    its plain version (_check_scores: dmin exact, S symmetric, S and total
    at rtol 2e-4, two runs bitwise equal); the records-in-device-memory
    route, with one block a classifier taking every sample, bitwise equal
    to the default route; timed beside its bound and plain version."""
    from hibag_tpu_torch.ops import _build
    from hibag_tpu_torch.ops import post_scores as ps

    lib = _build.load()
    worst = 0.0
    for C, H, A, N in LIMIT_SCORES:
        hap, g, tie = _score_case(rng, C, H, A, N, dev)
        label = f"C={C} H={H} A={A} N={N}"
        before = ps.LAUNCHES
        e = _check_scores(hap, g, A, label, tie)
        if ps.LAUNCHES <= before:
            raise AssertionError("ensemble_scores did not launch its kernel")
        worst = max(worst, e)
        route = ps.scores_plan(H, A, C, N, lib.hibag_post_scores_smem)
        want = ps.ensemble_scores(hap, g, A)
        got = ps.ensemble_scores(
            hap, g, A, smem_budget=int(lib.hibag_post_scores_smem(H, A, 0)),
            record_budget=C * ps.record_bytes(H))
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"scores {label}: the one-block device "
                                 "route differs from the default")
        ms = _cuda_ms(lambda: ps.ensemble_scores(hap, g, A), 3)
        plain_ms = _cuda_ms(lambda: ps.ensemble_scores_ref(hap, g, A), 1)
        extra = (f"route (shared, NB, record bytes) {route}; dmin exact, S "
                 f"symmetric, S max abs err {e:.3e}; the device route at "
                 "NB=1 bitwise equal; ")
        print(_limit_line("post_scores", label, ms, plain_ms,
                          _scores_bound(hap, g, A), extra))
    return worst


class _Stop(Exception):
    """Ends a training after the greedy steps a phase compares."""


def _record_steps(module, attr, store, stop_after=None):
    """Wraps module.attr (a grow_step) so that each call's arguments and
    results go to `store`; with `stop_after`, raises _Stop after that many
    calls. Returns a function that restores it."""
    orig = getattr(module, attr)

    def rec(*a, **k):
        out = orig(*a, **k)
        # copies: on the CPU a caller's tensor may share a buffer it updates
        store.append((tuple(x.clone() if torch.is_tensor(x) else x
                            for x in a), k, out))
        if stop_after is not None and len(store) >= stop_after:
            raise _Stop
        return out
    setattr(module, attr, rec)
    return lambda: setattr(module, attr, orig)


def _same_steps(kern, plain, K):
    """(classifiers whose first len(plain) greedy steps took the same inputs
    in the kernels' run and in the plain versions' (the live haplotypes'
    bits and alleles and the selected genotypes exact, their frequencies at
    rtol 1e-4) and gave the same counts (exact) and -2logLik (rtol 1e-4) at
    each step, [(classifier, step, what) where each of the others parted,
    what being "inputs", "frequencies", "counts" of the candidates named,
    or "-2logLik"])."""
    same, parted = 0, []
    for k in range(K):
        what = None
        for i, ((x, _, xo), (y, _, yo)) in enumerate(zip(kern, plain)):
            h = int((x[1][k] > 0).sum())
            if h != int((y[1][k] > 0).sum()) or not all(
                    torch.equal(u.cpu(), v.cpu()) for u, v in (
                        (x[0][k, :h], y[0][k, :h]),
                        (x[2][k, :h], y[2][k, :h]), (x[3][k], y[3][k]))):
                what = "inputs"
            elif not torch.allclose(x[1][k, :h], y[1][k, :h], rtol=1e-4,
                                    atol=0):
                what = "frequencies"
            elif not torch.equal(xo[2][k].cpu(), yo[2][k].cpu()):
                cs = (xo[2][k] != yo[2][k]).nonzero()[:, 0].tolist()
                what = f"counts of candidates {cs}"
            elif not torch.allclose(xo[3][k], yo[3][k], rtol=1e-4, atol=0):
                what = "-2logLik"
            if what:
                parted.append((k, i, what))
                break
        same += what is None and len(kern) >= len(plain)
    return same, parted


def _wide_predict(model, hgeno, htable, label):
    """Held-out prediction of a model wider than the ensemble kernel takes:
    through the scoring kernel, not ens_acc; returns (accuracy, launches)."""
    from hibag_tpu_torch import predict
    from hibag_tpu_torch.ops import ens_acc
    from hibag_tpu_torch.ops import post_scores as ps

    ps.LAUNCHES = 0
    ens_acc.LAUNCHES = 0
    res = predict(model, hgeno, device="cuda")
    torch.cuda.synchronize()
    if ps.LAUNCHES < 1 or ens_acc.LAUNCHES:
        raise AssertionError(f"{label}: held-out predict launched scoring "
                             f"{ps.LAUNCHES}, ens_acc {ens_acc.LAUNCHES}")
    return res.accuracy_vs(htable.allele1, htable.allele2), ps.LAUNCHES


def _wide_training(card):
    """train_parallel(mode="host") and (mode="fused") of WIDE_K classifiers
    on the wide panel with no engine= override: the kernels launched, OOB
    and held-out accuracy >= 0.9 (held-out through the scoring kernel),
    out_of_bag through it; classifiers equal to an engine="torch" run over
    the first WIDE_TORCH_STEPS greedy steps, as a reading. Then a fused
    training at hcap=4,160 on a small wide panel: every step's kernels
    at H=4,160, its live slots (at most 4,096) printed."""
    import collections

    from hibag_tpu_torch import out_of_bag, train_parallel
    from hibag_tpu_torch.models import em
    from hibag_tpu_torch.models import train as train_mod
    from hibag_tpu_torch.models import train_fused
    from hibag_tpu_torch.ops import post_scores as ps
    from hibag_tpu_torch.ops import train_step as ts
    from hibag_tpu_torch.utils.synthetic import (PANEL_RECOMBINATION,
                                                 synthetic_panel)

    seed, n, p, a = WIDE_PANEL
    (table, geno), (htable, hgeno) = synthetic_panel(
        seed, n, p, a, n_held_out=500, recombination=PANEL_RECOMBINATION)
    present = len(np.unique(np.concatenate([table.allele1, table.allele2])))
    kw = dict(n_classifiers=WIDE_K, batch=WIDE_K, seed=100, mtry=17,
              verbose=False, with_matching=False, device="cuda")
    lines = []
    for mode in ("host", "fused"):
        extra = (dict(hcap=256, max_steps=192, on_overflow="freeze")
                 if mode == "fused" else {})
        steps = []
        where = train_mod if mode == "host" else train_fused
        tier, tiers = em.mask_tier, collections.Counter()

        def counted_tier(*x):
            t = tier(*x)
            tiers[t] += 1
            return t
        restore = _record_steps(where, "grow_step", steps)
        em.mask_tier = counted_tier
        for k in ts.LAUNCHES:
            ts.LAUNCHES[k] = 0
        try:
            t0 = time.perf_counter()
            model = train_parallel(table, geno, mode=mode, **kw, **extra)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
        finally:
            restore()
            em.mask_tier = tier
        launches = dict(ts.LAUNCHES)
        if launches["em_estep"] + launches["em_estep_packed"] < 1 \
                or launches["evaluate_candidates_kernel"] < 1:
            raise AssertionError(f"wide {mode}: the kernels did not launch: "
                                 f"{launches}")
        _freq_sums(model, f"wide {mode}")
        oob = float(np.mean([c.oob_accuracy for c in model.classifiers]))
        acc, n_ps = _wide_predict(model, hgeno, htable, f"wide {mode}")
        if oob < 0.9 or acc < 0.9:
            raise AssertionError(f"wide {mode}: mean OOB {oob:.4f}, held-out "
                                 f"{acc:.4f} (< 0.9)")
        n_hap = [c.n_haplo for c in model.classifiers]
        H = max(s[0][0].shape[1] for s in steps)
        line = (f"[limits] train_parallel(mode='{mode}') N={n} P={p} A={a} "
                f"({present} present) K={WIDE_K} mtry=17: "
                f"{WIDE_K / elapsed:.4f} classifiers/s ({elapsed:.3f} s), "
                f"{len(steps)} steps up to H={H}, launches: EM int8 "
                f"{launches['em_estep']}, packed "
                f"{launches['em_estep_packed']}, eval "
                f"{launches['evaluate_candidates_kernel']}; mask tiers "
                f"{dict(tiers)}; mean OOB {oob:.4f}; held-out accuracy "
                f"{acc:.4f} (500 samples, post_scores launches {n_ps}, "
                f"ens_acc 0); haplotypes {min(n_hap)}..{max(n_hap)}")
        if mode == "host":
            ps.LAUNCHES = 0
            res = out_of_bag(model, table, geno, device="cuda")
            if ps.LAUNCHES < WIDE_K:
                raise AssertionError(f"out_of_bag launched the scoring "
                                     f"kernel {ps.LAUNCHES} times")
            plain = []
            restore = _record_steps(train_mod, "grow_step", plain,
                                    WIDE_TORCH_STEPS)
            try:
                train_parallel(table, geno, mode="host", engine="torch", **kw)
            except _Stop:
                pass
            finally:
                restore()
            same, parted = _same_steps(steps[:WIDE_TORCH_STEPS], plain,
                                       WIDE_K)
            line += (f"; out_of_bag acc.haplo "
                     f"{res['overall']['acc.haplo']:.4f} (post_scores "
                     f"launches {ps.LAUNCHES}); equal to engine='torch' over "
                     f"the first {WIDE_TORCH_STEPS} greedy steps: "
                     f"{same}/{WIDE_K}, parted (classifier, step, what) "
                     f"{parted}")
        lines.append(line + f" | {card}")
        print(lines[-1])

    # the kernels at H=4,160 from a training: the fused trainer sized to a
    # capacity of 4,160 slots, a few steps on a small wide panel. Its live
    # slots stay far below 4,096 (the padding makes the width); growth by
    # freeze or retry stops at RETRY_MAX_HCAP = 4,096, as in hibag_tpu
    (t2, g2), _ = synthetic_panel(seed + 1, 120, 40, a,
                                  recombination=PANEL_RECOMBINATION)
    steps = []
    restore = _record_steps(train_fused, "grow_step", steps)
    for k in ts.LAUNCHES:
        ts.LAUNCHES[k] = 0
    try:
        t0 = time.perf_counter()
        model = train_parallel(t2, g2, n_classifiers=1, batch=1, seed=100,
                               mtry=8, verbose=False, with_matching=False,
                               mode="fused", hcap=4160, max_steps=4,
                               on_overflow="freeze", device="cuda")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    finally:
        restore()
    launches = dict(ts.LAUNCHES)
    Hs = sorted({s[0][0].shape[1] for s in steps})
    live = max(int((s[0][1] > 0).sum(1).max()) for s in steps)
    if Hs != [4160] or not 0 < live <= 4096 \
            or launches["evaluate_candidates_kernel"] != len(steps) \
            or launches["em_estep"] + launches["em_estep_packed"] < 1:
        raise AssertionError(f"hcap=4160: steps at H={Hs}, {live} live "
                             f"slots, launches {launches}")
    _freq_sums(model, "hcap=4160")
    print(f"[limits] train_parallel(mode='fused', hcap=4160, "
          f"on_overflow='freeze') N=120 P=40 A={a} K=1 mtry=8: {len(steps)} "
          f"steps at H=4160 (live slots up to {live}, the rest padding) in "
          f"{elapsed:.3f} s, launches: EM int8 "
          f"{launches['em_estep']}, packed {launches['em_estep_packed']}, "
          f"eval {launches['evaluate_candidates_kernel']}; OOB "
          f"{model.classifiers[0].oob_accuracy:.4f} | {card}")


def phase_limits(dev, card):
    """Phase 10: the kernels past 4,096 slots and 128 alleles, then the
    wide locus trained and scored on the card."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 10)
    em_err = _limit_em(rng, dev)
    ev_err = _limit_eval(rng, dev)
    sc_err = _limit_scores(rng, dev)
    t1 = time.perf_counter()
    _wide_training(card)
    print(f"[limits] kernels {t1 - t0:.1f} s (EM max abs err {em_err:.3e}, "
          f"evaluation {ev_err:.3e}, scoring {sc_err:.3e}), training "
          f"{time.perf_counter() - t1:.1f} s | {card}")


#: phase 11's mesh A: two shards of the classifiers on the one card
MESH_A = ("cuda:0", "cuda:0")
#: phase 11's budget, seconds (its checks and readings, not the artifacts
#: `--mesh` rebuilds)
MESH_BUDGET_S = 60.0
#: phase 11 (d): train_dynamic's classifiers and job size
DYN_K, DYN_JOB = 8, 2
#: seconds the worker pair of phase 11 (d) may take
PAIR_TIMEOUT_S = 180


def _classifier_tuples(model):
    return [(c.snp_index, c.hap_bits, c.bootstrap_count, c.oob_accuracy,
             c.hap_allele, c.hap_freq) for c in model.classifiers]


def _held_to(label, got, want):
    """Raises unless the classifiers (as `_classifier_tuples`) have equal
    SNPs, haplotypes, bootstraps, OOB and alleles and frequencies at rtol
    1e-5 (tests/test_parallel.py:138-141); returns how many are bitwise
    equal."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} classifiers, want "
                             f"{len(want)}")
    bitwise = 0
    for k, (a, b) in enumerate(zip(got, want)):
        for name, x, y in zip(("SNPs", "haplotypes", "bootstrap", "OOB",
                               "alleles"), a[:5], b[:5]):
            if not np.array_equal(x, y):
                raise AssertionError(f"{label}: classifier {k}'s {name} "
                                     "differ")
        if a[5].shape != b[5].shape or not np.allclose(a[5], b[5], rtol=1e-5,
                                                       atol=0):
            raise AssertionError(f"{label}: classifier {k}'s frequencies "
                                 "differ beyond rtol 1e-5")
        bitwise += int(np.array_equal(a[5], b[5]))
    return bitwise


def _np_close(name, got, want, rtol, atol):
    return _close(name, torch.from_numpy(np.asarray(got, dtype=np.float64)),
                  torch.from_numpy(np.asarray(want, dtype=np.float64)),
                  rtol, atol)


def _mesh_predict(label, model, geno, single):
    """(a): predict(devices=MESH_A, with_prob=True) twice, bitwise equal,
    the second timed and counted; calls equal the one-card run's, postprob
    and matching at rtol 2e-4, atol 1e-6. Then one call of the default
    type (no posterior table, as phases 4 and 7 time), timed. Returns
    (result, seconds, (ens_acc launches, scoring launches), response-only
    seconds)."""
    from hibag_tpu_torch import predict
    from hibag_tpu_torch.ops import ens_acc
    from hibag_tpu_torch.ops import post_scores as ps

    first = predict(model, geno, devices=list(MESH_A), with_prob=True)
    torch.cuda.synchronize()
    ens_acc.LAUNCHES = ps.LAUNCHES = 0
    t0 = time.perf_counter()
    res = predict(model, geno, devices=list(MESH_A), with_prob=True)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = (ens_acc.LAUNCHES, ps.LAUNCHES)
    for name in ("allele1", "allele2", "prob", "matching", "postprob"):
        if not np.array_equal(getattr(first, name), getattr(res, name)):
            raise AssertionError(f"{label}: two mesh predict() calls differ "
                                 f"in {name}")
    for name in ("postprob", "matching"):
        _np_close(f"{label} mesh {name}", getattr(res, name),
                  getattr(single, name), rtol=2e-4, atol=1e-6)
    t0 = time.perf_counter()
    resp = predict(model, geno, devices=list(MESH_A))
    torch.cuda.synchronize()
    el_resp = time.perf_counter() - t0
    for name in ("allele1", "allele2"):
        if not np.array_equal(getattr(resp, name), getattr(res, name)):
            raise AssertionError(f"{label}: the mesh's response-only call "
                                 f"differs in {name}")
    return res, elapsed, launches, el_resp


def _check_batch_split(dev, K=8, C=17, H=256, A=14, S=1024):
    """Raises unless the evaluation, int8 EM and packed EM kernels give
    bitwise over K classifiers what two launches over K/2 each give, on
    phase 5's step shape by default: what a mesh's shards rest on."""
    c = _train_case(np.random.default_rng(SEED + 11), K, C, H, A, S, dev)
    kern, _, eargs = _eval_call(c)
    cases = [("evaluate_candidates_kernel", kern, eargs,
              (0, 1, 2, 3, 4, 5, 8, 9))]
    for name, (k, _, a) in _em_calls(c).items():
        cases.append((name, k, a, (0, 1, 2, 3, 4)))
    halves = ((0, K // 2), (K // 2, K))
    for name, k, a, kdim in cases:
        whole = k(*a)
        parts = [k(*[x[lo:hi].contiguous() if i in kdim else x
                     for i, x in enumerate(a)]) for lo, hi in halves]
        torch.cuda.synchronize()
        for j, w in enumerate(whole):
            if not torch.equal(w, torch.cat([p[j] for p in parts])):
                raise AssertionError(f"{name}: K={K} differs from two "
                                     f"launches of K={K // 2} in output {j}")


def phase_mesh(dev, card, art):
    """Phase 11: the classifiers split over mesh A (two shards on the one
    card) in predict() and train_parallel(), the step kernels' batch
    independence, and two worker processes over gloo on the card."""
    from hibag_tpu_torch import predict, train_parallel
    from hibag_tpu_torch.models import train as train_mod
    from hibag_tpu_torch.models import train_fused
    from hibag_tpu_torch.models.predict import SCAN_CCHUNK
    from hibag_tpu_torch.ops import ens_acc
    from hibag_tpu_torch.ops import post_scores as ps
    from hibag_tpu_torch.ops import train_step as ts

    t_start = time.perf_counter()
    # (a) prediction: the slice's model on the ensemble kernel
    model, geno, res4 = art["slice"]
    ens_acc.LAUNCHES = 0
    single = predict(model, geno, device="cuda", with_prob=True)
    blocks = ens_acc.LAUNCHES
    res, el, (ens_l, ps_l), el_r = _mesh_predict("slice", model, geno,
                                                 single)
    if ens_l != 2 * blocks or ps_l:
        raise AssertionError(f"slice on mesh A: ens_acc launched {ens_l} "
                             f"times (want 2 x {blocks} blocks), scoring "
                             f"kernel {ps_l}")
    for name in ("allele1", "allele2"):
        if not np.array_equal(getattr(res, name), getattr(res4, name)):
            raise AssertionError(f"slice on mesh A: {name} differ from "
                                 "phase 4's calls")
    slice_bitwise = np.array_equal(res.postprob, single.postprob)
    print(f"[mesh] (a) slice predict(devices={list(MESH_A)}, with_prob=True)"
          f" N={N_SLICE}: {N_SLICE / el:.1f} samples/s ({el * 1e3:.2f} ms); "
          f"response only {N_SLICE / el_r:.1f} (phase 4, one card: "
          f"{art['slice_rate']:.1f}); "
          f"ens_acc launches {ens_l} = 2 x {blocks} blocks; two runs bitwise "
          f"equal; calls equal phase 4's; postprob bitwise equal to one "
          f"card's: {slice_bitwise} (two shards on one card) | {card}")

    # (a) the wide model on the scan engine
    wmodel, wgeno, wres = art["wide"]
    ps.LAUNCHES = 0
    wsingle = predict(wmodel, wgeno, device="cuda", with_prob=True)
    single_ps = ps.LAUNCHES
    res, el, (ens_l, ps_l), el_r = _mesh_predict("wide", wmodel, wgeno,
                                                 wsingle)
    C, cc = wmodel.n_classifiers, SCAN_CCHUNK
    half = [C // 2 + C % 2, C // 2]
    per_block = sum(-(-h // cc) for h in half)
    wblocks = single_ps // -(-C // cc)
    if ens_l or ps_l != per_block * wblocks:
        raise AssertionError(f"wide on mesh A: scoring kernel launched "
                             f"{ps_l} times (want {per_block} x {wblocks} "
                             f"blocks), ens_acc {ens_l}")
    top2 = -np.sort(-res.postprob, axis=0)[:2]
    clear = top2[0] - top2[1] > 1e-4 * top2[0]
    same = (res.allele1 == wres.allele1) & (res.allele2 == wres.allele2)
    if not np.all(same[clear]):
        raise AssertionError(f"wide on mesh A: {int((~same[clear]).sum())} "
                             "calls differ from phase 7's outside the tie "
                             "margin")
    print(f"[mesh] (a) wide predict(devices=mesh A) N={N_WIDE}: "
          f"{N_WIDE / el:.1f} samples/s ({el * 1e3:.2f} ms, with_prob); "
          f"response only {N_WIDE / el_r:.1f} (phase 7, one card: "
          f"{art['wide_rate']:.1f}); "
          f"scoring launches {ps_l} = {per_block} chunks x {wblocks} blocks,"
          f" ens_acc 0; calls equal phase 7's on {int(clear.sum())}/{N_WIDE}"
          f" clear samples ({int(same.sum())} of all) | {card}")

    # (b) training on mesh A: host, then fused, on phase 5's panel
    table, geno5 = art["mid_panel"]
    calls = []
    step, fstep = train_mod.grow_step, train_fused._step

    def counted(*a, **k):
        calls.append((threading.get_ident(), a[0].device))
        return step(*a, **k)

    def fcounted(st, *a, **k):
        calls.append((threading.get_ident(), st.bits.device))
        return fstep(st, *a, **k)

    readings = {}
    for mode, kw, want, rate in (
            ("host", HOST_KW, art["host_model"], art["host_rate"]),
            ("fused", FUSED_KW, art["fused_model"], art["fused_rate"])):
        kw = {k: v for k, v in kw.items() if k != "device"}
        calls.clear()
        for k in ts.LAUNCHES:
            ts.LAUNCHES[k] = 0
        train_mod.grow_step, train_fused._step = counted, fcounted
        t0 = time.perf_counter()
        try:
            got = train_parallel(table, geno5, mesh=list(MESH_A), **kw)
            torch.cuda.synchronize()
        finally:
            train_mod.grow_step, train_fused._step = step, fstep
        el = time.perf_counter() - t0
        lc = dict(ts.LAUNCHES)
        threads = {t for t, _ in calls}
        if lc["evaluate_candidates_kernel"] != len(calls) \
                or lc["em_estep"] + lc["em_estep_packed"] < len(calls) \
                or len(threads) < 2 or threading.get_ident() in threads \
                or (mode == "host" and len(calls) % 2) \
                or any(d.type != "cuda" for _, d in calls):
            raise AssertionError(f"{mode} on mesh A: {len(calls)} shard "
                                 f"steps from {len(threads)} threads, "
                                 f"launches {lc}")
        bitwise = _held_to(f"{mode} on mesh A", _classifier_tuples(got),
                           _classifier_tuples(want))
        K = kw["n_classifiers"]
        readings[mode] = K / el
        print(f"[mesh] (b) train_parallel(mode={mode!r}, mesh=mesh A) K={K}:"
              f" {K / el:.4f} classifiers/s ({el:.3f} s; one card: "
              f"{rate:.4f}); {len(calls)} shard steps, each in a shard's "
              f"thread; "
              f"launches EM int8 {lc['em_estep']}, packed "
              f"{lc['em_estep_packed']}, eval "
              f"{lc['evaluate_candidates_kernel']}; SNPs, haplotypes, "
              f"bootstraps and OOB equal the one-card run's, frequencies at "
              f"rtol 1e-5, bitwise {bitwise}/{K} (two shards on one card) | "
              f"{card}")

    # (c) the step kernels over K=8 against K=4 + 4
    _check_batch_split(dev)
    print(f"[mesh] (c) K=8 vs 4 + 4 at K=8 S=1024 H=256 C=17 A=14: the "
          f"evaluation, int8 EM and packed EM kernels bitwise equal | {card}")

    # (d) two processes on the card over gloo
    wall, notes = _dist_pair(art)
    elapsed = time.perf_counter() - t_start
    print(f"[mesh] phase 11: {elapsed:.1f} s (budget {MESH_BUDGET_S:.0f} s); "
          f"readings, two shards on one card (not a multi-GPU speed): "
          f"predict as above, train host {readings['host']:.4f} and fused "
          f"{readings['fused']:.4f} classifiers/s; worker pair {wall:.1f} s "
          f"wall ({notes}) | {card}")
    if elapsed > MESH_BUDGET_S:
        raise AssertionError(f"phase 11 took {elapsed:.1f} s, over its "
                             f"{MESH_BUDGET_S:.0f} s")


def _dist_pair(art):
    """(d): one pair of `chip_smoke.py --dist-worker` processes on the card,
    each running train_distributed, train_dynamic and predict_distributed
    in turn on inputs written to a temporary directory; checks their
    results against the one-process runs. Returns (wall seconds, note)."""
    import pickle
    import socket

    from hibag_tpu_torch import train_parallel

    model, geno, res4 = art["slice"]
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
            pickle.dump({"mid": art["mid_panel"],
                         "headline": art["headline_panel"],
                         "model": model, "geno": geno}, f)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=here)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"),
             "--dist-worker", f"127.0.0.1:{port}", "2", str(i), tmp],
            cwd=here, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for i in range(2)]
        try:
            logs = [p.communicate(timeout=PAIR_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        wall = time.perf_counter() - t0
        for i, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"worker {i} exited {p.returncode}:\n"
                                     f"{log[-4000:]}")
        outs = []
        for i in range(2):
            with open(os.path.join(tmp, f"out{i}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        claims = sorted(os.listdir(os.path.join(tmp, "claims")))
        owners = [open(os.path.join(tmp, "claims", c)).read()
                  for c in claims]

    n_jobs = -(-DYN_K // DYN_JOB)
    if claims != [f"claim_{j}" for j in range(n_jobs)] \
            or not set(owners) <= {"0", "1"}:
        raise AssertionError(f"train_dynamic claims {claims} by {owners}")
    kw = {k: v for k, v in PACKED_KW.items() if k != "n_classifiers"}
    dyn_want = _classifier_tuples(train_parallel(
        *art["headline_panel"], n_classifiers=DYN_K, **kw))
    fused_want = _classifier_tuples(art["fused_model"])
    bit = {"distributed": [], "dynamic": []}
    for i, out in enumerate(outs):
        for name, want in (("distributed", fused_want),
                           ("dynamic", dyn_want)):
            bit[name].append(_held_to(f"worker {i} {name}", out[name], want))
        ld, ly, lp = (out["launches"][k] for k in ("distributed", "dynamic",
                                                   "predict"))
        if ld["evaluate_candidates_kernel"] < 1 or ld["em_estep"] < 1:
            raise AssertionError(f"worker {i}: train_distributed launches "
                                 f"{ld}")
        mine = owners.count(str(i))
        if mine < 1 or ly["em_estep_packed"] < 1:
            raise AssertionError(f"worker {i}: {mine} train_dynamic jobs "
                                 f"and packed EM launches {ly}")
        if lp < 1:
            raise AssertionError(f"worker {i}: predict_distributed did not "
                                 "launch ens_acc")
        p = out["predict"]
        for name in ("allele1", "allele2"):
            if not np.array_equal(p[name], getattr(res4, name)):
                raise AssertionError(f"worker {i}: predict_distributed's "
                                     f"{name} differ from phase 4's")
        _np_close(f"worker {i} prob", p["prob"], res4.prob, rtol=2e-4,
                  atol=0)
    pbit = all(np.array_equal(o["predict"]["prob"], res4.prob) for o in outs)
    secs = {k: max(o["seconds"][k] for o in outs) for k in outs[0]["seconds"]}
    return wall, (f"slower worker's seconds: train_distributed "
                  f"{secs['distributed']:.3f} (K=8, one process on one card "
                  f"in phase 5: {8 / art['fused_rate']:.3f}), train_dynamic "
                  f"{secs['dynamic']:.3f}, predict_distributed "
                  f"{secs['predict']:.3f}; "
                  f"train_distributed bitwise {bit['distributed']}/8 per "
                  f"worker, train_dynamic jobs by worker "
                  f"{[owners.count(str(i)) for i in range(2)]} with worker 1 "
                  f"joining once worker 0 had claimed a job, bitwise "
                  f"{bit['dynamic']}/"
                  f"{DYN_K}, predict_distributed calls equal phase 4's, prob "
                  f"bitwise: {pbit}")


def _await_claim(work_dir, timeout=60.0):
    """Return once `work_dir` holds a claim file (phase 11 (d)'s late
    joiner)."""
    deadline = time.monotonic() + timeout
    while not (os.path.isdir(work_dir) and os.listdir(work_dir)):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no claim in {work_dir} after {timeout} s")
        time.sleep(0.01)


def dist_worker(argv):
    """One process of phase 11 (d): `chip_smoke.py --dist-worker <host:port>
    <nproc> <pid> <dir>`; reads dir/inputs.pkl, writes dir/out<pid>.pkl."""
    import pickle

    from hibag_tpu_torch import train_distributed, train_dynamic
    from hibag_tpu_torch.ops import ens_acc
    from hibag_tpu_torch.ops import train_step as ts
    from hibag_tpu_torch.parallel.mesh import (distributed_init,
                                               predict_distributed)

    coord, nproc, pid, tmp = argv[0], int(argv[1]), int(argv[2]), argv[3]
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    distributed_init(coord, nproc, pid)
    out, launches, secs = {}, {}, {}

    def reset():
        ens_acc.LAUNCHES = 0
        for k in ts.LAUNCHES:
            ts.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        return time.perf_counter()

    t0 = reset()
    out["distributed"] = _classifier_tuples(
        train_distributed(*inp["mid"], **FUSED_KW))
    launches["distributed"] = dict(ts.LAUNCHES)
    secs["distributed"] = time.perf_counter() - t0
    t0 = reset()
    if pid == 1:
        _await_claim(os.path.join(tmp, "claims"))
    kw = {k: v for k, v in PACKED_KW.items() if k != "n_classifiers"}
    out["dynamic"] = _classifier_tuples(train_dynamic(
        *inp["headline"], n_classifiers=DYN_K, job_size=DYN_JOB,
        work_dir=os.path.join(tmp, "claims"), **kw))
    launches["dynamic"] = dict(ts.LAUNCHES)
    secs["dynamic"] = time.perf_counter() - t0
    t0 = reset()
    res = predict_distributed(inp["model"], inp["geno"], device="cuda")
    torch.cuda.synchronize()
    launches["predict"] = ens_acc.LAUNCHES
    secs["predict"] = time.perf_counter() - t0
    out["predict"] = {k: getattr(res, k) for k in
                      ("allele1", "allele2", "prob", "matching")}
    out["launches"], out["seconds"] = launches, secs
    with open(os.path.join(tmp, f"out{pid}.pkl"), "wb") as f:
        pickle.dump(out, f)
    return 0


def _mesh_artifacts():
    """What phase 11 takes from phases 4-8, made anew for `--mesh`: the
    slice's model, cohort and one-card calls, the wide model's, phase 5's
    fused and phase 8's host classifiers on their panel, phase 6's
    panel."""
    from hibag_tpu_torch import predict, train_parallel

    model, geno, _, _ = _slice_case()
    predict(model, geno, device="cuda")
    t0 = time.perf_counter()
    res = predict(model, geno, device="cuda")
    art = dict(slice=(model, geno, res),
               slice_rate=N_SLICE / (time.perf_counter() - t0))
    wmodel, wgeno, _, _ = _wide_case()
    predict(wmodel, wgeno, device="cuda")
    t0 = time.perf_counter()
    art["wide"] = (wmodel, wgeno, predict(wmodel, wgeno, device="cuda"))
    art["wide_rate"] = N_WIDE / (time.perf_counter() - t0)
    (table, geno5), _ = _mid_panel()
    art["mid_panel"] = (table, geno5)
    art["headline_panel"] = _headline_panel()
    for name, kw in (("fused", FUSED_KW), ("host", HOST_KW)):
        train_parallel(table, geno5, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        art[f"{name}_model"] = train_parallel(table, geno5, **kw)
        torch.cuda.synchronize()
        art[f"{name}_rate"] = kw["n_classifiers"] / (time.perf_counter() - t0)
    return art


def mesh_only():
    """Phase 11 alone, after phases 1 and 2 (its inputs made anew); prints
    no result line."""
    dev, card = phase_device()
    phase_build()
    phase_mesh(dev, card, _mesh_artifacts())


def main():
    dev, card = phase_device()
    phase_build()

    from hibag_tpu_torch import predict
    from hibag_tpu_torch.data.geno import align_to_model
    from hibag_tpu_torch.models import predict as predict_mod
    from hibag_tpu_torch.ops import ens_acc

    model, geno, true1, true2 = _slice_case()
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

    # phase 4: the main path, counted on the timed run
    predict(model, geno, device="cuda")
    torch.cuda.synchronize()
    ens_acc.LAUNCHES = 0
    t0 = time.perf_counter()
    res = predict(model, geno, device="cuda")
    elapsed = time.perf_counter() - t0
    launches = ens_acc.LAUNCHES
    if launches < 1:
        raise AssertionError("predict() did not launch the ensemble kernel")
    _repeatable("slice", predict, model, geno, res)
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
          f"{launches}, two calls bitwise equal, f64 calls equal on "
          f"{int(clear.sum())}/{N_F64} clear samples | {card}")

    art = dict(slice=(model, geno, res), slice_rate=rate)
    train_timing = phase_train_kernels(dev)
    train_launches, fused_rate = phase_train(card, art)
    train_launches["em_estep_packed"] = phase_packed(card, art)
    wide = phase_wide(dev, card, art)
    phase_host(card, fused_rate, art)
    phase_files(card, model, geno, true1, true2, res, clear)
    phase_limits(dev, card)
    phase_mesh(dev, card, art)

    kernels = [{"name": "ens_acc", "route": "cuda",
                "source": "hibag_tpu_torch/csrc/ens_acc.cu",
                "replaces": "hibag_tpu/ops/scoring_pallas.py:140",
                "launches": launches, **timing}]
    for name, src, line in (
            ("em_estep", "em_estep.cu", "hibag_tpu/ops/train_step_pallas.py:91"),
            ("em_estep_packed", "em_estep.cu",
             "hibag_tpu/ops/train_step_pallas.py:173"),
            ("evaluate_candidates_kernel", "eval_cand.cu",
             "hibag_tpu/ops/train_step_pallas.py:416")):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"hibag_tpu_torch/csrc/{src}",
                        "replaces": line, "launches": train_launches[name],
                        **train_timing[name]})
    # one kernel serves _kernel (one classifier) and _kernel_ens (a chunk)
    kernels.append({"name": "post_scores", "route": "cuda",
                    "source": "hibag_tpu_torch/csrc/post_scores.cu",
                    "replaces": "hibag_tpu/ops/scoring_pallas.py:33, "
                                "hibag_tpu/ops/scoring_pallas.py:116",
                    **wide})
    # no single PyTorch call computes any of these functions
    for k in kernels:
        k["library_ms"] = None
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def limits_only():
    """Phase 10 alone, after phases 1 and 2; prints no result line."""
    dev, card = phase_device()
    phase_build()
    phase_limits(dev, card)


if __name__ == "__main__":
    if sys.argv[1:] == ["--limits"]:
        sys.exit(limits_only())
    if sys.argv[1:] == ["--mesh"]:
        sys.exit(mesh_only())
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(sys.argv[2:]))
    sys.exit(main())
