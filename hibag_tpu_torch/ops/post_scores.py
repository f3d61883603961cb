"""Per-classifier posterior scores: the wrapper of the hand-written CUDA
kernel csrc/post_scores.cu, and its plain PyTorch version.

Counterpart of hibag_tpu/ops/scoring_pallas.py::ensemble_scores_pallas
(_kernel_ens: C classifiers in one launch), ::posterior_scores_pallas
(_kernel: one classifier) and ::classifier_posteriors (the drop-in for
ops.scoring.posterior_scores). For classifier c and sample n they return

    S [C, N, A, A]  ordered-pair scores Wᵀ·exp(λ·(D − dmin))·W, symmetric
    dmin [C, N]     minimum distance over valid haplotype pairs (exact)
    total [C, N]    Σ S over the full A × A matrix

with nothing accumulated across classifiers: the scan prediction engine
(models/predict.py::_predict_block) weights and sums them itself.

One kernel serves both TPU kernels. `ensemble_scores` is its only launch
site: on a CUDA tensor it launches the kernel or raises, on a CPU tensor it
runs its plain version `ensemble_scores_ref`, a loop over
ops.scoring.posterior_scores. `posterior_scores_kernel` (one classifier) and
`classifier_posteriors` are calls of it at C = 1.
"""

from __future__ import annotations

import threading

import torch

from ..constants import MAXNUM_SNP
from .ens_acc import (PackedHaplotypes, check_inputs, pack_haplotypes,
                      unpack_bits)
from .scoring import posterior_scores
from .train_step import pen_table

#: most haplotype slots per classifier the kernel takes (a cell's pair count
#: is an int32: H^2 < 2^31), as many as the port's trainer can build
MAX_H = 46340
#: most alleles the kernel takes (S is written to device memory; this bounds
#: one (classifier, sample)'s output at 4 MiB; above 180 alleles the cells'
#: running minima take a device scratch of A(A+1) bytes a (classifier,
#: sample) beside it)
MAX_A = 1024
#: most classifiers in one launch (the grid's y dimension)
MAX_C = 65535
#: the plain version scores samples in runs whose [n, H, H] intermediates
#: hold at most this many elements each (256 MiB in float32)
PLAIN_ELEMS = 1 << 26
#: shared memory the kernel may ask for (of the 227 KB a block can have on
#: the H100, less its static scratch); the slot records take 24 bytes a slot
SMEM_BYTES = 224 * 1024
#: most device memory for the slot records where they do not fit in shared
#: memory: blocks then take several samples each (`scores_plan`)
RECORD_BYTES = 256 * 1024 ** 2

#: kernel launches made by `ensemble_scores`; never the plain version's
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()


def _count():
    """One launch more, under a lock: a mesh's shards launch from
    several threads."""
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1


def check_limits(n_slots: int, n_alleles: int) -> None:
    """Raise ValueError for a shape the kernel does not take."""
    if n_slots > MAX_H:
        raise ValueError(f"{n_slots} haplotypes in one classifier exceed the "
                         f"scoring kernel's limit MAX_H={MAX_H}")
    if not 1 <= n_alleles <= MAX_A:
        raise ValueError(f"{n_alleles} alleles: the scoring kernel takes "
                         f"1..MAX_A={MAX_A}")


def _check(hap: PackedHaplotypes, g, n_alleles):
    check_limits(hap.n_slots, n_alleles)
    if hap.n_classifiers > MAX_C:
        raise ValueError(f"{hap.n_classifiers} classifiers in one launch "
                         f"exceed MAX_C={MAX_C}")
    check_inputs(hap, g)


def record_bytes(H: int) -> int:
    """Bytes of one block's slot records in device memory: uint4 [H], then
    uint2 [H] padded to whole 16-byte words."""
    return 16 * (H + -(-H // 2))


def scores_plan(H, A, C, N, smem_bytes, budget=SMEM_BYTES,
                record_budget=RECORD_BYTES):
    """How the kernel scores N samples of C classifiers of H slots: (shared,
    NB, scratch bytes). With `shared` (the slot records and the rest fit
    `budget` bytes; `smem_bytes(H, A, records)` is the kernel's shared
    memory) a block takes one (classifier, sample), NB = N and no record
    scratch. Else the records go to device memory, NB blocks a classifier
    take samples n, n + NB, ..., as many blocks as `record_budget` bytes
    hold records for (at least one a classifier). Both routes give bitwise
    the same results."""
    if smem_bytes(H, A, 1) <= budget:
        return True, N, 0
    NB = max(1, min(N, record_budget // max(1, C * record_bytes(H))))
    return False, NB, C * NB * record_bytes(H)


def ensemble_scores(hap: PackedHaplotypes, g: torch.Tensor, n_alleles: int,
                    *, smem_budget=SMEM_BYTES, record_budget=RECORD_BYTES):
    """(S [C, N, A, A], dmin [C, N], total [C, N]) for genotype codes g int8
    [C, N, 128] gathered to each classifier's SNP slots (3 = missing or
    padded). `smem_budget` and `record_budget` choose the kernel's route
    (`scores_plan`); every route gives bitwise the same results."""
    _check(hap, g, n_alleles)
    if g.device.type == "cpu":
        return ensemble_scores_ref(hap, g, n_alleles)
    from . import _build

    C, N, A = hap.n_classifiers, int(g.shape[1]), n_alleles
    dev = g.device
    S = torch.empty((C, N, A, A), dtype=torch.float32, device=dev)
    dmin = torch.empty((C, N), dtype=torch.float32, device=dev)
    total = torch.empty((C, N), dtype=torch.float32, device=dev)
    if N == 0 or C == 0:
        return S, dmin, total
    lib = _build.load()
    tab = pen_table(dev)
    # the cells' running minima, where they do not fit in shared memory
    per = lib.hibag_post_scores_scratch(A)
    scratch = (torch.empty(C * N * per, dtype=torch.uint8, device=dev)
               if per else None)
    shared, NB, nrec = scores_plan(hap.n_slots, A, C, N,
                                   lib.hibag_post_scores_smem, smem_budget,
                                   record_budget)
    records = (None if shared else
               torch.empty(nrec // 4, dtype=torch.int32, device=dev))
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(dev):
        err = lib.hibag_post_scores(
            hap.hb.data_ptr(), hap.freq.data_ptr(), hap.allele.data_ptr(),
            hap.nh.data_ptr(), g.data_ptr(), tab.data_ptr(), S.data_ptr(),
            dmin.data_ptr(), total.data_ptr(), ptr(scratch), ptr(records), C,
            hap.n_slots, N, A, NB,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.hibag_cuda_error_string(err).decode()
        raise RuntimeError(f"scoring kernel launch failed: {msg} ({err})")
    _count()
    return S, dmin, total


def posterior_scores_kernel(hap: PackedHaplotypes, g: torch.Tensor,
                            n_alleles: int):
    """(S [N, A, A], dmin [N], total [N]) of ONE classifier (hap with C = 1)
    for genotype codes g int8 [N, 128] gathered to its SNP slots:
    `ensemble_scores` at C = 1."""
    if hap.n_classifiers != 1:
        raise ValueError(f"one classifier expected, got {hap.n_classifiers}")
    if g.dim() != 2:
        raise ValueError(f"g must be int8 [N, {MAXNUM_SNP}], got "
                         f"{g.dtype} {tuple(g.shape)}")
    S, dmin, total = ensemble_scores(hap, g[None], n_alleles)
    return S[0], dmin[0], total[0]


def classifier_posteriors(hap_bits, hap_freq, hap_allele, geno_codes,
                          n_alleles):
    """ops.scoring.posterior_scores (float32) through the kernel: the same
    arguments — hap_bits [H, 128] {0,1}, hap_freq [H] (0 for padded slots),
    hap_allele [H], geno_codes [N, 128] — and the same dict of S [N, A, A],
    dmin [N] and total [N], on geno_codes' device. The haplotypes are packed
    on the host first."""
    hap = pack_haplotypes(hap_bits[None].cpu().numpy(),
                          hap_freq[None].cpu().numpy(),
                          hap_allele[None].cpu().numpy(), n_alleles,
                          geno_codes.device)
    S, dmin, total = posterior_scores_kernel(
        hap, geno_codes.to(torch.int8).contiguous(), n_alleles)
    return {"S": S, "dmin": dmin, "total": total}


def ensemble_scores_ref(hap: PackedHaplotypes, g: torch.Tensor,
                        n_alleles: int):
    """Plain PyTorch version of `ensemble_scores`: ops.scoring.
    posterior_scores classifier by classifier over its valid slots, in runs
    of samples whose [n, H, H] intermediates hold at most PLAIN_ELEMS
    elements. Same inputs and outputs."""
    C, N, A = hap.n_classifiers, int(g.shape[1]), n_alleles
    bits = unpack_bits(hap.hb)
    S = torch.empty((C, N, A, A), dtype=torch.float32, device=g.device)
    dmin = torch.empty((C, N), dtype=torch.float32, device=g.device)
    total = torch.empty((C, N), dtype=torch.float32, device=g.device)
    for c, m in enumerate(hap.nh.tolist()):
        step = max(1, PLAIN_ELEMS // max(m * m, 1))
        for s0 in range(0, N, step):
            sl = slice(s0, s0 + step)
            res = posterior_scores(bits[c, :m], hap.freq[c, :m],
                                   hap.allele[c, :m], g[c, sl], A)
            S[c, sl] = res["S"]
            dmin[c, sl] = res["dmin"]
            total[c, sl] = res["total"]
    return S, dmin, total


def posterior_scores_kernel_ref(hap: PackedHaplotypes, g: torch.Tensor,
                                n_alleles: int):
    """Plain PyTorch version of `posterior_scores_kernel`."""
    S, dmin, total = ensemble_scores_ref(hap, g[None], n_alleles)
    return S[0], dmin[0], total[0]
