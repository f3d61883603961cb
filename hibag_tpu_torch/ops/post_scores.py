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
(models/predict.py::_scan_raw) weights and sums them itself.

One kernel serves both TPU kernels. `ensemble_scores` is its entry in S
mode: on a CUDA tensor it plans the route and launches the kernel or raises,
on a CPU tensor it runs its plain version `ensemble_scores_ref`, a loop over
ops.scoring.posterior_scores. `posterior_scores_kernel` (one classifier) and
`classifier_posteriors` are calls of it at C = 1.

`fold_scores` is the kernel's fold mode, the scan engine's probability
vote: it returns dmin and total and adds Σ_c (w[c,n] / total[c,n])·Q_c[n]
into the ensemble's cells ens [N, A, A], Q_c the unordered convention of
S_c (`fold_into`), with no S in device memory. Its plain version
`fold_scores_ref` is `ensemble_scores_ref` followed by `fold_into`.
"""

from __future__ import annotations

import torch

from ..constants import MAXNUM_SNP
from ._build import launch, load, pen_table, same_device
from .ens_acc import (PackedHaplotypes, check_inputs, pack_haplotypes,
                      unpack_bits)
from .scoring import posterior_scores, unordered_from_S

#: most haplotype slots per classifier the kernel takes (a cell's pair count
#: is an int32: H^2 < 2^31), as many as the port's trainer can build
MAX_H = 46340
#: most alleles the kernel takes (in S mode S is written to device memory;
#: this bounds one (classifier, sample)'s output at 4 MiB; above 180 alleles
#: the cells' running minima take a device scratch of A(A+1) bytes a
#: (classifier, sample) beside it)
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

#: shared memory a fold-mode block may ask for with its slot records in it
#: (else they go to device memory): four such blocks, the kernel's launch
#: bounds (csrc/post_scores.cu::kFoldBlocksPerSm), share an SM's 228 KB,
#: each with its 1 KB reserve and static scratch
FOLD_SMEM_BYTES = 56 * 1024
#: most device memory for the fold mode's per-block scratch (10 bytes a
#: cell): blocks then take several samples each (`fold_plan`)
FOLD_SCRATCH_BYTES = 512 * 1024 ** 2

#: kernel launches made by `ensemble_scores`; never the plain version's
#: (with tracing on, each launch is also recorded: utils/trace.py::launch)
LAUNCHES = 0


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


def fold_plan(H, A, N, smem_bytes, scratch_bytes):
    """How the fold mode scores N samples of classifiers of H slots at A
    alleles: (shared, NB, record scratch bytes). A block takes samples n,
    n + NB, ... and all of a launch's classifiers for each, with a device
    scratch of `scratch_bytes(A)` bytes (the cells' values, minima and
    running sums); NB = N where FOLD_SCRATCH_BYTES holds that many, else as
    many as it holds. With `shared` the slot records sit in shared memory
    (`smem_bytes(H, A, 1)` within FOLD_SMEM_BYTES, so that four blocks
    share an SM); else in a device scratch of 24 bytes a slot a block, and
    NB is also bounded by RECORD_BYTES."""
    NB = max(1, min(N, FOLD_SCRATCH_BYTES // scratch_bytes(A)))
    if smem_bytes(H, A, 1) <= FOLD_SMEM_BYTES:
        return True, NB, 0
    NB = max(1, min(NB, RECORD_BYTES // record_bytes(H)))
    return False, NB, NB * record_bytes(H)


def fold_into(ens, S, total, w):
    """The scan engine's fold of one chunk in plain PyTorch: adds
    Σ_c (w[c] / total[c])·Q_c into ens [n, A, A], Q_c = S_c with its
    off-diagonal cells doubled (ops.scoring.unordered_from_S), for S
    [cc, n, A, A] (overwritten), total and w [cc, n]."""
    Q = unordered_from_S(S, inplace=True)
    scale = w / total.clamp_min(1e-30)
    ens += Q.mul_(scale[..., None, None]).sum(0)


def fold_scores(hap: PackedHaplotypes, g: torch.Tensor, w: torch.Tensor,
                n_alleles: int, ens: torch.Tensor):
    """(dmin [C, N], total [C, N]) for genotype codes g int8 [C, N, 128]
    gathered to each classifier's SNP slots, with
    Σ_c (w[c,n] / total[c,n])·Q_c[n] added into ens float32 [N, A, A] in
    place (w float32 [C, N], the classifier weights): on a CUDA tensor the
    kernel's fold mode under `fold_plan`'s route, on a CPU tensor
    `fold_scores_ref`."""
    _check(hap, g, n_alleles)
    C, N, A = hap.n_classifiers, int(g.shape[1]), n_alleles
    if w.dtype != torch.float32 or tuple(w.shape) != (C, N):
        raise ValueError(f"w must be float32 [{C}, {N}]")
    if ens.dtype != torch.float32 or tuple(ens.shape) != (N, A, A):
        raise ValueError(f"ens must be float32 [{N}, {A}, {A}]")
    same_device(g, w, ens)
    if g.device.type == "cpu":
        return fold_scores_ref(hap, g, w, A, ens)
    lib = load()
    return _fold_launch(hap, g, w, A, ens, *fold_plan(
        hap.n_slots, A, N, lib.hibag_post_scores_fold_smem,
        lib.hibag_post_scores_fold_scratch))


def _fold_launch(hap, g, w, n_alleles, ens, shared, NB, nrec):
    """The fold mode on checked CUDA inputs, launched (unless C or N is 0)
    under the given route (`fold_plan`'s (shared, NB, scratch bytes))."""
    C, N, A = hap.n_classifiers, int(g.shape[1]), n_alleles
    dev = g.device
    dmin = torch.empty((C, N), dtype=torch.float32, device=dev)
    total = torch.empty((C, N), dtype=torch.float32, device=dev)
    if N == 0 or C == 0:
        return dmin, total
    scratch = torch.empty(NB * load().hibag_post_scores_fold_scratch(A) // 4,
                          dtype=torch.float32, device=dev)
    records = (None if shared else
               torch.empty(nrec // 4, dtype=torch.int32, device=dev))
    launch("hibag_post_scores_fold", "post_scores",
           {"C": C, "N": N, "H": hap.n_slots, "A": A, "fold": 1}, dev,
           hap.hb, hap.freq, hap.allele, hap.nh, g, w, pen_table(dev), ens,
           dmin, total, scratch, records, C, hap.n_slots, N, A, NB,
           tally=(globals(), "LAUNCHES"))
    return dmin, total


def fold_scores_ref(hap: PackedHaplotypes, g: torch.Tensor, w: torch.Tensor,
                    n_alleles: int, ens: torch.Tensor):
    """Plain PyTorch version of `fold_scores`: `ensemble_scores_ref`, then
    `fold_into`. Same inputs and outputs."""
    S, dmin, total = ensemble_scores_ref(hap, g, n_alleles)
    fold_into(ens, S, total, w)
    return dmin, total


def ensemble_scores(hap: PackedHaplotypes, g: torch.Tensor, n_alleles: int):
    """(S [C, N, A, A], dmin [C, N], total [C, N]) for genotype codes g int8
    [C, N, 128] gathered to each classifier's SNP slots (3 = missing or
    padded), on a CUDA tensor under `scores_plan`'s route."""
    _check(hap, g, n_alleles)
    if g.device.type == "cpu":
        return ensemble_scores_ref(hap, g, n_alleles)
    return _scores_launch(hap, g, n_alleles, *scores_plan(
        hap.n_slots, n_alleles, hap.n_classifiers, int(g.shape[1]),
        load().hibag_post_scores_smem))


def _scores_launch(hap: PackedHaplotypes, g: torch.Tensor, n_alleles: int,
                   shared, NB, nrec):
    """The scoring kernel's outputs on checked CUDA inputs, launched (unless
    C or N is 0) under the given route (`scores_plan`'s (shared, NB,
    scratch bytes))."""
    C, N, A = hap.n_classifiers, int(g.shape[1]), n_alleles
    dev = g.device
    S = torch.empty((C, N, A, A), dtype=torch.float32, device=dev)
    dmin = torch.empty((C, N), dtype=torch.float32, device=dev)
    total = torch.empty((C, N), dtype=torch.float32, device=dev)
    if N == 0 or C == 0:
        return S, dmin, total
    tab = pen_table(dev)
    # the cells' running minima, where they do not fit in shared memory
    per = load().hibag_post_scores_scratch(A)
    scratch = (torch.empty(C * N * per, dtype=torch.uint8, device=dev)
               if per else None)
    records = (None if shared else
               torch.empty(nrec // 4, dtype=torch.int32, device=dev))
    launch("hibag_post_scores", "post_scores",
           {"C": C, "N": N, "H": hap.n_slots, "A": A, "fold": 0}, dev,
           hap.hb, hap.freq, hap.allele, hap.nh, g, tab, S, dmin, total,
           scratch, records, C, hap.n_slots, N, A, NB,
           tally=(globals(), "LAUNCHES"))
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
