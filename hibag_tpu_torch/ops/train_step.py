"""The training step's kernels: wrappers of csrc/em_estep.cu and
csrc/eval_cand.cu, each beside its plain PyTorch version.

Counterparts of hibag_tpu/ops/train_step_pallas.py:
* `em_estep` — `em_estep_pallas` (_em_kernel): one E+M step for all
  candidates from the int8 matched-pair mask [K, S, H, H];
* `em_estep_packed` — `em_estep_pallas_packed` (_em_kernel_packed): the same
  from the bit-packed mask [K, S, H, H // 8] in _pack_mask's layout;
* `evaluate_candidates_kernel` — `evaluate_candidates_pallas`
  (_eval_kernel): OOB accuracy counts and in-bag -2logLik.

Each wrapper checks its inputs, takes CUDA tensors only, plans the launch
from the shapes and launches its kernel or raises. The plain versions are
models/em.py's `em_estep_ref`, `em_estep_packed_ref` and
`evaluate_candidates`; the trainer picks kernel or plain version by its
``engine``. Both kernels are deterministic: the same inputs give bitwise
the same outputs (no float atomics).
"""

from __future__ import annotations

import torch

from ..constants import MAXNUM_SNP
from ..utils import trace
from ._build import cuda_only, launch, load, pen_table

#: the EM kernels' limits: H a multiple of EM_H_MULTIPLE up to EM_MAX_H
#: (their pair and row lists hold slot indices in 16 bits), and 1..MAX_C
#: candidates; past that, the mask's device memory (models/em.py's tiers)
EM_MAX_H = 65536
EM_H_MULTIPLE = 32
#: the evaluation kernel's limits: haplotype slots (the triangle of slot
#: pairs is indexed in int32, from products H (H + 1) < 2^31) and alleles
#: (the scoring kernel's post_scores.MAX_A, so the scan engine scores every
#: model the trainer makes)
EVAL_MAX_H = 46340
EVAL_MAX_A = 1024
#: most candidates either kernel takes
MAX_C = 64
#: shared memory the evaluation kernel may ask for (of the 227 KB a block
#: can have on the H100, less its static scratch)
EVAL_SMEM_BYTES = 224 * 1024
#: most device scratch the evaluation kernel's records-in-device-memory
#: plan takes (it holds one classifier's run at least)
EVAL_SCRATCH_BYTES = 1024 ** 3
#: the evaluation kernel's plans (csrc/eval_cand.cu kPlan*): phases, with
#: the frequencies, row scratch, cell grids and slot records in shared
#: memory; tiles, with the slot records in shared memory and nothing in
#: device memory; tiles, with the slot records in device memory
EVAL_PLAN_SHARED, EVAL_PLAN_TILED, EVAL_PLAN_RECORDS = 1, 0, -1
#: sample groups of the EM kernels: a block owns a run of samples, the
#: number of runs depends on S only
EM_MAX_GROUPS = 64
EM_GROUP_SAMPLES = 16
#: the packed EM kernel: samples a block takes at once (a warp each), the
#: pairs a warp lists per sample (a sample with more is taken by the whole
#: block; the sums are the same either way), and the shared memory it may
#: ask for
EM_PACKED_WARPS = 8
EM_PAIR_LIST = 64
EM_SMEM_BYTES = 224 * 1024

#: kernel launches made by each wrapper (with tracing on, each launch is
#: also recorded: utils/trace.py::launch)
LAUNCHES = {"em_estep": 0, "em_estep_packed": 0,
            "evaluate_candidates_kernel": 0}


# ---------------------------------------------------------------------------
# EM E+M step
# ---------------------------------------------------------------------------

def _check_em(fA, fB, mask, gc, B, packed):
    if fA.dtype != torch.float32 or fB.dtype != torch.float32 \
            or fA.dim() != 3 or fB.shape != fA.shape:
        raise ValueError("fA and fB must be float32 [K, C, H]")
    K, C, H = fA.shape
    if not 1 <= C <= MAX_C:
        raise ValueError(f"{C} candidates: the EM kernel takes 1..MAX_C="
                         f"{MAX_C}")
    if H % EM_H_MULTIPLE or not 0 < H <= EM_MAX_H:
        raise ValueError(f"H={H}: the EM kernel takes multiples of "
                         f"EM_H_MULTIPLE={EM_H_MULTIPLE} up to EM_MAX_H="
                         f"{EM_MAX_H}")
    want = (torch.uint8, H // 8) if packed else (torch.int8, H)
    if mask.dim() != 4 or mask.dtype != want[0] or mask.shape[0] != K \
            or tuple(mask.shape[2:]) != (H, want[1]):
        raise ValueError(f"mask must be {want[0]} [K={K}, S, {H}, {want[1]}],"
                         f" got {mask.dtype} {tuple(mask.shape)}")
    S = mask.shape[1]
    if gc.dtype != torch.int8 or tuple(gc.shape) != (K, C, S):
        raise ValueError(f"g_cand must be int8 [{K}, {C}, {S}]")
    if B.dtype != torch.float32 or tuple(B.shape) != (K, S):
        raise ValueError(f"B must be float32 [{K}, {S}]")
    name = "em_estep_packed" if packed else "em_estep"
    cuda_only(name, f"models/em.py::{name}_ref", fA, fB, mask, gc, B)
    if mask.data_ptr() % 16:
        raise ValueError("mask must be 16-byte aligned")
    return K, C, H, S


def em_packed_plan(H, C, S, smem_bytes, budget=EM_SMEM_BYTES,
                   pair_list=EM_PAIR_LIST):
    """How the packed EM kernel runs S samples of a classifier of H slots
    and C candidates: (G, R, shared) with R samples a block (at least a
    batch of EM_PACKED_WARPS, and at most EM_MAX_GROUPS runs) in G = ceil(S
    / R) runs. Both come from S alone, so a classifier's sums do not depend
    on the batch it is trained in. `shared`: whether the frequencies and
    the accumulator sit in shared memory (they do when
    `smem_bytes(H, C, pair_list, 1)`, the kernel's shared memory, fits
    `budget` bytes; else both are in device memory, with bitwise the same
    sums). Raises when not even the pair lists fit."""
    R = min(max(EM_PACKED_WARPS, -(-S // EM_MAX_GROUPS)), max(S, 1))
    G = max(1, -(-S // R))
    if smem_bytes(H, C, pair_list, 1) <= budget:
        return G, R, True
    if smem_bytes(H, C, pair_list, 0) > budget:
        raise ValueError(f"pair lists of {pair_list} do not fit the packed EM "
                         f"kernel's shared memory ({budget} bytes)")
    return G, R, False


def _em_outputs(fA, G):
    """dfA, dfB, dll [K, C] and the per-run partial sums of the EM kernels
    (part [K, G, 2, C, H], dllp [K, G, C])."""
    K, C, H = fA.shape
    f32 = dict(dtype=torch.float32, device=fA.device)
    return (torch.empty_like(fA), torch.empty_like(fA),
            torch.empty((K, C), **f32), torch.empty((K, G, 2, C, H), **f32),
            torch.empty((K, G, C), **f32))


def em_estep(fA, fB, mask, g_cand, B, total_n):
    """One E+M step for all candidates of K classifiers from the int8
    matched-pair mask: fA/fB float32 [K, C, H]; mask int8 [K, S, H, H];
    g_cand int8 [K, C, S] the candidates' genotype codes; B float32 [K, S]
    bootstrap counts; total_n the sample count. Returns (dfA, dfB
    [K, C, H], dll [K, C])."""
    K, C, H, S = _check_em(fA, fB, mask, g_cand, B, packed=False)
    G = max(1, min(EM_MAX_GROUPS, -(-S // EM_GROUP_SAMPLES)))
    dfA, dfB, dll, part, dllp = _em_outputs(fA, G)
    launch("hibag_em_estep", "em_estep",
           {"K": K, "S": S, "H": H, "C": C, "tier": "int8"}, fA.device,
           mask, fA, fB, g_cand, B, part, dllp, dfA, dfB, dll, K, S, H, C, G,
           float(total_n), tally=(LAUNCHES, "em_estep"))
    return dfA, dfB, dll


def em_estep_packed(fA, fB, packed, g_cand, B, total_n):
    """`em_estep` from the bit-packed mask uint8 [K, S, H, H // 8] (bit b of
    byte k is column 8k + b), under `em_packed_plan`'s plan."""
    K, C, H, S = _check_em(fA, fB, packed, g_cand, B, packed=True)
    G, R, shared = em_packed_plan(H, C, S, load().hibag_em_packed_smem)
    return _em_packed_launch(fA, fB, packed, g_cand, B, total_n, G, R,
                             shared, EM_PAIR_LIST)


def _em_packed_launch(fA, fB, packed, g_cand, B, total_n, G, R, shared,
                      pair_list):
    """One launch of the packed EM kernel on checked CUDA inputs under the
    given plan (`em_packed_plan`'s (G, R, shared) for `pair_list`)."""
    K, C, H = fA.shape
    S = packed.shape[1]
    dfA, dfB, dll, part, dllp = _em_outputs(fA, G)
    tmask = torch.empty((K, G, H // 32), dtype=torch.int32, device=fA.device)
    launch("hibag_em_packed", "em_estep_packed",
           {"K": K, "S": S, "H": H, "C": C, "tier": "packed"}, fA.device,
           packed, fA, fB, g_cand, B, part, dllp, tmask, dfA, dfB, dll, K, S,
           H, C, G, R, pair_list, int(shared), float(total_n),
           tally=(LAUNCHES, "em_estep_packed"))
    return dfA, dfB, dll


# ---------------------------------------------------------------------------
# candidate evaluation
# ---------------------------------------------------------------------------

def _check_eval(bits, allele, fA, fB, g_cand, geno_sel, a1, a2, is_oob, B,
                n_alleles):
    if fA.dtype != torch.float32 or fA.dim() != 3 or fB.shape != fA.shape \
            or fB.dtype != torch.float32:
        raise ValueError("fA and fB must be float32 [K, C, H]")
    K, C, H = fA.shape
    N = geno_sel.shape[1]
    if not 1 <= C <= MAX_C:
        raise ValueError(f"{C} candidates: the evaluation kernel takes "
                         f"1..MAX_C={MAX_C}")
    if H > EVAL_MAX_H:
        raise ValueError(f"H={H} exceeds the evaluation kernel's limit "
                         f"EVAL_MAX_H={EVAL_MAX_H}")
    if not 1 <= n_alleles <= EVAL_MAX_A:
        raise ValueError(f"{n_alleles} alleles: the evaluation kernel takes "
                         f"1..EVAL_MAX_A={EVAL_MAX_A}")
    if bits.dtype != torch.float32 or tuple(bits.shape) != (K, H, MAXNUM_SNP):
        raise ValueError(f"bits must be float32 [{K}, {H}, {MAXNUM_SNP}]")
    if tuple(allele.shape) != (K, H) or allele.dtype not in (torch.int32,
                                                             torch.int64):
        raise ValueError(f"allele must be int32 or int64 [{K}, {H}]")
    if geno_sel.dtype != torch.int8 or tuple(geno_sel.shape) != (
            K, N, MAXNUM_SNP):
        raise ValueError(f"geno_sel must be int8 [{K}, N, {MAXNUM_SNP}]")
    if g_cand.dtype != torch.int8 or tuple(g_cand.shape) != (K, C, N):
        raise ValueError(f"g_cand must be int8 [{K}, {C}, {N}]")
    if a1.dtype != torch.int32 or a2.dtype != torch.int32 \
            or tuple(a1.shape) != (N,) or tuple(a2.shape) != (N,):
        raise ValueError(f"a1 and a2 must be int32 [{N}]")
    if is_oob.dtype != torch.bool or tuple(is_oob.shape) != (K, N):
        raise ValueError(f"is_oob must be bool [{K}, {N}]")
    if B.dtype != torch.float32 or tuple(B.shape) != (K, N):
        raise ValueError(f"B must be float32 [{K}, {N}]")
    cuda_only("evaluate_candidates_kernel",
              "models/em.py::evaluate_candidates", bits, allele, fA, fB,
              g_cand, geno_sel, a1, a2, is_oob, B)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """float32 {0,1} [..., 128] -> int32 [..., 4]: bit l of SNP slot l in
    word l // 32 (the layout of ops/ens_acc.py)."""
    b = bits.reshape(*bits.shape[:-1], 4, 32).to(torch.int64)
    sh = torch.arange(32, dtype=torch.int64, device=bits.device)
    w = (b << sh).sum(-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def eval_layout(bits, allele, fA, fB, n_alleles):
    """The evaluation kernel's view of a batch, plain PyTorch: each
    classifier's ok slots (fA > 0 or fB > 0 for some candidate) first, in a
    stable sort by allele, the others after. Returns (hb int32 [K, H, 4]
    their packed bits; al int32 [K, H] their alleles, n_alleles past the ok
    slots; fq float32 [K, H, NG, 2, 4], NG = ceil(C / 4): slot i's fA
    (fq[k, i, g, 0]) and fB (fq[k, i, g, 1]) of candidates 4g..4g+3, 0 past
    C; nok int32 [K] the ok slots)."""
    K, C, H = fA.shape
    A = n_alleles
    ok = ((fA > 0) | (fB > 0)).any(dim=1)
    key = torch.where(ok, allele.to(torch.int64), A)
    order = torch.sort(key, dim=1, stable=True).indices
    hb = pack_bits(bits.gather(1, order[..., None].expand(-1, -1,
                                                          MAXNUM_SNP)))
    idx = order[:, None, :].expand(-1, C, -1)
    NG = -(-C // 4)
    fq = torch.zeros((K, H, NG * 4, 2), dtype=torch.float32,
                     device=fA.device)
    fq[:, :, :C, 0] = fA.gather(2, idx).transpose(1, 2)
    fq[:, :, :C, 1] = fB.gather(2, idx).transpose(1, 2)
    fq = fq.reshape(K, H, NG, 4, 2).transpose(3, 4).contiguous()
    return (hb, key.gather(1, order).to(torch.int32), fq,
            ok.sum(1).to(torch.int32))


def eval_plan(H, n_alleles, C, K, N, smem_bytes, budget=EVAL_SMEM_BYTES):
    """How the evaluation kernel runs a batch of K classifiers of H slots
    over N samples: (M, plan, S) with M = H rounded up to 4 (the slots a
    block makes room for); the plan, the first whose shared memory
    `smem_bytes(M, A, C, plan)` fits `budget` bytes of EVAL_PLAN_SHARED
    (the phase path: one phase per column allele, the candidates'
    frequencies, the row scratch, the cell grids and the slot records in
    shared memory), EVAL_PLAN_TILED (the tiled path: the cells made in
    tiles that the finish reads from shared memory, the slot records
    there, nothing in device memory) and EVAL_PLAN_RECORDS (the tiled path
    with the slot records in device memory); and S the samples a block
    takes: about 8 blocks for each of the H100's 132 SMs, more samples a
    block where the records' device scratch would pass EVAL_SCRATCH_BYTES.
    The choice reads M, A and C alone, and all plans give bitwise the same
    results. Raises when not even EVAL_PLAN_RECORDS fits `budget`."""
    M = max(4, -(-H // 4) * 4)
    A = n_alleles
    S = max(1, -(-K * N // (8 * 132)))
    for plan in (EVAL_PLAN_SHARED, EVAL_PLAN_TILED):
        if smem_bytes(M, A, C, plan) <= budget:
            return M, plan, S
    if smem_bytes(M, A, C, EVAL_PLAN_RECORDS) > budget:
        raise ValueError(
            f"{A} alleles at {C} candidates do not fit the evaluation "
            f"kernel's shared memory ({budget} bytes)")
    runs = max(1, EVAL_SCRATCH_BYTES
               // (K * eval_scratch_bytes(M, EVAL_PLAN_RECORDS)))
    return M, EVAL_PLAN_RECORDS, max(S, -(-N // runs))


def eval_scratch_bytes(M, plan):
    """Device scratch of one block of the evaluation kernel: under
    EVAL_PLAN_RECORDS the slot records (24 bytes a slot), else none."""
    return 24 * M if plan == EVAL_PLAN_RECORDS else 0


def evaluate_candidates_kernel(bits, allele, fA, fB, g_cand, geno_sel, a1,
                               a2, is_oob, B, n_alleles):
    """OOB accuracy count and in-bag -2logLik of every candidate of K
    classifiers; the arguments and results of models.em.evaluate_candidates
    (bits float32 [K, H, 128], allele [K, H], fA/fB float32 [K, C, H],
    g_cand int8 [K, C, N], geno_sel int8 [K, N, 128], a1/a2 int32 [N],
    is_oob bool [K, N], B float32 [K, N]) -> (acc int32 [K, C], ll float32
    [K, C]), under `eval_plan`'s plan."""
    _check_eval(bits, allele, fA, fB, g_cand, geno_sel, a1, a2, is_oob, B,
                n_alleles)
    N = geno_sel.shape[1]
    if N == 0:
        z = torch.zeros(fA.shape[:2], dtype=torch.int32, device=fA.device)
        return z, z.float()
    M, plan, S = eval_plan(fA.shape[2], n_alleles, fA.shape[1], fA.shape[0],
                           N, load().hibag_eval_smem)
    return _eval_launch(bits, allele, fA, fB, g_cand, geno_sel, a1, a2,
                        is_oob, B, n_alleles, M, plan, S)


def _eval_launch(bits, allele, fA, fB, g_cand, geno_sel, a1, a2, is_oob, B,
                 n_alleles, M, plan, S):
    """One launch of the evaluation kernel on checked CUDA inputs under the
    given plan (`eval_plan`'s (M, plan, S))."""
    K, C, H = fA.shape
    N = geno_sel.shape[1]
    A = n_alleles
    dev = fA.device
    acc = torch.empty((K, C), dtype=torch.int32, device=dev)
    ll = torch.empty((K, C), dtype=torch.float32, device=dev)
    hb, al, fq, nok = eval_layout(bits, allele, fA, fB, A)
    gscratch = None
    if plan == EVAL_PLAN_RECORDS:
        gscratch = torch.empty(K * -(-N // S) * eval_scratch_bytes(M, plan)
                               // 4, dtype=torch.float32, device=dev)
    oob = is_oob.to(torch.uint8)
    accp = torch.empty((K, C, N), dtype=torch.int32, device=dev)
    llp = torch.empty((K, C, N), dtype=torch.float32, device=dev)
    launch("hibag_eval_cand", "evaluate_candidates_kernel",
           {"K": K, "N": N, "H": H, "C": C, "A": A, "plan": plan}, dev,
           hb, al, nok, fq, g_cand, geno_sel, a1, a2, oob, B, pen_table(dev),
           accp, llp, gscratch, acc, ll, K, H, N, C, A, M, S, plan,
           tally=(LAUNCHES, "evaluate_candidates_kernel"),
           counts=lambda: eval_counts(allele, fA, fB, geno_sel, A))
    if plan != EVAL_PLAN_SHARED:
        trace.count("evaluate_candidates_tiled")
    return acc, ll


def eval_counts(allele, fA, fB, geno_sel, n_alleles) -> torch.Tensor:
    """The evaluation's data-dependent work, per classifier, int64 [3, K]:
    its ok slots (fA > 0 or fB > 0 for some candidate); the 32-slot words of
    its selected codes that hold a heterozygous code, summed over the
    samples; and its row cells, the sum over alleles a of a's ok slots
    times the alleles b >= a holding ok slots. Reduced on the device for a
    launch record while tracing is on (utils/trace.py)."""
    K, N = geno_sel.shape[:2]
    A = n_alleles
    ok = ((fA > 0) | (fB > 0)).any(dim=1)
    het = (geno_sel.reshape(K, N, MAXNUM_SNP // 32, 32) == 1).any(-1)
    cnt = torch.zeros((K, A + 1), dtype=torch.int64, device=fA.device)
    cnt.scatter_add_(1, torch.where(ok, allele.long(), A),
                     torch.ones_like(ok, dtype=torch.int64))
    cnt = cnt[:, :A]
    later = (cnt > 0).long().flip(1).cumsum(1).flip(1)
    return torch.stack([ok.sum(1), het.sum((1, 2)), (cnt * later).sum(1)])
