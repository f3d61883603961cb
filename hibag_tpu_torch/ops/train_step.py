"""The training step's kernels: wrappers of csrc/em_estep.cu and
csrc/eval_cand.cu, each beside its plain PyTorch version.

Counterparts of hibag_tpu/ops/train_step_pallas.py:
* `em_estep` — `em_estep_pallas` (_em_kernel): one E+M step for all
  candidates from the int8 matched-pair mask [K, S, H, H];
* `em_estep_packed` — `em_estep_pallas_packed` (_em_kernel_packed): the same
  from the bit-packed mask [K, S, H, H // 8] in _pack_mask's layout;
* `evaluate_candidates_kernel` — `evaluate_candidates_pallas`
  (_eval_kernel): OOB accuracy counts and in-bag -2logLik.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs the plain version (`*_ref`), which is models/em.py's arithmetic.
Both kernels are deterministic: the same inputs give bitwise the same
outputs (no float atomics).
"""

from __future__ import annotations

import threading

import torch

from ..constants import LOG_MIN_RARE_FREQ, MAXNUM_SNP
from ..models import em

#: the EM kernels' limits: H a multiple of EM_H_MULTIPLE up to EM_MAX_H
#: (their pair and row lists hold slot indices in 16 bits), and 1..MAX_C
#: candidates; past that, the mask's device memory (models/em.py's tiers)
EM_MAX_H = 65536
EM_H_MULTIPLE = 32
#: the evaluation kernel's limits: haplotype slots (the triangle of slot
#: pairs is indexed in int32, from products H (H + 1) < 2^31) and alleles
#: (the scoring kernel's post_scores.MAX_A, so the scan engine scores every
#: model the trainer makes); past that, the device scratch
#: (EVAL_SCRATCH_BYTES)
EVAL_MAX_H = 46340
EVAL_MAX_A = 1024
#: most candidates either kernel takes
MAX_C = 64
#: shared memory the evaluation kernel may ask for (of the 227 KB a block
#: can have on the H100, less its static scratch)
EVAL_SMEM_BYTES = 224 * 1024
#: most device scratch the evaluation kernel's device-memory plans take
#: (they hold one classifier's run at least; one block's scratch must fit)
EVAL_SCRATCH_BYTES = 1024 ** 3
#: the evaluation kernel's plans (csrc/eval_cand.cu kPlan*): everything in
#: shared memory; frequencies, row scratch and cell grids in device memory;
#: the slot records there too
EVAL_PLAN_SHARED, EVAL_PLAN_DEVICE, EVAL_PLAN_RECORDS = 1, 0, -1
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

#: kernel launches made by each wrapper; never the plain versions'
LAUNCHES = {"em_estep": 0, "em_estep_packed": 0,
            "evaluate_candidates_kernel": 0}
_COUNT_LOCK = threading.Lock()


def _count(name):
    """One launch more, under a lock: a mesh's shards launch from
    several threads."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _same_device(*xs):
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError("all inputs must be on one device")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("all inputs must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _raise_if_failed(lib, err, what):
    if err != 0:
        msg = lib.hibag_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


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
    dev = _same_device(fA, fB, mask, gc, B)
    if dev.type == "cuda" and mask.data_ptr() % 16:
        raise ValueError("mask must be 16-byte aligned")
    return K, C, H, S


def _em_launch(fA, fB, mask, gc, B, total_n):
    from . import _build

    K, C, H = fA.shape
    S = mask.shape[1]
    dev = fA.device
    dfA = torch.empty_like(fA)
    dfB = torch.empty_like(fB)
    dll = torch.empty((K, C), dtype=torch.float32, device=dev)
    G = max(1, min(EM_MAX_GROUPS, -(-S // EM_GROUP_SAMPLES)))
    part = torch.empty((K, G, 2, C, H), dtype=torch.float32, device=dev)
    dllp = torch.empty((K, G, C), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.hibag_em_estep(
            mask.data_ptr(), fA.data_ptr(), fB.data_ptr(), gc.data_ptr(),
            B.data_ptr(), part.data_ptr(), dllp.data_ptr(), dfA.data_ptr(),
            dfB.data_ptr(), dll.data_ptr(), K, S, H, C, G, float(total_n),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_if_failed(lib, err, "EM")
    return dfA, dfB, dll


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


def _em_packed_launch(fA, fB, packed, gc, B, total_n, smem_budget,
                      pair_list):
    from . import _build

    K, C, H = fA.shape
    S = packed.shape[1]
    dev = fA.device
    lib = _build.load()
    G, R, shared = em_packed_plan(H, C, S, lib.hibag_em_packed_smem,
                                  smem_budget, pair_list)
    dfA = torch.empty_like(fA)
    dfB = torch.empty_like(fB)
    dll = torch.empty((K, C), dtype=torch.float32, device=dev)
    part = torch.empty((K, G, 2, C, H), dtype=torch.float32, device=dev)
    dllp = torch.empty((K, G, C), dtype=torch.float32, device=dev)
    tmask = torch.empty((K, G, H // 32), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.hibag_em_packed(
            packed.data_ptr(), fA.data_ptr(), fB.data_ptr(), gc.data_ptr(),
            B.data_ptr(), part.data_ptr(), dllp.data_ptr(), tmask.data_ptr(),
            dfA.data_ptr(), dfB.data_ptr(), dll.data_ptr(), K, S, H, C, G, R,
            pair_list, int(shared), float(total_n),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_if_failed(lib, err, "packed EM")
    return dfA, dfB, dll


def em_estep(fA, fB, mask, g_cand, B, total_n):
    """One E+M step for all candidates of K classifiers from the int8
    matched-pair mask: fA/fB float32 [K, C, H]; mask int8 [K, S, H, H];
    g_cand int8 [K, C, S] the candidates' genotype codes; B float32 [K, S]
    bootstrap counts; total_n the sample count. Returns (dfA, dfB
    [K, C, H], dll [K, C])."""
    _check_em(fA, fB, mask, g_cand, B, packed=False)
    if fA.device.type == "cpu":
        return em_estep_ref(fA, fB, mask, g_cand, B, total_n)
    out = _em_launch(fA, fB, mask, g_cand, B, total_n)
    _count("em_estep")
    return out


def em_estep_packed(fA, fB, packed, g_cand, B, total_n, *,
                    smem_budget=EM_SMEM_BYTES, pair_list=EM_PAIR_LIST):
    """`em_estep` from the bit-packed mask uint8 [K, S, H, H // 8] (bit b of
    byte k is column 8k + b). `smem_budget` caps the kernel's shared memory
    and `pair_list` the pairs a warp lists per sample (`em_packed_plan`);
    every setting gives bitwise the same results."""
    _check_em(fA, fB, packed, g_cand, B, packed=True)
    if fA.device.type == "cpu":
        return em_estep_packed_ref(fA, fB, packed, g_cand, B, total_n)
    out = _em_packed_launch(fA, fB, packed, g_cand, B, total_n, smem_budget,
                            pair_list)
    _count("em_estep_packed")
    return out


def em_estep_ref(fA, fB, mask, g_cand, B, total_n):
    """Plain PyTorch version of `em_estep`."""
    m = em._geno_sel_masks(g_cand, fA.dtype)
    return em.em_estep_masked(fA, fB, mask, B, m, total_n)


def em_estep_packed_ref(fA, fB, packed, g_cand, B, total_n):
    """Plain PyTorch version of `em_estep_packed`."""
    m = em._geno_sel_masks(g_cand, fA.dtype)
    return em.em_estep_packed(fA, fB, packed, B, m, total_n)


# ---------------------------------------------------------------------------
# candidate evaluation
# ---------------------------------------------------------------------------

def pen_table(device) -> torch.Tensor:
    """float32 [257]: exp(log(1e-5) * d), made on `device` by the same
    float32 exp as the plain version's penalties (so the kernel's penalty
    for a distance is bitwise the plain version's)."""
    d = torch.arange(2 * MAXNUM_SNP + 1, dtype=torch.float32, device=device)
    return torch.exp(LOG_MIN_RARE_FREQ * d)


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
    _same_device(bits, allele, fA, fB, g_cand, geno_sel, a1, a2, is_oob, B)


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
    block makes room for); the plan, the first of EVAL_PLAN_SHARED (the
    candidates' frequencies, the row scratch, the cell grids and the slot
    records in shared memory), EVAL_PLAN_DEVICE (the records alone there)
    and EVAL_PLAN_RECORDS (none of them) whose shared memory
    `smem_bytes(M, A, C, plan)` fits `budget` bytes; and S the samples a
    block takes: about 8 blocks for each of the H100's 132 SMs, more
    samples a block where the device scratch would pass
    EVAL_SCRATCH_BYTES. All plans give bitwise the same results. Raises
    when one block's device scratch alone passes EVAL_SCRATCH_BYTES."""
    M = max(4, -(-H // 4) * 4)
    A = n_alleles
    S = max(1, -(-K * N // (8 * 132)))
    if smem_bytes(M, A, C, EVAL_PLAN_SHARED) <= budget:
        return M, EVAL_PLAN_SHARED, S
    plan = (EVAL_PLAN_DEVICE if smem_bytes(M, A, C, EVAL_PLAN_DEVICE)
            <= budget else EVAL_PLAN_RECORDS)
    per = eval_scratch_bytes(M, A, C, plan)
    if per > EVAL_SCRATCH_BYTES:
        raise ValueError(
            f"{H} haplotype slots and {A} alleles at {C} candidates need "
            f"{per} bytes of device scratch a block, more than the "
            f"evaluation kernel's EVAL_SCRATCH_BYTES={EVAL_SCRATCH_BYTES}")
    runs = max(1, EVAL_SCRATCH_BYTES // (K * per))
    return M, plan, max(S, -(-N // runs))


def eval_scratch_bytes(M, n_alleles, C, plan=EVAL_PLAN_DEVICE):
    """Device scratch of one block of the evaluation kernel's device-memory
    plans: the [slot][candidate] row sums and the cell grids, C padded to
    4, and under EVAL_PLAN_RECORDS the slot records (24 bytes a slot)."""
    return (4 * (-(-C // 4) * 4) * (M + n_alleles * (n_alleles + 1) // 2)
            + (24 * M if plan == EVAL_PLAN_RECORDS else 0))


def evaluate_candidates_kernel(bits, allele, fA, fB, g_cand, geno_sel, a1,
                               a2, is_oob, B, n_alleles, *,
                               smem_budget=EVAL_SMEM_BYTES):
    """OOB accuracy count and in-bag -2logLik of every candidate of K
    classifiers; the arguments and results of models.em.evaluate_candidates
    (bits float32 [K, H, 128], allele [K, H], fA/fB float32 [K, C, H],
    g_cand int8 [K, C, N], geno_sel int8 [K, N, 128], a1/a2 int32 [N],
    is_oob bool [K, N], B float32 [K, N]) -> (acc int32 [K, C], ll float32
    [K, C]). `smem_budget` caps the kernel's shared memory (`eval_plan`);
    every plan gives bitwise the same results."""
    _check_eval(bits, allele, fA, fB, g_cand, geno_sel, a1, a2, is_oob, B,
                n_alleles)
    if fA.device.type == "cpu":
        return evaluate_candidates_ref(bits, allele, fA, fB, g_cand,
                                       geno_sel, a1, a2, is_oob, B,
                                       n_alleles)
    from . import _build

    K, C, H = fA.shape
    N = geno_sel.shape[1]
    A = n_alleles
    dev = fA.device
    acc = torch.empty((K, C), dtype=torch.int32, device=dev)
    ll = torch.empty((K, C), dtype=torch.float32, device=dev)
    if N == 0:
        return acc.zero_(), ll.zero_()
    lib = _build.load()
    M, plan, S = eval_plan(H, A, C, K, N, lib.hibag_eval_smem, smem_budget)
    hb, al, fq, nok = eval_layout(bits, allele, fA, fB, A)
    gscratch = None
    if plan != EVAL_PLAN_SHARED:
        gscratch = torch.empty(
            K * -(-N // S) * eval_scratch_bytes(M, A, C, plan) // 4,
            dtype=torch.float32, device=dev)
    oob = is_oob.to(torch.uint8)
    accp = torch.empty((K, C, N), dtype=torch.int32, device=dev)
    llp = torch.empty((K, C, N), dtype=torch.float32, device=dev)
    tab = pen_table(dev)
    with torch.cuda.device(dev):
        err = lib.hibag_eval_cand(
            hb.data_ptr(), al.data_ptr(), nok.data_ptr(), fq.data_ptr(),
            g_cand.data_ptr(), geno_sel.data_ptr(), a1.data_ptr(),
            a2.data_ptr(), oob.data_ptr(), B.data_ptr(), tab.data_ptr(),
            accp.data_ptr(), llp.data_ptr(),
            gscratch.data_ptr() if gscratch is not None else None,
            acc.data_ptr(), ll.data_ptr(), K, H, N, C, A, M, S, plan,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_if_failed(lib, err, "evaluation")
    _count("evaluate_candidates_kernel")
    return acc, ll


def evaluate_candidates_ref(bits, allele, fA, fB, g_cand, geno_sel, a1, a2,
                            is_oob, B, n_alleles):
    """Plain PyTorch version of `evaluate_candidates_kernel`."""
    return em.evaluate_candidates(bits, allele, fA, fB, g_cand, geno_sel, a1,
                                  a2, is_oob, B, n_alleles)
