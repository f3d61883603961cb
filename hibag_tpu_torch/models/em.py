"""EM haplotype-frequency estimation and candidate-SNP evaluation in plain
PyTorch, batched over K classifiers (counterpart of hibag_tpu/models/em.py).

Every function takes a leading classifier axis K where the JAX module is
vmapped by the fused trainer; each classifier's arithmetic is the JAX
module's. Reference behaviour: the EM loops of src/LibHLA.cpp:1000-1255
(CAlg_EM), the rare-haplotype merge of :461-515 (EraseDoubleHaplos) and the
candidate evaluation of :1920-1979 (CVariableSelection).

* ``match_pairs``: the matched-pair set of a sample is the minimum-distance
  pairs (i, j) within its two allele blocks, kept as a symmetric mask.
* The EM runs for all mtry candidates at once from the frequencies fA / fB
  of the new SNP's 0 / 1 versions of each haplotype; the four bilinear forms
  f_X · mask · f_Y give each sample's pair sum for genotype 0/1/2/NA.
* ``_make_estep`` keeps the mask in one of three tiers (int8, bit-packed, or
  re-matched per sample chunk), matches through the CUDA kernel of
  ops/match.py and runs each E+M step through those of ops/train_step.py
  (``engine="cuda"``), or through the plain versions here (``"torch"``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..constants import (EM_INIT_VAL_FRAC, EM_MAX_ITERATIONS,
                         LOG_MIN_RARE_FREQ, MIN_RARE_FREQ)
from ..ops.scoring import pair_distance
from ..utils import trace

BIG = 1e9

#: default EM convergence reltol: sqrt(machine eps) of float32, the
#: reference's sqrt(DBL_EPSILON) scaled to float32 compute (as hibag_tpu)
F32_RELTOL = float(np.sqrt(np.finfo(np.float32).eps))

# Mask tiers, sized for one 80 GB H100. hibag_tpu sized them for the 16 GB
# of a v5e (em.py:243-254): an int8/bool mask per classifier up to 32 M
# elements, and half of the chip's memory (8 GiB) for the batch's masks.
# The same shares of 80 GB are five times as large: 160 M elements per
# classifier for the int8 tier and 40 GiB for the batch, leaving the other
# half for the genotypes, the kernels' partial sums and the plain versions'
# chunked intermediates, which are bounded independently of S·H².
#: largest int8 mask (S·H·H bytes) one classifier keeps resident
MASK_MATERIALIZE_ELEMS = 160 * 1024 * 1024
#: the whole batch's mask budget: a batch of K classifiers gives each
#: MASK_TOTAL_BUDGET_BYTES // K unless the caller passes ``mask_budget``
MASK_TOTAL_BUDGET_BYTES = 40 * 1024 ** 3


# ---------------------------------------------------------------------------
# pair matching (PrepareHaplotypes)
# ---------------------------------------------------------------------------

def _chunk_plan(n: int, per_sample_elems: int,
                budget_elems: int = 16 * 1024 * 1024) -> tuple:
    """(chunk, n_chunks): the sample-chunk size of hibag_tpu's _chunk_plan,
    so that the port's sums group samples as the reference's do."""
    c = max(8, min(256, budget_elems // max(per_sample_elems, 1)))
    c = min(n, (c // 8) * 8)
    if c <= 0:
        c = min(n, 8)
    return c, -(-n // max(c, 1))


def _match_chunk(bits, valid, allele, geno_sel, a1, a2):
    """One classifier: bits [H, L], valid/allele [H], geno_sel [s, L], a1/a2
    [s] -> bool [s, H, H] matched-pair mask."""
    D = pair_distance(bits, geno_sel)
    ok1 = valid[None, :] & (allele[None, :] == a1[:, None])
    ok2 = valid[None, :] & (allele[None, :] == a2[:, None])
    block = ok1[:, :, None] & ok2[:, None, :]
    block = block | block.transpose(1, 2)
    Dm = torch.where(block, D, BIG)
    dmin = Dm.amin(dim=(1, 2), keepdim=True)
    return block & (Dm == dmin)


def match_pairs(bits, valid, allele, geno_sel, a1, a2, lo=0, hi=None,
                engine="torch"):
    """Matched haplotype-pair masks [K, hi - lo, H, H] (symmetric), for
    samples lo..hi of geno_sel [K, S, L]; bits [K, H, L] {0,1}, valid and
    allele [K, H], a1/a2 [S] (a1 <= a2). The reference's min-Hamming set
    (_PrepHaploMatch_def, src/LibHLA.cpp:1569-1636).

    ``engine="torch"``: bool, the plain version, a classifier and sample
    chunk at a time. ``"cuda"``: int8 {0, 1} from one launch of the
    matching kernel (ops/match.py; L = 128, H a multiple of 32), bitwise
    the plain mask."""
    K, S = geno_sel.shape[:2]
    hi = S if hi is None else hi
    H = bits.shape[1]
    with trace.span("train.match", bits):
        if _kernel_engine(engine):
            return _match_kernel(bits, valid, allele, geno_sel, a1, a2, lo,
                                 hi, packed=False)
        out = torch.empty((K, hi - lo, H, H), dtype=torch.bool,
                          device=bits.device)
        c, _ = _chunk_plan(S, H * H, 4 * 1024 * 1024)
        for k in range(K):
            for s in range(lo, hi, c):
                e = min(s + c, hi)
                out[k, s - lo:e - lo] = _match_chunk(
                    bits[k], valid[k], allele[k], geno_sel[k, s:e], a1[s:e],
                    a2[s:e])
    return out


def _kernel_engine(engine) -> bool:
    if engine not in ("torch", "cuda"):
        raise ValueError(f"unknown engine {engine!r}: use 'cuda' or 'torch'")
    return engine == "cuda"


def _match_kernel(bits, valid, allele, geno_sel, a1, a2, lo, hi, packed):
    """The matching kernel's call on the plain version's arguments."""
    from ..ops import match
    from ..ops.train_step import pack_bits

    i32 = lambda x: x.to(torch.int32).contiguous()
    return match.match_pairs_kernel(
        pack_bits(bits), valid.contiguous(), i32(allele),
        geno_sel.contiguous(), i32(a1), i32(a2), lo, hi, packed=packed)


def _pack_mask(mask):
    """bool [..., H] -> uint8 [..., H // 8]: bit b of byte k is column
    8k + b (H a multiple of 8)."""
    shp = mask.shape
    m = mask.reshape(*shp[:-1], shp[-1] // 8, 8).to(torch.uint8)
    w = torch.tensor([1 << b for b in range(8)], dtype=torch.uint8,
                     device=mask.device)
    return (m * w).sum(-1, dtype=torch.uint8)


def _unpack_mask(packed, dtype):
    """uint8 [..., H // 8] -> dtype [..., H] in {0, 1}."""
    sh = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> sh) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8).to(dtype)


def match_pairs_packed(bits, valid, allele, geno_sel, a1, a2,
                       engine="torch"):
    """``match_pairs`` bit-packed along the last axis: uint8
    [K, S, H, H // 8]. ``engine="torch"`` builds it one sample chunk at a
    time, so the bool mask never exists whole; ``"cuda"`` writes it in one
    launch of the matching kernel, with no bool mask at all."""
    K, S = geno_sel.shape[:2]
    H = bits.shape[1]
    with trace.span("train.match", bits):
        if _kernel_engine(engine):
            return _match_kernel(bits, valid, allele, geno_sel, a1, a2, 0, S,
                                 packed=True)
        out = torch.empty((K, S, H, H // 8), dtype=torch.uint8,
                          device=bits.device)
        c, _ = _chunk_plan(S, H * H, 4 * 1024 * 1024)
        for s in range(0, S, c):
            e = min(s + c, S)
            out[:, s:e] = _pack_mask(match_pairs(bits, valid, allele,
                                                 geno_sel, a1, a2, s, e))
    return out


# ---------------------------------------------------------------------------
# EM over all candidates at once
# ---------------------------------------------------------------------------

def _geno_sel_masks(g, dt):
    """Genotype-selection masks [..., 3] in `dt` from candidate codes g:
    m00 = [g==0 or NA], m01 = [g==1 or NA], m11 = [g==2 or NA] (the pair
    flags of PrepareNewSNP)."""
    is0, is1, is2 = g == 0, g == 1, g == 2
    isna = ~(is0 | is1 | is2)
    return torch.stack([(is0 | isna).to(dt), (is1 | isna).to(dt),
                        (is2 | isna).to(dt)], dim=-1)


def _em_estep_chunk(fA, fB, mask_f, B_c, m_c, total_n):
    """E+M contributions of one sample chunk, for K classifiers.

    fA/fB [K, C, H]; mask_f [K, c, H, H] in the compute dtype; B_c [K, c];
    m_c [K, C, c, 3] (_geno_sel_masks). Returns (dfA, dfB [K, C, H],
    dll [K, C]), additive over chunks. The s-sums are a multiply followed by
    a reduction, not a matrix product, as in hibag_tpu (em.py:214-220): their
    order then does not depend on the batch size.
    """
    C = fA.shape[1]
    fboth = torch.cat([fA, fB], dim=1)                       # [K, 2C, H]
    t = torch.einsum("kshj,kcj->kcsh", mask_f, fboth)        # [K, 2C, c, H]
    t0, t1 = t[:, :C], t[:, C:]
    s00 = (fA[:, :, None, :] * t0).sum(-1)                   # [K, C, c]
    s01 = (fA[:, :, None, :] * t1).sum(-1)
    s10 = (fB[:, :, None, :] * t0).sum(-1)
    s11 = (fB[:, :, None, :] * t1).sum(-1)
    m00, m01, m11 = m_c[..., 0], m_c[..., 1], m_c[..., 2]
    psum = m00 * s00 + m01 * s01 + m01 * s10 + m11 * s11
    psum_safe = psum.clamp_min(1e-37)
    wgt = B_c[:, None, :].to(fA.dtype) / psum_safe           # [K, C, c]
    w00, w01, w11 = wgt * m00, wgt * m01, wgt * m11
    dfA = fA * (torch.einsum("kcs,kcsh->kch", w00, t0)
                + torch.einsum("kcs,kcsh->kch", w01, t1)) / total_n
    dfB = fB * (torch.einsum("kcs,kcsh->kch", w01, t0)
                + torch.einsum("kcs,kcsh->kch", w11, t1)) / total_n
    dll = (B_c[:, None, :].to(fA.dtype) * torch.log(psum_safe)).sum(-1)
    return dfA, dfB, dll


def _em_estep_chunked(fA, fB, mask_of, S, B, m, total_n):
    """Sum of _em_estep_chunk over the sample chunks of hibag_tpu's plan;
    mask_of(lo, hi) gives the chunk's mask in the compute dtype."""
    C, H = fA.shape[1:]
    c, _ = _chunk_plan(S, max(H * H, 2 * C * H))
    accA = accB = accL = None
    for s in range(0, S, c):
        e = min(s + c, S)
        d = _em_estep_chunk(fA, fB, mask_of(s, e), B[:, s:e], m[:, :, s:e],
                            total_n)
        if accA is None:
            accA, accB, accL = d
        else:
            accA, accB, accL = accA + d[0], accB + d[1], accL + d[2]
    return accA, accB, accL


def em_estep_masked(fA, fB, mask, B, m, total_n):
    """One E+M step from a resident mask [K, S, H, H] (bool or int8)."""
    return _em_estep_chunked(fA, fB, lambda s, e: mask[:, s:e].to(fA.dtype),
                             mask.shape[1], B, m, total_n)


def em_estep_packed(fA, fB, packed, B, m, total_n):
    """One E+M step from a bit-packed mask [K, S, H, H // 8]."""
    return _em_estep_chunked(
        fA, fB, lambda s, e: _unpack_mask(packed[:, s:e], fA.dtype),
        packed.shape[1], B, m, total_n)


def em_estep_ref(fA, fB, mask, g_cand, B, total_n):
    """Plain version of ops/train_step.py::em_estep, under its signature
    (g_cand int8 [K, C, S] in place of the selection masks)."""
    return em_estep_masked(fA, fB, mask, B, _geno_sel_masks(g_cand, fA.dtype),
                           total_n)


def em_estep_packed_ref(fA, fB, packed, g_cand, B, total_n):
    """Plain version of ops/train_step.py::em_estep_packed, under its
    signature."""
    return em_estep_packed(fA, fB, packed, B,
                           _geno_sel_masks(g_cand, fA.dtype), total_n)


def mask_tier(S: int, H: int, mask_budget: int) -> str:
    """The mask tier of `_make_estep` for S samples, H (padded) slots and
    ``mask_budget`` bytes per classifier: "int8", "packed" or "remat"."""
    if S * H * H <= min(MASK_MATERIALIZE_ELEMS, mask_budget):
        return "int8"
    if H % 8 == 0 and S * H * (H // 8) <= mask_budget:
        return "packed"
    return "remat"


def _make_estep(valid, bits, allele, geno_sel, a1, a2, B, g_new, total_n,
                mask_budget=None, engine="torch"):
    """The E-step closure (fA, fB) -> (dfA, dfB, dll) with the mask tier
    chosen from static shapes (hibag_tpu em.py:397-471):

    * int8: the mask is matched once and kept, while S·H·H bytes fit both
      MASK_MATERIALIZE_ELEMS and ``mask_budget`` (bytes per classifier);
    * packed: else, bit-packed (8x smaller) while S·H·H/8 fits
      ``mask_budget``;
    * remat: else, each E-step re-matches the mask one sample chunk at a
      time.

    The tiers give the same sums up to float32 order. ``engine="cuda"``
    matches through ops/match.py's kernel (its int8 or packed mask as it
    is) and runs the steps through ops/train_step.py's kernels, on slots
    padded with empty ones to the kernels' multiple of 32 (empty slots match
    nothing and add exact zeros); ``"torch"`` through the plain versions
    here.
    """
    K, S = geno_sel.shape[:2]
    H = bits.shape[1]
    if mask_budget is None:
        mask_budget = MASK_TOTAL_BUDGET_BYTES // max(K, 1)
    if engine == "cuda":
        from ..ops import train_step as ts

        pad = -H % ts.EM_H_MULTIPLE
        if pad:
            bits = torch.nn.functional.pad(bits, (0, 0, 0, pad))
            valid = torch.nn.functional.pad(valid, (0, pad))
            allele = torch.nn.functional.pad(allele, (0, pad))
        gc, Bf = g_new.contiguous(), B.to(torch.float32).contiguous()
        masked = lambda fA, fB, mask, s, e: ts.em_estep(
            fA, fB, mask, gc[:, :, s:e].contiguous(),
            Bf[:, s:e].contiguous(), total_n)
        packed = lambda fA, fB, pk: ts.em_estep_packed(fA, fB, pk, gc, Bf,
                                                       total_n)
    else:
        pad = 0
        m = _geno_sel_masks(g_new, torch.float32)
        masked = lambda fA, fB, mask, s, e: em_estep_masked(
            fA, fB, mask, B[:, s:e], m[:, :, s:e], total_n)
        packed = lambda fA, fB, pk: em_estep_packed(fA, fB, pk, B, m,
                                                    total_n)
    Hp = H + pad
    # looked up at call time, so that wrappers of the module's names see
    # each call
    match = lambda s, e: match_pairs(bits, valid, allele, geno_sel, a1, a2,
                                     s, e, engine=engine)

    tier = mask_tier(S, Hp, mask_budget)
    if tier == "int8":
        mask = match(0, S)
        step = lambda fA, fB: masked(fA, fB, mask, 0, S)
    elif tier == "packed":
        pk = match_pairs_packed(bits, valid, allele, geno_sel, a1, a2,
                                engine=engine)
        step = lambda fA, fB: packed(fA, fB, pk)
    else:
        c, _ = _chunk_plan(S, Hp * Hp, 4 * 1024 * 1024)

        def step(fA, fB):
            acc = None
            for s in range(0, S, c):
                e = min(s + c, S)
                d = masked(fA, fB, match(s, e), s, e)
                acc = d if acc is None else tuple(x + y
                                                  for x, y in zip(acc, d))
            return acc
    if not pad:
        return step

    def padded(fA, fB):
        dfA, dfB, dll = step(torch.nn.functional.pad(fA, (0, pad)),
                             torch.nn.functional.pad(fB, (0, pad)))
        return dfA[..., :H], dfB[..., :H], dll
    return padded


def em_all_candidates(freq0, valid, bits, allele, geno_sel, a1, a2, B,
                      g_new, afreq, total_n, reltol=F32_RELTOL,
                      mask_budget=None, engine="torch", skip=None):
    """The reference's EM to convergence for every candidate SNP of K
    classifiers.

    freq0 [K, H] current haplotype frequencies; valid [K, H] bool; bits
    [K, H, L]; allele [K, H]; geno_sel [K, S, L] codes over the selected
    SNPs; a1/a2 [S]; B [K, S] bootstrap counts (0 for padded samples);
    g_new [K, C, S] candidate genotype codes; afreq [K, C]; total_n a float.

    Convergence as src/LibHLA.cpp:1185-1255 and hibag_tpu: the tolerance is
    anchored at the first iteration's log-likelihood, a candidate is done
    when |dLL| <= tol and keeps its state from then on, and a classifier
    stops at EM_MAX_ITERATIONS or when all its candidates are done (the
    vmapped while_loop: each classifier has its own iteration count).
    ``skip`` [K] bool marks classifiers whose result the caller discards
    (done ones): they stop after the first step.

    Returns (fA [K, C, H], fB [K, C, H], loglik [K, C], n_iter [K]).
    Traced as the span ``train.em``: each E-step counts one
    ``train.em_iterations`` and each convergence check, a blocking read of
    the device, one ``host_syncs``.
    """
    with trace.span("train.em", freq0):
        return _em_loop(freq0, valid, bits, allele, geno_sel, a1, a2, B,
                        g_new, afreq, total_n, reltol, mask_budget, engine,
                        skip)


def _em_loop(freq0, valid, bits, allele, geno_sel, a1, a2, B, g_new, afreq,
             total_n, reltol, mask_budget, engine, skip):
    K, C = g_new.shape[:2]
    v = valid.to(freq0.dtype)
    # DoubleHaplosInitFreq (src/LibHLA.cpp:447-459): p0*f + eps, p1*f + eps
    fA = ((freq0[:, None, :] * (1.0 - afreq[:, :, None]) + EM_INIT_VAL_FRAC)
          * v[:, None, :])
    fB = ((freq0[:, None, :] * afreq[:, :, None] + EM_INIT_VAL_FRAC)
          * v[:, None, :])
    estep = _make_estep(valid, bits, allele, geno_sel, a1, a2, B, g_new,
                        total_n, mask_budget, engine)
    fA, fB, ll = estep(fA, fB)
    trace.count("train.em_iterations")
    tol = reltol * (ll.abs() + reltol)
    done = torch.zeros((K, C), dtype=torch.bool, device=fA.device)
    if skip is not None:
        done = done | skip[:, None]
    it = torch.ones(K, dtype=torch.int64, device=fA.device)
    while True:
        active = ~done.all(dim=1) & (it <= EM_MAX_ITERATIONS)
        trace.count("host_syncs")
        if not bool(active.any()):
            break
        fA_new, fB_new, ll_new = estep(fA, fB)
        trace.count("train.em_iterations")
        upd = active[:, None] & ~done
        newly = (ll_new - ll).abs() <= tol
        fA = torch.where(upd[..., None], fA_new, fA)
        fB = torch.where(upd[..., None], fB_new, fB)
        ll = torch.where(upd, ll_new, ll)
        done = done | (active[:, None] & newly)
        it = it + active.to(it.dtype)
    return fA, fB, ll, it


def erase_rare(fA, fB, rare_prob):
    """EraseDoubleHaplos (src/LibHLA.cpp:461-515) for every candidate: when
    either member of a haplotype's pair is rare, keep the more frequent one
    (the 0 version on ties) with the pair's sum if that reaches
    MIN_RARE_FREQ, else drop both; then renormalise. Dropped slots are 0."""
    sumf = fA + fB
    is_rare = (fA < rare_prob) | (fB < rare_prob)
    keep_merged = is_rare & (sumf >= MIN_RARE_FREQ)
    keep_bit0 = fA >= fB
    zero = torch.zeros((), dtype=fA.dtype, device=fA.device)
    fA2 = torch.where(is_rare, torch.where(keep_merged & keep_bit0, sumf,
                                           zero), fA)
    fB2 = torch.where(is_rare, torch.where(keep_merged & ~keep_bit0, sumf,
                                           zero), fB)
    total = (fA2 + fB2).sum(-1, keepdim=True)
    scale = 1.0 / total.clamp_min(1e-37)
    return fA2 * scale, fB2 * scale


# ---------------------------------------------------------------------------
# candidate evaluation: OOB accuracy + in-bag log-likelihood
# ---------------------------------------------------------------------------

def candidate_penalties(g, dt=torch.float32):
    """[..., 3] new-SNP penalties q^delta(g, s) for s = b1 + b2 in {0,1,2}:
    g=0: q^s, g=1: q^|s-1|, g=2: q^(2-s), missing: 1 (em.py:653-661)."""
    s = torch.tensor([0.0, 1.0, 2.0], dtype=dt, device=g.device)
    gg = g[..., None]
    delta = torch.where(gg == 0, s, torch.where(
        gg == 1, (s - 1.0).abs(), torch.where(gg == 2, 2.0 - s,
                                              torch.zeros_like(s))))
    return torch.exp(LOG_MIN_RARE_FREQ * delta)


def compare_count(g1, g2, t1, t2):
    """CHLATypeList::Compare (src/LibHLA.cpp:911-924): matched alleles (0,
    1 or 2) between a called pair g1 <= g2 and the true pair t1 <= t2."""
    m1 = (g1 == t1) | (g1 == t2)
    t1u = torch.where(m1 & (g1 == t1), -1, t1)
    t2u = torch.where(m1 & (g1 != t1) & (g1 == t2), -1, t2)
    m2 = (g2 == t1u) | (g2 == t2u)
    return m1.to(torch.int32) + m2.to(torch.int32)


def _tri_index(g1, g2, A):
    """Packed upper-triangle index of allele cell (g1, g2), g1 <= g2."""
    return g1 * A - g1 * (g1 - 1) // 2 + (g2 - g1)


def _top_two(V, A):
    """(best value, its packed cell index, second value, its index) over the
    unordered allele cells of V [..., A, A] (Sc * (2 - I), symmetric in real
    arithmetic): the first row-major maxima, the second with both mirrors
    of the best left out."""
    flat = V.reshape(*V.shape[:-2], A * A)
    b = flat.argmax(dim=-1, keepdim=True)
    g1, g2 = torch.minimum(b // A, b % A), torch.maximum(b // A, b % A)
    rest = flat.scatter(-1, torch.cat([g1 * A + g2, g2 * A + g1], -1),
                        -torch.inf)
    s = rest.argmax(dim=-1, keepdim=True)
    h1, h2 = torch.minimum(s // A, s % A), torch.maximum(s // A, s % A)
    return (flat.gather(-1, b)[..., 0], _tri_index(g1, g2, A)[..., 0],
            rest.gather(-1, s)[..., 0], _tri_index(h1, h2, A)[..., 0])


def _evaluate_one(bits, allele, fA, fB, g_cand, geno_sel, a1, a2, is_oob, B,
                  n_alleles, per_sample=False, detail=False):
    """hibag_tpu's evaluate_candidates for one classifier (em.py:599-708)."""
    C, H = fA.shape
    N = geno_sel.shape[0]
    A = n_alleles
    dt = fA.dtype
    base_ok = ((fA > 0) | (fB > 0)).any(dim=0)
    pair_ok = base_ok[:, None] & base_ok[None, :]
    onehotT = torch.nn.functional.one_hot(allele.long(), A).to(dt).T  # [A, H]
    Mf = torch.stack([fA, fB], dim=1)[:, :, None, :] * onehotT[None, None]
    eye2 = 2.0 - torch.eye(A, dtype=dt, device=fA.device)
    acc = torch.zeros(C, dtype=torch.int32, device=fA.device)
    ll = torch.zeros(C, dtype=dt, device=fA.device)
    tqs, totals, dets = [], [], []
    c, _ = _chunk_plan(N, C * 2 * H * A, 8 * 1024 * 1024)
    for s in range(0, N, c):
        e = min(s + c, N)
        n = e - s
        D = pair_distance(bits, geno_sel[s:e])
        Dm = torch.where(pair_ok[None], D, BIG)
        dmin = Dm.amin(dim=(1, 2), keepdim=True)
        Pen = torch.exp((LOG_MIN_RARE_FREQ * (Dm - dmin)).to(dt))
        Pen = torch.where(pair_ok[None], Pen, 0.0)
        T = torch.einsum("nij,ceBj->cneBi", Pen, Mf)
        Sb = torch.einsum("cbAi,cneBi->cnbeAB", Mf, T)
        pd = candidate_penalties(g_cand[:, s:e], dt)          # [C, n, 3]
        pd2 = torch.stack([pd[..., :2], pd[..., 1:]], dim=-2)  # [C, n, 2, 2]
        Sc = torch.einsum("cnbe,cnbeAB->cnAB", pd2, Sb)
        total = Sc.sum(dim=(2, 3))
        V = Sc * eye2
        if detail:
            ta1, ta2 = a1[s:e].long(), a2[s:e].long()
            tq_raw = (Sc[:, torch.arange(n, device=fA.device), ta1, ta2]
                      * torch.where(ta1 == ta2, 1.0, 2.0)[None].to(dt))
            bv, bk, sv, sk = _top_two(V, A)
            dets.append(torch.stack([total, tq_raw, bv, bk.to(dt), sv,
                                     sk.to(dt)], dim=-1))
        b = V.reshape(C, n, A * A).argmax(dim=2)
        g1 = torch.minimum(b // A, b % A)
        g2 = torch.maximum(b // A, b % A)
        ta1, ta2 = a1[s:e].long(), a2[s:e].long()
        cnt = compare_count(g1, g2, ta1[None], ta2[None])
        # a total or true-pair score below the smallest normal (FLT_MIN in
        # float32) counts as 0, as hibag_tpu reads it when XLA flushes every
        # denormal term of the sum
        tiny = torch.finfo(dt).tiny
        total = torch.where(total >= tiny, total, 0.0)
        acc += torch.where(is_oob[s:e][None] & (total > 0), cnt,
                           0).sum(1).to(torch.int32)
        tq = Sc[:, torch.arange(n, device=fA.device), ta1, ta2]
        tq = tq * torch.where(ta1 == ta2, 1.0, 2.0)[None].to(dt)
        tq = torch.where(tq >= tiny, tq, 0.0)
        post = tq / total.clamp_min(1e-37)
        ll += -2.0 * (B[s:e][None].to(dt)
                      * torch.log(post.clamp_min(1e-37))).sum(1)
        if per_sample:
            tqs.append(tq)
            totals.append(total)
    if per_sample:
        return acc, ll, torch.cat(tqs, 1), torch.cat(totals, 1)
    if detail:
        return acc, ll, torch.cat(dets, 1)
    return acc, ll


def _flushing() -> bool:
    """Whether float32 arithmetic on the CPU flushes denormals to zero now
    (PyTorch has no getter for the setting)."""
    return bool(torch.tensor([2.0 ** -140], dtype=torch.float32) * 1.0 == 0)


@contextlib.contextmanager
def flush_denormals():
    """Float32 denormals flushed to zero on the CPU inside the block: the
    counterpart of XLA's flush of float32 denormals, which hibag_tpu's sums
    run under. The setting is the calling thread's (intra-op worker threads
    keep the state they were started with), so the block runs on one
    thread. Restores the caller's setting and thread count after; raises
    where the CPU cannot flush, since the sums would then differ from
    hibag_tpu's."""
    was, threads = _flushing(), torch.get_num_threads()
    if not torch.set_flush_denormal(True):
        raise RuntimeError("this CPU cannot flush float32 denormals, so the "
                           "evaluation would not match hibag_tpu's")
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        torch.set_flush_denormal(was)


def evaluate_candidates(bits, allele, fA, fB, g_cand, geno_sel, a1, a2,
                        is_oob, B, n_alleles, per_sample=False,
                        detail=False):
    """OOB best-guess accuracy count and in-bag -2logLik of every candidate,
    for K classifiers: bits [K, H, L]; allele [K, H]; fA/fB [K, C, H]
    post-erase (0 = dropped); g_cand [K, C, N]; geno_sel [K, N, L]; a1/a2
    [N] (a1 <= a2); is_oob [K, N] bool; B [K, N].

    Returns (acc [K, C] int32, summed 0/1/2 per OOB sample; loglik [K, C]),
    and with ``per_sample`` also each sample's true-pair score and total
    (the numerator and denominator of its posterior), [K, C, N]; with
    ``detail`` instead a third result [K, C, N, 6]: each sample's total and
    true-pair score before the FLT_MIN rule, and the value and packed
    upper-triangle index of its best and second-best allele cells (for
    diagnosis: utils/wide_steps.py).
    Per classifier the JAX module's factorised arithmetic: one penalty matrix
    over the base haplotypes for all candidates, each candidate adding its
    2x2 bilinear forms weighted by q^delta of the new SNP
    (_OutOfBagAccuracy / _InBagLogLik, src/LibHLA.cpp:1934-1979).
    On CPU tensors it runs under ``flush_denormals``, the counterpart of
    XLA's flush of float32 denormals; PyTorch's CUDA ops keep denormals.
    """
    scope = (flush_denormals() if fA.device.type == "cpu"
             else contextlib.nullcontext())
    with scope:
        out = [_evaluate_one(bits[k], allele[k], fA[k], fB[k], g_cand[k],
                             geno_sel[k], a1, a2, is_oob[k], B[k], n_alleles,
                             per_sample, detail)
               for k in range(fA.shape[0])]
    return tuple(torch.stack(x) for x in zip(*out))
