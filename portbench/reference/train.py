"""Plain reference of HIBAG's classifier training, in plain PyTorch: the
bootstrap, the initial haplotypes, pair matching, the EM haplotype
frequencies, the rare-haplotype merge, the candidate evaluation (OOB
accuracy and in-bag log-likelihood) and the greedy choice.

Semantics: HIBAG's CAlg_EM and CVariableSelection (src/LibHLA.cpp:447-515,
1000-1255, 1569-1636, 1880-2122) as the fused trainer configures them:
EM converged to sqrt(float32 eps) relative to the first iteration's
log-likelihood (at most 500 iterations), candidates drawn with threefry
(gen/threefry.py) from key seed x 7919 + id, bootstrap from R's RNG
(gen/rrng.py) seeded (seed + 1000003 x id) mod (2^31 - 1).

Pair matching is kept as a list of (sample, i, j) triples, the EM sums run
over it with index_add, and every product and sum runs in the dtype asked
(float64 for the reference, bfloat16 for the control). Nothing of the
program is imported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..gen import threefry
from ..gen.rrng import RRng
from .predict import pair_distance

MIN_RARE_FREQ = 1e-5
LOG_MIN_RARE_FREQ = math.log(MIN_RARE_FREQ)
EM_INIT_VAL_FRAC = 0.001
EM_MAX_ITERATIONS = 500
FRACTION_HAPLO = 0.1
STOP_RELTOL_LOGLIK_ADDSNP = 0.001
PRUNE_RELTOL_LOGLIK = 0.1
MAXNUM_SNP = 128
EM_RELTOL = float(np.sqrt(np.finfo(np.float32).eps))
BIG = 1e6


@dataclass
class Data:
    """One locus's training data, as the trainer takes it from the panel."""

    geno: torch.Tensor      # [N, P] int64 codes of the kept SNPs
    a1: torch.Tensor        # [N] allele index, a1 <= a2
    a2: torch.Tensor
    n_alleles: int
    kept: np.ndarray        # [P] panel SNP indices kept


def training_data(panel, device) -> Data:
    """The samples' allele pairs as indices into the sorted alleles present,
    and the SNPs that are not monomorphic among the called genotypes
    (hlaAttrBagging's preamble, R/HIBAG.R:77-174)."""
    geno = panel["geno"].T.astype(np.int64)                  # [N, P]
    miss = geno >= 3
    f = np.where(miss, 0, geno).sum(0) / np.maximum(2.0 * (~miss).sum(0), 1)
    kept = np.flatnonzero(np.minimum(f, 1 - f) > 0)
    names = panel["alleles"]
    present = sorted({names[a] for a in np.concatenate([panel["a1"],
                                                        panel["a2"]])},
                     key=lambda s: tuple(int(x) for x in s.split(":")))
    idx = {a: i for i, a in enumerate(present)}
    h1 = np.array([idx[names[a]] for a in panel["a1"]])
    h2 = np.array([idx[names[a]] for a in panel["a2"]])
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return Data(geno=t(geno[:, kept]), a1=t(np.minimum(h1, h2)),
                a2=t(np.maximum(h1, h2)), n_alleles=len(present), kept=kept)


def bootstrap(seed: int, cid: int, n: int) -> np.ndarray:
    """Classifier `cid`'s bootstrap counts [n] (at least one sample out of
    the bag)."""
    return RRng((seed + 1000003 * cid) % (2**31 - 1)).bootstrap_counts(n)


def init_list(d: Data, B, dtype):
    """One haplotype of no SNPs per allele present in the bag, at its share
    of the bag's alleles: (bits [H, 0], freq [H], allele [H])."""
    A = d.n_alleles
    cnt = torch.zeros(A, dtype=torch.float64, device=B.device)
    cnt.index_add_(0, d.a1, B.double())
    cnt.index_add_(0, d.a2, B.double())
    sel = torch.nonzero(cnt > 0)[:, 0]
    return (torch.zeros((len(sel), 0), dtype=torch.uint8, device=B.device),
            (cnt[sel] / cnt.sum()).to(dtype), sel)


def match(bits, allele, geno_sel, a1, a2, block=64):
    """The matched pairs of every sample: the least-distance pairs (i, j)
    with alleles {a1, a2}, both orders. Returns (s, i, j) int64 [T]."""
    out = []
    for lo in range(0, geno_sel.shape[0], block):
        g = geno_sel[lo:lo + block]
        D = pair_distance(bits, g)
        ok1 = allele[None, :] == a1[lo:lo + block, None]
        ok2 = allele[None, :] == a2[lo:lo + block, None]
        blk = ok1[:, :, None] & ok2[:, None, :]
        blk = blk | blk.transpose(1, 2)
        Dm = torch.where(blk, D, BIG)
        dmin = Dm.amin(dim=(1, 2), keepdim=True)
        s, i, j = torch.nonzero(blk & (Dm == dmin), as_tuple=True)
        out.append((s + lo, i, j))
    return tuple(torch.cat(x) for x in zip(*out))


def _flags(g, dtype):
    """[C, N] flags m00, m01, m11 of the candidate codes g: 1 where the
    pair's new bits (0, 0), (0, 1) or (1, 1) agree with g or g is missing."""
    na = g > 2
    return tuple(((g == k) | na).to(dtype) for k in (0, 1, 2))


def _em_start(freq, triples, B, g_new, afreq, total_n, dtype):
    """(step, fA, fB): the E+M step closure of HIBAG's EM for every
    candidate SNP at once (freq [H] of the current list, triples its
    matched pairs, B [N] bootstrap counts, g_new [C, N] candidate codes,
    afreq [C]), and the doubled list's starting frequencies."""
    s, i, j = triples
    N = B.shape[0]
    m00, m01, m11 = _flags(g_new, dtype)
    Bd = B.to(dtype)
    f = freq.to(dtype)
    fA = f[None, :] * (1 - afreq.to(dtype))[:, None] + EM_INIT_VAL_FRAC
    fB = f[None, :] * afreq.to(dtype)[:, None] + EM_INIT_VAL_FRAC
    C, H = fA.shape

    def step(fA, fB):
        a_i, a_j, b_i, b_j = fA[:, i], fA[:, j], fB[:, i], fB[:, j]
        x00, x01, x11 = m00[:, s], m01[:, s], m11[:, s]
        term = x00 * a_i * a_j + x01 * (a_i * b_j + b_i * a_j) \
            + x11 * b_i * b_j
        psum = torch.zeros((C, N), dtype=dtype, device=fA.device)
        psum.index_add_(1, s, term)
        psum = psum.clamp_min(1e-37)
        w = (Bd[None, :] / psum)[:, s]
        ga = w * (x00 * a_j + x01 * b_j)
        gb = w * (x01 * a_j + x11 * b_j)
        accA = torch.zeros((C, H), dtype=dtype, device=fA.device)
        accB = torch.zeros((C, H), dtype=dtype, device=fA.device)
        accA.index_add_(1, i, ga)
        accB.index_add_(1, i, gb)
        ll = (Bd[None, :] * torch.log(psum)).sum(1)
        return fA * accA / total_n, fB * accB / total_n, ll
    return step, fA, fB


def em(freq, triples, B, g_new, afreq, total_n, dtype):
    """HIBAG's EM for every candidate SNP at once. Returns (fA, fB [C, H]):
    the frequencies of each haplotype extended by the new SNP's 0 and 1,
    each candidate stopped at the first iteration whose log-likelihood
    moved by at most EM_RELTOL of the first iteration's."""
    step, fA, fB = _em_start(freq, triples, B, g_new, afreq, total_n, dtype)
    fA, fB, ll = step(fA, fB)
    tol = EM_RELTOL * (ll.abs() + EM_RELTOL)
    done = torch.zeros(fA.shape[0], dtype=torch.bool, device=fA.device)
    for _ in range(EM_MAX_ITERATIONS):
        if bool(done.all()):
            break
        nA, nB, nll = step(fA, fB)
        upd = ~done
        fA = torch.where(upd[:, None], nA, fA)
        fB = torch.where(upd[:, None], nB, fB)
        done = done | ((nll - ll).abs() <= tol)
        ll = torch.where(upd, nll, ll)
    return fA, fB


def em_branches(freq, triples, B, g_new, afreq, total_n, margin, cap):
    """`em` for one candidate in float64, branching where float32 rounding
    could decide the stop: an iteration whose log-likelihood move lies
    within `margin` (relative to the first iteration's log-likelihood) of
    the tolerance both stops there and goes on. Returns up to `cap`
    (fA [H], fB [H]) outcomes."""
    step, fA, fB = _em_start(freq, triples, B, g_new, afreq, total_n,
                             torch.float64)
    fA, fB, ll = step(fA, fB)
    ll0 = float(ll[0])
    tol = EM_RELTOL * (abs(ll0) + EM_RELTOL)
    near = margin * abs(ll0)
    live, out = [(fA, fB, ll)], []
    for _ in range(EM_MAX_ITERATIONS):
        if not live:
            break
        nxt = []
        for fA, fB, ll in live:
            nA, nB, nll = step(fA, fB)
            d = abs(float(nll[0] - ll[0]))
            if d <= tol + near:
                out.append((nA[0], nB[0]))
            if d > tol - near:
                nxt.append((nA, nB, nll))
        live = nxt[:max(cap - len(out), 0)]
    out += [(fA[0], fB[0]) for fA, fB, _ in live]
    return out[:cap]


def erase_rare(fA, fB, rare, prefer=None, ties=1e-4):
    """EraseDoubleHaplos: where either member of a haplotype's pair is below
    `rare`, keep the more frequent one (the 0 version on ties) with the
    pair's sum if that reaches MIN_RARE_FREQ, else drop both; renormalise.
    ``prefer`` [H] (-1, 0 or 1) settles pairs whose two versions lie
    within ``ties`` of each other: float32 rounding decides those, so the
    version the program kept is kept (-1: the 0 version's rule)."""
    s = fA + fB
    is_rare = (fA < rare) | (fB < rare)
    keep = is_rare & (s >= MIN_RARE_FREQ)
    bit0 = fA >= fB
    if prefer is not None:
        tie = (fA - fB).abs() <= ties * s
        bit0 = torch.where(tie & (prefer >= 0), prefer == 0, bit0)
    zero = torch.zeros((), dtype=fA.dtype, device=fA.device)
    nA = torch.where(is_rare, torch.where(keep & bit0, s, zero), fA)
    nB = torch.where(is_rare, torch.where(keep & ~bit0, s, zero), fB)
    tot = (nA + nB).sum(-1, keepdim=True).clamp_min(1e-37)
    return nA / tot, nB / tot


def prefixes(hap_allele, hap_bits):
    """Every (allele, first k bits) of a classifier's haplotypes, k >= 1:
    the versions its lineages kept."""
    out = set()
    for a, b in zip(hap_allele, hap_bits):
        b = tuple(int(x) for x in b)
        out |= {(int(a),) + b[:k] for k in range(1, len(b) + 1)}
    return out


def _prefer(bits, allele, kept):
    """[H] version of each haplotype's new bit that the lineages in `kept`
    (`prefixes`) show: 0 or 1 where one of them appears, else -1."""
    out = []
    for a, b in zip(allele.tolist(), bits.tolist()):
        k0 = (a,) + tuple(b) + (0,) in kept
        k1 = (a,) + tuple(b) + (1,) in kept
        out.append(0 if k0 and not k1 else 1 if k1 and not k0 else -1)
    return torch.tensor(out, device=bits.device)


def compare_count(g1, g2, t1, t2):
    """Alleles (0, 1 or 2) shared by the called pair g1 <= g2 and the true
    pair t1 <= t2 (CHLATypeList::Compare)."""
    m1 = (g1 == t1) | (g1 == t2)
    t1u = torch.where(m1 & (g1 == t1), -1, t1)
    t2u = torch.where(m1 & (g1 != t1) & (g1 == t2), -1, t2)
    m2 = (g2 == t1u) | (g2 == t2u)
    return m1.long() + m2.long()


def evaluate(bits, allele, fA, fB, g_cand, geno_sel, d: Data, B, is_oob,
             dtype, budget=1 << 30, ties=None):
    """OOB accuracy count and in-bag -2 log-likelihood of each candidate:
    the list bits [H, s] extended by each candidate's bit, at frequencies
    fA / fB [C, H] (0 = dropped). A pair's penalty is 1e-5 to the power of
    its distance over the list's SNPs less the sample's least one, times
    1e-5 to the power of the new SNP's distance for the pair's two new
    bits. Returns (acc [C] int64, loss [C]); with ``ties`` (a relative
    gap), also the least and the most OOB count over the answers a near
    tie allows: where a sample's two best cells lie within ``ties`` of each
    other, either is a sound call."""
    C, H = fA.shape
    A = d.n_alleles
    dev = fA.device
    onehot = torch.nn.functional.one_hot(allele.long(), A).to(dtype)   # [H, A]
    eye2 = 2.0 - torch.eye(A, dtype=dtype, device=dev)
    base_ok = ((fA > 0) | (fB > 0)).any(0)
    pair_ok = base_ok[:, None] & base_ok[None, :]
    acc = torch.zeros(C, dtype=torch.int64, device=dev)
    lo_hi = torch.zeros((2, C), dtype=torch.int64, device=dev)
    loss = torch.zeros(C, dtype=dtype, device=dev)
    block = max(1, budget // (8 * (C * H * max(A, H) * 3 + 4 * H * H)))
    W = [onehot[None] * f[:, :, None].to(dtype) for f in (fA, fB)]  # [C,H,A]
    for lo in range(0, geno_sel.shape[0], block):
        hi = min(lo + block, geno_sel.shape[0])
        D = torch.where(pair_ok[None], pair_distance(bits, geno_sel[lo:hi]),
                        BIG)
        dmin = D.amin(dim=(1, 2), keepdim=True)
        pen = torch.where(pair_ok[None], torch.exp(
            LOG_MIN_RARE_FREQ * (D - dmin)), 0.0).to(dtype)       # [n, H, H]
        g = g_cand[:, lo:hi]                                       # [C, n]
        S = torch.zeros((C, hi - lo, A, A), dtype=dtype, device=dev)
        right = [torch.einsum("nij,cjb->cnib", pen, w) for w in W]
        for b in (0, 1):
            for e in (0, 1):
                t = b + e
                dn = torch.where(g == 0, t, torch.where(
                    g == 1, abs(t - 1), torch.where(g == 2, 2 - t, 0)))
                q = torch.exp(LOG_MIN_RARE_FREQ * dn.double()).to(dtype)
                S += q[:, :, None, None] * torch.einsum(
                    "cia,cnib->cnab", W[b], right[e])
        total = S.sum(dim=(2, 3))
        V = (S * eye2).reshape(C, hi - lo, A * A)
        best = V.argmax(dim=2)
        g1 = torch.minimum(best // A, best % A)
        g2 = torch.maximum(best // A, best % A)
        t1, t2 = d.a1[lo:hi], d.a2[lo:hi]
        cnt = compare_count(g1, g2, t1[None], t2[None])
        use = is_oob[lo:hi][None] & (total > 0)
        acc += torch.where(use, cnt, 0).sum(1)
        if ties is not None:
            top2 = V.topk(2, dim=2)
            b2 = top2.indices[..., 1]
            cnt2 = compare_count(torch.minimum(b2 // A, b2 % A),
                                 torch.maximum(b2 // A, b2 % A),
                                 t1[None], t2[None])
            v1, v2 = top2.values[..., 0], top2.values[..., 1]
            tie = (v1 - v2) <= ties * v1
            # a cell and its mirror hold the same pair: no tie between them
            tie = tie & (torch.minimum(b2 // A, b2 % A) * A
                         + torch.maximum(b2 // A, b2 % A)
                         != g1 * A + g2)
            alt = torch.where(tie, cnt2, cnt)
            lo_hi[0] += torch.where(use, torch.minimum(cnt, alt), 0).sum(1)
            lo_hi[1] += torch.where(use, torch.maximum(cnt, alt), 0).sum(1)
        tq = S[:, torch.arange(hi - lo, device=dev), t1, t2] \
            * torch.where(t1 == t2, 1.0, 2.0).to(dtype)[None]
        post = tq / total.clamp_min(1e-37)
        loss += -2.0 * (B[lo:hi].to(dtype)[None]
                        * torch.log(post.clamp_min(1e-37))).sum(1)
    if ties is not None:
        return acc, loss, lo_hi
    return acc, loss


def candidates_ok(g_cand, B):
    """(ok [C], afreq [C]): a candidate is polymorphic in the bag; afreq its
    allele frequency over the bag's called genotypes."""
    okg = g_cand <= 2
    cnt = (torch.where(okg, g_cand, 0).double() * B.double()[None]).sum(1)
    valid = 2.0 * (okg.double() * B.double()[None]).sum(1)
    ok = (cnt > 0) & (cnt < valid)
    return ok, torch.where(ok, cnt / valid.clamp_min(1.0), 0.5)


def grow(bits, freq, allele, fa, fb):
    """The list extended by one SNP: each haplotype's 0 and 1 versions at
    their frequencies, those above 0 kept."""
    z = torch.zeros((bits.shape[0], 1), dtype=bits.dtype, device=bits.device)
    nb = torch.cat([torch.cat([bits, z], 1), torch.cat([bits, z + 1], 1)])
    nf = torch.cat([fa, fb])
    na = torch.cat([allele, allele])
    keep = nf > 0
    return nb[keep], nf[keep], na[keep]


def decide(ok, acc, loss, gmax, gmin):
    """CVariableSelection::Search's running-max scan over the candidates in
    draw order: (winner index or -1, max acc, its loss, kills [C])."""
    okacc = torch.where(ok, acc, -1)
    max_acc = max(gmax, int(okacc.max()))
    best = ok & (acc == max_acc)
    lb = torch.where(best, loss, torch.inf)
    wi = int(lb.argmin())
    win = bool(best.any()) and (max_acc > gmax or float(lb[wi]) < gmin)
    imp = (ok & (acc > gmax)).long()
    earlier = (imp.cumsum(0) - imp) > 0
    kill = ok & ((acc < gmax) | ((acc == gmax) & ~earlier
                                 & (loss > gmin * (1 + PRUNE_RELTOL_LOGLIK))))
    return (wi if win else -1), max_acc, (float(lb[wi]) if win else gmin), kill


def _score(d, B, bits, freq, allele, cand, dtype, ns=None):
    """(acc, loss, ok) of candidates `cand` on the list (bits, freq,
    allele) whose SNPs are the columns `ns` (None: no SNP yet)."""
    N = d.geno.shape[0]
    rare = max(FRACTION_HAPLO / (2.0 * N), MIN_RARE_FREQ)
    geno_sel = (d.geno[:, ns] if ns is not None
                else d.geno[:, :0])
    g_cand = d.geno[:, cand].T                                  # [C, N]
    ok, afreq = candidates_ok(g_cand, B)
    tri = match(bits, allele, geno_sel, d.a1, d.a2)
    fA, fB = em(freq, tri, B, g_cand, afreq, float(N), dtype)
    fA, fB = erase_rare(fA, fB, rare)
    acc, loss = evaluate(bits, allele, fA, fB, g_cand, geno_sel, d, B,
                         B == 0, dtype)
    return acc, loss, ok


def replay(d: Data, B, order, kept=None, margin=1e-5, cap=16):
    """The classifier grown in float64 along the SNP columns `order` (the
    program's choice, in the order it took them): at each step the list is
    matched, extended by the SNP through the EM, merged for rare haplotypes
    and kept above 0. Where float32 rounding could stop an EM one iteration
    earlier or later (`em_branches`), both outcomes are grown, up to `cap`
    lists; where it decides which version of a rare pair the merge keeps,
    the version the program's lineages show is kept (``kept``, the
    program's `prefixes`). Returns the final lists, each (bits [H, s]
    uint8, freq [H], allele [H])."""
    N = d.geno.shape[0]
    rare = max(FRACTION_HAPLO / (2.0 * N), MIN_RARE_FREQ)
    lists = [init_list(d, B, torch.float64)]
    for j, col in enumerate(order):
        geno_sel = d.geno[:, order[:j]]
        g_new = d.geno[:, col][None]
        _, afreq = candidates_ok(g_new, B)
        nxt = []
        for bits, freq, allele in lists:
            tri = match(bits, allele, geno_sel, d.a1, d.a2)
            prefer = None if kept is None else _prefer(bits, allele, kept)
            for fa, fb in em_branches(freq, tri, B, g_new, afreq, float(N),
                                      margin, cap):
                fa, fb = erase_rare(fa[None], fb[None], rare, prefer)
                nxt.append(grow(bits, freq, allele, fa[0], fb[0]))
        lists = nxt[:cap]
    return lists


NOT_DRAWN = 1000.0


class _Prefixes:
    """The classifier's lists along the program's SNP columns `order`, grown
    in float64 as `replay` grows its first list: ``at(j)`` is the list
    after the first j SNPs."""

    def __init__(self, d: Data, B, order, kept):
        self.d, self.B, self.order, self.kept = d, B, order, kept
        N = d.geno.shape[0]
        self.rare = max(FRACTION_HAPLO / (2.0 * N), MIN_RARE_FREQ)
        self.lists = [init_list(d, B, torch.float64)]

    def at(self, j):
        d, B = self.d, self.B
        while len(self.lists) <= j:
            k = len(self.lists) - 1
            bits, freq, allele = self.lists[k]
            g_new = d.geno[:, self.order[k]][None]
            _, afreq = candidates_ok(g_new, B)
            tri = match(bits, allele, _columns(d, self.order[:k]), d.a1,
                        d.a2)
            fa, fb = em(freq, tri, B, g_new, afreq, float(d.geno.shape[0]),
                        torch.float64)
            prefer = None if self.kept is None else _prefer(bits, allele,
                                                            self.kept)
            fa, fb = erase_rare(fa, fb, self.rare, prefer)
            self.lists.append(grow(bits, freq, allele, fa[0], fb[0]))
        return self.lists[j]


def _columns(d: Data, cols):
    return d.geno[:, list(cols)] if len(cols) else d.geno[:, :0]


def _draws(rank, pool, maybe, mtry, limit=8):
    """The candidate draws a pool allows: `rank` [P] the SNPs in draw order
    (draw_top_k's), `pool` the SNPs surely in the pool, `maybe` those that
    may be. Each maybe SNP that would be drawn is taken both in and out.
    Returns up to `limit` (candidates, in-pool flags, pool, maybe)."""
    out = []

    def walk(i, pool, maybe, cand):
        if len(out) >= limit:
            return
        while i < len(rank) and len(cand) < mtry:
            s = int(rank[i])
            if s in maybe:
                walk(i + 1, pool | {s}, maybe - {s}, cand + [s])
                maybe = maybe - {s}
            elif s in pool:
                cand = cand + [s]
            i += 1
        if len(cand) < mtry:
            # short of the pool: the rest in ascending index, as top_k
            # ranks every slot outside the pool alike
            rest = sorted(set(range(len(rank))) - pool - set(cand))
            cand = cand + rest[:mtry - len(cand)]
        out.append((cand, [c in pool for c in cand], pool, maybe))

    walk(0, pool, maybe, [])
    return out


#: the program sums a loss in float32 over the bag, so two losses, or a
#: loss and a threshold, within LOSS_ABS of each other may fall either way;
#: a relative gap of losses is taken over at least LOSS_FLOOR
LOSS_ABS = 1e-4
LOSS_FLOOR = 1.0
#: the program grows its lists in float32, so a candidate's OOB count may
#: differ by one from the count on the reference's float64 list: a
#: decision that turns on losses alone turns as well on one count, and
#: counts at most FLIP
FLIP = 1.0


def _add_gap(k, okp, lo, hi, loss, glo, gmin):
    """How far taking candidate k lies from what the search allows: OOB
    counts by which another candidate is surely better, or 1,000 times the
    relative excess of k's loss over a candidate that at best ties it, or
    over the stop rule's threshold where k does not improve the best."""
    if not okp[k]:
        return NOT_DRAWN
    gap = 0.0
    for c in range(len(okp)):
        if c == k or not okp[c]:
            continue
        if lo[c] > hi[k]:
            gap = max(gap, float(lo[c] - hi[k]))
        elif lo[c] == hi[k]:
            gap = max(gap, min(FLIP, 1000 * (loss[k] - loss[c])
                               / max(loss[c], LOSS_FLOOR)))
    if hi[k] < glo:
        gap = max(gap, float(glo - hi[k]))
    elif hi[k] == glo:
        thr = gmin * (1 - STOP_RELTOL_LOGLIK_ADDSNP)
        gap = max(gap, min(FLIP, 1000 * (loss[k] - thr)
                           / max(gmin, LOSS_FLOOR)))
    return gap


def _stay_gap(okp, lo, hi, loss, glo, ghi, gmin):
    """How far taking no candidate lies from what the search allows: OOB
    counts by which a candidate surely improves the best, or 1,000 times
    the relative margin by which the best loss among candidates surely at
    the best beats the stop rule's threshold, where no candidate that may
    be at the best has a loss under its floor."""
    gap = 0.0
    for c in range(len(okp)):
        if okp[c] and lo[c] > ghi:
            gap = max(gap, float(lo[c] - ghi))
    sure = [loss[c] for c in range(len(okp))
            if okp[c] and lo[c] == hi[c] == glo == ghi]
    may = [loss[c] for c in range(len(okp))
           if okp[c] and max(lo[c], glo) <= min(hi[c], ghi)]
    if sure and min(may) >= STOP_RELTOL_LOGLIK_ADDSNP + LOSS_ABS:
        thr = gmin * (1 - STOP_RELTOL_LOGLIK_ADDSNP)
        gap = max(gap, min(FLIP, 1000 * (thr - min(sure))
                           / max(gmin, LOSS_FLOOR)))
    return gap


def _kills(k, okp, lo, hi, loss, glo, ghi, gmin, tol):
    """(sure, unsure): the candidates an accepted step surely kills, and
    those it may (`_decide`'s pruning with the previous best acc in
    [glo, ghi] and loss gmin; losses within `tol` or LOSS_ABS of the bar
    count either way)."""
    sure, unsure = [], []
    bar = gmin * (1 + PRUNE_RELTOL_LOGLIK)
    for c in range(len(okp)):
        if c == k or not okp[c]:
            continue
        prev = [e for e in range(c) if okp[e]]
        imp_sure = any(lo[e] > ghi for e in prev)
        imp_may = any(hi[e] > glo for e in prev)
        eq_may = max(lo[c], glo) <= min(hi[c], ghi)
        kill_may = lo[c] < ghi or (
            eq_may and not imp_sure
            and loss[c] > bar * (1 - tol) - LOSS_ABS)
        keep_may = hi[c] > glo or (
            eq_may and (imp_may or loss[c] <= bar * (1 + tol) + LOSS_ABS))
        if kill_may and keep_may:
            unsure.append(c)
        elif kill_may:
            sure.append(c)
    return sure, unsure


def _kill_gap(c, lo, hi, loss, glo, gmin):
    """How far a candidate that the step surely kills lies from surviving:
    OOB counts below the best, or 1,000 times the relative excess of its
    loss over the pruning bar."""
    if hi[c] < glo:
        return float(glo - hi[c])
    bar = gmin * (1 + PRUNE_RELTOL_LOGLIK)
    return min(FLIP, 1000 * (loss[c] - bar) / max(bar, LOSS_FLOOR))


def search_gap(d: Data, seed, cid, mtry, order, max_steps, kept=None,
               ties=1e-3, tol=1e-3, cap=32, log=None):
    """The greedy search of classifier `cid` replayed along the program's
    path (its SNP columns `order`): at every step the reference redraws
    the step's candidates with threefry from the pool the path leaves,
    scores them in float64 on the program's list so far (grown as
    `_Prefixes` grows it), and holds what the program did, taking a
    candidate (the next SNP of `order` is among them) or none, to the
    search's rules (`_add_gap`, `_stay_gap`), then follows it. A sample's
    two best calls within `ties` of each other count either way, so each
    OOB count is a range; where that leaves a kill unsure, both pools are
    followed (up to `cap` paths; a SNP that may be in the pool is decided
    when a draw reaches it). A SNP the program takes later stayed in its
    pool: a step that surely kills it counts how far it lay from surviving
    (`_kill_gap`) and keeps it, and a path on which a step takes no
    candidate while one of them is such a SNP ends there. A path that ends
    so, or runs out of draws, before the program's last SNP reads NOT_DRAWN
    if every step on it was certain; once a step on it was not (a gap, an
    unsure kill, an OOB count that near ties leave open), the float32
    program may have drawn from another pool since, and the path's gap so
    far is its reading. Returns the least over the paths of the
    largest gap of a step: 0 where the program did what the search does,
    NOT_DRAWN where it took a SNP that no draw offered. ``log``, a list,
    gets each step's readings."""
    N, P = d.geno.shape
    dev = d.geno.device
    B = torch.from_numpy(bootstrap(seed, cid, N)).to(dev)
    pre = _Prefixes(d, B, order, kept)
    key = threefry.prng_key(seed * 7919 + cid, dev)[None]
    scored = {}
    # path: (pool, maybe, j, glo, ghi, gmin, gap, done, unsure, lost)
    paths = [(frozenset(range(P)), frozenset(), 0, 0, 0, 1e30, 0.0, False,
              False, False)]
    for _ in range(max_steps):
        if all(p[7] for p in paths):
            break
        keys = threefry.split(key)
        key, k1 = keys[:, 0], keys[:, 1]
        bits32 = (threefry.random_bits(k1, P)[0] >> 9).cpu().numpy()
        rank = np.argsort(-bits32, kind="stable")
        nxt = []
        for path in paths:
            pool, maybe, j, glo, ghi, gmin, gap, done, unsure, _ = path
            if done:
                nxt.append(path)
                continue
            for cand, inp, pool, maybe in _draws(rank, pool, maybe, mtry):
                if not any(inp):
                    nxt.append((pool, maybe, j, glo, ghi, gmin, gap, True,
                                unsure, unsure and j < len(order)))
                    continue
                ck = (j, tuple(cand))
                if ck not in scored:
                    bits, freq, allele = pre.at(j)
                    poly, _, lo, hi, loss = _score_ties(
                        d, B, bits, freq, allele, cand, order[:j], ties)
                    scored[ck] = (poly, lo, hi, loss)
                poly, lo, hi, loss = scored[ck]
                okp = [a and b for a, b in zip(poly, inp)]
                open_ = any(o and a != b for o, a, b in zip(okp, lo, hi))
                want = order[j] if j < len(order) else None
                if want in cand and inp[cand.index(want)]:
                    k = cand.index(want)
                    g = _add_gap(k, okp, lo, hi, loss, glo, gmin)
                    if g >= NOT_DRAWN and unsure:
                        # the program drew from another pool before here
                        nxt.append((pool, maybe, j, glo, ghi, gmin, gap, True,
                                    unsure, True))
                        continue
                    sure, maybe_k = _kills(k, okp, lo, hi, loss, glo, ghi,
                                           gmin, tol)
                    later = set(order[j + 1:])
                    for c in sure:
                        if cand[c] in later:
                            g = max(g, _kill_gap(c, lo, hi, loss, glo, gmin))
                    gone = {cand[c] for c in sure} - later | {want}
                    moved = {cand[c] for c in maybe_k} - later
                    pool2 = pool - gone - moved
                    maybe2 = maybe | moved
                    glo2 = max(glo, lo[k]) if hi[k] >= glo else glo
                    ghi2 = max(hi[k], glo) if hi[k] >= glo else ghi
                    state = (pool2, maybe2, j + 1, glo2, ghi2, loss[k])
                    open_ = open_ or bool(maybe_k)
                else:
                    g = _stay_gap(okp, lo, hi, loss, glo, ghi, gmin)
                    drawn = {c for c, i in zip(cand, inp) if i}
                    pool2 = pool - drawn
                    state = (pool2, maybe, j, glo, ghi, gmin)
                    if drawn & set(order[j:]):
                        # the program drew from another pool here
                        g = 0.0 if unsure else NOT_DRAWN
                        nxt.append(state + (max(gap, g), True, unsure,
                                            unsure))
                        continue
                if log is not None:
                    log.append((j, cand, okp, lo, hi, loss, glo, ghi, gmin,
                                want in cand, g))
                unsure2 = unsure or open_ or g > 0
                fin = (not state[0] and not state[1]) or \
                    state[2] >= MAXNUM_SNP or g >= NOT_DRAWN
                lost = fin and unsure2 and state[2] < len(order) \
                    and g < NOT_DRAWN
                nxt.append(state + (max(gap, g), fin, unsure2, lost))
        live = [p for p in nxt if p[6] < NOT_DRAWN and not p[9]]
        nxt = live or sorted(nxt, key=lambda p: p[6])[:1]
        best = {}
        for p in nxt:
            sig = p[:5] + (round(p[5], 6),) + p[7:]
            if sig not in best or p[6] < best[sig][6]:
                best[sig] = p
        paths = sorted(best.values(), key=lambda p: p[6])[:cap]
    return min(g if j >= len(order) or unsure else max(g, NOT_DRAWN)
               for _, _, j, _, _, _, g, _, unsure, _ in paths)


def _score_ties(d, B, bits, freq, allele, cand, cols, ties):
    """(polymorphic, acc, least acc, most acc, loss) of candidates `cand`
    on the list (bits, freq, allele) over the SNP columns `cols`, in
    float64, as Python lists; the OOB count's range over the calls near
    ties allow (`evaluate`)."""
    N = d.geno.shape[0]
    rare = max(FRACTION_HAPLO / (2.0 * N), MIN_RARE_FREQ)
    geno_sel = _columns(d, cols)
    g_cand = d.geno[:, list(cand)].T
    poly, afreq = candidates_ok(g_cand, B)
    tri = match(bits, allele, geno_sel, d.a1, d.a2)
    fA, fB = em(freq, tri, B, g_cand, afreq, float(N), torch.float64)
    fA, fB = erase_rare(fA, fB, rare)
    acc, loss, lo_hi = evaluate(bits, allele, fA, fB, g_cand, geno_sel, d,
                                B, B == 0, torch.float64, ties=ties)
    return (poly.tolist(), acc.tolist(), lo_hi[0].tolist(),
            lo_hi[1].tolist(), loss.tolist())


def oob_counts(d: Data, B, order, bits, freq, allele, ties=1e-4):
    """(least, most) OOB accuracy count of a classifier given whole (its
    haplotypes bits [H, s] over the SNP columns `order`, freq [H], allele
    [H]) over the calls near ties allow (`evaluate`)."""
    geno_sel = d.geno[:, list(order)]
    f = freq.to(torch.float64)[None]
    missing = torch.full((1, d.geno.shape[0]), 3, dtype=d.geno.dtype,
                         device=d.geno.device)
    _, _, lo_hi = evaluate(bits, allele, f, torch.zeros_like(f), missing,
                           geno_sel, d, B, B == 0, torch.float64, ties=ties)
    return int(lo_hi[0, 0]), int(lo_hi[1, 0])


def train_one(d: Data, seed, cid, mtry, dtype, max_steps=192):
    """One classifier trained by the whole greedy search in `dtype` (the
    control). Returns (snp columns in order, bits, freq, allele, OOB count,
    bootstrap)."""
    N, P = d.geno.shape
    dev = d.geno.device
    B = torch.from_numpy(bootstrap(seed, cid, N)).to(dev)
    bits, freq, allele = init_list(d, B, dtype)
    key = threefry.prng_key(seed * 7919 + cid, dev)[None]
    pool = torch.ones(P, dtype=torch.bool, device=dev)
    order, gmax, gmin = [], 0, 1e30
    for _ in range(max_steps):
        keys = threefry.split(key)
        key, k1 = keys[:, 0], keys[:, 1]
        cand = threefry.draw_top_k(k1, pool[None], mtry)[0]
        in_pool = pool[cand]
        acc, loss, ok = _score(d, B, bits, freq, allele, cand, dtype,
                               ns=order if order else None)
        ok = ok & in_pool
        wi, max_acc, min_loss, kill = decide(ok, acc, loss.double(), gmax,
                                             gmin)
        sign = max_acc > gmax or (
            wi >= 0 and STOP_RELTOL_LOGLIK_ADDSNP <= min_loss
            < gmin * (1 - STOP_RELTOL_LOGLIK_ADDSNP))
        if sign:
            col = int(cand[wi])
            geno_sel = d.geno[:, order] if order else d.geno[:, :0]
            g_new = d.geno[:, col][None]
            _, afreq = candidates_ok(g_new, B)
            tri = match(bits, allele, geno_sel, d.a1, d.a2)
            fA, fB = em(freq, tri, B, g_new, afreq, float(N), dtype)
            fA, fB = erase_rare(fA, fB, max(FRACTION_HAPLO / (2.0 * N),
                                            MIN_RARE_FREQ))
            bits, freq, allele = grow(bits, freq, allele, fA[0], fB[0])
            order.append(col)
            gmax, gmin = max_acc, min_loss
            picked = torch.zeros_like(kill)
            picked[wi] = True
            pool[cand[kill | picked]] = False
        else:
            pool[cand[in_pool]] = False
        if not bool(pool.any()) or len(order) >= MAXNUM_SNP:
            break
    return order, bits, freq, allele, gmax, B
