"""Fused classifier growth: the whole greedy SNP selection of K classifiers
as batched device work (counterpart of hibag_tpu/models/train_fused.py).

One growth step, for every classifier at once (hibag_tpu's vmapped
``step_one``, with the K axis written out): candidate draw → EM for every
candidate (`em_all_candidates`) → `erase_rare` → candidate evaluation →
`_decide` → the doubling/sort update of the haplotype list. The host loops
over steps and stops when every classifier is done.

As in hibag_tpu's fused mode, the candidates are drawn with JAX's threefry
PRNG (utils/threefry.py replicates it bitwise), the haplotype list is kept
in fixed slots ordered by descending frequency, and the decision logic is
CVariableSelection::Search (src/LibHLA.cpp:1981-2122). With the same seed,
the port and hibag_tpu's ``engine="jnp"`` draw the same candidates; their
trajectories differ only where float32 sums in another order fall on the
other side of an exact tie (docs/DEVIATIONS.md #3, #11).

Engines (`resolve_engine`): ``"cuda"`` runs the EM step and the evaluation
through the CUDA kernels of ops/train_step.py; ``"torch"`` through their
plain versions. Within one engine the trajectory is deterministic.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from ..constants import (FRACTION_HAPLO, GENO_MISSING, MAXNUM_SNP,
                         MIN_RARE_FREQ, PRUNE_RELTOL_LOGLIK,
                         STOP_RELTOL_LOGLIK_ADDSNP)
from ..utils import threefry, trace
from .em import (F32_RELTOL, em_all_candidates, erase_rare,
                 evaluate_candidates)

#: on_overflow="retry"/"freeze" grow the slot capacity up to this ceiling
RETRY_MAX_HCAP = 4096


@dataclass
class GrowState:
    """The growth state of K classifiers, on one device. `_step` updates
    ``geno_sel`` and ``snp_order`` in place (hibag_tpu donates the state to
    its device loop instead) and replaces the other fields."""

    bits: torch.Tensor       # [K, Hc, L] float32 {0,1}
    freq: torch.Tensor       # [K, Hc] float32, 0 = empty slot
    allele: torch.Tensor     # [K, Hc] int32
    geno_sel: torch.Tensor   # [K, N, L] int8, codes of the accepted SNPs
    n_snp: torch.Tensor      # [K] int64
    snp_order: torch.Tensor  # [K, L] int64, accepted SNPs in order, -1 pad
    pool: torch.Tensor       # [K, P] bool, SNPs still drawable
    gmax_acc: torch.Tensor   # [K] int32
    gmin_loss: torch.Tensor  # [K] float32
    done: torch.Tensor       # [K] bool
    key: torch.Tensor        # [K, 2] int64, threefry keys (32-bit words)
    overflow: torch.Tensor   # [K] int32, accepted steps that dropped haplotypes
    n_step: torch.Tensor     # [K] int32, live growth steps taken
    steps: int = 0           # loop iterations of this batch

    def take(self, idx: torch.Tensor) -> "GrowState":
        """The classifiers `idx`, as a new state (copies)."""
        return GrowState(**{f.name: getattr(self, f.name)[idx]
                            for f in fields(self) if f.name != "steps"},
                         steps=self.steps)


def _decide(cand_ok, acc_c, loss_c, gmax_acc, gmin_loss, prune: bool):
    """The reference's running-max candidate scan (src/LibHLA.cpp:2018-2069)
    in closed form, for K classifiers (hibag_tpu train_fused.py:59-104):
    cand_ok/acc_c/loss_c [K, Cm], gmax_acc/gmin_loss [K] ->
    (min_i [K] (-1 for none), max_acc [K], min_loss [K], kills [K, Cm]).

    The final max_acc is the max over the running max and the ok candidates;
    the winner is the earliest least loss among the candidates at max_acc,
    gated on beating gmin_loss when acc did not improve; a candidate at
    gmax_acc is killed only if no earlier ok candidate exceeded gmax_acc.
    """
    neg = torch.iinfo(torch.int32).min + 1
    okacc = torch.where(cand_ok, acc_c, neg)
    max_acc = torch.maximum(gmax_acc, okacc.max(dim=1).values)
    is_best = cand_ok & (acc_c == max_acc[:, None])
    loss_best = torch.where(is_best, loss_c, torch.inf)
    wi = loss_best.argmin(dim=1)                  # the first of equal minima
    wloss = loss_best.gather(1, wi[:, None])[:, 0]
    win = is_best.any(dim=1) & ((max_acc > gmax_acc) | (wloss < gmin_loss))
    min_i = torch.where(win, wi, -1)
    min_loss = torch.where(win, wloss, gmin_loss)

    improver = (cand_ok & (acc_c > gmax_acc[:, None])).to(torch.int32)
    earlier_improver = (improver.cumsum(dim=1) - improver) > 0
    kill = cand_ok & ((acc_c < gmax_acc[:, None])
                      | ((acc_c == gmax_acc[:, None]) & ~earlier_improver
                         & (loss_c > gmin_loss[:, None]
                            * (1 + PRUNE_RELTOL_LOGLIK))))
    return min_i, max_acc, min_loss, kill if prune else torch.zeros_like(kill)


def resolve_engine(engine, device) -> str:
    """The step engine: ``"cuda"`` (the CUDA kernels) for a CUDA device,
    ``"torch"`` (their plain versions) for the CPU or when asked for, as
    hibag_tpu's ``engine="jnp"``. None and "auto" choose by device."""
    device = torch.device(device)
    if engine in (None, "auto"):
        return "cuda" if device.type == "cuda" else "torch"
    if engine == "cuda" and device.type != "cuda":
        raise ValueError("engine='cuda' needs a CUDA device")
    if engine not in ("cuda", "torch"):
        raise ValueError(f"unknown engine {engine!r}: use 'cuda' or 'torch'")
    return engine


def grow_step(bits, freq, allele, geno_sel, B, is_oob, g_cand, afreq, a1, a2,
              n_alleles, rare_prob, total_n, mask_budget, engine, skip=None,
              reltol=F32_RELTOL):
    """The device work of one greedy step for K classifiers, without the
    decisions (hibag_tpu parallel/mesh.py::_grow_step_single, vmapped by
    batched_grow_step): EM for every candidate, `erase_rare`, then the
    candidate evaluation. Shared by the fused `_step` and the host trainer
    (models/train.py). bits [K, H, L]; freq [K, H] (0 = empty slot);
    allele [K, H]; geno_sel [K, N, L]; B and is_oob [K, N]; g_cand
    [K, C, N]; afreq [K, C]; a1/a2 [N]. ``engine`` "cuda" runs the CUDA
    kernels, "torch" their plain versions; ``skip`` [K] marks classifiers
    whose results the caller discards. Returns (fA, fB [K, C, H] erased,
    acc [K, C], loss [K, C])."""
    fA, fB, _, _ = em_all_candidates(
        freq, freq > 0, bits, allele, geno_sel, a1, a2, B, g_cand, afreq,
        total_n, reltol=reltol, mask_budget=mask_budget, engine=engine,
        skip=skip)
    with trace.span("train.erase", fA):
        fA, fB = erase_rare(fA, fB, rare_prob)
    if engine == "cuda":
        from ..ops.train_step import evaluate_candidates_kernel as evaluate
    else:
        evaluate = evaluate_candidates
    with trace.span("train.eval", fA):
        acc, loss = evaluate(bits, allele, fA, fB, g_cand, geno_sel, a1, a2,
                             is_oob, B, n_alleles)
    return fA, fB, acc, loss


def _step(st: GrowState, B, is_oob, geno_T, a1, a2, rare_prob, total_n,
          n_alleles, mtry, prune, freeze, budget, mask_budget, engine):
    """One growth step of every classifier (hibag_tpu's step_one, vmapped).
    A done classifier takes the step as a no-op; outside freeze mode its
    key still advances, in freeze mode a frozen or done one keeps it.
    Traced as the spans ``train.draw``, ``train.em`` (with ``train.match``),
    ``train.erase``, ``train.eval`` and ``train.update``."""
    dev = st.bits.device
    with trace.span("train.draw", dev):
        keys = threefry.split(st.key)                   # [K, 2, 2]
        key, k1 = keys[:, 0], keys[:, 1]
        cand_idx = threefry.draw_top_k(k1, st.pool, mtry)   # [K, Cm]
        cand_in_pool = st.pool.gather(1, cand_idx)

        g_cand = geno_T[cand_idx]                       # [K, Cm, N] int8
        okg = g_cand <= 2
        allele_cnt = torch.einsum(
            "kcn,kn->kc", torch.where(okg, g_cand.to(torch.float32), 0.0), B)
        valid_cnt = 2.0 * torch.einsum("kcn,kn->kc", okg.to(torch.float32),
                                       B)
        cand_ok = cand_in_pool & (allele_cnt > 0) & (allele_cnt < valid_cnt)
        afreq = torch.where(cand_ok, allele_cnt / valid_cnt.clamp_min(1.0),
                            0.5)

    fA, fB, acc_c, loss_c = grow_step(
        st.bits, st.freq, st.allele, st.geno_sel, B, is_oob, g_cand, afreq,
        a1, a2, n_alleles, rare_prob, total_n, mask_budget, engine,
        skip=st.done)
    with trace.span("train.update", dev):
        return _update(st, geno_T, fA, fB, acc_c, loss_c, cand_idx,
                       cand_in_pool, cand_ok, key, mtry, prune, freeze,
                       budget)


def _update(st, geno_T, fA, fB, acc_c, loss_c, cand_idx, cand_in_pool,
            cand_ok, key, mtry, prune, freeze, budget):
    """The rest of `_step` after the device work: `_decide`, the accepted
    candidate's doubled list, sort and the pool update."""
    K, Hc, L = st.bits.shape
    P = geno_T.shape[0]
    dev = st.bits.device
    ar = torch.arange(K, device=dev)
    was_done = st.done
    min_i, max_acc, min_loss, kills = _decide(
        cand_ok, acc_c, loss_c, st.gmax_acc, st.gmin_loss, prune)

    gmax, gmin = st.gmax_acc, st.gmin_loss
    sign = torch.where(
        max_acc > gmax, True,
        torch.where((max_acc == gmax) & (min_i >= 0),
                    (min_loss >= STOP_RELTOL_LOGLIK_ADDSNP)
                    & (min_loss < gmin * (1 - STOP_RELTOL_LOGLIK_ADDSNP)),
                    False))
    sign = sign & ~st.done
    mi = min_i.clamp_min(0)
    chosen = cand_idx.gather(1, mi[:, None])[:, 0]      # [K]

    # the accepted candidate's doubled list, sorted by descending frequency
    col = st.n_snp.clamp_max(L - 1)                     # n_snp = L: done
    cmask = (torch.arange(L, device=dev)[None, :] == col[:, None])[:, None]
    bits2 = torch.cat([torch.where(cmask, 0.0, st.bits),
                       torch.where(cmask, 1.0, st.bits)], dim=1)
    freq2 = torch.cat([fA[ar, mi], fB[ar, mi]], dim=1)  # [K, 2Hc]
    allele2 = torch.cat([st.allele, st.allele], dim=1)
    order = torch.argsort(torch.where(freq2 > 0, -freq2, torch.inf), dim=1,
                          stable=True)[:, :Hc]
    new_bits = bits2.gather(1, order[..., None].expand(-1, -1, L))
    new_freq = freq2.gather(1, order)
    new_allele = allele2.gather(1, order)
    dropped = (freq2 > 0).sum(dim=1) > Hc
    if freeze:
        # freeze at the first drop: no update at all, key included, so the
        # re-seated state replays this step at a larger capacity
        frozen = sign & dropped
        sign = sign & ~frozen
        key = torch.where((frozen | was_done)[:, None], st.key, key)
        overflow = st.overflow + frozen.to(torch.int32)
    else:
        frozen = torch.zeros_like(sign)
        overflow = st.overflow + (sign & dropped).to(torch.int32)

    # in place: the chosen SNP's codes into column n_snp of geno_sel
    arN = torch.arange(st.geno_sel.shape[1], device=dev)
    old_col = st.geno_sel[ar[:, None], arN[None, :], col[:, None]]
    st.geno_sel[ar[:, None], arN[None, :], col[:, None]] = torch.where(
        sign[:, None], geno_T[chosen], old_col)
    st.snp_order[ar, col] = torch.where(sign, chosen, st.snp_order[ar, col])

    s1 = sign[:, None]
    bits = torch.where(s1[..., None], new_bits, st.bits)
    freq = torch.where(s1, new_freq, st.freq)
    allele = torch.where(s1, new_allele, st.allele)
    n_snp = st.n_snp + sign.to(st.n_snp.dtype)
    gmax_acc = torch.where(sign, max_acc, gmax)
    gmin_loss = torch.where(sign, min_loss, gmin)

    # accepted: the chosen SNP and the killed leave the pool; rejected: the
    # whole draw leaves it; frozen: the pool stays, for the replay
    picked = torch.arange(mtry, device=dev)[None, :] == mi[:, None]
    kill_scatter = torch.zeros((K, P), dtype=torch.bool, device=dev).scatter(
        1, cand_idx, torch.where(s1, kills | picked, cand_in_pool))
    pool = torch.where((was_done | frozen)[:, None], st.pool,
                       st.pool & ~kill_scatter)
    n_step = st.n_step + (~(was_done | frozen)).to(torch.int32)
    done = (was_done | frozen | ~pool.any(dim=1) | (n_snp >= MAXNUM_SNP)
            | (n_step >= budget))
    return GrowState(bits=bits, freq=freq, allele=allele,
                     geno_sel=st.geno_sel, n_snp=n_snp,
                     snp_order=st.snp_order, pool=pool, gmax_acc=gmax_acc,
                     gmin_loss=gmin_loss, done=done, key=key,
                     overflow=overflow, n_step=n_step, steps=st.steps + 1)


def init_state(bits0, freq0, allele0, key0, n_samples, real_snp) -> GrowState:
    """A fresh GrowState from the initial haplotypes bits0/freq0/allele0
    [K, Hc, L]/[K, Hc]/[K, Hc] and keys key0 [K, 2] (tensors on one device);
    real_snp [P] bool marks the SNP columns that may be drawn."""
    K = bits0.shape[0]
    dev = bits0.device
    return GrowState(
        bits=bits0.clone(), freq=freq0.clone(), allele=allele0.clone(),
        geno_sel=torch.full((K, n_samples, MAXNUM_SNP), GENO_MISSING,
                            dtype=torch.int8, device=dev),
        n_snp=torch.zeros(K, dtype=torch.int64, device=dev),
        snp_order=torch.full((K, MAXNUM_SNP), -1, dtype=torch.int64,
                             device=dev),
        pool=real_snp[None, :].expand(K, -1).clone(),
        gmax_acc=torch.zeros(K, dtype=torch.int32, device=dev),
        gmin_loss=torch.full((K,), 1e30, dtype=torch.float32, device=dev),
        done=torch.zeros(K, dtype=torch.bool, device=dev),
        key=key0.clone(),
        overflow=torch.zeros(K, dtype=torch.int32, device=dev),
        n_step=torch.zeros(K, dtype=torch.int32, device=dev))


def fused_grow_batch(state: GrowState, B, real, geno, a1, a2, rare_prob,
                     total_n, n_alleles, mtry, prune=True, max_steps=256,
                     seg_steps=None, progress=None, freeze=False,
                     mask_budget=None, engine="torch") -> GrowState:
    """Grow the K classifiers of `state` until every one is done or the
    batch has run `max_steps` steps; each classifier takes at most
    `max_steps` live steps (``n_step``), so a resumed one keeps exactly its
    remaining allowance. Returns the final state (the given one is consumed:
    its ``geno_sel`` and ``snp_order`` are updated in place).

    B [K, N] float32 bootstrap counts (0 in padded rows); real [N] bool;
    geno [N, P] int8; a1/a2 [N] int32. ``progress(steps, n_done, K)`` is
    called every ``seg_steps`` steps (hibag_tpu's dispatch segments: here
    they bound nothing else, as no dispatch ceiling exists). ``freeze``
    stops a classifier at its first slot overflow (see `_step`).
    """
    K = state.done.shape[0]
    if mask_budget is None:
        from .em import MASK_TOTAL_BUDGET_BYTES
        mask_budget = MASK_TOTAL_BUDGET_BYTES // max(K, 1)
    geno_T = geno.T.contiguous()
    is_oob = (B == 0) & real[None, :]
    seg = seg_steps or max_steps
    while state.steps < max_steps:
        trace.count("host_syncs")
        if bool(state.done.all()):
            break
        with trace.span("train.step", state.bits):
            state = _step(state, B, is_oob, geno_T, a1, a2, rare_prob,
                          total_n, n_alleles, mtry, prune, freeze, max_steps,
                          mask_budget, engine)
        if progress is not None and (state.steps % seg == 0
                                     or bool(state.done.all())):
            progress(state.steps, int(state.done.sum()), K)
    return state


def _freeze_reseat(state: GrowState, idx, new_hc: int) -> GrowState:
    """The frozen classifiers `idx` of a finished freeze-mode state,
    re-seated in `new_hc` haplotype slots (zero-padded) and cleared to
    resume. Zero slots are summation identities and the doubling sort keeps
    live haplotypes in the same relative order, so the resumed replay is the
    step the classifier would have taken at `new_hc` from the start."""
    sub = state.take(idx)
    pad = new_hc - sub.bits.shape[1]
    kf = idx.shape[0]
    pad_h = lambda x: torch.nn.functional.pad(
        x, (0, 0, 0, pad) if x.dim() == 3 else (0, pad))
    return replace(sub, bits=pad_h(sub.bits), freq=pad_h(sub.freq),
                   allele=pad_h(sub.allele),
                   done=torch.zeros_like(sub.done),
                   overflow=torch.zeros_like(sub.overflow), steps=0)


def train_fused_batch(ctx, K: int, seed: int, mtry: int, prune: bool = True,
                      hcap: int = 256, first_id: int = 0,
                      max_steps: int = 256, seg_steps=None, progress=None,
                      on_overflow: str = "warn", _ids=None,
                      freeze_max_batch=None, engine=None,
                      mask_budget=None, mesh=None) -> list:
    """Train K classifiers with the fused growth; returns Classifiers.

    ctx: a models.train.TrainingContext (its tensors fix the device).
    Classifier j draws its bootstrap from RRng((seed + 1000003 * id) mod
    (2^31 - 1)) and its candidates from threefry key seed * 7919 + id, as
    in hibag_tpu, with id = first_id + j.

    ``on_overflow``: when a classifier's doubled list exceeds ``hcap`` slots,
    "warn" keeps it truncated (lowest frequencies dropped) and warns;
    "retry" retrains the overflowed classifiers from scratch at 2 x hcap;
    "freeze" stops them at their first drop with the key not advanced,
    re-seats them at a larger capacity and resumes (`_train_freeze`); both
    exact modes go up to RETRY_MAX_HCAP. ``seg_steps`` and ``progress`` as
    in `fused_grow_batch`; ``freeze_max_batch`` caps the classifiers of one
    resume batch. ``engine``: see `resolve_engine`. ``mask_budget``: bytes
    of EM pair mask per classifier (models.em tiers); None gives each
    MASK_TOTAL_BUDGET_BYTES // rows of each pass (a freeze resume or retry
    of few classifiers keeps a larger mask resident, as in hibag_tpu).
    ``mesh`` (an EnsembleMesh or a list of devices) splits the K
    classifiers into shards (parallel/mesh.py::shard_bounds), each grown by
    this function on its device with its own GrowState, freeze re-seats and
    retries, the training data replicated (TrainingContext.on); K need not
    be a multiple of the mesh size. A classifier's bootstrap and draws come
    from its id, so placement does not change them. With a mesh, None gives
    every pass of every shard MASK_TOTAL_BUDGET_BYTES // K of the whole
    batch, so a shard's first pass takes the unsharded batch's mask tiers;
    its resumes and retries may take a smaller tier than the unsharded
    ones (whose budget is divided by their own rows) only where a packed
    mask passes that budget. The shards' host loops take turns on the
    interpreter lock (parallel/mesh.py), so a mesh is no faster than one
    device; to train on several cards, run one process per card
    (`train_distributed`, `train_dynamic`). Traced as the root span
    ``train.batch`` (utils/trace.py), a retry's or a shard's batch inside
    it.
    """
    with trace.span("train.batch", ctx.device):
        return _train_fused_batch(ctx, K, seed, mtry, prune, hcap, first_id,
                                  max_steps, seg_steps, progress,
                                  on_overflow, _ids, freeze_max_batch,
                                  engine, mask_budget, mesh)


def _train_fused_batch(ctx, K, seed, mtry, prune, hcap, first_id, max_steps,
                       seg_steps, progress, on_overflow, _ids,
                       freeze_max_batch, engine, mask_budget, mesh):
    from ..parallel.mesh import as_mesh, run_shards, shard_bounds
    from ..utils.rng import RRng
    from .em import MASK_TOTAL_BUDGET_BYTES
    from .model import Classifier
    from .train import _init_haplotype

    ids = (list(range(first_id, first_id + K)) if _ids is None
           else list(_ids))
    mesh = as_mesh(mesh)
    if mesh is not None:
        if mask_budget is None:
            mask_budget = MASK_TOTAL_BUDGET_BYTES // max(K, 1)
        shards = shard_bounds(mesh, K)
        parts = run_shards([d for d, _, _ in shards], [
            (lambda d=d, lo=lo, hi=hi: train_fused_batch(
                ctx.on(d), hi - lo, seed, mtry, prune, hcap,
                max_steps=max_steps, seg_steps=seg_steps, progress=progress,
                on_overflow=on_overflow, _ids=ids[lo:hi],
                freeze_max_batch=freeze_max_batch, engine=engine,
                mask_budget=mask_budget))
            for d, lo, hi in shards])
        return [c for part in parts for c in part]

    dev = ctx.device
    engine = resolve_engine(engine, dev)
    N, P = ctx.n_samp, ctx.n_snp
    L = MAXNUM_SNP
    rare_prob = max(FRACTION_HAPLO / (2.0 * N), MIN_RARE_FREQ)

    Bs_real = np.stack([RRng((seed + 1000003 * ids[j]) % (2**31 - 1))
                        .bootstrap_counts(N) for j in range(K)])
    Bs = np.stack([ctx.pad_B(b) for b in Bs_real]).astype(np.float32)
    bits0 = np.zeros((K, hcap, L), np.float32)
    freq0 = np.zeros((K, hcap), np.float32)
    allele0 = np.zeros((K, hcap), np.int32)
    for k in range(K):
        st = _init_haplotype(ctx, Bs_real[k])
        h = len(st.freq)
        if h > hcap:
            raise ValueError(f"hcap {hcap} < initial haplotypes {h}")
        freq0[k, :h] = st.freq
        allele0[k, :h] = st.allele
    keys = torch.stack([threefry.prng_key(seed * 7919 + i, dev) for i in ids])
    real = torch.arange(ctx.n_samp_pad, device=dev) < N
    real_snp = torch.arange(ctx.n_snp_pad, device=dev) < P

    def t(x):
        if dev.type != "cpu":
            trace.count("h2d_bytes", x.nbytes)
        return torch.from_numpy(x).to(dev)
    B_t = t(Bs)

    def mk(k, bits_k, freq_k, allele_k, ns, snp_order_k, acc_k):
        freq_k = np.asarray(freq_k, dtype=np.float64)
        sel = freq_k > 0
        order = np.argsort(allele_k[sel], kind="stable")
        n_oob = int((Bs_real[k] == 0).sum())
        return Classifier(
            snp_index=snp_order_k[:ns].astype(np.int32),
            hap_bits=bits_k[sel][order][:, :ns].astype(np.uint8),
            hap_freq=freq_k[sel][order],
            hap_allele=allele_k[sel][order].astype(np.int32),
            bootstrap_count=Bs_real[k].astype(np.int32),
            oob_accuracy=float(0.5 * acc_k / max(n_oob, 1)))

    grow = dict(real=real, geno=ctx.geno_t, a1=ctx.a1_t, a2=ctx.a2_t,
                rare_prob=rare_prob, total_n=float(N),
                n_alleles=ctx.n_alleles, mtry=mtry, prune=prune,
                max_steps=max_steps, seg_steps=seg_steps, progress=progress,
                mask_budget=mask_budget, engine=engine)
    state = init_state(t(bits0), t(freq0), t(allele0), keys, ctx.n_samp_pad,
                       real_snp)
    if on_overflow == "freeze":
        return _train_freeze(state, B_t, hcap, freeze_max_batch, mk, grow)
    if on_overflow not in ("warn", "retry"):
        raise ValueError(f"on_overflow={on_overflow!r}: use 'warn', 'retry' "
                         "or 'freeze'")

    state = fused_grow_batch(state, B_t, **grow)
    host = _to_host(state)
    retry_map = {}
    overflow = host["overflow"]
    if overflow.any():
        if on_overflow == "retry" and hcap < RETRY_MAX_HCAP:
            bad = [k for k in range(K) if overflow[k] > 0]
            retrained = train_fused_batch(
                ctx, len(bad), seed, mtry, prune, hcap * 2, 0, max_steps,
                seg_steps=seg_steps, on_overflow=on_overflow,
                _ids=[ids[k] for k in bad], engine=engine,
                mask_budget=mask_budget)
            retry_map = dict(zip(bad, retrained))
        else:
            warnings.warn(
                f"hcap={hcap} overflowed on {int((overflow > 0).sum())}/{K} "
                f"classifiers ({int(overflow.sum())} accepted steps dropped "
                f"low-frequency haplotypes); raise hcap (or pass "
                f"on_overflow='freeze') for exact semantics")
    return [retry_map[k] if k in retry_map else
            mk(k, host["bits"][k], host["freq"][k], host["allele"][k],
               int(host["n_snp"][k]), host["snp_order"][k],
               int(host["gmax_acc"][k])) for k in range(K)]


def _to_host(state: GrowState) -> dict:
    return {f: getattr(state, f).cpu().numpy() for f in
            ("bits", "freq", "allele", "n_snp", "snp_order", "gmax_acc",
             "overflow")}


def _train_freeze(state, B_t, hcap, freeze_max_batch, mk, grow) -> list:
    """on_overflow="freeze": grow with freeze at the first drop, then re-seat
    the frozen classifiers at a larger capacity and resume them, never
    re-running a completed step (hibag_tpu train_fused.py:682-806). The
    capacity doubles below 512, then grows by 128 up to 1024, then by 512;
    at RETRY_MAX_HCAP the last resume may truncate, with a warning. Equal to
    "retry" whenever the step sums do not depend on the capacity."""
    K = state.done.shape[0]
    state = fused_grow_batch(state, B_t, freeze=True, **grow)
    results = {}
    items = [(state, np.arange(K), hcap, True)]
    while items:
        state, cur, hcap_cur, freezing = items.pop()
        host = _to_host(state)
        ov = host["overflow"]
        fin = np.flatnonzero(ov == 0) if freezing else np.arange(len(ov))
        for i in fin:
            results[int(cur[i])] = mk(
                int(cur[i]), host["bits"][i], host["freq"][i],
                host["allele"][i], int(host["n_snp"][i]),
                host["snp_order"][i], int(host["gmax_acc"][i]))
        if not freezing:
            if (ov > 0).any():
                warnings.warn(
                    f"hcap={hcap_cur} overflowed on {int((ov > 0).sum())} "
                    f"classifiers at the RETRY_MAX_HCAP ceiling "
                    f"({int(ov.sum())} accepted steps dropped low-frequency "
                    f"haplotypes)")
            continue
        rows = np.flatnonzero(ov > 0)
        if rows.size == 0:
            continue
        if hcap_cur < RETRY_MAX_HCAP:
            if hcap_cur < 512:
                hcap_cur *= 2
            elif hcap_cur < 1024:
                hcap_cur += 128
            else:
                hcap_cur += 512
            hcap_cur = min(hcap_cur, RETRY_MAX_HCAP)
        else:
            freezing = False
        cap = freeze_max_batch or rows.size
        for lo in range(0, rows.size, cap):
            chunk = rows[lo:lo + cap]
            idx = torch.from_numpy(chunk).to(state.bits.device)
            sub = _freeze_reseat(state, idx, hcap_cur)
            sub = fused_grow_batch(sub, B_t[cur[chunk]], freeze=freezing,
                                   **grow)
            items.append((sub, cur[chunk], hcap_cur, freezing))
    return [results[k] for k in range(K)]
