"""Ensemble training: hibag_tpu/models/train.py in PyTorch (hlaAttrBagging /
hlaParallelAttrBagging, reference R/HIBAG.R:48-451).

`make_training_context` intersects samples, filters SNPs and factorises
alleles. Two trainers grow the classifiers, on one device or with the
batch split over a mesh of devices (parallel/mesh.py):

* the host trainer (`train`, `grow_classifier`, `train_parallel_batch`,
  ``train_parallel(mode="host")``): the reference's greedy loop on the host
  with its R RNG stream, the accept/stop/prune decisions and the haplotype
  list in numpy, and each step's EM, rare-haplotype erase and candidate
  evaluation for all candidates of a batch of classifiers as one call of
  models/train_fused.py::grow_step (the CUDA kernels on the card);
* the fused trainer (``mode="fused"``, models/train_fused.py): the whole
  greedy step on the device, candidates drawn by a threefry replica.

``train_parallel(mode="auto")`` trains fused on a CUDA device and host on
the CPU, as hibag_tpu picks host mode on its CPU backend.
`train_distributed` (a fixed share of the ensemble per process) and
`train_dynamic` (batches claimed through files) train over processes.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..constants import (FRACTION_HAPLO, GENO_MISSING, MAXNUM_SNP,
                         MIN_RARE_FREQ, PRUNE_RELTOL_LOGLIK,
                         STOP_RELTOL_LOGLIK_ADDSNP)
from ..data.allele import unique_alleles
from ..device import resolve_device
from ..utils import trace
from ..utils.rng import RRng
from .em import MASK_TOTAL_BUDGET_BYTES
from .model import AttrBagModel, Classifier
from .train_fused import grow_step, resolve_engine


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _shape_bucket(n: int, lo: int = 64) -> int:
    """Next bucket >= n from {64, 96, 128, 192, 256, 384, ...} (powers of two
    and their 1.5x midpoints; multiples of 8192 above 16,384), as
    hibag_tpu pads: the same padded shapes give the same sums."""
    if n > 16384:
        return _round_up(n, 8192)
    b = lo
    while b < n:
        b = b + b // 2 if (b & (b - 1)) == 0 else (b // 3) * 4
    return b


class SamplingWithoutReplace:
    """Index-pool bookkeeping of CSamplingWithoutReplace
    (src/LibHLA.cpp:930-993), with its RNG consumption order."""

    def __init__(self, m_total: int):
        self.idx = list(range(m_total))
        self.m_try = 0

    def total(self) -> int:
        return len(self.idx)

    def random_select(self, m_try: int, rng: RRng) -> None:
        n = len(self.idx)
        if m_try > n:
            m_try = n
        if m_try < n:
            for i in range(m_try):
                k = rng.random_num(n - i)
                self.idx[k], self.idx[n - i - 1] = self.idx[n - i - 1], self.idx[k]
        self.m_try = m_try

    def selection(self) -> list:
        return self.idx[len(self.idx) - self.m_try:]

    def set_selected(self, i: int, value: int) -> None:
        self.idx[len(self.idx) - self.m_try + i] = value

    def remove(self, i: int) -> None:
        del self.idx[len(self.idx) - self.m_try + i]

    def remove_selection(self) -> None:
        del self.idx[len(self.idx) - self.m_try:]

    def remove_flagged(self) -> None:
        n = len(self.idx)
        for i in range(n - 1, n - self.m_try - 1, -1):
            if self.idx[i] < 0:
                del self.idx[i]


@dataclass
class TrainingContext:
    """One locus's training data, with its padded tensors on `device`.

    Samples and SNPs are padded to shape buckets (as hibag_tpu pads them):
    padded samples are all-missing (code 3) with bootstrap weight 0, and
    padded SNP columns start outside the candidate pool. The host trainer
    pads each step's haplotype list to a multiple of `hap_bucket`. `on`
    gives the same data on another device (a mesh replicates it so).
    """

    geno: np.ndarray          # [N, P] codes {0,1,2,3}
    a1: np.ndarray            # [N] int32 allele index, a1 <= a2
    a2: np.ndarray            # [N]
    n_alleles: int
    snp_id: np.ndarray
    snp_position: np.ndarray
    snp_allele: np.ndarray
    sample_id: np.ndarray
    hap_bucket: int = 32
    device: torch.device = torch.device("cpu")

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.n_samp, self.n_snp = self.geno.shape
        self.n_samp_pad = _shape_bucket(self.n_samp)
        self.n_snp_pad = _shape_bucket(self.n_snp)
        pad = self.n_samp_pad - self.n_samp
        self.geno_pad = np.pad(self.geno,
                               ((0, pad), (0, self.n_snp_pad - self.n_snp)),
                               constant_values=GENO_MISSING)
        def t(x):
            x = np.ascontiguousarray(x)
            if self.device.type != "cpu":
                trace.count("h2d_bytes", x.nbytes)
            return torch.from_numpy(x).to(self.device)
        self.geno_t = t(self.geno_pad.astype(np.int8))
        self.a1_t = t(np.pad(self.a1, (0, pad)).astype(np.int32))
        self.a2_t = t(np.pad(self.a2, (0, pad)).astype(np.int32))
        self._copies = {self.device: self}

    def on(self, device) -> "TrainingContext":
        """This context with its tensors on `device`, made once per
        device."""
        device = torch.device(device)
        if device not in self._copies:
            self._copies[device] = replace(self, device=device)
        return self._copies[device]

    def pad_B(self, B: np.ndarray) -> np.ndarray:
        return np.pad(B, (0, self.n_samp_pad - self.n_samp))


@dataclass
class _HaploState:
    """A compact haplotype list (allele-grouped)."""

    bits: np.ndarray     # [H, n_snp] uint8
    freq: np.ndarray     # [H] float64
    allele: np.ndarray   # [H] int32


def _init_haplotype(ctx: TrainingContext, B: np.ndarray) -> _HaploState:
    """One frequency-weighted haplotype per observed allele
    (_InitHaplotype, src/LibHLA.cpp:1880-1914)."""
    counts = np.zeros(ctx.n_alleles, dtype=np.int64)
    np.add.at(counts, ctx.a1, B)
    np.add.at(counts, ctx.a2, B)
    total = counts.sum()
    sel = np.nonzero(counts > 0)[0]
    return _HaploState(bits=np.zeros((len(sel), 0), dtype=np.uint8),
                       freq=counts[sel] * (1.0 / total),
                       allele=sel.astype(np.int32))


def make_training_context(hla_table, geno_data, na_rm: bool = True,
                          mono_rm: bool = True, maf: float = float("nan"),
                          hap_bucket: int = 32, device="cuda") -> tuple:
    """Sample intersection, SNP filtering and allele factorisation
    (hlaAttrBagging preamble, R/HIBAG.R:77-174).

    Returns (TrainingContext, allele list, kept-SNP mask)."""
    geno_pos = {s: i for i, s in enumerate(geno_data.sample_id)}
    keep = [i for i, s in enumerate(hla_table.sample_id) if s in geno_pos]
    if na_rm:
        keep = [i for i in keep if hla_table.allele1[i] is not None
                and hla_table.allele2[i] is not None]
    if not keep:
        raise ValueError("no common samples between HLA table and genotypes")
    samp_ids = hla_table.sample_id[keep]
    h1 = hla_table.allele1[keep]
    h2 = hla_table.allele2[keep]
    gcols = np.array([geno_pos[s] for s in samp_ids])
    geno = geno_data.genotype[:, gcols].T.copy()   # [N, P]

    g = geno.astype(np.float64)
    miss = g >= GENO_MISSING
    with np.errstate(invalid="ignore"):
        f = np.where(miss, 0, g).sum(0) / np.maximum(2.0 * (~miss).sum(0), 1)
    mf = np.minimum(f, 1 - f)
    mf[~np.isfinite(mf)] = 0
    snp_keep = np.ones(geno.shape[1], dtype=bool)
    if mono_rm:
        snp_keep &= mf > 0
    if np.isfinite(maf):
        snp_keep &= mf >= maf
    geno = geno[:, snp_keep]

    alleles = unique_alleles(np.concatenate([h1, h2]))
    aidx = {a: i for i, a in enumerate(alleles)}
    a1 = np.array([aidx[a] for a in h1], dtype=np.int32)
    a2 = np.array([aidx[a] for a in h2], dtype=np.int32)
    a1, a2 = np.minimum(a1, a2), np.maximum(a1, a2)
    ctx = TrainingContext(
        geno=geno.astype(np.int8), a1=a1, a2=a2, n_alleles=len(alleles),
        snp_id=geno_data.snp_id[snp_keep],
        snp_position=geno_data.snp_position[snp_keep],
        snp_allele=geno_data.snp_allele[snp_keep],
        sample_id=samp_ids, hap_bucket=hap_bucket,
        device=resolve_device(device))
    return ctx, alleles, snp_keep


def _resolve_mtry(mtry, n_snp: int) -> int:
    """mtry resolution (R/HIBAG.R:180-208)."""
    if isinstance(mtry, str):
        if mtry == "sqrt":
            m = int(np.ceil(np.sqrt(n_snp)))
        elif mtry == "all":
            m = n_snp
        elif mtry == "one":
            m = 1
        else:
            raise ValueError(f"invalid mtry {mtry!r}")
    else:
        m = float(mtry)
        if not np.isfinite(m):
            m = int(np.ceil(np.sqrt(n_snp)))
        else:
            if 0 < m < 1:
                m = n_snp * m
            m = min(int(np.ceil(m)), n_snp)
    return max(int(m), 1)


def _partial_model(ctx, alleles, hla_table, geno_data, classifiers):
    g = ctx.geno.astype(np.float64)
    miss = g >= GENO_MISSING
    with np.errstate(invalid="ignore"):
        afreq = (np.where(miss, 0, g).sum(0)
                 / np.maximum(2.0 * (~miss).sum(0), 1))
    hla_freq = np.zeros(len(alleles))
    for a in (ctx.a1, ctx.a2):
        np.add.at(hla_freq, a, 1)
    hla_freq /= max(hla_freq.sum(), 1)
    return AttrBagModel(
        locus=hla_table.locus,
        snp_id=ctx.snp_id, snp_position=ctx.snp_position,
        snp_allele=ctx.snp_allele, snp_allele_freq=afreq,
        hla_alleles=list(alleles), hla_freq=hla_freq,
        assembly=geno_data.assembly, sample_id=ctx.sample_id,
        classifiers=list(classifiers))


def _decide_host(cand_ok, acc_c, loss_c, n_cands, gmax_acc, gmin_loss,
                 sampling, prune):
    """The reference's running-max candidate scan (src/LibHLA.cpp:2018-2069)
    for one classifier, in float64 from the float32 loss, as hibag_tpu's
    host loop runs it (train.py:283-309). Flags the pruned candidates in
    `sampling`; returns (accept, min_i, max_acc, min_loss)."""
    max_acc = gmax_acc
    min_loss = gmin_loss
    min_i = -1
    for i in range(n_cands):
        if not cand_ok[i]:
            continue
        acc = int(acc_c[i])
        loss = float(loss_c[i]) if acc >= max_acc else 0.0
        if acc > max_acc:
            min_i, min_loss, max_acc = i, loss, acc
        elif acc == max_acc and loss < min_loss:
            min_i, min_loss = i, loss
        if prune:
            if acc < gmax_acc:
                sampling.set_selected(i, -1)
            elif acc == gmax_acc:
                if loss > gmin_loss * (1 + PRUNE_RELTOL_LOGLIK) \
                        and min_i != i:
                    sampling.set_selected(i, -1)

    if max_acc > gmax_acc:
        sign = True
    elif max_acc == gmax_acc and min_i >= 0:
        sign = (min_loss >= STOP_RELTOL_LOGLIK_ADDSNP and
                min_loss < gmin_loss * (1 - STOP_RELTOL_LOGLIK_ADDSNP))
    else:
        sign = False
    return sign, min_i, max_acc, min_loss


def _double(st: _HaploState, fa, fb) -> _HaploState:
    """The accepted candidate's doubled list in the interleaved 2h+b order,
    which keeps the allele grouping (hibag_tpu train.py:317-335): haplotype
    h with the new SNP at 0 (frequency fa[h]) then at 1 (fb[h]), each kept
    where its frequency is above 0."""
    H = len(st.freq)
    keep = np.stack([fa[:H] > 0, fb[:H] > 0], axis=1).reshape(-1)
    col = np.tile(np.array([0, 1], dtype=np.uint8), H)[:, None]
    bits = np.concatenate([np.repeat(st.bits, 2, axis=0), col], axis=1)
    return _HaploState(
        bits=bits[keep],
        freq=np.stack([fa[:H], fb[:H]], axis=1).reshape(-1)[keep],
        allele=np.repeat(st.allele, 2)[keep])


def _ordered_results(ctx, states, g_cand, geno_sel, Bs, done, rare_prob,
                     Hcap):
    """eval_mode="ordered": each live classifier's candidate step through
    io/native.py::ordered_step (the reference's serial sums, on the host),
    padded to Hcap slots."""
    from ..io.native import ordered_step

    K, C = g_cand.shape[:2]
    N = ctx.n_samp
    fA = np.zeros((K, C, Hcap))
    fB = np.zeros((K, C, Hcap))
    acc = np.zeros((K, C), dtype=np.int32)
    loss = np.zeros((K, C))
    for k, st in enumerate(states):
        if done[k]:
            continue
        res = ordered_step(st.bits, st.freq, st.allele, g_cand[k, :, :N],
                           geno_sel[k, :N], ctx.a1, ctx.a2, Bs[k] == 0,
                           Bs[k].astype(np.float64), ctx.n_alleles, float(N),
                           rare_prob)
        if res is None:
            raise RuntimeError("eval_mode='ordered' requires the native "
                               "library (make -C native)")
        _, fa, fb, acc[k], loss[k] = res
        fA[k, :, :fa.shape[1]] = fa
        fB[k, :, :fb.shape[1]] = fb
    return fA, fB, acc, loss


def _grow_host(ctx: TrainingContext, Bs: np.ndarray, rngs: list, mtry: int,
               prune: bool = True, dtype=np.float32, engine=None,
               eval_mode: str = "device", verbose_detail: bool = False,
               mask_budget: Optional[int] = None, mesh=None) -> list:
    """Grow K classifiers in lockstep on the host loop (hibag_tpu's
    grow_classifier and train_parallel_batch): Bs [K, N] bootstrap counts;
    classifier k draws its candidates from rngs[k]. Each step pads every
    haplotype list to the batch's largest, rounded up to ctx.hap_bucket,
    and the candidates to `mtry` (column 0, not ok), and runs the device
    work of all K classifiers as one `grow_step` on ctx.device, or with
    `mesh` (an EnsembleMesh) as one `grow_step` per shard of classifiers
    on the shard's device (parallel/mesh.py::run_shards), every shard padded
    to the batch's one Hcap; a finished classifier rides along with an
    empty draw and its results are discarded. The decisions stay one loop
    over all K. ``mask_budget`` None gives each classifier
    MASK_TOTAL_BUDGET_BYTES // K of the whole batch, so a shard takes the
    mask tiers of the whole batch."""
    dtype = np.dtype(dtype)
    if dtype not in (np.float32, np.float64):
        raise ValueError(f"dtype {dtype}: use np.float32 or np.float64")
    if eval_mode not in ("device", "ordered"):
        raise ValueError(f"unknown eval_mode {eval_mode!r}")
    f64 = dtype == np.float64
    if f64 and engine == "cuda":
        raise ValueError("dtype=np.float64 runs the plain versions: the CUDA "
                         "kernels compute in float32")
    from ..parallel.mesh import run_shards, shard_bounds

    K = len(rngs)
    shards = [(ctx.device, 0, K)] if mesh is None else shard_bounds(mesh, K)
    engine = "torch" if f64 else resolve_engine(engine, shards[0][0])
    if mask_budget is None:
        mask_budget = MASK_TOTAL_BUDGET_BYTES // max(K, 1)
    N, P = ctx.n_samp, ctx.n_snp
    Np, L = ctx.n_samp_pad, MAXNUM_SNP
    rare_prob = max(FRACTION_HAPLO / (2.0 * N), MIN_RARE_FREQ)
    reltol = float(np.sqrt(np.finfo(dtype).eps))
    Bs = np.asarray(Bs, dtype=np.int64)
    Bs_pad = np.stack([ctx.pad_B(b) for b in Bs])                # [K, Np]
    n_oob = (Bs == 0).sum(1)
    t = lambda x, d: torch.from_numpy(np.ascontiguousarray(x)).to(d)
    oob = (Bs_pad == 0) & (np.arange(Np) < N)[None, :]
    consts = [(ctx.on(d), t(Bs_pad[lo:hi].astype(dtype), d), t(oob[lo:hi], d))
              for d, lo, hi in shards]

    def device_step(bits, freq, allele, g_cand, afreq):
        def run(i):
            d, lo, hi = shards[i]
            c, B_t, oob_t = consts[i]
            out = grow_step(
                t(bits[lo:hi], d), t(freq[lo:hi], d), t(allele[lo:hi], d),
                t(geno_sel[lo:hi], d), B_t, oob_t, t(g_cand[lo:hi], d),
                t(afreq[lo:hi].astype(dtype), d), c.a1_t, c.a2_t,
                ctx.n_alleles, rare_prob, float(N), mask_budget, engine,
                skip=t(np.array(done[lo:hi]), d), reltol=reltol)
            return [x.to("cpu", torch.float64).numpy()
                    if x.is_floating_point() else x.cpu().numpy()
                    for x in out]

        parts = run_shards([d for d, _, _ in shards],
                           [(lambda i=i: run(i)) for i in range(len(shards))])
        return [np.concatenate(x) for x in zip(*parts)]

    states = [_init_haplotype(ctx, b) for b in Bs]
    snp_sels: list[list[int]] = [[] for _ in range(K)]
    geno_sel = np.full((K, Np, L), GENO_MISSING, dtype=np.int8)
    samplings = [SamplingWithoutReplace(P) for _ in range(K)]
    gmax_acc = [0] * K
    gmin_loss = [1e30] * K
    done = [False] * K

    while not all(done):
        Hs = [len(st.freq) for st in states]
        Hcap = _round_up(max(Hs), ctx.hap_bucket)
        bits = np.zeros((K, Hcap, L), dtype=np.float32)
        freq = np.zeros((K, Hcap), dtype=dtype)
        allele = np.zeros((K, Hcap), dtype=np.int32)
        for k, st in enumerate(states):
            bits[k, :Hs[k], :st.bits.shape[1]] = st.bits
            freq[k, :Hs[k]] = st.freq
            allele[k, :Hs[k]] = st.allele

        cands_k: list[list] = []
        cand_idx = np.zeros((K, mtry), dtype=np.int64)
        for k in range(K):
            if done[k]:
                cands_k.append([])
                continue
            samplings[k].random_select(mtry, rngs[k])
            c = samplings[k].selection()
            cands_k.append(c)
            cand_idx[k, :len(c)] = c

        # PrepareNewSNP: bootstrap-weighted allele frequency, monomorphic
        # candidates (in the bag) not ok
        g_cand = np.take(ctx.geno_pad, cand_idx, axis=1)      # [Np, K, Cm]
        g_cand = np.moveaxis(g_cand, 0, 2).astype(np.int8)    # [K, Cm, Np]
        gv = g_cand.astype(np.int64)
        okg = gv <= 2
        allele_cnt = np.einsum("kcn,kn->kc", np.where(okg, gv, 0), Bs_pad)
        valid_cnt = 2 * np.einsum("kcn,kn->kc", okg.astype(np.int64), Bs_pad)
        cand_ok = (allele_cnt > 0) & (allele_cnt < valid_cnt)
        for k in range(K):
            cand_ok[k, len(cands_k[k]):] = False
        afreq = np.where(cand_ok, allele_cnt / np.maximum(valid_cnt, 1), 0.5)

        if eval_mode == "ordered":
            fA, fB, acc_b, loss_b = _ordered_results(
                ctx, states, g_cand, geno_sel, Bs, done, rare_prob, Hcap)
        else:
            fA, fB, acc_b, loss_b = device_step(bits, freq, allele, g_cand,
                                                afreq)

        for k in range(K):
            if done[k]:
                continue
            sign, min_i, max_acc, min_loss = _decide_host(
                cand_ok[k], acc_b[k], loss_b[k], len(cands_k[k]),
                gmax_acc[k], gmin_loss[k], samplings[k], prune)
            if sign:
                gmax_acc[k], gmin_loss[k] = max_acc, min_loss
                states[k] = _double(states[k], fA[k, min_i], fB[k, min_i])
                chosen = cands_k[k][min_i]
                geno_sel[k, :, len(snp_sels[k])] = ctx.geno_pad[:, chosen]
                snp_sels[k].append(int(chosen))
                if prune:
                    samplings[k].set_selected(min_i, -1)
                    samplings[k].remove_flagged()
                else:
                    samplings[k].remove(min_i)
                if verbose_detail:
                    print(f"    {len(snp_sels[k]):2d}, SNP: {chosen + 1}, "
                          f"loss: {gmin_loss[k]:g}, oob acc: "
                          f"{50.0 * gmax_acc[k] / max(n_oob[k], 1):.2f}%, "
                          f"# of haplo: {len(states[k].freq)}")
            else:
                samplings[k].remove_selection()
            if samplings[k].total() == 0 or len(snp_sels[k]) >= MAXNUM_SNP:
                done[k] = True

    return [Classifier(
        snp_index=np.asarray(snp_sels[k], dtype=np.int32),
        hap_bits=states[k].bits, hap_freq=states[k].freq,
        hap_allele=states[k].allele, bootstrap_count=Bs[k].astype(np.int32),
        oob_accuracy=float(0.5 * gmax_acc[k] / max(int(n_oob[k]), 1)))
        for k in range(K)]


def grow_classifier(ctx: TrainingContext, B: np.ndarray, rng: RRng,
                    mtry: int, prune: bool = True,
                    verbose_detail: bool = False, dtype=np.float32,
                    em_iter_seg: Optional[int] = None,
                    eval_mode: str = "device", engine=None) -> Classifier:
    """Grow one classifier from bootstrap counts B [N]: the reference's
    greedy forward SNP selection (CVariableSelection::Search,
    src/LibHLA.cpp:1981-2122), drawing candidates from `rng`.

    Each step fits EM for all `mtry` candidates at once and scores them on
    ctx.device: the CUDA kernels on a CUDA device (``engine`` None or
    "cuda"), their plain versions on the CPU or with ``engine="torch"``
    (train_fused.resolve_engine).
    dtype: np.float64 runs the EM and evaluation in float64 through the
    plain versions on any device (hibag_tpu's float64 path has no kernel
    either); the EM tolerance is sqrt(eps) of `dtype`.
    em_iter_seg: accepted for hibag_tpu's signature and has no effect (it
    split the EM into TPU dispatches with bitwise the same results).
    eval_mode: "device" as above; "ordered" runs each step on the host
    through io/native.py::ordered_step, the reference's serial summation
    order, so exact floating ties resolve as the reference's
    (docs/DEVIATIONS.md #3); it needs the native library and no device.
    """
    return _grow_host(ctx, np.asarray(B)[None], [rng], mtry, prune=prune,
                      dtype=dtype, engine=engine, eval_mode=eval_mode,
                      verbose_detail=verbose_detail)[0]


def train_parallel_batch(ctx: TrainingContext, rngs: list, mtry: int,
                         prune: bool = True, mesh=None,
                         verbose: bool = False, engine=None,
                         mask_budget: Optional[int] = None) -> list:
    """Grow len(rngs) classifiers in lockstep, one `grow_step` per greedy
    step for the batch, the decisions per classifier on the host
    (hibag_tpu's train_parallel_batch). Classifier k draws its bootstrap,
    then its candidates, from rngs[k]. ``engine`` as in `grow_classifier`;
    ``mask_budget``: bytes of EM pair mask per classifier (models.em
    tiers); ``mesh`` (an EnsembleMesh or a list of devices) splits each
    step's device work over its devices, the training data replicated
    (`TrainingContext.on`); ``verbose`` is accepted for hibag_tpu's
    signature."""
    from ..parallel.mesh import as_mesh

    Bs = np.stack([r.bootstrap_counts(ctx.n_samp) for r in rngs])
    return _grow_host(ctx, Bs, rngs, mtry, prune=prune, engine=engine,
                      mask_budget=mask_budget, mesh=as_mesh(mesh))


def train_parallel(hla_table, geno_data, n_classifiers: int = 100,
                   mtry="sqrt", prune: bool = True, seed: int = 100,
                   batch: Optional[int] = None, mesh=None,
                   na_rm: bool = True, mono_rm: bool = True,
                   maf: float = float("nan"), verbose: bool = True,
                   with_matching: bool = True, hap_bucket: int = 64,
                   auto_save: Optional[str] = None,
                   first_id: int = 0, mode: str = "auto", hcap: int = 256,
                   max_steps: int = 256, on_overflow: str = "warn",
                   seg_steps: Optional[int] = None,
                   freeze_max_batch: Optional[int] = None,
                   resume: bool = False, engine=None, device="cuda",
                   mask_budget: Optional[int] = None) -> AttrBagModel:
    """Ensemble training (hlaParallelAttrBagging) on `device` ("cuda" by
    default, which raises without a card; "cpu" runs the kernels' plain
    versions).

    Trains `n_classifiers` in batches of `batch` (default 8, or one per
    mesh device); classifier j of the ensemble has the id first_id + j,
    which fixes its bootstrap and its candidate draws, so batching and
    placement do not change the result. ``mesh`` (an EnsembleMesh or a list
    of devices) splits each batch over its devices, which replaces
    `device`; each shard runs the step kernels on its device. The shards'
    host loops take turns on the one process's interpreter lock, so a mesh
    trains no faster than one device (two shards on one card were slower
    than one device: PERF.md); to train on several cards, run one process
    per card with `train_distributed` or `train_dynamic`. ``mode``:
    "host" grows them with `train_parallel_batch` (the R RNG stream
    RRng((seed + 1000003 * id) mod (2^31 - 1)), haplotype lists padded to
    multiples of `hap_bucket`); "fused" with
    models.train_fused.train_fused_batch (`hcap`, `max_steps`,
    `on_overflow`, `seg_steps`, `freeze_max_batch` are its arguments);
    "auto" trains fused on a CUDA device and host on the CPU. With
    `auto_save` the partial model is written after every batch; with
    `resume` and an existing `auto_save` file training continues from it.
    ``engine`` "torch" runs the plain versions of the kernels on any device
    (train_fused.resolve_engine). The other arguments are hibag_tpu's.
    """
    if mode not in ("fused", "host", "auto"):
        raise ValueError(f"unknown mode {mode!r}")
    from ..parallel.mesh import as_mesh
    from .train_fused import train_fused_batch

    mesh = as_mesh(mesh)
    ctx, alleles, _ = make_training_context(
        hla_table, geno_data, na_rm=na_rm, mono_rm=mono_rm, maf=maf,
        hap_bucket=hap_bucket,
        device=device if mesh is None else mesh.devices[0])
    m = _resolve_mtry(mtry, ctx.n_snp)
    if mode == "auto":
        mode = "fused" if ctx.device.type == "cuda" else "host"
    batch = batch or (mesh.size if mesh is not None else 8)

    classifiers: list = []
    k0 = first_id
    if resume and auto_save and os.path.exists(auto_save):
        classifiers = list(AttrBagModel.load(auto_save).classifiers)[
            :n_classifiers]
        k0 = first_id + len(classifiers)
    while len(classifiers) < n_classifiers:
        kb = min(batch, n_classifiers - len(classifiers))
        t0 = time.time()
        if mode == "fused":
            cls = train_fused_batch(
                ctx, kb, seed=seed, mtry=m, prune=prune, hcap=hcap,
                first_id=k0, max_steps=max_steps, seg_steps=seg_steps,
                on_overflow=on_overflow, freeze_max_batch=freeze_max_batch,
                engine=engine, mask_budget=mask_budget, mesh=mesh)
        else:
            rngs = [RRng((seed + 1000003 * (k0 + j)) % (2**31 - 1))
                    for j in range(kb)]
            cls = train_parallel_batch(ctx, rngs, m, prune=prune, mesh=mesh,
                                       engine=engine, mask_budget=mask_budget)
        classifiers.extend(cls)
        k0 += kb
        if verbose:
            oob = np.mean([c.oob_accuracy for c in cls])
            print(f"-- #{len(classifiers)}, batch of {kb} in "
                  f"{time.time() - t0:.2f}s, avg oob acc: {oob * 100:.2f}%")
        if auto_save:
            _partial_model(ctx, alleles, hla_table, geno_data,
                           classifiers).save(auto_save)

    model = _partial_model(ctx, alleles, hla_table, geno_data, classifiers)
    if with_matching:
        from .predict import predict
        pd = predict(model, geno_data, match_type="Pos+Allele",
                     device=ctx.device)
        model.matching = pd.matching
        if auto_save:
            model.save(auto_save)
    return model


def train_distributed(hla_table, geno_data, n_classifiers: int = 100,
                      seed: int = 100, coordinator: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None,
                      **kwargs) -> AttrBagModel:
    """Ensemble training over processes (torch.distributed, gloo).

    Each process trains a fixed contiguous share of the ensemble
    (parallel/mesh.py::classifier_range) with `train_parallel` on its own
    device (`process_device` of kwargs' ``device``, default "cuda": card
    rank % device_count), then the classifiers are gathered and every
    process returns the whole model, without matching. The classifiers'
    random streams come from their ids, so any number of processes trains
    the classifiers of one process. Single process: train_parallel.
    Replaces hlaParallelAttrBagging's PSOCK-cluster job farm (reference
    R/HIBAG.R:293-451, R/DataUtilities.R:124-213). kwargs go to
    train_parallel (mode, batch, mesh, hcap, ...).
    """
    from ..parallel.mesh import (classifier_range, distributed_init,
                                 gather_classifiers, process_device)

    pi, pc = distributed_init(coordinator, num_processes, process_id)
    kwargs.update(device=process_device(kwargs.get("device", "cuda"), pi),
                  with_matching=False)
    share = classifier_range(n_classifiers, pi, pc)
    local = train_parallel(hla_table, geno_data, n_classifiers=len(share),
                           seed=seed, first_id=share.start, **kwargs)
    return gather_classifiers(local, n_classifiers)


def train_dynamic(hla_table, geno_data, n_classifiers: int = 100,
                  seed: int = 100, work_dir: Optional[str] = None,
                  job_size: int = 8, coordinator: Optional[str] = None,
                  num_processes: Optional[int] = None,
                  process_id: Optional[int] = None,
                  **kwargs) -> AttrBagModel:
    """Ensemble training over processes with dynamic load balance: the
    reference's .DynamicClusterCall job farm (R/DataUtilities.R:124-213),
    where the next job goes to whichever worker is free, so a slow or late
    process never idles the others.

    Each process claims the next `job_size` classifiers by creating a claim
    file in `work_dir` with O_CREAT|O_EXCL (a filesystem all processes
    share), trains them with `train_parallel` on its own device (as
    `train_distributed`), and goes on until every batch is claimed; then
    the classifiers are gathered and every process returns the whole model,
    without matching. Which process trains a batch varies from run to run;
    the classifiers do not, since their random streams come from their ids.
    Raises if the gathered classifiers are fewer than `n_classifiers`
    (stale claim files). kwargs go to train_parallel; its SNP and sample
    filters (na_rm, mono_rm, maf) also build the merged model.
    """
    import tempfile

    from ..parallel.mesh import (allgather_pickled, distributed_init,
                                 process_device)

    pi, pc = distributed_init(coordinator, num_processes, process_id)
    kwargs.update(device=process_device(kwargs.get("device", "cuda"), pi),
                  with_matching=False)
    if work_dir is None:
        if pc > 1:
            raise ValueError("train_dynamic with several processes needs a "
                             "shared work_dir for the claim files")
        work_dir = tempfile.mkdtemp(prefix="hibag_dyn_")
    os.makedirs(work_dir, exist_ok=True)

    local: dict = {}
    for ci, lo in enumerate(range(0, n_classifiers, job_size)):
        try:
            fd = os.open(os.path.join(work_dir, f"claim_{ci}"),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            continue
        os.write(fd, str(pi).encode())
        os.close(fd)
        hi = min(lo + job_size, n_classifiers)
        part = train_parallel(hla_table, geno_data, n_classifiers=hi - lo,
                              seed=seed, first_id=lo, **kwargs)
        for off, c in enumerate(part.classifiers):
            local[lo + off] = c

    merged: dict = {}
    for part_map in allgather_pickled(local):
        merged.update(part_map)
    if len(merged) != n_classifiers:
        raise RuntimeError(
            f"the claimed jobs gave {len(merged)}/{n_classifiers} "
            f"classifiers: stale claim files in {work_dir}?")
    filters = {k: kwargs[k] for k in ("na_rm", "mono_rm", "maf")
               if k in kwargs}
    # the merged model's SNPs and alleles: host data, no device work
    ctx, alleles, _ = make_training_context(hla_table, geno_data,
                                            device="cpu", **filters)
    return _partial_model(ctx, alleles, hla_table, geno_data,
                          [merged[k] for k in range(n_classifiers)])


def train(hla_table, geno_data, n_classifiers: int = 100, mtry="sqrt",
          prune: bool = True, na_rm: bool = True, mono_rm: bool = True,
          maf: float = float("nan"), seed: Optional[int] = None,
          rng: Optional[RRng] = None, verbose: bool = True,
          verbose_detail: bool = False, with_matching: bool = True,
          hap_bucket: int = 32, assembly: Optional[str] = None,
          dtype=np.float32, em_iter_seg: Optional[int] = None,
          engine=None, device="cuda") -> AttrBagModel:
    """Build an attribute-bagging model (hlaAttrBagging, reference
    R/HIBAG.R:48-275): the classifiers one after another through
    `grow_classifier`, all from one R RNG stream (`rng`, else RRng(seed)),
    each drawing its bootstrap and then its candidates. On `device`
    ("cuda" by default, which raises without a card); ``dtype``,
    ``em_iter_seg`` and ``engine`` as in `grow_classifier`."""
    ctx, alleles, _ = make_training_context(
        hla_table, geno_data, na_rm=na_rm, mono_rm=mono_rm, maf=maf,
        hap_bucket=hap_bucket, device=device)
    m = _resolve_mtry(mtry, ctx.n_snp)
    if rng is None:
        rng = RRng(seed)
    if verbose:
        print(f"Build a model with {n_classifiers} individual classifiers:")
        print(f"    # of SNPs randomly sampled as candidates "
              f"for each selection: {m}")
        print(f"    # of SNPs: {ctx.n_snp}")
        print(f"    # of samples: {ctx.n_samp}")
        print(f"    # of unique HLA alleles: {ctx.n_alleles}")

    classifiers = []
    for k in range(n_classifiers):
        t0 = time.time()
        B = rng.bootstrap_counts(ctx.n_samp)
        c = grow_classifier(ctx, B, rng, m, prune=prune,
                            verbose_detail=verbose_detail, dtype=dtype,
                            em_iter_seg=em_iter_seg, engine=engine)
        classifiers.append(c)
        if verbose:
            print(f"[{k + 1}] {time.strftime('%Y-%m-%d %H:%M:%S')}, "
                  f"oob acc: {c.oob_accuracy * 100:.2f}%, "
                  f"# of SNPs: {c.n_snp}, # of haplo: {c.n_haplo} "
                  f"({time.time() - t0:.2f}s)")

    # the model keeps the whole filtered SNP set; publish() drops the unused
    model = _partial_model(ctx, alleles, hla_table, geno_data, classifiers)
    if assembly:
        model.assembly = assembly
    if with_matching:
        from .predict import predict
        pd = predict(model, geno_data, match_type="Pos+Allele",
                     device=ctx.device)
        model.matching = pd.matching
        if verbose:
            oob = np.mean([c.oob_accuracy for c in classifiers])
            print(f"Out-of-bag accuracy: {oob * 100:.2f}%")
    return model
