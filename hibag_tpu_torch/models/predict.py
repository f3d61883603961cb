"""Ensemble HLA-type prediction in PyTorch (counterpart of
hibag_tpu/models/predict.py), with the classifiers split over a mesh of
devices (parallel/mesh.py; one device is a mesh of one shard): each block of
samples goes through `_predict_block_mesh`.

Per classifier c and sample n (reference semantics, src/LibHLA.cpp:2317-2482):
  * classifier weight w[n,c] = Σ snp_weight over c's non-missing SNPs in n,
    normalized by Σ snp_weight over all c's SNPs
  * ensemble prob = Σ_c w·posterior / Σ_c w                (vote="prob")
  * majority vote: one-hot of per-classifier best guess, weight 1
  * matching[n] = Σ_c w·normalizer / Σ_c w
  * dosage[A] = 2·P[A,A] + Σ_{B≠A} P{A,B}

Two engines, chosen openly by the model's shape:
  * the ensemble engine: all classifiers of a sample block in one call of
    ops.ens_acc.ensemble_accumulate. engine="auto" (the default) takes it
    for every model that kernel takes (ens_acc.fits: at most 1,024
    haplotypes per classifier and 128 alleles), and engine="pallas" always
    (it raises for a model the kernel does not take);
  * the scan engine (_scan_raw): chunks of SCAN_CCHUNK classifiers, each
    chunk one launch of the scoring kernel (ops/post_scores.py). For the
    probability vote in float32 its fold mode (fold_scores) adds the
    chunk's weighted posteriors into the block's sums itself; the majority
    vote and float64 take its S mode (ensemble_scores) and fold S in torch
    ops. Weights and matching are torch ops.
    engine="auto" takes it for the wider models, as hibag_tpu.predict does
    (hibag_tpu/models/predict.py:505-519), and engine="jnp" (or its alias
    "scan") always. Its kernel takes 4,096 haplotypes per classifier and
    1,024 alleles.
The engine names are hibag_tpu's: "pallas" is its ensemble kernel, "jnp"
its per-classifier scan.
Each wrapper launches its CUDA kernel on a card and runs its plain PyTorch
version on the CPU. dtype=np.float64 is the reference-precision scan engine,
ops.scoring.posterior_scores in float64 on any device, as hibag_tpu's float64
path has no kernel either.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..constants import GENO_MISSING, LOG_MIN_RARE_FREQ, MAXNUM_SNP
from ..device import resolve_device
from ..ops import ens_acc, post_scores
from ..ops.ens_acc import PackedHaplotypes, ensemble_accumulate
from ..ops.post_scores import ensemble_scores, fold_into, fold_scores
from ..ops.scoring import majority_hits, posterior_scores, unordered_from_S
from ..utils import trace
from .convert import ensemble_from_packed
from .model import AttrBagModel, IdCache


def _log_match(w, total, dmin):
    """log(w · total · exp(λ·dmin)), −inf where the classifier has no
    weight."""
    lm = torch.log(w.clamp_min(1e-30)) + torch.log(total) \
        + LOG_MIN_RARE_FREQ * dmin
    return torch.where(w > 0, lm, -torch.inf)


#: classifiers per launch of the scan engine's scoring kernel (in S mode
#: its [cchunk, n, A, A] output sizes the block). The smallest value within
#: 2% of the fastest of 1, 2, 4, 8 and 16 on a wide 160-allele model on an
#: H100, in S mode (CHANGES.md)
SCAN_CCHUNK = 8


def _one_classifier_fn(geno_codes, snp_weight, n_alleles, vote, acc_dt, ens,
                       wsum, fused):
    """Per-chunk closure of the scan engine, adding each chunk's weighted
    posteriors into ens [n,A,A] and its weights into wsum [n] in place.

    Returns a function (part, sidx) -> (log_match [cc,n], w [cc,n]) for a
    chunk of cc classifiers with SNP slots sidx [cc, L]. With `fused`
    (vote="prob" in float32), part is the chunk's
    PackedHaplotypes and the scoring kernel's fold mode adds into ens
    (ops.post_scores.fold_scores); else part(g) gives the chunk's (S
    [cc,n,A,A], dmin [cc,n], total [cc,n]) from the gathered codes g int8
    [cc, n, L], folded here (S is overwritten in place). Traced as
    ``predict.fold`` from the scores' return on.
    """
    A = n_alleles

    def one_chunk(part, sidx):
        g, w = _gather_codes(sidx, snp_weight, geno_codes, acc_dt)
        if fused:
            dmin, total = fold_scores(part, g, w, A, ens)
        else:
            S, dmin, total = part(g)
        with trace.span("predict.fold", geno_codes.device):
            log_match = _log_match(w, total, dmin)
            if vote == "prob":
                if not fused:
                    fold_into(ens, S, total, w)
                wsum.add_(w.sum(0))
            else:
                cc, n = w.shape
                Q = unordered_from_S(S, inplace=True)
                hits = majority_hits(Q.reshape(cc * n, A, A)).reshape(
                    cc, n, A, A) * (w > 0)[..., None, None]
                ens.add_(hits.sum(0))
                wsum.add_((w > 0).to(acc_dt).sum(0))
            return log_match, w

    return one_chunk


def _chunk_scores(hap, c0, c1, n_alleles, f64):
    """scores(g) of classifiers c0..c1-1 for _one_classifier_fn's S mode:
    one launch of the scoring kernel (ensemble_scores) or, with f64,
    ops.scoring.posterior_scores in float64 classifier by classifier."""
    A = n_alleles
    if f64:
        bits, freq, allele = (x[c0:c1] for x in hap)

        def scores(g):
            res = [posterior_scores(bits[k], freq[k], allele[k], g[k], A,
                                    f64=True) for k in range(c1 - c0)]
            return tuple(torch.stack([r[key] for r in res])
                         for key in ("S", "dmin", "total"))
        return scores
    part = hap.subset(c0, c1)
    return lambda g: ensemble_scores(part, g, A)


def _scan_raw(hap, snp_index, snp_weight, geno_codes, n_alleles,
              vote="prob", cchunk=SCAN_CCHUNK, f64=False):
    """One block of samples against the ensemble `hap`, `cchunk`
    classifiers at a time (the scan engine), before normalisation.

    hap: the ensemble as PackedHaplotypes, scored in float32 by the scoring
    kernel on a card and by its plain version on the CPU; with `f64`, the
    tuple (hap_bits [C,Hm,L], hap_freq [C,Hm] float64, hap_allele [C,Hm]).
    snp_index [C,L]; snp_weight [P]; geno_codes [n,P] uint8. The last chunk
    may hold fewer classifiers. Returns ens [n,A,A] (the weighted sum over
    the classifiers, symmetric unordered convention), wsum [n], log_match
    [C,n], w [C,n]. Traced as a ``predict.scan`` span and a
    ``predict.scan_chunks`` count per chunk, and a ``predict.scan_fused``
    count per chunk folded in the kernel.
    """
    n, A = geno_codes.shape[0], n_alleles
    C = snp_index.shape[0]
    dev = geno_codes.device
    acc_dt = torch.float64 if f64 else torch.float32
    # the kernel folds the probability vote in float32; the majority vote
    # (each classifier's argmax of Q) and float64 fold S in torch ops
    fused = vote == "prob" and not f64
    ens = torch.zeros((n, A, A), dtype=acc_dt, device=dev)
    wsum = torch.zeros((n,), dtype=acc_dt, device=dev)
    one_chunk = _one_classifier_fn(geno_codes, snp_weight, A, vote, acc_dt,
                                   ens, wsum, fused)
    log_match, ws = [], []
    for c0 in range(0, C, cchunk):
        c1 = min(c0 + cchunk, C)
        with trace.span("predict.scan", dev):
            trace.count("predict.scan_chunks")
            if fused:
                trace.count("predict.scan_fused")
            part = (hap.subset(c0, c1) if fused
                    else _chunk_scores(hap, c0, c1, A, f64))
            lm, w = one_chunk(part, snp_index[c0:c1])
        log_match.append(lm)
        ws.append(w)
    return ens, wsum, torch.cat(log_match), torch.cat(ws)


def _predict_block(hap, snp_index, snp_weight, geno_codes, n_alleles,
                   vote="prob", cchunk=SCAN_CCHUNK, f64=False):
    """`_scan_raw` with ens weight-normalized: ens [n,A,A], wsum [n],
    log_match [C,n], w [C,n]."""
    ens, wsum, log_match, w = _scan_raw(hap, snp_index, snp_weight,
                                        geno_codes, n_alleles, vote, cchunk,
                                        f64)
    return ens / wsum.clamp_min(1e-30)[:, None, None], wsum, log_match, w


#: device tensors per PackedEnsemble, one entry per (device, classifier
#: range) (weak: dies with the pack)
_PREP_CACHE = IdCache()


def _prepare_ensemble(packed, device, c0: int = 0,
                      c1: Optional[int] = None) -> PackedHaplotypes:
    """Classifiers c0..c1-1 of the ensemble (all by default) in the kernels'
    layout on `device`, built once per (PackedEnsemble, device, range) so
    repeated predict() calls, and repeated calls on a mesh shard by shard,
    skip the packing and the host-to-device copy."""
    c1 = packed.hap_bits.shape[0] if c1 is None else c1
    memo = _PREP_CACHE.get(packed)
    if memo is None:
        memo = {}
        _PREP_CACHE.set(packed, memo)
    hap = memo.get((device, c0, c1))
    if hap is None:
        hap = ensemble_from_packed(packed, device, c0, c1)
        memo[(device, c0, c1)] = hap
    return hap


def _gather_codes(snp_index, snp_weight, geno_codes, dtype=torch.float32):
    """Codes gathered to each classifier's SNP slots, g int8 [C, n, L]
    (3 = missing or padded slot), and the classifier weights w [C, n] in
    `dtype`, both contiguous."""
    C, L = snp_index.shape
    n = geno_codes.shape[0]
    in_cls = snp_index >= 0                                     # [C, L]
    safe = snp_index.clamp_min(0).long()
    g = geno_codes[:, safe.reshape(-1)].reshape(n, C, L).permute(1, 0, 2)
    g = torch.where(in_cls[:, None, :], g, GENO_MISSING).to(torch.int8)
    wsnp = snp_weight[safe] * in_cls                            # [C, L]
    nonmiss = g != GENO_MISSING
    w = ((nonmiss * wsnp[:, None, :]).sum(-1).to(dtype)
         / wsnp.sum(-1, keepdim=True).clamp_min(1).to(dtype))
    return g.contiguous(), w.contiguous()


def _ens_core(hap: PackedHaplotypes, snp_index, snp_weight, geno_codes,
              n_alleles, vote="prob"):
    """(ens_raw [n,A,A] — weighted posterior sum over the classifiers —
    log_match [C,n], w [C,n]) through ensemble_accumulate."""
    g, w = _gather_codes(snp_index, snp_weight, geno_codes)
    ens, dmin, total = ensemble_accumulate(hap, g, w, n_alleles,
                                           majority=vote == "majority")
    return ens, _log_match(w, total, dmin), w


def _ens_wsum(w, vote):
    """Ensemble normalizer: classifier weights for probability voting, one
    vote per contributing classifier for majority voting."""
    return w.sum(0) if vote == "prob" else (w > 0).to(w.dtype).sum(0)


def _predict_block_mesh(shards, snp_weight, geno, n_alleles, vote, use_ens):
    """One sample block over the shards of a mesh (a one-device predict()
    is a mesh of one shard): each shard (device, hap, snp_index) runs the
    ensemble kernel (`_ens_core`, one launch) or the scan engine
    (`_scan_raw`) over its classifiers on its device, with snp_weight and
    the block's codes `geno` taken from dicts by device. On the first
    shard's device (mesh.devices[0]) the shards' weighted posteriors and
    weight sums are added in mesh order, and log_match and w concatenated in
    classifier order. Same returns as _predict_block."""
    from ..parallel.mesh import run_shards

    def run(dev, hap, si):
        with trace.span("predict.block", dev):
            if use_ens:
                ens, lm, w = _ens_core(hap, si, snp_weight[dev], geno[dev],
                                       n_alleles, vote)
                return ens, _ens_wsum(w, vote), lm, w
            return _scan_raw(hap, si, snp_weight[dev], geno[dev], n_alleles,
                             vote)

    parts = run_shards([d for d, _, _ in shards],
                       [(lambda s=s: run(*s)) for s in shards])
    d0 = shards[0][0]
    ens, wsum = parts[0][0], parts[0][1]
    for p in parts[1:]:
        ens = ens + p[0].to(d0)
        wsum = wsum + p[1].to(d0)
    log_match = torch.cat([p[2].to(d0) for p in parts])
    w = torch.cat([p[3].to(d0) for p in parts])
    return ens / wsum.clamp_min(1e-30)[:, None, None], wsum, log_match, w


def _pack_cols(ens, wsum, lse, wssum, response):
    """Block outputs as ONE buffer, so each block makes one device-to-host
    copy.

    response=False: [n, A*A+3] — full posterior matrix + (wsum, lse, wssum).
    response=True: [n, A+5] — per-allele dosage, the argmax flat index over
    the upper triangle, its probability, and the three matching stats. The
    lower triangle masks to -1 (< any probability) and argmax takes the
    first occurrence, as np.triu_indices order does on the host."""
    n = wsum.shape[0]
    dt = ens.dtype
    if response:
        A = ens.shape[1]
        mask = torch.ones((A, A), dtype=torch.bool, device=ens.device).triu()
        flat = torch.where(mask[None], ens, -1.0).reshape(n, A * A)
        best = flat.argmax(dim=1)
        maxp = flat.gather(1, best[:, None])[:, 0]
        dosage = ens.sum(dim=2) + ens.diagonal(dim1=1, dim2=2)
        head = [dosage, best[:, None].to(dt), maxp[:, None]]
    else:
        head = [ens.reshape(n, -1)]
    return torch.cat(head + [wsum[:, None].to(dt), lse[:, None].to(dt),
                             wssum[:, None].to(dt)], dim=1)


def _pack_stats(ens, wsum, log_match, w, response=False):
    """Matching reduction (log-sum-exp over classifiers, exact for
    likelihoods below the float32 range) + _pack_cols."""
    m = log_match.amax(dim=0)
    fin = torch.isfinite(m)
    safe_m = torch.where(fin, m, 0.0)
    s = torch.exp(log_match - safe_m[None, :]).sum(dim=0)
    lse = torch.where(fin, safe_m + torch.log(s), -torch.inf)
    return _pack_cols(ens, wsum, lse, w.sum(dim=0), response)


def _default_block(N, C, A, Hm, device, ens=True, cchunk=SCAN_CCHUNK,
                   f64=False, fused=False) -> int:
    """Samples per block from the device's memory: an eighth of the card's
    memory (256 MiB on the CPU) over a per-sample bound of the block's
    intermediates — gathered codes and weights of the classifiers in flight
    (all C for the ensemble kernel, `cchunk` for the scan engine), the
    [n, A, A] posteriors, the scan engine's [cchunk, n, A, A] scores and
    their products (on a card in float32 with `fused`, the fold mode's
    scratch of 10 bytes a cell instead: post_scores.fold_plan), and, where
    plain versions run (the CPU, and float64 on any device), their
    [n, H, H] distance tensors."""
    k = C if ens else min(cchunk, C)
    per_sample = k * (8 * MAXNUM_SNP + 24) + 16 * A * A
    if not ens:
        per_sample += (5 * A * (A + 1)
                       if fused and not f64 and device.type == "cuda"
                       else 12 * k * A * A)
    if device.type != "cuda" or f64:
        per_sample += (64 if f64 else 32) * Hm * Hm
    if device.type == "cuda":
        budget = torch.cuda.get_device_properties(device).total_memory // 8
    else:
        budget = 1 << 28
    return max(1, min(N, budget // per_sample))


@dataclass
class PredictionResult:
    """Prediction output (hlaAlleleClass equivalent, value df + extras)."""

    sample_id: np.ndarray
    allele1: np.ndarray            # object [N] best-guess allele strings
    allele2: np.ndarray
    prob: np.ndarray               # [N] posterior of the best guess
    matching: np.ndarray           # [N] matching proportion
    dosage: Optional[np.ndarray] = None      # [A, N]
    postprob: Optional[np.ndarray] = None    # [A(A+1)/2, N] triangular
    hla_alleles: Optional[list] = None
    locus: str = ""
    match_info: Optional[dict] = None

    def accuracy_vs(self, true1, true2) -> float:
        """Per-allele accuracy (0/0.5/1 per sample, averaged)."""
        hits = []
        for a1, a2, t1, t2 in zip(self.allele1, self.allele2, true1, true2):
            if a1 is None or t1 is None:
                continue
            hits.append(_pair_match(a1, a2, t1, t2) / 2.0)
        return float(np.mean(hits)) if hits else float("nan")


def _pair_match(a1, a2, t1, t2) -> int:
    """#matched alleles between unordered pairs (CHLATypeList::Compare,
    reference src/LibHLA.cpp:910-924)."""
    best = 0
    for x, y in ((a1, a2), (a2, a1)):
        s = int(x == t1) + int(y == t2)
        best = max(best, s)
    return best


def predict(model: AttrBagModel, data, vote: str = "prob",
            match_type: str = "Position", same_strand: bool = False,
            block: Optional[int] = None, with_dosage: bool = True,
            with_prob: bool = False, hap_bucket: int = 64,
            engine: str = "auto", type: Optional[str] = None,
            dtype=np.float32, device="cuda", mesh=None, devices=None,
            verbose: bool = False) -> PredictionResult:
    """Impute HLA types for `data` (SNPGenoData or pre-aligned code matrix
    [N, P_model]) on `device` (default "cuda"; raises when there is no card).

    Equivalent of hlaPredict (reference R/HIBAG.R:470-818).

    type: reference-style output selector ("response+dosage" [default],
    "response", "prob", "response+prob") overriding with_dosage/with_prob.
    engine: "auto", "pallas" or "jnp" (hibag_tpu's names; "scan" is an
    alias of "jnp"). "auto" runs the ensemble kernel (ops/ens_acc.py) for
    every model it takes (ens_acc.fits: at most ens_acc.MAX_H haplotypes
    per classifier and ens_acc.MAX_A alleles) and the scan engine for the
    rest, as hibag_tpu.predict sends a model beyond its ensemble kernel's
    limit to its scan engine; "pallas" always takes the ensemble kernel and
    raises ValueError for a model it does not take; "jnp" always takes the
    scan engine. The scan engine scores SCAN_CCHUNK classifiers per launch
    of the scoring kernel (ops/post_scores.py: at
    most post_scores.MAX_H haplotypes and post_scores.MAX_A alleles; beyond
    them it raises ValueError naming the limit). Each engine's LAUNCHES
    counts its kernel's launches; on the CPU both run their plain versions.
    block: samples per block (default: from the device's memory).
    dtype: np.float64 selects the reference-precision scan engine, plain
    PyTorch in float64 on any device, whatever `engine` says (hibag_tpu's
    float64 path forces "jnp" and has no kernel either).
    mesh / devices: split the classifiers over a mesh
    (parallel/mesh.py::ensemble_mesh; `devices`, a list of devices, builds
    one; `mesh` may be such a list too), replacing the reference's
    per-worker splits in hlaPredict(cl=) (R/HIBAG.R:764-807). Each shard of
    classifiers runs the engine's kernel on its device (the ensemble
    kernel: one launch per shard and block; the scan engine: its chunks),
    and the shards' weighted posteriors are summed on the mesh's first
    device (`_predict_block_mesh`); `device` is then not read. Without
    them, `device` is a mesh of one shard. float64 takes no mesh
    (ValueError).
    Traced (utils/trace.py) as the root span ``predict.call`` holding
    ``predict.align``, ``predict.prepare``, a ``predict.block`` per block
    and shard (the scan engine's chunks in it: ``predict.scan`` spans
    holding ``predict.fold``), a ``predict.fetch`` per block and
    ``predict.finalize``.
    """
    if type is not None:
        if type not in ("response+dosage", "response", "prob",
                        "response+prob"):
            raise ValueError(f"unknown type {type!r}")
        with_dosage = type == "response+dosage"
        with_prob = type in ("prob", "response+prob")
    if vote not in ("prob", "majority"):
        raise ValueError(f"unknown vote {vote!r}")
    if engine not in ("auto", "pallas", "jnp", "scan"):
        raise ValueError(f"unknown engine {engine!r}")
    f64 = np.dtype(dtype) == np.float64
    if mesh is None and devices is not None:
        mesh = devices
    if f64:
        if mesh is not None:
            raise ValueError("dtype=float64 prediction is single-device only")
        dev = resolve_device(device)
    else:
        from ..parallel.mesh import as_mesh, ensemble_mesh
        mesh = ensemble_mesh([device]) if mesh is None else as_mesh(mesh)
        dev = mesh.devices[0]
    with trace.span("predict.call", dev):
        with trace.span("predict.align", dev):
            codes, sample_id, info = _align_input(model, data, match_type,
                                                  same_strand)
        with trace.span("predict.prepare", dev):
            prep = _prepare(model, codes, mesh, dev, hap_bucket, engine,
                            f64, block, vote)
        out = _run_blocks(prep, codes.shape[0], model.n_alleles, vote,
                          not with_prob, f64, verbose)
        with trace.span("predict.finalize", dev):
            return _finalize(model, sample_id, info, out, with_dosage,
                             with_prob)


def _align_input(model, data, match_type, same_strand):
    """(codes uint8 [N, P_model], sample ids, alignment info or None) of
    `data`, an SNPGenoData aligned to the model or a code matrix."""
    from ..data.geno import SNPGenoData, align_to_model

    if isinstance(data, SNPGenoData):
        codes, info = align_to_model(model, data, match_type=match_type,
                                     same_strand=same_strand)
        if info["missing_fraction"] > 0.5:
            import warnings
            warnings.warn(
                f"More than 50% of model SNPs are missing in the target "
                f"({info['missing_fraction']:.1%}) — imputation may be unreliable.")
        return codes, data.sample_id, info
    codes = np.asarray(data, dtype=np.uint8)
    return codes, np.arange(codes.shape[0]).astype(object), None


@dataclass
class _Prepared:
    """What the blocks of one predict() call run on: the float64 ensemble
    `hap` and slots `si` (f64), else the mesh's `shards` (device, hap,
    snp_index); the engine; samples per block; and, by device, the cohort's
    codes and the SNP weights (copied to each device once; blocks are
    slices)."""

    hap: Optional[tuple]
    si: Optional[torch.Tensor]
    shards: list
    use_ens: bool
    block: int
    on: dict
    dev: torch.device


def _prepare(model, codes, mesh, dev, hap_bucket, engine, f64, block,
             vote):
    """The model packed (memoized), the ensemble in the kernels' layout on
    each device, the block size and the cohort's host-to-device copy."""
    packed = model.pack(hap_bucket=hap_bucket,
                        dtype=np.float64 if f64 else np.float32)
    N = codes.shape[0]
    A = model.n_alleles
    C = model.n_classifiers
    hap = si = None
    if f64:
        hap = tuple(torch.from_numpy(x).to(dev) for x in (
            packed.hap_bits, packed.hap_freq, packed.hap_allele))
        Hm = packed.hap_bits.shape[1]
        use_ens = False
        si = torch.from_numpy(packed.snp_index).to(dev)
        shards = []
    else:
        from ..parallel.mesh import shard_bounds
        shards = [(d, _prepare_ensemble(packed, d, lo, hi),
                   torch.from_numpy(packed.snp_index[lo:hi]).to(d))
                  for d, lo, hi in shard_bounds(mesh, C)]
        Hm = max(h.n_slots for _, h, _ in shards)
        use_ens = engine in ("auto", "pallas") and ens_acc.fits(Hm, A)
        if engine == "pallas" and not use_ens:
            raise ValueError(
                f"engine='pallas': the ensemble kernel takes at most "
                f"{ens_acc.MAX_H} haplotypes per classifier and "
                f"{ens_acc.MAX_A} alleles; this model has {Hm} and {A} "
                "(engine='auto' or 'jnp' runs the scan engine)")
        if not use_ens:
            post_scores.check_limits(Hm, A)
    sw = torch.from_numpy(packed.snp_weight.astype(np.int32)).to(dev)
    if block is None:
        block = _default_block(N, C, A, Hm, dev, use_ens, SCAN_CCHUNK, f64,
                               vote == "prob")
    block = max(1, min(block, N))

    codes = np.ascontiguousarray(codes)
    if dev.type != "cpu":
        trace.count("h2d_bytes", codes.nbytes)
    geno_all = torch.from_numpy(codes).to(dev)
    on = {dev: (geno_all, sw)}
    for d, _, _ in shards:
        if d not in on:
            on[d] = (geno_all.to(d), sw.to(d))
    return _Prepared(hap, si, shards, use_ens, block, on, dev)


def _run_blocks(prep, N, A, vote, response, f64, verbose):
    """Every block of samples through the engine, each block's stats
    fetched to the host as one buffer. Returns (dosage [N, A], best [N],
    maxp [N]) under `response`, else the posterior tables [N, A, A]; then
    matching [N] and wsum [N], float64 numpy."""
    if response:
        dosage_all = np.zeros((N, A), dtype=np.float64)
        best_all = np.zeros(N, dtype=np.int64)
        maxp_all = np.zeros(N, dtype=np.float64)
    else:
        ens_all = np.zeros((N, A, A), dtype=np.float64)
    match_all = np.zeros(N, dtype=np.float64)
    wsum_all = np.zeros(N, dtype=np.float64)
    from ..utils.progress import Progress
    prog = Progress(N, info="Predicting", enabled=verbose)

    block, on = prep.block, prep.on
    for start in range(0, N, block):
        if f64:
            with trace.span("predict.block", prep.dev):
                out = _predict_block(prep.hap, prep.si, on[prep.dev][1],
                                     on[prep.dev][0][start:start + block],
                                     A, vote, SCAN_CCHUNK, f64)
        else:
            out = _predict_block_mesh(
                prep.shards, {d: x[1] for d, x in on.items()},
                {d: x[0][start:start + block] for d, x in on.items()}, A,
                vote, prep.use_ens)
        stats = _pack_stats(*out, response=response)
        with trace.span("predict.fetch", prep.dev):
            trace.count("host_syncs")
            buf = stats.to("cpu", torch.float64).numpy()
        n_eff = buf.shape[0]
        # _pack_cols layout: head (dosage[A] + best + maxp, or ens[A*A])
        # then the three stats columns
        head = A + 2 if response else A * A
        wsum, lse, wssum = buf[:, head], buf[:, head + 1], buf[:, head + 2]
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            matching = np.where(wssum > 0, np.exp(lse) / wssum, np.nan)
        sl = slice(start, start + n_eff)
        if response:
            dosage_all[sl] = buf[:, :A]
            best_all[sl] = buf[:, A].astype(np.int64)
            maxp_all[sl] = buf[:, A + 1]
        else:
            ens_all[sl] = buf[:, :A * A].reshape(-1, A, A)
        match_all[sl] = matching
        wsum_all[sl] = wsum
        prog.forward(n_eff)
    head = (dosage_all, best_all, maxp_all) if response else (ens_all,)
    return head + (match_all, wsum_all)


def _finalize(model, sample_id, info, out, with_dosage, with_prob):
    """The PredictionResult of `_run_blocks`'s arrays: allele names, the
    best guess's probability, dosages and the triangular posteriors."""
    response = not with_prob
    A = model.n_alleles
    if response:
        dosage_all, best_all, maxp_all, match_all, wsum_all = out
    else:
        ens_all, match_all, wsum_all = out
    N = match_all.shape[0]
    alleles = np.asarray(model.hla_alleles, dtype=object)
    if response:
        a1 = alleles[best_all // A].copy()
        a2 = alleles[best_all % A].copy()
        maxp = maxp_all
    else:
        iu, ju = np.triu_indices(A)
        tri = ens_all[:, iu, ju]                              # [N, A(A+1)/2]
        best = tri.argmax(axis=1)
        maxp = tri[np.arange(N), best]
        a1 = alleles[iu[best]].copy()
        a2 = alleles[ju[best]].copy()
    bad = (maxp <= 0) | (wsum_all <= 0)
    a1[bad] = None
    a2[bad] = None
    maxp = np.where(bad, 0.0, maxp)

    dosage = None
    if with_dosage:
        # dosage[A] = 2*P[A,A] + sum_{B != A} P{A,B}
        dosage = dosage_all.T if response else \
            (ens_all.sum(axis=2) + np.einsum("naa->na", ens_all)).T  # [A, N]

    return PredictionResult(
        sample_id=sample_id,
        allele1=a1, allele2=a2, prob=maxp, matching=match_all,
        dosage=dosage,
        postprob=tri.T if with_prob else None,
        hla_alleles=list(alleles), locus=model.locus, match_info=info,
    )
